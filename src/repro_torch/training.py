"""Train-step construction: loss, gradients by autograd, AdamW.

The reference's `training.py` on parameter trees of tensors.  A train
step is a plain function of (state, batch): gradients come from
`torch.autograd.grad` over the parameter leaves (the params themselves
never require grad), the update from `optim.adamw_update` under
`torch.no_grad()`, and the step returns a new `TrainState` without a
host sync — the metrics stay 0-d device tensors.

On a mesh (`mesh=`) the state is stored as `launch.shardings.
state_sharding` says: every parameter and AdamW moment a DTensor of
which each rank holds its block.  A step gathers each parameter at use
(expert stacks only over the axes other than "model": each rank runs
its own experts), takes the loss of the whole batch on the rank's rows
(`loss_fn(mesh=)`), sums the gradients over the batch axes in float32
(each rank's is its rows' share), clips by the norm of the whole
gradient, and updates its own blocks with `adamw_update`.  The
semantics are the reference's under GSPMD (DESIGN.md Sec. 4); on a
mesh of one rank the step is the single-device step, bitwise.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch import pytree
from repro_torch.distributed.collectives import all_reduce_axes
from repro_torch.distributed.sharding import is_dtensor, local, local_block, gather
from repro_torch.models import ModelConfig
from repro_torch.models.act_sharding import batch_rows
from repro_torch.models.moe import ep_axes, is_expert_stack
from repro_torch.models.transformer import loss_fn
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, cosine_schedule
from repro_torch.optim.adamw import AdamWState

__all__ = ["TrainState", "init_train_state", "make_train_step", "make_eval_step"]


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def init_train_state(seed: int, cfg: ModelConfig, opt_cfg: AdamWConfig,
                     device="cuda") -> TrainState:
    from repro_torch.models import init_params

    params = init_params(seed, cfg, device=device)
    return TrainState(params=params, opt=adamw_init(params, opt_cfg))


def _grads_of(params, batch: dict, cfg: ModelConfig):
    """((loss, metrics), grads): grads in each leaf's dtype, as autograd
    (and the reference's `value_and_grad`) gives them."""
    leaves = [p.detach().requires_grad_(True) for p in pytree.leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(pytree.unflatten(params, leaves), batch, cfg)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), pytree.unflatten(params, grads)


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    mesh=None,
    schedule: Callable | None = None,
    total_steps: int = 10000,
    grad_accum: int = 1,
):
    """Returns train_step(state, batch) -> (state, metrics).

    The learning rate is ``schedule(opt.step + 1)`` (indexed from 1, so
    warmup does not zero the first step); by default the cosine schedule
    with ``min(500, total_steps // 10)`` warmup steps.  ``grad_accum >
    1`` splits the batch into that many microbatches along its first
    axis, sums their float32 gradients and metrics, and divides by the
    count (the reference's `lax.scan`, as a loop).

    With `mesh`, the state must be sharded (DTensor leaves) and the batch
    DTensors laid out by `launch.shardings.batch_sharding`; the step
    then runs as the module docstring says.  Its microbatches are the
    reference's, slices of the whole batch: with ``grad_accum > 1`` the
    batch's rows are gathered and each slice is laid out anew.
    """
    if schedule is None:
        schedule = lambda s: cosine_schedule(  # noqa: E731
            s, opt_cfg.lr_peak, warmup_steps=min(500, total_steps // 10),
            total_steps=total_steps)
    if mesh is not None:
        return _sharded_train_step(cfg, opt_cfg, mesh, schedule, grad_accum)

    def train_step(state: TrainState, batch: dict):
        lr = schedule(state.opt.step + 1)
        if grad_accum == 1:
            (_, metrics), grads = _grads_of(state.params, batch, cfg)
        else:
            n = next(iter(batch.values())).shape[0]
            if n % grad_accum:
                raise ValueError(f"batch of {n} does not split into {grad_accum} "
                                 "microbatches")
            per = n // grad_accum
            grads, metrics = None, None
            for i in range(grad_accum):
                mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
                (_, m), g = _grads_of(state.params, mb, cfg)
                g = pytree.tree_map(lambda x: x.to(torch.float32), g)
                if grads is None:
                    grads, metrics = g, m
                else:
                    grads = pytree.tree_map(torch.add, grads, g)
                    metrics = {k: metrics[k] + m[k] for k in metrics}
            grads = pytree.tree_map(lambda g: g / grad_accum, grads)
            metrics = {k: v / grad_accum for k, v in metrics.items()}
        params, opt, opt_metrics = adamw_update(
            grads, state.opt, state.params, opt_cfg, lr)
        metrics = {**metrics, **opt_metrics, "lr": lr}
        return TrainState(params, opt), metrics

    return train_step


def _like(new: torch.Tensor, old):
    """`new`, this rank's block, as a DTensor laid out like `old`."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(new, old.device_mesh, old.placements, run_check=False,
                              shape=old.shape, stride=old.stride())


def _microbatches(batch: dict, mesh, grad_accum: int) -> list[dict]:
    """The batch's `grad_accum` row slices, each laid out by
    `batch_sharding` for its size."""
    from repro_torch.launch.shardings import shard_batch

    for key, v in batch.items():
        if isinstance(v, torch.Tensor) and not is_dtensor(v):
            raise TypeError(f"batch[{key!r}]: a sharded step needs the batch as DTensors "
                            "(launch.shardings.shard_batch)")
    if grad_accum == 1:
        return [batch]
    full = {k: gather(v) for k, v in batch.items()}
    n = next(iter(full.values())).shape[0]
    if n % grad_accum:
        raise ValueError(f"batch of {n} does not split into {grad_accum} microbatches")
    per = n // grad_accum
    return [shard_batch(mesh, {k: v[i * per:(i + 1) * per] for k, v in full.items()}, per)
            for i in range(grad_accum)]


def _sharded_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, mesh, schedule,
                        grad_accum: int):
    def train_step(state: TrainState, batch: dict):
        named = pytree.leaves_with_path(state.params)
        moments = (pytree.leaves(state.opt.m), pytree.leaves(state.opt.v))
        for (path, p), m, v in zip(named, *moments):
            if not (is_dtensor(p) and is_dtensor(m) and is_dtensor(v)):
                raise TypeError(f"{path}: a sharded step needs the state stored as "
                                "DTensors (launch.shardings.state_sharding)")
            if not p.placements == m.placements == v.placements:
                raise ValueError(f"{path}: params and AdamW moments are laid out "
                                 "differently")
        keeps = [ep_axes(path, p) for path, p in named]
        for (path, _), k in zip(named, keeps):
            if is_expert_stack(path) and not k:
                raise ValueError(f"{path}: a sharded step needs expert stacks stored "
                                 "with their expert dim split over 'model' (each rank "
                                 "holds its own experts' gradients)")
        used = [gather(p, keep=k).detach().requires_grad_(True)
                for (_, p), k in zip(named, keeps)]
        micro = _microbatches(batch, mesh, grad_accum)
        step = local(state.opt.step)
        lr = schedule(step + 1)
        shares, metrics = None, None      # this rank's float32 shares, summed
        for mb in micro:
            with torch.enable_grad():
                loss, m = loss_fn(pytree.unflatten(state.params, used), mb, cfg, mesh)
                g = torch.autograd.grad(loss, used, allow_unused=True,
                                        materialize_grads=True)
            g = [x.to(torch.float32) for x in g]
            m = {k: v.detach() for k, v in m.items()}
            if shares is None:
                shares, metrics = g, m
            else:
                shares = [a + b for a, b in zip(shares, g)]
                metrics = {k: metrics[k] + m[k] for k in metrics}
        _, rows = batch_rows(micro[0], mesh)
        grads = [all_reduce_axes(g, mesh, rows) for g in shares]
        if grad_accum > 1:
            grads = [g / grad_accum for g in grads]
            metrics = {k: v / grad_accum for k, v in metrics.items()}
        # The norm of the whole gradient: an expert stack's rank holds
        # its own experts' part.
        sq = torch.stack([torch.sum(torch.square(g)) for g in grads])
        ep = [i for i, k in enumerate(keeps) if k]
        if ep:
            idx = torch.tensor(ep, device=sq.device)
            sq = sq.index_copy(0, idx, all_reduce_axes(sq[idx], mesh, ("model",)))
        gnorm = torch.sqrt(torch.sum(sq))
        mine = [local_block(g, mesh, p.placements, skip=k)
                for g, (_, p), k in zip(grads, named, keeps)]
        params, opt, opt_metrics = adamw_update(
            pytree.unflatten(state.params, mine),
            AdamWState(step, *(pytree.tree_map(local, t) for t in
                               (state.opt.m, state.opt.v))),
            pytree.tree_map(local, state.params), opt_cfg, lr, gnorm=gnorm)
        step_new = (_like(opt.step, state.opt.step) if is_dtensor(state.opt.step)
                    else opt.step)
        opt = AdamWState(step_new, *(pytree.tree_map(_like, new, old) for new, old in
                                     ((opt.m, state.opt.m), (opt.v, state.opt.v))))
        params = pytree.tree_map(_like, params, state.params)
        metrics = {**metrics, **opt_metrics, "lr": lr}
        return TrainState(params, opt), metrics

    return train_step


def make_eval_step(cfg: ModelConfig, mesh=None):
    """Returns eval_step(params, batch) -> metrics (no gradients); on a
    mesh the metrics of the whole batch (see `loss_fn`)."""

    @torch.no_grad()
    def eval_step(params, batch: dict):
        _, metrics = loss_fn(params, batch, cfg, mesh)
        return metrics

    return eval_step
