"""Train-step construction: loss, gradients by autograd, AdamW.

The reference's `training.py` on parameter trees of tensors.  A train
step is a plain function of (state, batch): gradients come from
`torch.autograd.grad` over the parameter leaves (the params themselves
never require grad), the update from `optim.adamw_update` under
`torch.no_grad()`, and the step returns a new `TrainState` without a
host sync — the metrics stay 0-d device tensors.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch import pytree
from repro_torch.models import ModelConfig
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
    """
    if mesh is not None:
        raise NotImplementedError("mesh= is not ported (ROADMAP.md A5)")
    if schedule is None:
        schedule = lambda s: cosine_schedule(  # noqa: E731
            s, opt_cfg.lr_peak, warmup_steps=min(500, total_steps // 10),
            total_steps=total_steps)

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


def make_eval_step(cfg: ModelConfig, mesh=None):
    """Returns eval_step(params, batch) -> metrics (no gradients)."""
    if mesh is not None:
        raise NotImplementedError("mesh= is not ported (ROADMAP.md A5)")

    @torch.no_grad()
    def eval_step(params, batch: dict):
        _, metrics = loss_fn(params, batch, cfg)
        return metrics

    return eval_step
