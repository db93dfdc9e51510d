"""One rank of the port's multi-rank CPU jobs (not collected by pytest).

`tests/test_torch_sharding.py` spawns these with `torch.multiprocessing`
(the "spawn" method, so each rank imports only torch and the port, never
JAX): ranks meet through a `FileStore` in the job's directory, every
process group has a timeout, and each rank writes what it computed to
``out_<rank>.pkl`` there for the parent to hold against the reference.
"""

from __future__ import annotations

import datetime
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import pytree
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.configs.registry import ShapeSpec, materialize_inputs
from repro_torch.distributed.collectives import all_reduce_axes
from repro_torch.distributed.sharding import (
    NamedSharding,
    P,
    gather,
    gather_tree,
    local_block,
    shard_tree,
)
from repro_torch.launch.mesh import axis_sizes, make_debug_mesh
from repro_torch.launch.shardings import shard_batch, state_sharding
from repro_torch.models import ModelConfig, forward, init_params
from repro_torch.models.moe import ep_axes, moe_block
from repro_torch.models.transformer import loss_fn
from repro_torch.optim import AdamWConfig, AdamWState, compressed_psum
from repro_torch.optim.compression import CompressionState
from repro_torch.training import TrainState, make_eval_step, make_train_step

TIMEOUT = datetime.timedelta(seconds=90)   # a collective waiting longer fails

# tests/test_sharding_multidevice.py's configs.
MOE_CFG = dict(name="t", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
               d_ff=64, vocab_size=64, moe_experts=8, moe_top_k=2, moe_d_ff=16,
               capacity_factor=4.0, remat=False)
DENSE_CFG = dict(name="d", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
                 d_ff=64, vocab_size=64, attn_chunk_q=8, attn_chunk_kv=8, remat=False)
BATCH = 8


def _init(rank: int, world: int, workdir: str, timeout=TIMEOUT) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=timeout)


def run(rank: int, world: int, workdir: str) -> None:
    """The 8-rank job: MoE EP, the sharded train step, elastic restore,
    every registry smoke config's sharded loss, `compressed_psum`."""
    _init(rank, world, workdir)
    try:
        with open(os.path.join(workdir, "payload.pkl"), "rb") as f:
            payload = pickle.load(f)
        mesh = make_debug_mesh(2, 4, device="cpu", timeout=TIMEOUT)
        out = {"moe": _moe(mesh, payload["moe"]),
               "ep_grads": _ep_grads(mesh),
               "train": _train(mesh, payload["train"], workdir),
               "losses": _losses(mesh),
               "compress": _compress(payload["compress"])}
        with open(os.path.join(workdir, f"out_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_dies(rank: int, world: int, workdir: str) -> None:
    """Rank 1 leaves before the collective that rank 0 waits in, on a
    mesh axis's group."""
    short = datetime.timedelta(seconds=5)
    _init(rank, world, workdir, timeout=short)
    mesh = make_debug_mesh(world, 1, device="cpu", timeout=short)
    if rank == 1:
        os._exit(0)
    all_reduce_axes(torch.ones(4), mesh, ("data",))


def _t(tree):
    return pytree.tree_map(torch.from_numpy, tree)


def _np(tree):
    return pytree.tree_map(lambda x: x.detach().numpy().copy(), tree)


def _moe(mesh, pl: dict) -> dict:
    """`moe_block(mesh=)` on the global view: x rows over "data", expert
    stacks EP over "model" (FSDP over "data" on d_model)."""
    cfg = ModelConfig(**MOE_CFG, dtype=torch.float32)
    p, x = _t(pl["p"]), torch.from_numpy(pl["x"])
    specs = {"router": P(), "w_gate": P("model", "data", None),
             "w_up": P("model", "data", None), "w_down": P("model", None, "data")}
    pd = {k: NamedSharding(mesh, specs[k]).shard(v) for k, v in p.items()}
    xd = NamedSharding(mesh, P("data", None, None)).shard(x)
    out, aux = moe_block(xd, pd, cfg, mesh)
    half = x.shape[0] // 2
    aux_blocks = [float(moe_block(x[i * half:(i + 1) * half], p, cfg)[1])
                  for i in range(2)]
    return dict(out=gather(out).numpy(), aux=float(aux),
                aux_blocks=float(np.mean(aux_blocks)),
                local=tuple(out.to_local().shape),
                expert_local={k: tuple(v.to_local().shape) for k, v in pd.items()})


def _ep_grads(mesh) -> dict:
    """Expert-parallel gradients of `loss_fn(mesh=)` (summed over the
    batch axes, as the train step sums them) against autograd of the
    same objective on one rank: the whole batch's CE plus the mean of
    the row blocks' aux losses.  Capacity is lifted, so that routing
    does not depend on which rows share a call."""
    cfg = ModelConfig(**{**MOE_CFG, "n_layers": 2, "capacity_factor": 8.0},
                      dtype=torch.float32)
    params = init_params(3, cfg, device="cpu")
    batch = _train_batch(cfg, seed=5)
    sp = shard_tree(params, state_sharding(mesh, params, cfg))
    sb = shard_batch(mesh, batch, BATCH)
    named = pytree.leaves_with_path(sp)
    keeps = [ep_axes(path, x) for path, x in named]
    used = [gather(x, keep=k).requires_grad_(True) for (_, x), k in zip(named, keeps)]
    with torch.enable_grad():
        loss, _ = loss_fn(pytree.unflatten(params, used), sb, cfg, mesh)
        grads = torch.autograd.grad(loss, used, allow_unused=True, materialize_grads=True)
    grads = [all_reduce_axes(g.clone(), mesh, ("data",)) for g in grads]

    leaves = [p.clone().requires_grad_(True) for p in pytree.leaves(params)]
    with torch.enable_grad():
        tree = pytree.unflatten(params, leaves)
        _, m = loss_fn(tree, batch, cfg)
        half = BATCH // 2
        aux = sum(loss_fn(tree, {k: v[i * half:(i + 1) * half] for k, v in batch.items()},
                          cfg)[1]["router_aux"] for i in range(2)) / 2
        ref_loss = m["ce"] + cfg.router_aux_coef * aux
        ref = torch.autograd.grad(ref_loss, leaves, allow_unused=True,
                                  materialize_grads=True)
    errs = {}
    for (path, x), k, g, r in zip(named, keeps, grads, ref):
        if k:   # this rank's experts: the block at its "model" coordinate
            r = local_block(r, mesh, x.placements, skip=("data",))
        errs[path] = float((g - r).abs().max() / r.abs().max().clamp_min(1e-30))
    return dict(loss=float(loss), ref_loss=float(ref_loss), rel_err=errs,
                expert_shapes={path: tuple(g.shape) for (path, _), k, g
                               in zip(named, keeps, grads) if k})


def _train_batch(cfg, seed: int) -> dict:
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, 16), generator=gen, dtype=torch.int32)
    return {"tokens": tokens,
            "targets": torch.roll(tokens, -1, dims=1),
            "mask": (torch.rand((BATCH, 16), generator=gen) < 0.8).to(torch.float32)}


def _expected_local(shape, spec, mesh) -> tuple:
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,) if entry else ()):
            out[d] //= sizes[a]
    return tuple(out)


def _check_blocks(tree, shardings, mesh) -> list[str]:
    """Paths whose local block has the wrong shape or is not the block of
    the full tensor the spec places on this rank."""
    bad = []
    full = gather_tree(tree)
    for (path, x), f, sh in zip(pytree.leaves_with_path(tree), pytree.leaves(full),
                                pytree.leaves(shardings)):
        loc = x.to_local()
        if (tuple(loc.shape) != _expected_local(x.shape, sh.spec, mesh)
                or not torch.equal(loc, local_block(f, mesh, sh.placements))):
            bad.append(path)
    return bad


def _train(mesh, t: dict, workdir: str) -> dict:
    """The sharded train step against the single-device step (the
    reference's, in the parent, and the port's), every rank's blocks,
    and the elastic restore onto a (4, 2) mesh."""
    cfg = ModelConfig(**DENSE_CFG, dtype=torch.float32)
    opt = AdamWConfig(lr_peak=1e-3)
    s = t["state"]
    state0 = TrainState(_t(s["params"]), AdamWState(
        torch.tensor(s["step"], dtype=torch.int32), _t(s["m"]), _t(s["v"])))
    batch = _t(t["batch"])
    sh = state_sharding(mesh, state0, cfg)
    st = shard_tree(state0, sh)
    bad_blocks = _check_blocks(st, sh, mesh)
    specs = {path: tuple(x.spec) for path, x in pytree.leaves_with_path(sh)}
    sb = shard_batch(mesh, batch, BATCH)
    s1, m1 = make_train_step(cfg, opt, mesh, total_steps=10)(st, sb)
    bad_blocks += _check_blocks(s1, sh, mesh)
    full = gather_tree(s1)
    s2, m2 = make_train_step(cfg, opt, mesh, total_steps=10, grad_accum=2)(st, sb)
    ev = make_eval_step(cfg, mesh)(st.params, sb)
    plain = {}
    if dist.get_rank() == 0:      # the single-device steps, once
        p1, m = make_train_step(cfg, opt, total_steps=10)(state0, batch)
        p2, m_2 = make_train_step(cfg, opt, total_steps=10, grad_accum=2)(state0, batch)
        plain = dict(
            plain_loss=float(m["loss"]), plain_grad_norm=float(m["grad_norm"]),
            plain_params=_np(p1.params), accum_plain_loss=float(m_2["loss"]),
            accum_plain_params=_np(p2.params),
            eval_plain={k: float(v) for k, v in
                        make_eval_step(cfg)(state0.params, batch).items()})

    mgr = CheckpointManager(os.path.join(workdir, "ckpt"))
    mgr.save(1, s1.params)
    mesh2 = make_debug_mesh(4, 2, device="cpu", timeout=TIMEOUT)
    sh2 = state_sharding(mesh2, s1.params, cfg)
    r_step, rec = mgr.restore_latest(template=s1.params, sharding_tree=sh2)
    bad_elastic = _check_blocks(rec, sh2, mesh2)
    rec_full = gather_tree(rec)
    elastic = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                  for a, b in zip(pytree.leaves(rec_full), pytree.leaves(full.params)))
    return dict(loss=float(m1["loss"]), grad_norm=float(m1["grad_norm"]),
                params=_np(full.params), opt=_np(full.opt), specs=specs,
                bad_blocks=bad_blocks, **plain,
                accum_loss=float(m2["loss"]), accum_params=_np(gather_tree(s2.params)),
                eval={k: float(v) for k, v in ev.items()},
                restored_step=r_step, bad_elastic=bad_elastic, elastic_rel=elastic,
                elastic_mesh=tuple(pytree.leaves(rec)[0].device_mesh.shape))


def _losses(mesh) -> dict:
    """Every registry smoke config (float32; MoE capacity lifted):
    `loss_fn(mesh=)` on sharded params and batch against the unsharded
    CE of the whole batch and the mean aux loss of the two row blocks."""
    out = {}
    for arch in ARCHS:
        cfg = get_smoke_config(arch).replace(dtype=torch.float32)
        if cfg.is_moe:
            cfg = cfg.replace(capacity_factor=float(cfg.moe_experts))
        params = init_params(7, cfg, device="cpu")
        batch = materialize_inputs(cfg, ShapeSpec("t", "train", 16, BATCH), seed=1,
                                   device="cpu")["batch"]
        gen = torch.Generator().manual_seed(2)
        batch["mask"] = (torch.rand((BATCH, 16), generator=gen) < 0.75).to(torch.float32)
        sp = shard_tree(params, state_sharding(mesh, params, cfg))
        sb = shard_batch(mesh, batch, BATCH)
        loss, m = loss_fn(sp, sb, cfg, mesh)
        logits = gather(forward(sp, sb, cfg, mesh)[0])
        out[arch] = dict(loss=float(loss), ce=float(m["ce"]), aux=float(m["router_aux"]))
        if dist.get_rank():
            continue      # every rank holds the same values; rank 0 holds them
        _, ref = loss_fn(params, batch, cfg)
        ref_logits = forward(params, batch, cfg)[0]
        half = BATCH // 2
        aux = np.mean([float(loss_fn(params, {k: v[i * half:(i + 1) * half]
                                              for k, v in batch.items()}, cfg)[1]
                             ["router_aux"]) for i in range(2)])
        out[arch].update(
            ref_ce=float(ref["ce"]), ref_aux=float(aux),
            ref_loss=float(ref["ce"]) + cfg.router_aux_coef * float(aux),
            logits_rel=float((logits - ref_logits).abs().max() / ref_logits.abs().max()),
            logits_shape=tuple(logits.shape) == tuple(ref_logits.shape))
    return out


def _compress(g: np.ndarray) -> dict:
    """`compressed_psum` over "pod" on a (2, 2, 2) mesh, each pod holding
    its own row of `g`; a spy records every all-reduce's payload dtype
    on the pod group."""
    mesh = make_debug_mesh(2, 2, pods=2, device="cpu", timeout=TIMEOUT)
    pod_ranks = dist.get_process_group_ranks(mesh.get_group("pod"))
    seen, real = [], dist.all_reduce

    def spy(tensor, op=dist.ReduceOp.SUM, group=None, async_op=False):
        if group is not None and dist.get_process_group_ranks(group) == pod_ranks:
            seen.append(str(tensor.dtype))
        return real(tensor, op=op, group=group, async_op=async_op)

    pod = mesh.get_local_rank("pod")
    mine = torch.from_numpy(g[pod:pod + 1].copy())
    true_mean = torch.from_numpy(g.mean(axis=0))
    dist.all_reduce = spy
    try:
        err = CompressionState(error={"g": torch.zeros_like(mine)})
        synced, err = compressed_psum({"g": mine}, err, mesh, axis_name="pod")
        err0 = float((synced["g"][0] - true_mean).abs().max())
        acc = torch.zeros_like(true_mean)
        err = CompressionState(error={"g": torch.zeros_like(mine)})
        for _ in range(100):
            synced, err = compressed_psum({"g": mine}, err, mesh, axis_name="pod")
            acc += synced["g"][0]
        bias = float((acc / 100 - true_mean).abs().max())
    finally:
        dist.all_reduce = real
    return dict(err0=err0, bias=bias, dtypes=sorted(set(seen)), n_calls=len(seen))
