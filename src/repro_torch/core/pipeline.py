"""Bucketed whole-model programming pipeline (DESIGN.md Sec. 10).

The shared hot path for model-scale programming:

* `bucket_sizes` decomposes the total column count into a small menu of
  power-of-two buckets, so an arbitrary model runs at most
  log2(max/min)+1 distinct dispatch shapes.
* `get_program_fn` is the ONE cache of batched-programming entries
  (PyTorch runs eagerly, so an entry is a closure, not a compiled
  program; `compile_count()` still counts the distinct (config, bucket
  shape) dispatches, which bounds what a later CUDA-graph capture
  would record).
* `program_packed_columns` runs many independently-packed column blocks
  (one per weight leaf) through the bucket dispatches and splits the
  results back per block.

Per-column RNG (see `core.rng`): every column draws from
``fold_in(key, uid)``, so a column's programmed value depends only on
(key, uid) — not on bucket boundaries or padding.  That is what makes
the bucketed path bit-identical to the per-leaf path.

Faulty silicon (DESIGN.md Sec. 15): with a `FaultConfig` the per-cell
fault map is sampled per uid, like d2d, and every dispatch programs
under it; explicit `uids` let the spare-column pass program
non-contiguous physical columns (`core.remap`).

On a device mesh (`mesh=`, a `DeviceMesh` over an initialised process
group) each rank programs its block of every bucket's columns and the
blocks are gathered after the WV loop, so every rank holds the whole,
bitwise unsharded, deployment.

Telemetry (the reference's): the bucket loop runs in a
``deploy.program_columns`` span, and each dispatch's real column count
goes to the ``pipeline.bucket_columns`` digest (host ints).  The
reference also records a ``pipeline.compile`` instant when `jax.jit`
traces a new bucket shape; the port traces nothing, so it records none
(`compile_count()` still counts the distinct dispatch shapes).

Nothing here synchronizes with the device; `host_fetch` is the one
counted transfer point (`host_sync_count()`), and a batched deploy calls
it exactly once.  Nothing here updates a tensor in place, so slices of
caller-held state (targets, d2d) are safe to pass to the engine.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.distributed.collectives import all_gather_axes, block_of
from repro_torch.obs import metrics as obs_metrics

from . import device as dev_mod
from . import rng
from .cost import CircuitCost
from .types import FaultConfig, WVConfig
from .wv import WVStats, program_columns

__all__ = [
    "bucket_sizes",
    "get_program_fn",
    "program_packed_columns",
    "sample_d2d_for",
    "sample_fault_for",
    "host_fetch",
    "donates",
    "compile_count",
    "host_sync_count",
    "reset_counters",
]

DEFAULT_MIN_BUCKET = 256
DEFAULT_MAX_BUCKET = 1 << 18

_FN_CACHE: dict = {}
_TRACED: set = set()

COMPILE_COUNTER = "pipeline.compiles"
SYNC_COUNTER = "pipeline.host_syncs"


def compile_count() -> int:
    """Distinct (config, bucket-shape) dispatches run so far."""
    return int(obs_metrics.value(COMPILE_COUNTER))


def host_sync_count() -> int:
    """`host_fetch` device->host synchronizations performed so far."""
    return int(obs_metrics.value(SYNC_COUNTER))


def reset_counters() -> None:
    """Zero the pipeline's registry counters (the entry cache survives)."""
    obs_metrics.reset("pipeline.")


def host_fetch(tree):
    """The pipeline's single device->host transfer point (counted)."""
    return obs_metrics.fetch(tree, counter=SYNC_COUNTER)


def donates() -> bool:
    """Whether `get_program_fn` donates its targets / d2d arguments: the
    reference's XLA entry does off the CPU, so its callers copy a buffer
    they keep.  Eager PyTorch has no donation and the port's entry never
    frees or reuses an argument, so never."""
    return False


def bucket_sizes(
    c_total: int,
    min_bucket: int = DEFAULT_MIN_BUCKET,
    max_bucket: int = DEFAULT_MAX_BUCKET,
) -> list[int]:
    """Greedy power-of-two decomposition of a column count.

    Returns bucket sizes summing to >= c_total, each a power of two in
    [min_bucket, max_bucket].  Only the LAST bucket is padded (by at
    most min_bucket - 1 columns).
    """
    assert min_bucket > 0 and min_bucket & (min_bucket - 1) == 0, min_bucket
    assert max_bucket >= min_bucket and max_bucket & (max_bucket - 1) == 0, (
        max_bucket
    )
    sizes: list[int] = []
    rem = c_total
    while rem >= min_bucket:
        s = min(max_bucket, 1 << (rem.bit_length() - 1))
        sizes.append(s)
        rem -= s
    if rem > 0 or not sizes:
        sizes.append(min_bucket)
    return sizes


def get_program_fn(cfg: WVConfig, cost: CircuitCost, mesh=None,
                   mesh_axes: tuple | None = None, with_fault: bool = False):
    """The shared batched-programming entry: (key, targets, d2d, col_ids).

    Returns ``fn(key, (C, N) targets, (C, N) d2d, (C,) col_ids) ->
    (g, WVStats)``, cached per (cfg, cost, mesh, mesh_axes, with_fault).
    With `with_fault=True` the entry takes a trailing `device.FaultMap`
    of (C, N) fields and programs under it; it has its own cache entry,
    so the fault-free dispatches are counted apart.

    With a `mesh` the column axis is split over `mesh_axes` (default:
    every axis of the mesh, the first the major one): each rank programs
    its block of the C columns, ranks along an axis left out of
    `mesh_axes` repeat that block's work (the reference's ``P(axes,
    None)`` layout), and a C that the blocks do not divide is programmed
    whole on every rank.  No rank talks to another inside the WV loop: a
    column's trajectory depends only on ``fold_in(key, uid)``.  Then g
    and the stats, packed into one (C, N + 9) buffer, are gathered
    across the ranks (one `all_gather` per axis, no host sync), so every
    rank returns the whole bucket, bitwise what one device computes.
    """
    cache_key = (cfg, cost, mesh, mesh_axes, with_fault)
    entry = _FN_CACHE.get(cache_key)
    if entry is None:
        axes = (tuple(mesh_axes) if mesh_axes is not None
                else tuple(mesh.mesh_dim_names) if mesh is not None else ())

        def entry(key, targets, d2d, col_ids, *fault):
            assert len(fault) == int(with_fault), (len(fault), with_fault)
            tk = (cache_key, tuple(targets.shape))
            if tk not in _TRACED:
                _TRACED.add(tk)
                obs_metrics.inc(COMPILE_COUNTER)
            fm = fault[0] if fault else None
            c = int(targets.shape[0])
            blk, n_blk = block_of(mesh, axes) if axes else (0, 1)
            if not axes or c % n_blk:
                return program_columns(key, targets, cfg, cost=cost, d2d=d2d,
                                       col_ids=col_ids, fault=fm)
            lo, hi = blk * c // n_blk, (blk + 1) * c // n_blk
            g, st = program_columns(
                key, targets[lo:hi], cfg, cost=cost, d2d=d2d[lo:hi],
                col_ids=col_ids[lo:hi],
                fault=fm.map(lambda x: x[lo:hi]) if fm is not None else None)
            n = g.shape[1]
            packed = all_gather_axes(
                torch.cat([g, torch.stack(tuple(st), dim=1)], dim=1), mesh, axes)
            return packed[:, :n], WVStats(*packed[:, n:].unbind(dim=1))

        _FN_CACHE[cache_key] = entry
    return entry


def sample_d2d_for(key, col_ids, shape, dev_cfg):
    """Per-column-stream d2d sample, mirroring `program_columns`' own
    key schedule (`k_d2d` = first of the column key's 3-way split).

    Sampled `DEFAULT_MAX_BUCKET` columns at a time: each column's stream
    is its own, so chunking changes no value and bounds the generator's
    scratch.
    """
    parts = []
    for off in range(0, int(shape[0]), DEFAULT_MAX_BUCKET):
        ids = col_ids[off: off + DEFAULT_MAX_BUCKET]
        k_d2d = rng.split(rng.fold_col_keys(key, ids), 3)[0]
        parts.append(dev_mod.sample_d2d(k_d2d, (ids.shape[0],) + tuple(shape[1:]),
                                        dev_cfg))
    if not parts:
        return torch.empty(tuple(shape), dtype=torch.float32, device=key.device)
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def sample_fault_for(key, col_ids, shape, fault_cfg: FaultConfig, dev_cfg
                     ) -> dev_mod.FaultMap:
    """`device.sample_fault_map` over `col_ids`, `DEFAULT_MAX_BUCKET`
    columns at a time (a column's faults depend only on (key, uid), so
    chunking changes no value and bounds the generator's scratch)."""
    parts = []
    for off in range(0, int(shape[0]), DEFAULT_MAX_BUCKET):
        ids = col_ids[off: off + DEFAULT_MAX_BUCKET]
        parts.append(dev_mod.sample_fault_map(
            key, ids, (ids.shape[0],) + tuple(shape[1:]), fault_cfg, dev_cfg))
    if not parts:
        return dev_mod.empty_fault_map(tuple(shape), device=key.device)
    if len(parts) == 1:
        return parts[0]
    return dev_mod.FaultMap(*(torch.cat(xs) for xs in zip(*parts)))


def uids_to_device(uids, device) -> torch.Tensor:
    """Host uids -> an int64 tensor on `device` without a stream sync
    (staged in pinned memory on the card)."""
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(uids, np.int64)))
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def program_packed_columns(
    key: torch.Tensor,
    blocks: Sequence[torch.Tensor],
    cfg: WVConfig,
    cost: CircuitCost | None = None,
    *,
    mesh=None,
    mesh_axes: tuple | None = None,
    min_bucket: int = DEFAULT_MIN_BUCKET,
    max_bucket: int = DEFAULT_MAX_BUCKET,
    uid_base: int = 0,
    uids=None,
    pad_uid_base: int | None = None,
    fault_cfg: FaultConfig | None = None,
) -> tuple[list[torch.Tensor], list[WVStats], list[torch.Tensor],
           list[dev_mod.FaultMap | None]]:
    """Program many packed column blocks in a few bucketed dispatches.

    Args:
      key: master key (column sub-streams derive from it).
      blocks: list of (C_i, N) target-level tensors (e.g. one per leaf).
      cfg / cost: WV configuration and circuit constants.
      mesh / mesh_axes: optional device mesh whose ranks split each
        bucket's columns (`get_program_fn`); every rank returns the
        whole deployment.
      min_bucket / max_bucket: power-of-two bucket bounds.
      uid_base: first column uid (block b's column j gets uid
        ``uid_base + sum(C_<b) + j``).  Filler uids for bucket padding
        start at ``uid_base + c_total``.
      uids: optional explicit (sum C_i,) host column uids in place of
        the contiguous numbering: the spare-column pass programs
        non-contiguous physical columns (`core.remap`).
      pad_uid_base: first filler uid (default ``uid_base + c_total``);
        with explicit `uids`, pass a value past the whole uid range.
      fault_cfg: optional fault population.  When it has faults, the
        fault map is sampled per uid from the same master key (a
        bucketed and a per-leaf deploy see the same silicon), programming
        runs under it, and it is returned per block for the caller to
        keep beside d2d.  Filler rows get inert fault rows.

    Returns (g_blocks, stats_blocks, d2d_blocks, fault_blocks), split
    back to the input block boundaries; `fault_blocks` holds None per
    block without faults.  Everything stays on the device; no host syncs.
    """
    if cost is None:
        cost = CircuitCost()
    sizes = [int(b.shape[0]) for b in blocks]
    c_total = sum(sizes)
    if c_total == 0:
        return [], [], [], []
    device = key.device
    n = int(blocks[0].shape[1])
    targets = torch.cat(list(blocks)) if len(blocks) > 1 else blocks[0]
    targets = targets.to(device=device, dtype=torch.float32)
    if uids is None:
        uids = uid_base + torch.arange(c_total, dtype=torch.int64, device=device)
    else:
        uids = uids_to_device(uids, device)
    assert tuple(uids.shape) == (c_total,), (tuple(uids.shape), c_total)
    if pad_uid_base is None:
        pad_uid_base = uid_base + c_total
    # d2d and the fault map are persistent array state (ArrayState.d2d /
    # .fault), sampled from the same sub-streams the engine would use.
    d2d = sample_d2d_for(key, uids, (c_total, n), cfg.device)
    with_fault = fault_cfg is not None and fault_cfg.any_faults
    fault = (sample_fault_for(key, uids, (c_total, n), fault_cfg, cfg.device)
             if with_fault else None)

    fn = get_program_fn(cfg, cost, mesh, mesh_axes, with_fault)
    sizes_plan = bucket_sizes(c_total, min_bucket, max_bucket)
    g_parts, stat_parts = [], []
    off = 0
    with obs.span("deploy.program_columns", cat="pipeline", columns=c_total,
                  buckets=len(sizes_plan), blocks=len(blocks)):
        for size in sizes_plan:
            take = min(size, c_total - off)
            # How well the bucket menu fits real models: host ints only.
            obs.digests.observe("pipeline.bucket_columns", float(take),
                                lo=0.0, hi=float(DEFAULT_MAX_BUCKET), n_buckets=64)
            tb = targets[off: off + take]
            db = d2d[off: off + take]
            ub = uids[off: off + take]
            fb = fault.map(lambda x: x[off: off + take]) if with_fault else None
            pad = size - take
            if pad:
                # Filler columns: zero targets, fresh uids past the real
                # range (their streams never alias a real column's), unit
                # d2d, inert fault rows.
                tb = F.pad(tb, (0, 0, 0, pad))
                db = F.pad(db, (0, 0, 0, pad), value=1.0)
                ub = torch.cat([ub, pad_uid_base + torch.arange(
                    pad, dtype=torch.int64, device=device)])
                if with_fault:
                    fb = dev_mod.FaultMap(*(torch.cat([x, f]) for x, f in zip(
                        fb, dev_mod.empty_fault_map((pad, n), device=device))))
            g_b, st_b = fn(key, tb, db, ub, *((fb,) if with_fault else ()))
            g_parts.append(g_b[:take])
            stat_parts.append(st_b.map(lambda x: x[:take]))
            off += take

    g_all = torch.cat(g_parts) if len(g_parts) > 1 else g_parts[0]
    stats_all = (
        WVStats(*(torch.cat(xs) for xs in zip(*stat_parts)))
        if len(stat_parts) > 1
        else stat_parts[0]
    )
    g_blocks, stats_blocks, d2d_blocks, fault_blocks = [], [], [], []
    off = 0
    for c_i in sizes:
        g_blocks.append(g_all[off: off + c_i])
        stats_blocks.append(stats_all.map(lambda x: x[off: off + c_i]))
        d2d_blocks.append(d2d[off: off + c_i])
        fault_blocks.append(fault.map(lambda x: x[off: off + c_i])
                            if with_fault else None)
        off += c_i
    return g_blocks, stats_blocks, d2d_blocks, fault_blocks
