"""Model-level RRAM deployment: quantize -> slice -> program -> read back.

`deploy_arrays` takes a nested dict of model parameters, pushes every
eligible weight leaf through the quantize -> bit-slice -> pack-to-columns
-> write-and-verify pipeline, and returns a `DeployedModel` that keeps
per-leaf `ArrayState` (programmed conductances `g`, integer `targets`,
static `d2d` efficiencies, quant `scale`, pack `layout`) plus a
`DeployReport` of aggregate WV statistics (latency / energy /
iterations).  `materialize()` rebuilds dense params from the live `g`.

By default the whole model goes through the bucketed pipeline
(`core.pipeline`, DESIGN.md Sec. 10): all leaves' packed columns are
concatenated into a few power-of-two column buckets, and the report is
reduced on the device and fetched with a single host sync.
`batched=False` keeps the per-leaf baseline path; per-column RNG
sub-streams make the two bit-identical.

Faulty silicon (DESIGN.md Sec. 15, batched path only): `fault_cfg`
samples a per-cell `FaultMap` kept in each `ArrayState`; `remap_cfg`
provisions spare columns per leaf and, after the primary pass, repairs
the worst columns onto them in a second pass (`core.remap`), with
optional fault-aware placement.  The deploy still makes one host sync.

Telemetry (the reference's, DESIGN.md Sec. 14 and 16): a batched deploy
reduces per-tile health (give-up, retry and write pulses, verify reads,
squared cell error, remapped columns) and two digests (write pulses and
iterations per column) on the device, and they ride the report's one
host fetch; the fetched values are folded into `obs.health_registry`
(``deploy.*`` tile maps) and `obs.digests`, the report's totals into the
``deploy.*`` counters, and the modeled energy into the ``deploy`` (and
``deploy.give_up``) ledger phases, all inside a ``deploy`` span.

Deployment policy (the reference's, kept as is):
* leaves with ndim >= 2 go to RRAM (flattened to (K, M) on the last
  axis) — this includes the stacked per-layer norm scales (L, d);
* 1D leaves stay digital;
* embedding tables are excluded by default (`deploy_embeddings=False`).

Leaves are visited in the reference's pytree order — dict keys sorted,
recursively — and named in its `keystr` form (``['layers']['wq']``), so
every column gets the uid, and hence the noise stream, it gets there.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import obs, pytree
from repro_torch.quant import (
    QuantConfig,
    dequantize_weight,
    pack_columns,
    quantize_weight,
    unpack_columns,
)
from repro_torch.quant.pack import PackedLayout

from . import device as dev_mod
from . import pipeline
from . import remap as remap_mod
from .cost import CircuitCost
from .types import FaultConfig, WVConfig
from .wv import WVStats

__all__ = [
    "ArrayState",
    "DeployReport",
    "DeployedModel",
    "deploy_arrays",
    "deploy_params",
    "deploy_matrix",
    "flatten_with_names",
    "fill_names",
    "names_tree",
]


@dataclasses.dataclass
class DeployReport:
    """Aggregate WV statistics for one deployment.

    The give-up and remap fields ride the same single host sync as the
    rest: `total_gave_up_cells` counts cells the retry budget declared
    unprogrammable, `total_retry_pulses` the fine pulses burned on them,
    `remapped_columns` the primary columns repaired onto spares.  All
    three are zero on a fault-free deploy without a budget.
    """

    num_columns: int = 0
    num_cells: int = 0
    mean_iterations: float = 0.0
    total_latency_ns: float = 0.0     # sum over arrays (columns in parallel)
    critical_latency_ns: float = 0.0  # max over columns = array wall-time
    total_energy_pj: float = 0.0
    rms_cell_error_lsb: float = 0.0
    total_reads: float = 0.0          # verify ADC conversions/comparisons
    total_write_pulses: float = 0.0
    total_gave_up_cells: float = 0.0  # cells declared unprogrammable
    total_retry_pulses: float = 0.0   # pulses burned on gave-up cells
    remapped_columns: int = 0         # primaries repaired onto spares
    leaves: dict[str, dict[str, float]] = dataclasses.field(default_factory=dict)
    # The fetched `extra` tree of `collect` (per-tile health reductions,
    # deploy digests).  Not a dataclass field, as in the reference: a
    # transport slot for the fold in `deploy_arrays`, not part of the
    # report's scalars.
    extra = None

    @classmethod
    def collect(cls, leaf_stats: "dict[str, WVStats]", n_cells: int,
                remapped: "dict[str, torch.Tensor] | None" = None,
                extra: Any | None = None) -> "DeployReport":
        """Device-side report reduction with exactly ONE host sync.

        All reductions (per-leaf and aggregate) run on the device over the
        `WVStats` tensors; one `pipeline.host_fetch` moves the scalars,
        with the per-leaf remapped-column counts (`remapped`) and the
        caller's `extra` tree (per-tile health, deploy digests) beside
        them.  The fetched `extra` lands in `report.extra`.
        """
        if not leaf_stats:
            return cls()
        stats = list(leaf_stats.values())
        cat = lambda f: torch.cat([getattr(s, f) for s in stats])  # noqa: E731
        rms2 = torch.cat([s.rms_error_lsb ** 2 for s in stats])
        lat = cat("latency_ns")
        agg = dict(
            mean_iterations=torch.mean(cat("iterations")),
            total_latency_ns=torch.sum(lat),
            critical_latency_ns=torch.amax(lat),
            total_energy_pj=torch.sum(cat("energy_pj")),
            rms_cell_error_lsb=torch.sqrt(torch.mean(rms2)),
            total_reads=torch.sum(cat("reads")),
            total_write_pulses=torch.sum(cat("write_pulses")),
            total_gave_up_cells=torch.sum(cat("gave_up")),
            total_retry_pulses=torch.sum(cat("retry_pulses")),
        )
        per = {
            name: dict(
                mean_iterations=torch.mean(s.iterations),
                critical_latency_ns=torch.amax(s.latency_ns),
                energy_pj=torch.sum(s.energy_pj),
                rms_cell_error_lsb=torch.sqrt(torch.mean(s.rms_error_lsb ** 2)),
                gave_up_cells=torch.sum(s.gave_up),
            )
            for name, s in leaf_stats.items()
        }
        agg_h, per_h, rem_h, extra_h = pipeline.host_fetch(
            (agg, per, remapped or {}, extra))
        report = cls(
            num_columns=sum(int(s.iterations.shape[0]) for s in stats),
            num_cells=sum(int(s.iterations.shape[0]) * n_cells for s in stats),
            remapped_columns=int(sum(float(v) for v in rem_h.values())),
            **{k: float(v) for k, v in agg_h.items()},
        )
        report.leaves = {
            name: dict(
                columns=int(leaf_stats[name].iterations.shape[0]),
                **{k: float(v) for k, v in d.items()},
            )
            for name, d in per_h.items()
        }
        for name, v in rem_h.items():
            report.leaves[name]["remapped_columns"] = float(v)
        report.extra = extra_h
        return report

    def merge(self, name: str, stats: WVStats, n_cells: int) -> None:
        """Fold one leaf's stats in (per-leaf path: host syncs per leaf)."""
        c = int(stats.iterations.shape[0])
        lat = float(torch.sum(stats.latency_ns))
        crit = float(torch.amax(stats.latency_ns))
        en = float(torch.sum(stats.energy_pj))
        it = float(torch.mean(stats.iterations))
        rms = float(torch.sqrt(torch.mean(stats.rms_error_lsb ** 2)))
        self.total_reads += float(torch.sum(stats.reads))
        self.total_write_pulses += float(torch.sum(stats.write_pulses))
        self.total_gave_up_cells += float(torch.sum(stats.gave_up))
        self.total_retry_pulses += float(torch.sum(stats.retry_pulses))
        self.leaves[name] = dict(
            columns=c, mean_iterations=it, critical_latency_ns=crit,
            energy_pj=en, rms_cell_error_lsb=rms,
        )
        tot_cells = self.num_cells + c * n_cells
        w_old = self.num_cells / max(tot_cells, 1)
        self.rms_cell_error_lsb = float(
            (self.rms_cell_error_lsb**2 * w_old + rms**2 * (1 - w_old)) ** 0.5
        )
        self.mean_iterations = (
            self.mean_iterations * self.num_columns + it * c
        ) / max(self.num_columns + c, 1)
        self.num_columns += c
        self.num_cells = tot_cells
        self.total_latency_ns += lat
        self.critical_latency_ns = max(self.critical_latency_ns, crit)
        self.total_energy_pj += en


@dataclasses.dataclass
class ArrayState:
    """Persistent programmed state of one weight leaf on RRAM.

    `g` is the live analog conductance of every cell (LSB units);
    `targets` are the intended integer levels, `d2d` the static per-cell
    step efficiency, `scale`/`layout`/`shape`/`dtype` invert the
    quantize/pack transform.  No field is written in place.
    `uids` are the physical column uids (host numpy, one per `g` row):
    ``uid // columns_per_tile`` is the tile a column lives on, which is
    how the scrub's health maps (`obs.health`) attribute drift to
    silicon without device work.

    A faulty-silicon deploy carries two more pieces of physical state:
    `fault`, the sampled per-cell `FaultMap` that every re-program of the
    same cells reuses, and `remap`, the spare-column `RemapTable`.  With
    a remap the per-column tensors are PHYSICAL (C + S rows: C primaries
    then S spares), the logical C-column view is ``x[remap.perm]``, and
    `layout` describes the logical geometry.
    """

    g: torch.Tensor              # (C[+S], N) programmed analog levels, LSB
    targets: torch.Tensor        # (C[+S], N) integer target levels, LSB
    d2d: torch.Tensor            # (C[+S], N) static per-cell step efficiency
    scale: torch.Tensor          # per-channel quantization scale
    layout: PackedLayout
    shape: tuple[int, ...]       # original leaf shape
    dtype: torch.dtype
    uids: np.ndarray | None = None
    fault: dev_mod.FaultMap | None = None      # sampled silicon faults
    remap: remap_mod.RemapTable | None = None  # spare-column repair view

    def materialize(self, dtype: torch.dtype | None = None) -> torch.Tensor:
        """Programmed conductances -> effective dense weight leaf.

        `dtype` overrides the stored leaf dtype.
        """
        q = unpack_columns(remap_mod.apply_remap(self.g, self.remap), self.layout)
        w = dequantize_weight(q, self.scale).reshape(self.shape)
        return w.to(self.dtype if dtype is None else dtype)


def flatten_with_names(params: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """Leaves of a nested dict/list/tuple in the reference's pytree order.

    Dict keys are visited sorted; names are the reference's `keystr`
    form, e.g. ``['layers']['wq']`` or ``[0]`` (`pytree.leaves_with_path`).
    """
    return pytree.leaves_with_path(params, prefix)


def names_tree(params: Any, prefix: str = "") -> Any:
    """`params`' structure with each leaf replaced by its name."""
    if isinstance(params, dict):
        return {k: names_tree(v, f"{prefix}[{k!r}]") for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(names_tree(v, f"{prefix}[{i}]")
                            for i, v in enumerate(params))
    return prefix


def fill_names(names: Any, values: dict[str, Any]) -> Any:
    """A tree of leaf names (`DeployedModel.names`) -> the same tree with
    each name replaced by ``values[name]``."""
    if isinstance(names, dict):
        return {k: fill_names(v, values) for k, v in names.items()}
    if isinstance(names, (list, tuple)):
        return type(names)(fill_names(v, values) for v in names)
    return values[names]


@dataclasses.dataclass
class DeployedModel:
    """A parameter tree whose matmul leaves live on simulated RRAM.

    Digital leaves (norms, biases, embeddings) are kept verbatim and
    merged back at materialization.
    """

    names: Any                   # the input tree's structure, leaves named
    digital: dict[str, Any]      # leaf name -> digital leaf, verbatim
    arrays: dict[str, ArrayState]
    wv_cfg: WVConfig
    cost: CircuitCost

    def materialize(self) -> Any:
        """Rebuild the full dense parameter tree from current `g`."""
        values = dict(self.digital)
        for name, state in self.arrays.items():
            values[name] = state.materialize()
        return fill_names(self.names, values)

    def update_array(self, name: str, g: torch.Tensor) -> None:
        """Swap in new conductances for one leaf (its views re-tile)."""
        self.arrays[name] = dataclasses.replace(self.arrays[name], g=g)

    @property
    def num_columns(self) -> int:
        """Programmed columns over every analog leaf."""
        return sum(int(a.g.shape[0]) for a in self.arrays.values())


@dataclasses.dataclass
class _LeafPlan:
    """One eligible leaf, quantized and packed, awaiting programming."""

    name: str
    leaf: torch.Tensor
    cols: torch.Tensor           # (C, N) packed target levels
    layout: PackedLayout
    scale: torch.Tensor
    uid_base: int                # first global column uid of this leaf

    def state(self, g: torch.Tensor, d2d: torch.Tensor,
              targets: torch.Tensor | None = None,
              fault: dev_mod.FaultMap | None = None,
              remap: remap_mod.RemapTable | None = None,
              uids: np.ndarray | None = None) -> ArrayState:
        if uids is None:
            uids = self.uid_base + np.arange(int(self.cols.shape[0]), dtype=np.int64)
        return ArrayState(
            g=g, targets=self.cols if targets is None else targets, d2d=d2d,
            scale=self.scale, layout=self.layout, shape=tuple(self.leaf.shape),
            dtype=self.leaf.dtype, uids=np.asarray(uids, np.int64),
            fault=fault, remap=remap,
        )


# Deploy-wide digest configurations (static, so every deploy folds into
# the same bucket geometry): per-column verify write pulses and WV
# iterations.  Out-of-range columns clamp into the edge buckets.
_PULSE_DIGEST = ("deploy.write_pulses_per_column", 0.0, 4096.0, 64)
_ITER_DIGEST = ("deploy.iterations_per_column", 0.0, 128.0, 64)


def _deploy_health_tree(stats_map: "dict[str, WVStats]",
                        uids_map: "dict[str, np.ndarray]", cpt: int,
                        extra_columns: "dict[str, dict[str, torch.Tensor]] | None" = None
                        ) -> dict[str, Any]:
    """Device tree of per-tile health reductions (`cpt` columns per
    tile) and the deploy digests.

    Everything here is a device reduction (or host uid bookkeeping) that
    rides the deploy's one `host_fetch` through `DeployReport.collect(
    extra=...)`; building it never synchronizes.
    """
    tile_ids, tiles = obs.health.tile_deploy_stats(
        stats_map, uids_map, cpt, extra_columns=extra_columns)
    stats = list(stats_map.values())
    digs = {}
    for (name, lo, hi, nb), field in ((_PULSE_DIGEST, "write_pulses"),
                                      (_ITER_DIGEST, "iterations")):
        vals = torch.cat([getattr(s, field) for s in stats])
        digs[name] = obs.StreamingDigest.zeros(lo, hi, nb, device=vals.device).add(
            vals).as_tree()
    return {"tile_ids": tile_ids, "tiles": tiles, "digests": digs}


def _fold_deploy_health(extra_h: dict[str, Any] | None) -> None:
    """Fold the FETCHED health tree into the host registries."""
    if not extra_h:
        return
    tile_ids = extra_h["tile_ids"]
    for metric, vals in extra_h["tiles"].items():
        obs.health_registry.fold_tiles(f"deploy.{metric}", tile_ids, vals)
    bounds = {name: (lo, hi) for name, lo, hi, _ in (_PULSE_DIGEST, _ITER_DIGEST)}
    for name, tree in extra_h["digests"].items():
        obs.digests.fold(name, obs.StreamingDigest.from_tree(*bounds[name], tree))


def _plan_leaf(name, w, wv_cfg, q_cfg, uid_base) -> _LeafPlan:
    w2 = w.reshape((-1, w.shape[-1]))
    q, scale = quantize_weight(w2, q_cfg)
    cols, layout = pack_columns(q, wv_cfg.n_cells, q_cfg.cell_bits, q_cfg.slices)
    return _LeafPlan(name, w, cols, layout, scale, uid_base)


def _program_plan(key, plan: _LeafPlan, wv_cfg: WVConfig, cost: CircuitCost):
    """Program one planned leaf on its own (the per-leaf baseline path).

    Columns draw from ``fold_in(key, uid)`` with d2d from the same split
    the engine uses, so the result is bit-identical to programming the
    same uids inside a bucketed multi-leaf dispatch.
    """
    cols = plan.cols
    col_ids = plan.uid_base + torch.arange(
        cols.shape[0], dtype=torch.int64, device=cols.device)
    d2d = pipeline.sample_d2d_for(key, col_ids, tuple(cols.shape), wv_cfg.device)
    fn = pipeline.get_program_fn(wv_cfg, cost)
    g, stats = fn(key, cols, d2d, col_ids)
    return plan.state(g, d2d), stats


def _default_qcfg(wv_cfg: WVConfig) -> QuantConfig:
    return QuantConfig(weight_bits=wv_cfg.weight_bits, cell_bits=wv_cfg.device.bc)


def deploy_matrix(
    key: torch.Tensor,
    w: torch.Tensor,
    wv_cfg: WVConfig,
    q_cfg: QuantConfig | None = None,
    cost: CircuitCost | None = None,
    *,
    device="cuda",
) -> tuple[torch.Tensor, WVStats]:
    """Program one weight matrix onto RRAM; returns (w_programmed, stats).

    The read-back is float32 regardless of the input dtype.
    """
    key, w = key.to(device), w.to(device)
    plan = _plan_leaf("", w, wv_cfg, q_cfg or _default_qcfg(wv_cfg), 0)
    state, stats = _program_plan(key, plan, wv_cfg, cost or CircuitCost())
    return state.materialize(dtype=torch.float32), stats


def _eligible(name: str, leaf, deploy_embeddings: bool, predicate) -> bool:
    ok = isinstance(leaf, torch.Tensor) and leaf.ndim >= 2
    if ok and not deploy_embeddings and "embed" in name.lower():
        ok = False
    if ok and predicate is not None:
        ok = predicate(name, leaf)
    return ok


def deploy_arrays(
    key: torch.Tensor,
    params: Any,
    wv_cfg: WVConfig,
    q_cfg: QuantConfig | None = None,
    cost: CircuitCost | None = None,
    *,
    deploy_embeddings: bool = False,
    predicate: Callable[[str, torch.Tensor], bool] | None = None,
    batched: bool = True,
    mesh: Any | None = None,
    min_bucket: int = pipeline.DEFAULT_MIN_BUCKET,
    max_bucket: int = pipeline.DEFAULT_MAX_BUCKET,
    fault_cfg: FaultConfig | None = None,
    remap_cfg: remap_mod.RemapConfig | None = None,
    sensitivity: Callable[[str, torch.Tensor], float] | None = None,
    device="cuda",
) -> tuple[DeployedModel, DeployReport]:
    """Program every eligible weight leaf, keeping persistent array state.

    Returns (DeployedModel, DeployReport).  `batched=True` (default)
    routes ALL leaves' packed columns through the bucketed pipeline with
    one host sync for the report; `batched=False` programs leaf by leaf.
    Both paths draw per-column sub-streams, so they are bit-identical.
    Leaves are moved to `device` first.  With a `mesh` (a `DeviceMesh`)
    the batched path splits every bucket's columns over all of its axes
    (`pipeline.get_program_fn`) and gathers them back: the
    `DeployedModel` and the report on every rank are the unsharded ones,
    and the report still makes one host fetch.

    Faulty silicon (DESIGN.md Sec. 15, batched path only): `fault_cfg`
    samples a per-cell `FaultMap` (kept in each `ArrayState`) and
    programs under it; `remap_cfg` provisions spare columns per leaf and,
    after the primary pass, repairs the worst columns (by
    `WVStats.gave_up`, so set `wv_cfg.give_up_pulses`) onto them, with
    optional fault-aware placement steering leaves ranked by
    `sensitivity(name, leaf)` onto the cleanest probed tiles.  Every
    remap decision runs on the device; the deploy still makes exactly
    one host sync, which carries the give-up and remap counts.
    """
    q_cfg = q_cfg or _default_qcfg(wv_cfg)
    cost = cost or CircuitCost()
    use_fault = fault_cfg is not None and fault_cfg.any_faults
    use_remap = remap_cfg is not None and remap_cfg.spare_frac > 0.0
    if (use_fault or use_remap) and not batched:
        raise ValueError("fault_cfg/remap_cfg require the batched deployment path")
    key = key.to(device)
    digital: dict[str, Any] = {}
    plans: list[_LeafPlan] = []
    uid = 0
    for name, leaf in flatten_with_names(params):
        if not _eligible(name, leaf, deploy_embeddings, predicate):
            digital[name] = leaf
            continue
        plan = _plan_leaf(name, leaf.to(device), wv_cfg, q_cfg, uid)
        uid += int(plan.cols.shape[0])
        plans.append(plan)

    arrays: dict[str, ArrayState] = {}
    fc = fault_cfg if use_fault else None
    cpt = (fault_cfg or FaultConfig()).columns_per_tile
    with obs.span("deploy", cat="deploy", method=wv_cfg.method.value,
                  leaves=len(plans), batched=batched) as sp:
        if batched and not use_remap:
            g_blocks, stats_blocks, d2d_blocks, fault_blocks = (
                pipeline.program_packed_columns(
                    key, [p.cols for p in plans], wv_cfg, cost, mesh=mesh,
                    min_bucket=min_bucket, max_bucket=max_bucket, fault_cfg=fc,
                ))
            for plan, g, d2d, fb in zip(plans, g_blocks, d2d_blocks, fault_blocks):
                arrays[plan.name] = plan.state(g, d2d, fault=fb)
            stats_map = {p.name: s for p, s in zip(plans, stats_blocks)}
            uids_map = {p.name: arrays[p.name].uids for p in plans}
            report = DeployReport.collect(
                stats_map, wv_cfg.n_cells,
                extra=_deploy_health_tree(stats_map, uids_map, cpt))
        elif batched:
            arrays, report = _deploy_with_spares(
                key, plans, wv_cfg, cost, fc, remap_cfg, sensitivity,
                min_bucket, max_bucket, cpt, mesh)
        else:
            report = DeployReport()
            for plan in plans:
                state, stats = _program_plan(key, plan, wv_cfg, cost)
                report.merge(plan.name, stats, wv_cfg.n_cells)
                arrays[plan.name] = state
        sp["columns"] = report.num_columns
        sp["rms_cell_error_lsb"] = report.rms_cell_error_lsb
    # The per-tile reductions and digests were fetched BY the report's one
    # host sync; folding them, the counters and the charges is host work.
    _fold_deploy_health(report.extra)
    _account(report, wv_cfg, cost)
    model = DeployedModel(names=names_tree(params), digital=digital,
                          arrays=arrays, wv_cfg=wv_cfg, cost=cost)
    return model, report


def _account(report: DeployReport, wv_cfg: WVConfig, cost: CircuitCost) -> None:
    """The deploy's ``deploy.*`` counters and ledger charges, from the
    report's host floats."""
    obs.registry.fold(
        {
            "columns": report.num_columns,
            "verify_reads": report.total_reads,
            "write_pulses": report.total_write_pulses,
            # Contract-bearing give-up/remap counters (DESIGN.md Sec. 15).
            "gave_up_cells": report.total_gave_up_cells,
            "retry_pulses": report.total_retry_pulses,
            "remapped_columns": report.remapped_columns,
        },
        prefix="deploy.",
    )
    obs.charge(
        "deploy",
        energy_pj=report.total_energy_pj,
        latency_ns=report.critical_latency_ns,
        reads=report.total_reads,
        method=wv_cfg.method.value,
        columns=report.num_columns,
    )
    if report.total_gave_up_cells or report.remapped_columns:
        # The bounded-retry waste: energy of the pulses burned on cells
        # that were given up on, at mid-scale conductance (the per-pulse
        # energy model of cost.write_phase_cost, g = G_max / 2).
        e_pulse_pj = (
            cost.v_set ** 2
            * (wv_cfg.device.g_max_lsb / 2.0 * cost.g_lsb_us)
            * cost.t_write_pulse_ns * 1e-3
        )
        obs.charge(
            "deploy.give_up",
            energy_pj=report.total_retry_pulses * e_pulse_pj,
            gave_up_cells=report.total_gave_up_cells,
            retry_pulses=report.total_retry_pulses,
            remapped_columns=report.remapped_columns,
        )


def _deploy_with_spares(key, plans: list[_LeafPlan], wv_cfg: WVConfig,
                        cost: CircuitCost, fault_cfg: FaultConfig | None,
                        remap_cfg: remap_mod.RemapConfig, sensitivity,
                        min_bucket: int, max_bucket: int, cpt: int, mesh=None
                        ) -> tuple[dict[str, ArrayState], DeployReport]:
    """The two-pass spare-column deploy (DESIGN.md Sec. 15).

    Pass A programs every leaf's primary columns; the worst columns (by
    give-up count) pick spare candidates on the device; pass B programs
    the candidates' targets on the spares' own physical uids; the remap
    table is decided on the device from both passes' stats.  One host
    sync in all, the report's.
    """
    c_counts = [int(p.cols.shape[0]) for p in plans]
    s_counts = [remap_mod.n_spares(c, remap_cfg) for c in c_counts]
    phys_counts = [c + s for c, s in zip(c_counts, s_counts)]
    if remap_cfg.placement and fault_cfg is not None:
        sens = [sensitivity(p.name, p.leaf) if sensitivity is not None
                else 1.0 / max(pc, 1) for p, pc in zip(plans, phys_counts)]
        uid_arrays = remap_mod.plan_placement(
            key, phys_counts, fault_cfg, sens,
            provision=remap_cfg.placement_provision)
        uid_end = max((int(u.max()) + 1 for u in uid_arrays if u.size), default=0)
    else:
        uid_arrays, base = [], 0
        for pc in phys_counts:
            uid_arrays.append(base + np.arange(pc, dtype=np.int64))
            base += pc
        uid_end = base
    prim_uids = np.concatenate([ua[:c] for ua, c in zip(uid_arrays, c_counts)])
    spare_uids = np.concatenate([ua[c:] for ua, c in zip(uid_arrays, c_counts)])
    buckets = dict(mesh=mesh, min_bucket=min_bucket, max_bucket=max_bucket,
                   pad_uid_base=uid_end, fault_cfg=fault_cfg)
    g_blocks, stats_blocks, d2d_blocks, fault_blocks = pipeline.program_packed_columns(
        key, [p.cols for p in plans], wv_cfg, cost, uids=prim_uids, **buckets)
    cands = [remap_mod.spare_candidates(st.gave_up, s)
             for st, s in zip(stats_blocks, s_counts)]
    spare_cols = [p.cols[cand] for p, cand in zip(plans, cands)]
    sg_blocks, sstats_blocks, sd2d_blocks, sfault_blocks = (
        pipeline.program_packed_columns(
            key, spare_cols, wv_cfg, cost, uids=spare_uids, **buckets))

    arrays: dict[str, ArrayState] = {}
    combined: dict[str, WVStats] = {}
    remapped: dict[str, torch.Tensor] = {}
    remap_flags: dict[str, torch.Tensor] = {}
    for i, plan in enumerate(plans):
        st, sst = stats_blocks[i], sstats_blocks[i]
        table = remap_mod.build_table(st.gave_up, cands[i], sst.gave_up,
                                      remap_cfg.min_gave_up)
        fb, sfb = fault_blocks[i], sfault_blocks[i]
        arrays[plan.name] = plan.state(
            torch.cat([g_blocks[i], sg_blocks[i]]),
            torch.cat([d2d_blocks[i], sd2d_blocks[i]]),
            targets=torch.cat([plan.cols, spare_cols[i]]),
            fault=(None if fb is None else
                   dev_mod.FaultMap(*(torch.cat([a, b]) for a, b in zip(fb, sfb)))),
            remap=table,
            uids=uid_arrays[i],
        )
        combined[plan.name] = WVStats(*(torch.cat([a, b]) for a, b in zip(st, sst)))
        not_active = (~table.active[: c_counts[i]]).to(torch.float32)
        remapped[plan.name] = torch.sum(not_active)
        # Per-column remap flags in physical order (primaries, then
        # spares) for the per-tile health map.
        remap_flags[plan.name] = F.pad(not_active, (0, s_counts[i]))
    uids_map = {p.name: arrays[p.name].uids for p in plans}
    report = DeployReport.collect(
        combined, wv_cfg.n_cells, remapped=remapped,
        extra=_deploy_health_tree(combined, uids_map, cpt,
                                  extra_columns={"remapped_columns": remap_flags}))
    return arrays, report


def deploy_params(
    key: torch.Tensor,
    params: Any,
    wv_cfg: WVConfig,
    q_cfg: QuantConfig | None = None,
    cost: CircuitCost | None = None,
    *,
    deploy_embeddings: bool = False,
    predicate: Callable[[str, torch.Tensor], bool] | None = None,
    batched: bool = True,
    mesh: Any | None = None,
    device="cuda",
) -> tuple[Any, DeployReport]:
    """Program every eligible leaf and collapse the arrays to dense weights
    (`mesh` as in `deploy_arrays`)."""
    deployed, report = deploy_arrays(
        key, params, wv_cfg, q_cfg, cost,
        deploy_embeddings=deploy_embeddings, predicate=predicate,
        batched=batched, mesh=mesh, device=device,
    )
    return deployed.materialize(), report
