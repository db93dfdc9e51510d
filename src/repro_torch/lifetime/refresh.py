"""Scrub policies: when and what to re-program on an aging array.

Three policies, each cost-accounted through `core.cost`:

* ``none``: never touch the array (the drift baseline).
* ``periodic``: blind re-program of every column each `period_epochs`.
* ``verify_triggered``: the method's own verify sweep (N reads of every
  column, voted over independent sweeps) flags columns whose decoded
  deviation exceeds the threshold; only flagged columns re-enter
  `program_columns`.  A Hadamard sweep screens all N cells of a column
  at once, which is what makes cheap scrubbing possible.

Flagged column counts vary per epoch; the subset is padded to the next
power of two (capped at C) and programmed through the deploy pipeline's
shared entry (`core.pipeline.get_program_fn`), so the dispatch shapes
stay at most log2(C) + 1 per method.

A remapped array (DESIGN.md Sec. 15) passes `active=`: its inactive
physical rows (remapped-away primaries, unused spares) are never flagged
or re-programmed.  A faulty one passes its deployment's `fault=` map,
whose rows re-programming gathers for the flagged columns, never
resampling them.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from repro_torch import obs
from repro_torch import readout as ro
from repro_torch.core import device as dev_mod
from repro_torch.core import pipeline, rng
from repro_torch.core.cost import CircuitCost, read_phase_cost
from repro_torch.core.types import WVConfig, WVMethod
from repro_torch.core.wv import verify_sweep
from repro_torch.obs import metrics

from .drift import CellState, DriftConfig, effective_d2d, reset_programmed

__all__ = [
    "RefreshPolicy",
    "RefreshConfig",
    "RefreshOutcome",
    "default_flag_params",
    "flag_columns",
    "apply_refresh",
]


class RefreshPolicy(str, enum.Enum):
    NONE = "none"
    PERIODIC = "periodic"
    VERIFY_TRIGGERED = "verify_triggered"


@dataclasses.dataclass(frozen=True)
class RefreshConfig:
    """Scrub policy configuration.

    The verify-triggered detector repeats the method's verify sweep
    `verify_sweeps` times and flags a cell only when `votes` sweeps agree
    on the sign of its deviation; a column is flagged when more than
    `max_bad_cells` cells are bad.  `None` resolves per method through
    `default_flag_params`.
    """

    policy: RefreshPolicy = RefreshPolicy.VERIFY_TRIGGERED
    period_epochs: int = 1        # PERIODIC cadence / VT verify cadence
    max_bad_cells: int = 1        # VT: flag a column when more than this
                                  # many cells read out-of-threshold
    verify_sweeps: int | None = None    # None -> per-method default
    votes: int | None = None            # sweeps that must agree per cell
    threshold_lsb: float | None = None  # compare threshold override
    tau_w_scale: float = 2.0      # HARP flag threshold: tau_w_scale * tau_w

    def replace(self, **kw) -> "RefreshConfig":
        return dataclasses.replace(self, **kw)


def default_flag_params(method: WVMethod) -> tuple[int, int, float]:
    """(verify_sweeps, votes, threshold_lsb) calibrated per method: HD-PV
    and MRA decode near-unbiased magnitudes (2 of 2); HARP's ternary
    aggregate takes 3 of 4, CW-SC's one-hot compares 4 of 4."""
    return {
        WVMethod.CW_SC: (4, 4, 0.75),
        WVMethod.MRA: (2, 2, 0.75),
        WVMethod.HD_PV: (2, 2, 0.75),
        WVMethod.HARP: (4, 3, 1.0),
    }[method]


@dataclasses.dataclass
class RefreshOutcome:
    """What one refresh step did and what it cost (per column batch);
    latencies and energies are outputs of the cost model."""

    flagged: np.ndarray | None = None   # (C,) bool, VT only
    n_reprogrammed: int = 0
    verify_latency_ns: float = 0.0
    verify_energy_pj: float = 0.0
    program_latency_ns: float = 0.0     # critical path: max over columns
    program_energy_pj: float = 0.0
    write_pulses: float = 0.0
    gave_up_cells: float = 0.0          # cells declared unprogrammable
    retry_pulses: float = 0.0           # fine pulses burned on them

    @property
    def maintenance_energy_pj(self) -> float:
        return self.verify_energy_pj + self.program_energy_pj

    @property
    def maintenance_latency_ns(self) -> float:
        return self.verify_latency_ns + self.program_latency_ns


def flag_columns(key, g: torch.Tensor, targets: torch.Tensor, cfg: WVConfig,
                 refresh_cfg: RefreshConfig | None = None
                 ) -> tuple[torch.Tensor, int]:
    """Voted verify sweeps -> ((C,) bool drifted-column mask, sweeps used).

    Each sweep is the WV method's own verify read (`verify_sweep`, i.e.
    `readout.read_columns`: N Hadamard reads, common-mode cancellation,
    the converter), voted per cell by `readout.voted_signs` over fold-in
    sub-streams.  A cell is bad when `votes` sweeps agree on its
    deviation sign; a column is flagged when more than `max_bad_cells`
    cells are bad.  The mask stays on the device.
    """
    rc = refresh_cfg or RefreshConfig()
    sweeps, votes, thr = default_flag_params(cfg.method)
    sweeps = rc.verify_sweeps if rc.verify_sweeps is not None else sweeps
    votes = rc.votes if rc.votes is not None else votes
    thr = rc.threshold_lsb if rc.threshold_lsb is not None else thr
    cfg = cfg.replace(decision_threshold_lsb=thr, tau_w=rc.tau_w_scale * cfg.tau_w)
    if sweeps == 0:  # detection disabled: nothing read, nothing flagged
        return torch.zeros((g.shape[0],), dtype=torch.bool, device=g.device), 0
    targets = targets.to(torch.float32)
    pos, neg = ro.voted_signs(key, sweeps,
                              lambda k: verify_sweep(k, g, targets, cfg)[0])
    bad = torch.sum(torch.maximum(pos, neg) >= votes, dim=-1)
    return bad > rc.max_bad_cells, sweeps


def _pad_pow2(idx: np.ndarray, c: int) -> np.ndarray:
    """Pad a flagged-index set to the next power of two (capped at C),
    recycling flagged indices as filler (only the first occurrence of a
    column is scattered back)."""
    n = len(idx)
    size = 1
    while size < n:
        size *= 2
    size = min(size, c)
    if size > n:
        filler = idx[np.arange(size - n) % n]
        idx = np.concatenate([idx, filler])
    return idx


def _reprogram_subset(key, state: CellState, targets: torch.Tensor,
                      mask: np.ndarray, cfg: WVConfig, cost: CircuitCost,
                      drift_cfg: DriftConfig,
                      fault: dev_mod.FaultMap | None = None,
                      ) -> tuple[CellState, float, float, float, float, float]:
    """Re-program the masked columns; returns
    (state, lat, energy, pulses, gave_up_cells, retry_pulses).

    Wear-degraded step efficiency feeds `program_columns` through its
    d2d argument, so an old array takes more iterations to converge.  A
    deployment's `FaultMap` is physical state: its rows are gathered for
    the flagged columns and passed through the dispatch, never
    resampled.  Latency is the max over re-programmed columns
    (array-parallel), energy the sum; the five scalars reach the host in
    one fetch.
    """
    c, n = targets.shape
    idx = np.nonzero(mask)[0]
    if len(idx) == 0:
        return state, 0.0, 0.0, 0.0, 0.0, 0.0
    dev = state.g.device
    idx_p = torch.from_numpy(_pad_pow2(idx, c)).to(dev)
    idx_t = torch.from_numpy(idx).to(dev)
    k = len(idx)
    sub_targets = targets[idx_p]
    sub_d2d = effective_d2d(state, drift_cfg)[idx_p]
    k_prog, k_state = rng.split(key)
    # The deploy's batched entry; col_ids are the physical column indices,
    # so each column's refresh stream does not depend on the others.
    fn = pipeline.get_program_fn(cfg, cost, with_fault=fault is not None)
    fargs = () if fault is None else (fault.map(lambda x: x[idx_p]),)
    with obs.span("lifetime.reprogram", cat="lifetime", columns=k,
                  padded=int(idx_p.shape[0])):
        g_sub, stats = fn(k_prog, sub_targets, sub_d2d, idx_p, *fargs)
    # Scatter back: idx_p = [idx, filler], so its first k rows are the
    # flagged columns and the filler rows are dropped duplicates.
    g_new = state.g.index_copy(0, idx_t, g_sub[:k])
    refreshed = torch.zeros((c,), dtype=torch.bool, device=dev).index_fill(0, idx_t, True)
    # Per-cell pulse attribution: the engine reports per-column totals,
    # spread uniformly over the column's cells.
    pulses_col = stats.write_pulses[:k] / n
    pulses_cell = torch.zeros_like(state.cycles).index_copy(
        0, idx_t, pulses_col[:, None].expand(k, n).contiguous())
    new_state = reset_programmed(k_state, state, g_new, refreshed, pulses_cell,
                                 cfg.device, drift_cfg)
    h = metrics.fetch((
        torch.amax(stats.latency_ns[:k]),
        torch.sum(stats.energy_pj[:k]),
        torch.sum(stats.write_pulses[:k]),
        torch.sum(stats.gave_up[:k]),
        torch.sum(stats.retry_pulses[:k]),
    ))
    lat, en, pulses, gave_up, retry = (float(v) for v in h)
    return new_state, lat, en, pulses, gave_up, retry


def apply_refresh(key, state: CellState, targets: torch.Tensor, cfg: WVConfig,
                  cost: CircuitCost, drift_cfg: DriftConfig,
                  refresh_cfg: RefreshConfig, epoch: int,
                  active: torch.Tensor | None = None,
                  fault: dev_mod.FaultMap | None = None,
                  ) -> tuple[CellState, RefreshOutcome]:
    """Run one epoch's refresh decision for a batch of columns.

    `active` masks the physical rows of a remapped array that carry live
    weight: inactive rows are never flagged or re-programmed, PERIODIC
    scrubs active rows only, and verify energy is charged on the active
    rows.  It reaches the host in the fetch that already moves the flag
    mask.  `fault` is the deployment's fault map, threaded into
    re-programming.
    """
    outcome = RefreshOutcome()
    policy = refresh_cfg.policy
    due = (epoch + 1) % max(refresh_cfg.period_epochs, 1) == 0
    if policy == RefreshPolicy.NONE or not due:
        return state, outcome
    c = targets.shape[0]
    k_v, k_p = rng.split(key)
    if policy == RefreshPolicy.PERIODIC:
        mask = np.ones((c,), bool) if active is None else metrics.fetch(active) > 0.5
    elif policy == RefreshPolicy.VERIFY_TRIGGERED:
        flagged, sweeps = flag_columns(k_v, state.g, targets, cfg, refresh_cfg)
        if active is None:
            active = torch.ones_like(flagged)
        flagged_h, active_h = metrics.fetch((flagged, active))
        active_h = active_h > 0.5
        mask = (flagged_h > 0.5) & active_h
        # Every active column pays `sweeps` verify sweeps (read phase, no
        # writes); inactive rows are not driven.
        lat_v, en_v = read_phase_cost(cfg, cost)
        outcome.verify_latency_ns = float(lat_v) * sweeps  # array-parallel
        outcome.verify_energy_pj = float(en_v) * sweeps * int(active_h.sum())
        outcome.flagged = mask
    else:
        raise ValueError(policy)

    state, lat, en, pulses, gave_up, retry = _reprogram_subset(
        k_p, state, targets, mask, cfg, cost, drift_cfg, fault=fault)
    outcome.n_reprogrammed = int(mask.sum())
    outcome.program_latency_ns = lat
    outcome.program_energy_pj = en
    outcome.write_pulses = pulses
    outcome.gave_up_cells = gave_up
    outcome.retry_pulses = retry
    return state, outcome
