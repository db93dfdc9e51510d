"""Column-wise write-and-verify engine (paper Secs. 3-4).

All four WV schemes behind one vectorized loop:

  CW-SC  - column-wise single-cell baseline: one-hot verify reads with the
           compare-only ADC mode (ternary decision per cell, 1 fine
           pulse/iteration).  The paper's primary baseline.
  MRA-M  - multi-read averaging: M full-SAR one-hot reads per cell,
           averaged; magnitude estimate -> multi-pulse update.
  HD-PV  - Hadamard-encoded parallel verify: N Hadamard reads, full SAR,
           inverse-Hadamard (FWHT) decode; magnitude -> multi-pulse update.
  HARP   - Hadamard reads, compare-only vs the Hadamard-domain target
           (eq. 9), ternary aggregate s_w = H^T s_y (eq. 10), threshold
           tau_w (eq. 11); 1 fine pulse/iteration.

The verify READ itself is owned by the readout subsystem
(`repro_torch.readout`); this module owns the key schedule, the decision
logic on the returned measurements, and the write phase.

Each fine iteration is the reference's fused structure: the verify
aggregate, then write noise pre-sampled from the iteration's key, then
one `wv_step` cell update (threshold -> streak -> freeze -> pulse size
-> device step -> clip), which is the CUDA kernel for CUDA tensors.  The
reference's `lax.while_loop` becomes a loop of `max_fine_iters` trips
with no host sync: once every cell of a column is frozen, the column's
active mask zeroes its pulses and cost increments, so trips after the
reference's exit change nothing.

Shapes: targets (C, N) float32 integer levels; returns g (C, N) and a
`WVStats` of per-column diagnostics.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.wv_step import ops as wv_ops
from repro_torch.kernels.wv_step.ref import WVCellParams
from repro_torch.readout import config as ro_config
from repro_torch.readout import cost as ro_cost
from repro_torch.readout import readout as ro

from . import device as dev_mod
from . import rng
from .cost import CircuitCost, write_phase_cost
from .types import WVConfig, WVMethod

__all__ = ["WVStats", "program_columns", "verify_aggregate", "verify_sweep"]


class WVStats(NamedTuple):
    """Per-column WV diagnostics (all shape (C,), float32)."""

    iterations: torch.Tensor      # fine WV sweeps executed while column active
    latency_ns: torch.Tensor      # verify + write critical-path latency
    energy_pj: torch.Tensor       # verify + write + decode energy
    reads: torch.Tensor           # ADC conversions / comparisons issued
    write_pulses: torch.Tensor    # total write pulses applied
    rms_error_lsb: torch.Tensor   # final per-column RMS |g - w*|
    frozen_frac: torch.Tensor     # fraction of cells frozen at termination
    gave_up: torch.Tensor         # cells declared unprogrammable (count)
    retry_pulses: torch.Tensor    # fine pulses burned on cells that gave up

    def map(self, fn) -> "WVStats":
        """Apply `fn` to every field."""
        return WVStats(*(fn(x) for x in self))


def verify_aggregate(
    key: torch.Tensor,
    g: torch.Tensor,
    targets: torch.Tensor,
    cfg: WVConfig,
    col_offset: torch.Tensor | None = None,
):
    """One verification sweep, stopping BEFORE the ternary threshold.

    Returns (agg, dev_mag, n_compares, threshold):
      agg:      (C, N) decision aggregate — the decoded deviation for
        magnitude methods, the comparator sign for CW-SC, the
        unnormalized s_w = H^T s_y for HARP.
      dev_mag:  (C, N) |deviation| estimate for magnitude methods (pulse
        sizing); 1.0 placeholder for ternary methods.
      n_compares: (C, N) comparator operations (compare modes) else zeros.
      threshold: decision = sign(agg) * (|agg| > threshold).
    """
    rcfg = ro_config.for_wv_method(cfg)
    thr = cfg.decision_threshold_lsb

    if cfg.method == WVMethod.CW_SC:
        res = ro.read_columns(key, g, rcfg, targets=targets, col_offset=col_offset)
        # The comparator already made the ternary call; 0.5 re-thresholds
        # its {-1, 0, +1} output to itself.
        return res.values, torch.ones_like(g), res.n_compares, 0.5

    if cfg.method in (WVMethod.MRA, WVMethod.HD_PV):
        res = ro.read_columns(key, g, rcfg, col_offset=col_offset)
        w_hat = ro.decode_magnitude(res.values, rcfg)  # eq. 6 digital adders
        dev = w_hat - targets
        return dev, torch.abs(dev), torch.zeros_like(g), thr

    if cfg.method == WVMethod.HARP:
        res = ro.read_columns(key, g, rcfg, targets=targets, col_offset=col_offset)
        s_w = ro.decode_ternary(res.values, rcfg)  # unnormalized H^T s_y
        return s_w, torch.ones_like(g), res.n_compares, cfg.tau_w

    raise ValueError(cfg.method)


def _threshold(agg: torch.Tensor, thr: float) -> torch.Tensor:
    return torch.where(agg > thr, 1.0, torch.where(agg < -thr, -1.0, 0.0))


def verify_sweep(key, g, targets, cfg: WVConfig, col_offset=None):
    """One verification sweep: (decision in {-1,0,+1}, dev_mag, n_compares).

    +1 means conductance too HIGH (needs RESET).
    """
    agg, dev_mag, n_cmp, thr = verify_aggregate(key, g, targets, cfg, col_offset)
    return _threshold(agg, thr), dev_mag, n_cmp


def _characterized_coarse_pulses(
    targets: torch.Tensor, dev_cfg, max_pulses: int
) -> torch.Tensor:
    """Coarse pulse counts from the characterized (nominal) device response.

    The nominal SET curve starts from g = 0 for every cell, so one scalar
    landing trajectory (P+1 points) characterizes the whole batch; each
    cell takes the first pulse count whose landing is nearest its target
    (the reference's argmin), found by a running minimum over P+1 points
    instead of a (P+1, C, N) error tensor.
    """
    g_nom = torch.zeros((), dtype=torch.float32, device=targets.device)
    best = torch.abs(g_nom - targets)
    idx = torch.zeros_like(targets)
    for p in range(1, max_pulses + 1):
        g_nom = torch.clamp(
            g_nom + dev_mod._effective_step(
                g_nom, 1.0, dev_cfg, dev_cfg.coarse_step_lsb),
            0.0,
            dev_cfg.g_max_lsb,
        )
        err = torch.abs(g_nom - targets)
        better = err < best
        idx = torch.where(better, float(p), idx)
        best = torch.where(better, err, best)
    return idx


def program_columns(
    key: torch.Tensor,
    targets: torch.Tensor,
    cfg: WVConfig,
    cost: CircuitCost | None = None,
    d2d: torch.Tensor | None = None,
    col_ids: torch.Tensor | None = None,
    col_offset: torch.Tensor | None = None,
    fault: dev_mod.FaultMap | None = None,
    *,
    device=None,
) -> tuple[torch.Tensor, WVStats]:
    """Program a batch of columns from HRS to integer target levels.

    Args:
      key: key, shape (2,).
      targets: (C, N) target levels in [0, 2^Bc - 1].
      cfg: WV configuration (method, noise, ADC, device).
      cost: circuit cost constants (Table 1 defaults if None).
      d2d: optional pre-sampled (C, N) device-to-device efficiency.
      col_ids: optional (C,) per-column stream ids.  When given, every
        column draws its noise from ``fold_in(key, col_ids[c])``
        (DESIGN.md Sec. 10), independent of batch composition/padding.
        When None, the legacy batch-shaped draws are used.
      col_offset: optional (C,) static per-column converter offset.
      fault: optional static per-cell `device.FaultMap`, sampled by the
        caller like `d2d` (a scrub re-programs under the same silicon).
        The `wv_step` update takes ``d2d * fault.efficiency`` as its
        efficiency operand, so weak and tile-degraded cells need no
        kernel change, and stuck cells are re-pinned after each update
        (the reference's association, so `fault=None` and an inert map
        give bitwise the same conductances).
      device: where to run; defaults to the device of `targets`.

    Give-up (DESIGN.md Sec. 15): with `cfg.give_up_pulses` set, a cell
    whose cumulative fine-pulse count reaches the budget at the start of
    a sweep is frozen as unprogrammable; cells still unfrozen at the end
    also count as gave-up.  Stuck and weak cells are what exhaust it.

    Returns (g_final, WVStats).
    """
    if device is None:
        device = targets.device
    if cost is None:
        cost = CircuitCost()
    targets = targets.to(device=device, dtype=torch.float32)
    key = key.to(device)
    c, n = targets.shape
    assert n == cfg.n_cells, (n, cfg.n_cells)
    dev_cfg = cfg.device
    rcfg = ro_config.for_wv_method(cfg)

    if col_ids is None:
        k_d2d, k_coarse, k_loop = rng.split(key, 3)
    else:
        col_keys = rng.fold_col_keys(key, col_ids.to(device))
        k_d2d, k_coarse, k_loop = rng.split(col_keys, 3)
    if d2d is None:
        d2d = dev_mod.sample_d2d(k_d2d, targets.shape, dev_cfg)
    else:
        d2d = d2d.to(device)
    if fault is not None:
        fault = fault.map(lambda x: x.to(device))

    # ---- coarse OPEN-LOOP SET from HRS: pulse counts come from the
    # characterized device curve (no verify reads — write cost only).
    g = dev_mod.initial_state(targets.shape, device=device)
    n_coarse = _characterized_coarse_pulses(targets, dev_cfg, cfg.max_coarse_iters)
    direction0 = torch.where(n_coarse > 0, 1.0, 0.0)
    g = dev_mod.apply_pulses(
        k_coarse, g, direction0, n_coarse, d2d, dev_cfg,
        step_lsb=dev_cfg.coarse_step_lsb, fault=fault,
    )
    lat, en = write_phase_cost(g, n_coarse, direction0, dev_cfg, cost, coarse=True)
    pulses = torch.sum(n_coarse, dim=-1)

    ternary = cfg.method in (WVMethod.CW_SC, WVMethod.HARP)
    reads_per_sweep = rcfg.reads_per_sweep
    warmup = cfg.freeze_warmup_iters + (
        cfg.freeze_warmup_ternary_extra if ternary else 0
    )
    budget = cfg.give_up_pulses
    nmap_sqrt = dev_cfg.map_noise_mode == "pulse"
    d2d_eff = d2d if fault is None else d2d * fault.efficiency

    streak = torch.zeros(targets.shape, dtype=torch.int32, device=device)
    frozen = torch.zeros(targets.shape, dtype=torch.bool, device=device)
    gave_up = torch.zeros(targets.shape, dtype=torch.bool, device=device)
    cell_pulses = torch.zeros(targets.shape, dtype=torch.float32, device=device)
    iters = torch.zeros((c,), dtype=torch.float32, device=device)
    reads = torch.zeros((c,), dtype=torch.float32, device=device)

    for it in range(cfg.max_fine_iters):
        k_v, k_w = rng.split(rng.fold_in(k_loop, it))

        if budget is not None:
            # Budget check at sweep start: unconverged cells that spent
            # their pulse budget are treated like converged-frozen cells.
            exhausted = (~frozen) & (cell_pulses >= float(budget))
            frozen_in = frozen | exhausted
            gave_up = gave_up | exhausted
        else:
            frozen_in = frozen
        col_active = ~torch.all(frozen_in, dim=-1)  # (C,)

        agg, dev_mag, n_cmp, thr = verify_aggregate(k_v, g, targets, cfg, col_offset)
        c2c, nmap = dev_mod.sample_write_noise(k_w, g.shape, dev_cfg)
        p = WVCellParams(
            threshold=thr,
            k_streak=cfg.k_streak,
            can_freeze=it >= warmup,
            ternary=ternary,
            fine_step=dev_cfg.fine_step_lsb,
            max_pulses=float(cfg.max_pulses_per_iter),
            g_max=dev_cfg.g_max_lsb,
            nonlinearity=dev_cfg.nonlinearity,
            reset_asymmetry=dev_cfg.reset_asymmetry,
            nmap_sqrt_pulses=nmap_sqrt,
        )
        g_new, streak, frozen, n_p, direction = wv_ops.wv_cell_update(
            agg, dev_mag.contiguous(), g, streak, frozen_in.contiguous(),
            c2c, nmap, d2d_eff, p,
        )

        # Cost accounting (active columns only), priced at the pre-write g.
        lat_r, en_r = ro_cost.sweep_cost(
            rcfg, cost, n_compares=n_cmp if ternary else None
        )
        lat_w, en_w = write_phase_cost(g, n_p, direction, dev_cfg, cost)
        actf = col_active.to(torch.float32)
        iters = iters + actf
        lat = lat + actf * (lat_r + lat_w)
        en = en + actf * (en_r + en_w)
        reads = reads + actf * reads_per_sweep
        pulses = pulses + torch.sum(n_p, dim=-1)
        cell_pulses = cell_pulses + n_p
        g = dev_mod.clamp_stuck(g_new, fault)

    zero = torch.zeros((c,), dtype=torch.float32, device=device)
    if budget is not None:
        gave_up_cells = gave_up | ~frozen
        retry_pulses = torch.sum(
            torch.where(gave_up_cells, cell_pulses, 0.0), dim=-1
        )
        gave_up_count = torch.sum(gave_up_cells.to(torch.float32), dim=-1)
    else:
        gave_up_count = zero
        retry_pulses = zero

    err = g - targets
    stats = WVStats(
        iterations=iters,
        latency_ns=lat,
        energy_pj=en,
        reads=reads,
        write_pulses=pulses,
        rms_error_lsb=torch.sqrt(torch.mean(err * err, dim=-1)),
        frozen_frac=torch.mean(frozen.to(torch.float32), dim=-1),
        gave_up=gave_up_count,
        retry_pulses=retry_pulses,
    )
    return g, stats
