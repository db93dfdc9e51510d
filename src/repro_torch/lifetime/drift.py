"""Temporal RRAM device dynamics: relaxation, drift, disturb, wear.

The WV engine (`core.wv`) models programming-time noise only; this
module models what happens to a programmed conductance afterwards, so a
deployed model can be aged and re-verified.  Four effects, in cell-LSB
units:

1. **Post-programming relaxation**: the filament settles toward a
   per-cell equilibrium (the programmed level pulled toward mid-scale
   plus a static per-cell offset) with time constant `tau_relax_s`.
2. **Log-time drift**: g(t) = g(t_p) * ((t + t0) / (t_p + t0))^-nu with
   a static per-cell exponent nu; advancing from age a by dt multiplies
   by ((a + dt + t0) / (a + t0))^-nu, so small steps compose exactly.
3. **Read disturb**: every analog read nudges the column SET-ward by
   `read_disturb_lsb` per read.
4. **Endurance wear**: step efficiency degrades as
   (1 + cycles/endurance)^-wear_exponent, and a cell whose cycle count
   crosses its sampled limit becomes stuck (no longer drifts or
   switches).

`advance` is pure ((key, state, dt, reads) -> state) and shape-stable;
`LifetimeSimulator` calls it once per epoch and leaf.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import rng
from repro_torch.core.types import DeviceConfig

__all__ = [
    "DriftConfig",
    "CellState",
    "init_cell_state",
    "advance",
    "wear_efficiency",
    "effective_d2d",
    "reset_programmed",
]

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    """Post-programming dynamics parameters (cell-LSB / seconds)."""

    # Relaxation (minutes-scale).
    tau_relax_s: float = 120.0       # exponential settling time constant
    relax_frac: float = 0.05         # equilibrium pull toward mid-scale
    sigma_relax_lsb: float = 0.10    # static per-cell equilibrium offset std
    # Log-time drift.
    nu_drift: float = 0.01           # mean drift exponent
    sigma_nu_frac: float = 0.8       # per-cell dispersion of nu (lognormal-ish)
    t0_s: float = 30.0               # drift reference time
    # Read disturb (SET-ward, per accumulated column read).
    read_disturb_lsb: float = 1e-7
    # Endurance wear.
    endurance_cycles: float = 1e6    # median cycles-to-failure
    sigma_endurance_dec: float = 0.3 # lognormal spread, decades
    wear_exponent: float = 1.0       # step-efficiency decay power

    def replace(self, **kw) -> "DriftConfig":
        return dataclasses.replace(self, **kw)


class CellState(NamedTuple):
    """Aging state of a batch of columns (leading shape (C, N) / (C, 1))."""

    g: torch.Tensor        # (C, N) live analog conductance, LSB
    g_eq: torch.Tensor     # (C, N) relaxation equilibrium, LSB
    nu: torch.Tensor       # (C, N) static per-cell drift exponent
    d2d: torch.Tensor      # (C, N) static per-cell step efficiency (pristine)
    age_s: torch.Tensor    # (C, 1) seconds since the column's last program
    reads: torch.Tensor    # (C, 1) accumulated column reads since last program
    cycles: torch.Tensor   # (C, N) lifetime write pulses seen by each cell
    limit: torch.Tensor    # (C, N) per-cell cycles-to-failure
    stuck: torch.Tensor    # (C, N) bool: cell no longer switches


def _sample_equilibrium(key, g: torch.Tensor, dev: DeviceConfig,
                        cfg: DriftConfig) -> torch.Tensor:
    """Per-cell relaxation equilibrium for freshly programmed levels."""
    g_mid = 0.5 * dev.g_max_lsb
    offset = cfg.sigma_relax_lsb * rng.normal(key, tuple(g.shape))
    return torch.clamp(g + cfg.relax_frac * (g_mid - g) + offset, 0.0,
                       dev.g_max_lsb)


def _sample_nu(key, shape, cfg: DriftConfig) -> torch.Tensor:
    """Static per-cell drift exponent, strictly positive."""
    spread = torch.exp(cfg.sigma_nu_frac * rng.normal(key, tuple(shape))
                       - 0.5 * cfg.sigma_nu_frac**2)
    return cfg.nu_drift * spread


def init_cell_state(key, g: torch.Tensor, d2d: torch.Tensor, dev: DeviceConfig,
                    cfg: DriftConfig, initial_cycles: float = 0.0) -> CellState:
    """Aging state for freshly programmed conductances `g` (C, N)."""
    c = g.shape[0]
    k_eq, k_nu, k_lim = rng.split(key, 3)
    limit = cfg.endurance_cycles * torch.pow(
        10.0, cfg.sigma_endurance_dec * rng.normal(k_lim, tuple(g.shape)))
    cycles = torch.full(tuple(g.shape), float(initial_cycles), dtype=_F32,
                        device=g.device)
    return CellState(
        g=g.to(_F32),
        g_eq=_sample_equilibrium(k_eq, g, dev, cfg),
        nu=_sample_nu(k_nu, g.shape, cfg),
        d2d=d2d.to(_F32),
        age_s=torch.zeros((c, 1), dtype=_F32, device=g.device),
        reads=torch.zeros((c, 1), dtype=_F32, device=g.device),
        cycles=cycles,
        limit=limit,
        stuck=cycles > limit,
    )


def wear_efficiency(cycles: torch.Tensor, cfg: DriftConfig) -> torch.Tensor:
    """Step-efficiency multiplier after `cycles` write pulses: 1.0 for a
    pristine cell, decreasing, never negative."""
    return torch.pow(1.0 + cycles / cfg.endurance_cycles, -cfg.wear_exponent)


def effective_d2d(state: CellState, cfg: DriftConfig) -> torch.Tensor:
    """Current per-cell step efficiency: pristine d2d degraded by wear."""
    return state.d2d * wear_efficiency(state.cycles, cfg)


def advance(key, state: CellState, dt_s: float, reads: float,
            dev: DeviceConfig, cfg: DriftConfig) -> CellState:
    """Age all columns by `dt_s` seconds with `reads` column reads.

    Deterministic given the state: the key is unread (it is kept for
    later stochastic effects), which is what makes a verify sweep a
    faithful drift detector.  `reads` is one count for every column.
    """
    del key
    dt = torch.full((), float(dt_s), dtype=_F32, device=state.g.device)
    rd = torch.full(tuple(state.reads.shape), float(reads), dtype=_F32,
                    device=state.g.device)
    # 1. Exponential relaxation toward the per-cell equilibrium.
    settle = 1.0 - torch.exp(-dt / cfg.tau_relax_s)
    g = state.g + (state.g_eq - state.g) * settle
    # 2. Log-time drift over the age increment; the equilibrium decays
    # too (drift is filament dissolution, which relaxation cannot undo).
    factor = torch.pow((state.age_s + dt + cfg.t0_s) / (state.age_s + cfg.t0_s),
                       -state.nu)
    g = g * factor
    g_eq = state.g_eq * factor
    # 3. Read disturb: SET-ward, proportional to this epoch's reads.
    g = g + cfg.read_disturb_lsb * rd
    g = torch.clamp(g, 0.0, dev.g_max_lsb)
    # 4. Stuck cells are frozen filaments: they neither drift nor switch.
    g = torch.where(state.stuck, state.g, g)
    g_eq = torch.where(state.stuck, state.g_eq, g_eq)
    return state._replace(g=g, g_eq=g_eq, age_s=state.age_s + dt,
                          reads=state.reads + rd)


def reset_programmed(key, state: CellState, g_new: torch.Tensor,
                     refreshed: torch.Tensor, pulses_per_cell: torch.Tensor,
                     dev: DeviceConfig, cfg: DriftConfig) -> CellState:
    """Fold a re-programming event into the aging state.

    `refreshed` (C,) bool marks the re-programmed columns: they restart
    their relaxation clock (age, reads, fresh g_eq and nu); stuck cells
    ignore the new conductance; every applied pulse adds wear, which may
    newly stick a cell.
    """
    k_eq, k_nu = rng.split(key)
    col = refreshed[:, None]
    g = torch.where(col & ~state.stuck, g_new, state.g)
    cycles = state.cycles + torch.where(state.stuck, 0.0,
                                        pulses_per_cell.to(_F32))
    stuck = state.stuck | (cycles > state.limit)
    g_eq = torch.where(col, _sample_equilibrium(k_eq, g, dev, cfg), state.g_eq)
    nu = torch.where(col, _sample_nu(k_nu, g.shape, cfg), state.nu)
    zeros = torch.zeros_like(state.age_s)
    return state._replace(
        g=g, g_eq=g_eq, nu=nu,
        age_s=torch.where(col, zeros, state.age_s),
        reads=torch.where(col, zeros, state.reads),
        cycles=cycles, stuck=stuck,
    )
