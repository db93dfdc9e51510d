"""RRAM device model: nonlinear, asymmetric, stochastic conductance updates.

Implements the programming physics of paper Sec. 2.2 / Fig. 3:

* SET increases conductance, RESET decreases it.
* The effective per-pulse step tapers near the rails (nonlinear switching):
  SET is weak near LRS (g -> g_max), RESET weak near HRS (g -> 0).
* Asymmetry: RESET transitions are weaker than SET by a fixed factor.
* D2D: a static per-cell step-efficiency drawn once per cell.
* C2C: multiplicative jitter per write event.
* Mapping noise (eq. 1): additive Gaussian per write event with
  sigma_map = 0.10 * G_max, then clip to [0 (HRS), G_max (LRS)].

All quantities are in cell-LSB units (see core.types).

Faulty silicon (DESIGN.md Sec. 15): a `FaultMap` of stuck, weak and
endurance-exhausted cells is sampled per column uid from salted key
domains, with per-tile and per-chip correlated fields; `apply_pulses`
and `clamp_stuck` program under it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import rng
from .numerics import true_div
from .types import DeviceConfig, FaultConfig

__all__ = [
    "sample_d2d",
    "apply_pulses",
    "initial_state",
    "write_noise_sigma",
    "sample_write_noise",
    "FaultMap",
    "sample_fault_map",
    "empty_fault_map",
    "tile_ids",
    "chip_ids",
    "tile_quality",
    "clamp_stuck",
]


def sample_d2d(key: torch.Tensor, shape, dev: DeviceConfig) -> torch.Tensor:
    """Static device-to-device step-efficiency multiplier per cell.

    `key` may be a batch of per-column keys (leading axis == shape[0]).
    """
    return 1.0 + dev.sigma_d2d_frac * rng.normal(key, shape)


def write_noise_sigma(dev: DeviceConfig, step_lsb: float) -> float:
    """Per-single-pulse additive mapping-noise sigma for a pulse class.

    In "pulse" mode the per-pulse sigma is normalized so a full-swing
    coarse write accumulates ~sigma_map total; in "event" mode the whole
    write event draws sigma_map once.
    """
    if dev.map_noise_mode == "pulse":
        n_swing = dev.g_max_lsb / dev.coarse_step_lsb
        return float(
            dev.sigma_map_lsb / n_swing**0.5 * (step_lsb / dev.coarse_step_lsb)
        )
    return float(dev.sigma_map_lsb)


def sample_write_noise(
    key: torch.Tensor, shape, dev: DeviceConfig, step_lsb: float | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pre-sample the stochastic fields of one write event: (c2c, nmap).

    Draws from exactly the key splits `apply_pulses` uses.  `nmap`
    carries the single-pulse sigma; "pulse"-mode sqrt(n_pulses) scaling
    is applied downstream (the wv_step kernel / `apply_pulses`).
    """
    if step_lsb is None:
        step_lsb = dev.fine_step_lsb
    k_c2c, k_map = rng.split(key)
    c2c = 1.0 + dev.sigma_c2c_frac * rng.normal(k_c2c, shape)
    nmap = write_noise_sigma(dev, step_lsb) * rng.normal(k_map, shape)
    return c2c, nmap


def initial_state(shape, device="cuda") -> torch.Tensor:
    """All cells start at HRS (zero conductance) before coarse SET."""
    return torch.zeros(shape, dtype=torch.float32, device=device)


class FaultMap(NamedTuple):
    """Static per-cell silicon fault state (DESIGN.md Sec. 15).

    Physical device state like `d2d`: sampled once per deployment and
    passed into every programming dispatch that touches the same cells
    (a scrub re-programs under the same map, never a fresh draw).

    stuck:      (..., N) bool — the cell does not respond to pulses.
    stuck_g:    (..., N) f32  — where a stuck cell is pinned (0 for
                SA0/HRS, G_max for SA1/LRS, a random level for an
                endurance-exhausted cell).
    efficiency: (..., N) f32  — step-efficiency factor (1.0 healthy,
                `weak_efficiency` for weak cells, times the tile and
                chip spread).
    """

    stuck: torch.Tensor
    stuck_g: torch.Tensor
    efficiency: torch.Tensor

    def map(self, fn) -> "FaultMap":
        """Apply `fn` to every field."""
        return FaultMap(*(fn(x) for x in self))


def empty_fault_map(shape, device="cuda") -> FaultMap:
    """The inert map: nothing stuck, unit efficiency (used as pad)."""
    return FaultMap(
        stuck=torch.zeros(shape, dtype=torch.bool, device=device),
        stuck_g=torch.zeros(shape, dtype=torch.float32, device=device),
        efficiency=torch.ones(shape, dtype=torch.float32, device=device),
    )


# Salts carving fault sampling into its own key domain: the d2d / coarse
# / fine key schedule (DESIGN.md Sec. 10) is untouched, so a deployment
# that samples a fault map draws the same write noise as one that does not.
_FAULT_SALT = 0xFA0175
_TILE_SALT = 0x711E5
_CHIP_SALT = 0xC419
_LN10 = 2.302585092994046


def tile_ids(col_ids: torch.Tensor, fault_cfg: FaultConfig) -> torch.Tensor:
    """Physical tile index of each column uid (the geometry is static)."""
    return torch.div(col_ids, fault_cfg.columns_per_tile, rounding_mode="floor")


def chip_ids(col_ids: torch.Tensor, fault_cfg: FaultConfig) -> torch.Tensor:
    return torch.div(tile_ids(col_ids, fault_cfg), fault_cfg.tiles_per_chip,
                     rounding_mode="floor")


def _scalar_normals(key: torch.Tensor, salt: int, ids: torch.Tensor) -> torch.Tensor:
    """One standard normal per id from ``fold_in(fold_in(key, salt), id)``:
    the reference's ``vmap(lambda k: normal(k, ()))`` over the id keys."""
    keys = rng.fold_col_keys(rng.fold_in(key, salt), ids)
    return rng.normal(keys, (int(ids.shape[0]),))


def tile_quality(key: torch.Tensor, tids: torch.Tensor,
                 fault_cfg: FaultConfig) -> torch.Tensor:
    """Per-tile fault-rate multiplier (lognormal, sigma in decades).

    Deterministic in (master key, tile id): the factory probe
    (`remap.plan_placement`) and the deploy's fault sampler see the same
    silicon.  1.0 everywhere when sigma_tile_fault_dec == 0.
    """
    z = _scalar_normals(rng.fold_in(key, _FAULT_SALT), _TILE_SALT, tids)
    return torch.exp(fault_cfg.sigma_tile_fault_dec * _LN10 * z)


def sample_fault_map(key: torch.Tensor, col_ids: torch.Tensor, shape,
                     fault_cfg: FaultConfig, dev: DeviceConfig) -> FaultMap:
    """Sample the static fault state of a batch of physical columns.

    `key` is the deployment's master key (a single key); each column's
    draws come from ``fold_in(fold_in(key, FAULT_SALT), uid)``, so a
    column's faults depend only on (key, uid), never on the batch.
    `shape` is (C, N) with C == len(col_ids).  The per-tile lognormal
    fault-rate multiplier and the per-tile / per-chip step-efficiency
    offsets fold the tile and chip ids into salted keys, so columns of
    one tile share a draw.
    """
    shape = tuple(int(s) for s in shape)
    assert shape[0] == col_ids.shape[0], (shape, tuple(col_ids.shape))
    fkey = rng.fold_in(key, _FAULT_SALT)
    k_kind, k_level = rng.split(rng.fold_col_keys(fkey, col_ids))
    tids = tile_ids(col_ids, fault_cfg)
    rate_mult = tile_quality(key, tids, fault_cfg)[:, None]          # (C, 1)

    # One uniform per cell classifies it into {healthy, SA0, SA1, weak,
    # exhausted} by stacked thresholds, all scaled by the tile multiplier.
    u = rng.uniform(k_kind, shape)
    p0 = fault_cfg.p_stuck_hrs * rate_mult
    p1 = p0 + fault_cfg.p_stuck_lrs * rate_mult
    p2 = p1 + fault_cfg.p_weak * rate_mult
    p3 = p2 + fault_cfg.p_exhausted * rate_mult
    sa0 = u < p0
    sa1 = (u >= p0) & (u < p1)
    weak = (u >= p1) & (u < p2)
    exhausted = (u >= p2) & (u < p3)

    # Endurance-exhausted cells are frozen wherever they last landed.
    level = rng.uniform(k_level, shape) * dev.g_max_lsb
    stuck = sa0 | sa1 | exhausted
    stuck_g = torch.where(sa1, dev.g_max_lsb, torch.where(exhausted, level, 0.0))

    eff = torch.where(weak, fault_cfg.weak_efficiency, 1.0)
    if fault_cfg.sigma_tile_eff_frac > 0.0:
        zt = _scalar_normals(fkey, _TILE_SALT + 1, tids)
        eff = eff * (1.0 + fault_cfg.sigma_tile_eff_frac * zt[:, None])
    if fault_cfg.sigma_chip_eff_frac > 0.0:
        zc = _scalar_normals(fkey, _CHIP_SALT, chip_ids(col_ids, fault_cfg))
        eff = eff * (1.0 + fault_cfg.sigma_chip_eff_frac * zc[:, None])
    eff = torch.clamp_min(eff, 0.0)
    return FaultMap(stuck=stuck, stuck_g=stuck_g, efficiency=eff)


def clamp_stuck(g: torch.Tensor, fault: FaultMap | None = None) -> torch.Tensor:
    """Pin stuck cells at their physical level (no-op without a map)."""
    if fault is None:
        return g
    return torch.where(fault.stuck, fault.stuck_g, g)


def _effective_step(
    g: torch.Tensor, direction, dev: DeviceConfig, step_lsb: float
) -> torch.Tensor:
    """Direction-dependent nominal step at conductance g (Fig. 3 shape).

    direction: +1 (SET, conductance up), -1 (RESET, down), 0 (no pulse).
    """
    frac = torch.clamp(true_div(g, dev.g_max_lsb), 0.0, 1.0)
    set_eff = (1.0 - frac) ** dev.nonlinearity
    reset_eff = frac**dev.nonlinearity * dev.reset_asymmetry
    if not isinstance(direction, torch.Tensor):
        direction = torch.full_like(g, float(direction))
    eff = torch.where(direction > 0, set_eff, reset_eff)
    return step_lsb * eff


def apply_pulses(
    key: torch.Tensor,
    g: torch.Tensor,
    direction: torch.Tensor,
    n_pulses: torch.Tensor,
    d2d: torch.Tensor,
    dev: DeviceConfig,
    step_lsb: float | None = None,
    noise_scale: float = 1.0,
    fault: FaultMap | None = None,
) -> torch.Tensor:
    """Apply a burst of identical pulses to every cell (vectorized write).

    Args:
      key: key (or per-column key batch) for this write event.
      g: (..., N) current conductances in LSB.
      direction: (..., N) in {-1, 0, +1}.
      n_pulses: (..., N) pulse counts (0 = skip).
      d2d: (..., N) static per-cell efficiency from :func:`sample_d2d`.
      step_lsb: nominal step per pulse (defaults to the fine step).
      noise_scale: multiplier on sigma_map.
      fault: optional static `FaultMap`: weak cells see their collapsed
        step efficiency, stuck cells are re-pinned after the write.  The
        noise draw is unconditional, so `fault=None` and an inert map
        give bitwise the same conductances.

    Returns updated conductances, clipped to [0, G_max].
    """
    if step_lsb is None:
        step_lsb = dev.fine_step_lsb
    c2c, nmap = sample_write_noise(key, g.shape, dev, step_lsb)
    n = n_pulses.to(torch.float32)
    pulsed = n > 0
    eff = d2d if fault is None else d2d * fault.efficiency
    step = _effective_step(g, direction, dev, step_lsb) * eff
    delta = direction.to(torch.float32) * step * n * c2c
    if dev.map_noise_mode == "pulse":
        nmap = nmap * torch.sqrt(torch.clamp_min(n, 1.0))
    g_new = g + delta + torch.where(pulsed, nmap * noise_scale, 0.0)
    g_new = torch.clamp(g_new, 0.0, dev.g_max_lsb)
    return clamp_stuck(torch.where(pulsed, g_new, g), fault)
