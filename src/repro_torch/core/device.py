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

All quantities are in cell-LSB units (see core.types).  Fault maps are
not ported yet: `clamp_stuck` is the no-op of a fault-free array.
"""

from __future__ import annotations

import torch

from . import rng
from .numerics import true_div
from .types import DeviceConfig

__all__ = [
    "sample_d2d",
    "apply_pulses",
    "initial_state",
    "write_noise_sigma",
    "sample_write_noise",
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


def clamp_stuck(g: torch.Tensor, fault=None) -> torch.Tensor:
    """Pin stuck cells at their physical level (no-op without a map)."""
    if fault is not None:
        raise NotImplementedError("fault maps are not ported yet")
    return g


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

    Returns updated conductances, clipped to [0, G_max].
    """
    if step_lsb is None:
        step_lsb = dev.fine_step_lsb
    c2c, nmap = sample_write_noise(key, g.shape, dev, step_lsb)
    n = n_pulses.to(torch.float32)
    pulsed = n > 0
    step = _effective_step(g, direction, dev, step_lsb) * d2d
    delta = direction.to(torch.float32) * step * n * c2c
    if dev.map_noise_mode == "pulse":
        nmap = nmap * torch.sqrt(torch.clamp_min(n, 1.0))
    g_new = g + delta + torch.where(pulsed, nmap * noise_scale, 0.0)
    g_new = torch.clamp(g_new, 0.0, dev.g_max_lsb)
    return torch.where(pulsed, g_new, g)
