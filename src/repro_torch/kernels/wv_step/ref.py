"""Plain PyTorch version of the fused WV cell-update kernel.

One fine-WV iteration's *cell-domain* tail, given the per-cell decision
signal from the verify stage:

  1. ternary decision from the aggregate (threshold)
  2. streak / freeze bookkeeping (K consecutive stops, warmup gate)
  3. pulse sizing (ternary: 1; magnitude: round(|dev|/step) capped)
  4. nominal pulse application with the nonlinear/asymmetric device step
     (pre-sampled noise fields are inputs: RNG stays outside the kernel)

The CUDA kernel (`csrc/wv_step.cu`) repeats this operation for operation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.numerics import true_div


class WVCellParams(NamedTuple):
    threshold: float        # decision threshold on the aggregate
    k_streak: int
    can_freeze: bool        # warmup gate (host bool per iteration)
    ternary: bool           # 1 pulse vs magnitude pulses
    fine_step: float
    max_pulses: float
    g_max: float
    nonlinearity: float
    reset_asymmetry: float
    # "pulse"-mode mapping noise (core.device): nmap carries the
    # single-pulse sigma and the burst accumulates as a random walk, so
    # the applied noise scales with sqrt(n_pulses).  Off = "event" mode.
    nmap_sqrt_pulses: bool = False


def wv_cell_update(
    agg: torch.Tensor,        # verify aggregate (dev estimate or s_w), (C, N)
    dev_mag: torch.Tensor,    # |deviation| estimate for pulse sizing, (C, N)
    g: torch.Tensor,          # conductances (C, N)
    streak: torch.Tensor,     # int32 (C, N)
    frozen: torch.Tensor,     # bool (C, N)
    c2c: torch.Tensor,        # pre-sampled multiplicative jitter (C, N)
    nmap: torch.Tensor,       # pre-sampled additive mapping noise (C, N)
    d2d: torch.Tensor,        # static per-cell efficiency (C, N)
    p: WVCellParams,
):
    decision = torch.where(
        agg > p.threshold, 1.0, torch.where(agg < -p.threshold, -1.0, 0.0)
    )
    in_thr = decision == 0.0
    streak_new = torch.where(in_thr, streak + 1, 0).to(torch.int32)
    if p.can_freeze:
        frozen_new = frozen | (streak_new >= p.k_streak)
    else:
        frozen_new = frozen.clone()
    col_active = ~torch.all(frozen, dim=-1, keepdim=True)

    if p.ternary:
        n_p = torch.ones_like(g)
    else:
        n_p = torch.clamp(
            torch.round(true_div(dev_mag, p.fine_step)), 1.0, p.max_pulses
        )
    act = (~frozen) & (decision != 0.0) & col_active
    n_p = torch.where(act, n_p, 0.0)
    direction = torch.where(act, -decision, 0.0)

    frac = torch.clamp(true_div(g, p.g_max), 0.0, 1.0)
    set_eff = (1.0 - frac) ** p.nonlinearity
    reset_eff = frac ** p.nonlinearity * p.reset_asymmetry
    eff = torch.where(direction > 0, set_eff, reset_eff)
    delta = direction * p.fine_step * eff * d2d * n_p * c2c
    if p.nmap_sqrt_pulses:
        nmap = nmap * torch.sqrt(torch.clamp_min(n_p, 1.0))
    g_new = torch.clamp(
        g + delta + torch.where(n_p > 0, nmap, 0.0), 0.0, p.g_max
    )
    g_new = torch.where(n_p > 0, g_new, g)
    return g_new, streak_new, frozen_new, n_p, direction
