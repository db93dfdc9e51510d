"""`read_columns`: the single entry point onto the analog read path.

One call = one verification sweep of a batch of columns: basis encode
(the *physical* summation of cell currents under the drive patterns),
noise injection (`readout.noise`), optional static per-column converter
offset, converter conversion (`readout.converter`), and M-read
averaging.  Cost for the same sweep is priced by
`readout.cost.sweep_cost` from the same `ReadoutConfig`.

Every basis transform goes through `kernels.fwht.ops.fwht`, which runs
the CUDA kernel for a CUDA tensor and the plain butterfly on the CPU —
the two are bitwise equal.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import rng
from repro_torch.kernels.fwht import ops as fwht_ops

from . import config as config_mod
from . import converter as conv_mod
from . import noise as noise_mod
from .config import ReadoutConfig

__all__ = [
    "ReadResult",
    "read_columns",
    "encode",
    "decode_magnitude",
    "decode_ternary",
    "voted_signs",
]


class ReadResult(NamedTuple):
    """What one sweep hands the digital periphery (all measurement-domain).

    values:     (C, N) converter output — dequantized codes for SAR,
                raw analog for IDEAL, ternary signs in {-1, 0, +1} for
                COMPARE.  M averaged reads are already collapsed.
    n_compares: (C, N) comparator operations issued (COMPARE: 1 or 2
                per Fig. 7(c)); zeros for code-producing converters.
    n_reads:    physical column reads this sweep (M * N).
    """

    values: torch.Tensor
    n_compares: torch.Tensor
    n_reads: int


def encode(g: torch.Tensor, cfg: ReadoutConfig) -> torch.Tensor:
    """Noiseless physical read: cell conductances -> measurement domain."""
    if cfg.basis == config_mod.ReadoutBasis.HADAMARD:
        return fwht_ops.fwht(g)
    return g


def _centered_sar(y: torch.Tensor, cfg: ReadoutConfig) -> torch.Tensor:
    """SAR-convert measurements with the V_sam range convention.

    Hadamard row 0 (all-ones) reads over [0, FS]; the balanced rows are
    re-centred to [-FS/2, FS/2] (Sec. 3.2).  One-hot reads are all
    single-cell currents over [0, FS].
    """
    a, n, levels = cfg.adc, cfg.n_cells, cfg.levels
    if cfg.basis == config_mod.ReadoutBasis.HADAMARD:
        centered = torch.arange(n, device=y.device) > 0
        return torch.where(
            centered,
            conv_mod.sar_read(y, a, n, levels, centered=True),
            conv_mod.sar_read(y, a, n, levels, centered=False),
        )
    return conv_mod.sar_read(y, a, n, levels, centered=False)


def _mean_reads(x: torch.Tensor) -> torch.Tensor:
    """Mean over the M-read axis as the reference computes it: a
    left-to-right sum, then a multiply by float32(1/M)."""
    m = x.shape[1]
    s = x[:, 0]
    for i in range(1, m):
        s = s + x[:, i]
    return s * float(np.float32(1.0) / np.float32(m))


def read_columns(
    key: torch.Tensor,
    g: torch.Tensor,
    cfg: ReadoutConfig,
    *,
    targets: torch.Tensor | None = None,
    col_offset: torch.Tensor | None = None,
) -> ReadResult:
    """One verification sweep of a batch of columns.

    Args:
      key: sweep key, or a (C, 2) batch of per-column keys.
      g: (C, N) true cell conductances in cell-LSB.
      cfg: the read path (basis / converter / averaging / impairments).
      targets: (C, N) intended integer levels — REQUIRED for COMPARE.
      col_offset: optional (C,) static per-column converter offset.
    """
    c, n = g.shape
    assert n == cfg.n_cells, (n, cfg.n_cells)
    m = cfg.avg_reads

    y_true = encode(g, cfg)
    n_uc, mu_cm = noise_mod.sample_read_fields(key, (c,), m, n, cfg.noise)
    # Summation order is part of the bit-compat contract with the
    # reference: single-read sweeps materialize the combined noise field
    # first; M-read sweeps add the per-read field to the signal before
    # the shared common mode.
    if m == 1:
        y = y_true + (n_uc + mu_cm).reshape(c, n)
    else:
        y = (y_true[:, None, :] + n_uc) + mu_cm
    if col_offset is not None:
        y = y + col_offset.reshape((c,) + (1,) * (y.ndim - 1))

    zeros = torch.zeros((c, n), dtype=torch.int32, device=g.device)
    if cfg.converter == config_mod.Converter.IDEAL:
        vals = y if m == 1 else _mean_reads(y)
        return ReadResult(vals, zeros, m * n)

    if cfg.converter == config_mod.Converter.SAR:
        q = _centered_sar(y, cfg)
        vals = q if m == 1 else _mean_reads(q)
        return ReadResult(vals, zeros, m * n)

    if cfg.converter == config_mod.Converter.COMPARE:
        if targets is None:
            raise ValueError("compare-mode readout needs targets")
        t_grid = _centered_sar(encode(targets, cfg), cfg)
        sign, n_cmp = conv_mod.compare_read(y, t_grid, cfg.deadzone_lsb)
        return ReadResult(sign, n_cmp, n)

    raise ValueError(cfg.converter)


def decode_magnitude(values: torch.Tensor, cfg: ReadoutConfig) -> torch.Tensor:
    """Digital basis inversion to a cell-domain estimate (eq. 6):
    (1/N) H^T y for Hadamard reads, identity for one-hot."""
    if cfg.basis == config_mod.ReadoutBasis.HADAMARD:
        return fwht_ops.fwht(values) / cfg.n_cells
    return values


def decode_ternary(signs: torch.Tensor, cfg: ReadoutConfig) -> torch.Tensor:
    """HARP's unnormalized ternary aggregate s_w = H^T s_y (eq. 10) for
    Hadamard reads; identity for one-hot (CW-SC's signs ARE per-cell)."""
    if cfg.basis == config_mod.ReadoutBasis.HADAMARD:
        return fwht_ops.fwht(signs)
    return signs


def voted_signs(
    key: torch.Tensor,
    sweeps: int,
    decision_fn: Callable[[torch.Tensor], torch.Tensor],
) -> tuple[torch.Tensor, torch.Tensor]:
    """Repeat a ternary readout decision over independent sub-streams.

    Runs `decision_fn(fold_in(key, r))` for r in [0, sweeps) and counts
    positive / negative decisions per cell.  Returns (pos_counts,
    neg_counts), float tensors shaped like one decision.
    """
    if sweeps < 1:
        raise ValueError(f"voted_signs needs at least one sweep, got {sweeps}")
    pos = neg = None
    for r in range(sweeps):
        d = decision_fn(rng.fold_in(key, r))
        if pos is None:
            pos = torch.zeros_like(d)
            neg = torch.zeros_like(d)
        pos = pos + (d > 0.0)
        neg = neg + (d < 0.0)
    return pos, neg
