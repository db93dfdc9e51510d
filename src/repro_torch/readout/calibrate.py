"""Per-column converter offset drift and its calibration (reference tuning).

Each column's converter carries a *static* reference offset o_col,
sampled once per column (like d2d) from N(0, sigma_col_offset^2).
Unlike the per-sweep common mode mu_cm it never averages out across
sweeps: a one-hot readout eats it as a systematic level error, which is
what reference tuning trims in hardware.  (A Hadamard readout cancels a
measurement-constant offset on its N-1 balanced rows at decode, so
calibration matters most for one-hot converter fleets.)

`calibrate_offsets` models the tuning procedure: read a reference column
programmed at a known mid-scale level K times through the SAR converter,
average the measurement-domain error, and subtract that estimate from the
true offset.  The residual is ~ sqrt(sigma_uc^2 / (K N) + sigma_cm^2 / K)
plus a quantization floor.
"""

from __future__ import annotations

import torch

from repro_torch.core import rng

from . import config as config_mod
from . import readout as ro
from .config import ReadoutConfig

__all__ = ["sample_col_offsets", "calibrate_offsets"]


def sample_col_offsets(key: torch.Tensor, n_columns: int,
                       cfg: ReadoutConfig) -> torch.Tensor:
    """Static per-column converter reference offsets: (C,) in cell-LSB,
    on the key's device."""
    return cfg.sigma_col_offset_lsb * rng.normal(key, (int(n_columns),))


def calibrate_offsets(key: torch.Tensor, col_offset: torch.Tensor,
                      cfg: ReadoutConfig, k_reads: int = 8,
                      ref_level: float | None = None) -> torch.Tensor:
    """Trim per-column offsets from K calibration reads of a reference.

    Every column reads a reference column whose cells all sit at the
    known `ref_level` (default mid-scale, which centres both the one-hot
    range and the unbalanced Hadamard row 0, so neither rail clips the
    offset).  The per-column mean measurement error over K independent
    SAR sweeps estimates o_col; the return value is the RESIDUAL offset
    ``col_offset - estimate`` to hand back to `read_columns`, i.e. the
    read path after reference tuning.  Runs on `col_offset`'s device.
    """
    c = int(col_offset.shape[0])
    n = cfg.n_cells
    if ref_level is None:
        ref_level = 0.5 * (cfg.levels - 1)
    dev = col_offset.device
    key = key.to(dev)
    g_ref = torch.full((c, n), float(ref_level), dtype=torch.float32, device=dev)
    cal_cfg = cfg.replace(converter=config_mod.Converter.SAR, avg_reads=1)
    y_ref = ro.encode(g_ref, cal_cfg)

    est = torch.zeros((c,), dtype=torch.float32, device=dev)
    for k in range(k_reads):
        res = ro.read_columns(rng.fold_in(key, k), g_ref, cal_cfg,
                              col_offset=col_offset)
        est = est + torch.mean(res.values - y_ref, dim=-1)
    return col_offset - est / k_reads
