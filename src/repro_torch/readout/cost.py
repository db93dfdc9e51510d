"""Latency / energy of one readout sweep (paper Table 1, Sec. 5.3).

`sweep_cost` prices exactly the sweep `readout.read_columns` performs,
from the same `ReadoutConfig`:

  one-hot  + COMPARE (CW-SC) : N x (t_pulse + t_cmp), rare 2nd compare
  one-hot  + SAR M=M (MRA-M) : M*N x (t_pulse + t_sar)
  Hadamard + SAR     (HD-PV) : N x (t_pulse + t_sar) + decode adder
  Hadamard + COMPARE (HARP)  : N x (t_pulse + t_cmp') + ternary adder

The IDEAL converter is priced as a full SAR conversion.  Units: ns, pJ.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cost import CircuitCost

from . import config as config_mod
from .config import ReadoutConfig

__all__ = ["sweep_cost"]


def sweep_cost(
    cfg: ReadoutConfig,
    cost: CircuitCost,
    n_compares: torch.Tensor | None = None,
):
    """(latency_ns, energy_pj) of one readout sweep of one column.

    `n_compares`: (..., N) per-measurement comparison counts for the
    COMPARE converter; the 1.5/read expectation is assumed if None.
    Returns float32 tensors of shape (...) when `n_compares` is given,
    else Python floats already rounded to float32 (so that adding them
    to a float32 tensor costs no device round trip).
    """
    adc, n = cfg.adc, cfg.n_cells
    hadamard = cfg.basis == config_mod.ReadoutBasis.HADAMARD
    f32 = lambda v: float(np.float32(v))  # noqa: E731

    if cfg.converter == config_mod.Converter.COMPARE:
        if n_compares is None:
            cmp_total = np.float32(1.5 * n)
        else:
            cmp_total = torch.sum(n_compares.to(torch.float32), dim=-1)
        lat = (
            n * (adc.t_read_pulse_ns + adc.t_compare_ns)
            + (cmp_total - n) * adc.t_compare_ns
        )
        e = n * adc.e_tia_pj + cmp_total * adc.e_compare_pj
        if hadamard:
            lat = lat + cost.t_adder_ns
            e = e + n * cost.e_adder_harp_pj
        if n_compares is None:
            return f32(lat), f32(e)
        return lat, e

    reads = cfg.avg_reads * n
    lat = reads * (adc.t_read_pulse_ns + adc.t_sar_ns)
    e = reads * (adc.e_tia_pj + adc.e_sar_pj)
    if hadamard:
        lat = lat + cost.t_adder_ns
        e = e + n * cost.e_adder_hdpv_pj
    return f32(lat), f32(e)
