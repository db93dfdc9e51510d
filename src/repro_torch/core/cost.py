"""Circuit-level latency / energy cost model (paper Table 1, Sec. 5.3).

This module owns the Table-1 CONSTANTS (`CircuitCost`, plus `ADCConfig`
in core.types) and the write phase pricing.  The verify READ phase is
priced by `repro_torch.readout.cost.sweep_cost` from the same constants;
`read_phase_cost` is the WVConfig-facing wrapper.

Write phase: SET and RESET pulses are applied column-parallel; the phase
latency is max(pulses) * t_write within each phase, and energy is
V^2 * G * t per pulse integrated over the actual conductances.

Units: ns and pJ.
"""

from __future__ import annotations

import dataclasses

import torch

from .types import ADCConfig, DeviceConfig, WVConfig, WVMethod

__all__ = [
    "CircuitCost",
    "read_phase_cost",
    "write_phase_cost",
    "inference_token_cost",
    "decode_cost",
]


@dataclasses.dataclass(frozen=True)
class CircuitCost:
    """Extra Table-1 constants not owned by ADCConfig."""

    t_write_pulse_ns: float = 100.0
    v_set: float = 2.0
    v_reset: float = 2.0
    v_coarse: float = 4.0
    t_adder_ns: float = 5.0
    e_adder_hdpv_pj: float = 0.9   # multi-bit accumulate (0.8-1.0 pJ)
    e_adder_harp_pj: float = 0.2   # ternary accumulate
    g_lsb_us: float = 13.0 / 7.0   # conductance per LSB (G_max / (2^Bc - 1))
    # Inference phase (analog serving): bit-serial input DAC row drivers.
    t_dac_ns: float = 2.0          # row-driver settle per bit plane
    e_dac_pj: float = 0.05         # per driven row per plane


def read_phase_cost(cfg: WVConfig, cost: CircuitCost, n_compares=None):
    """(latency_ns, energy_pj) of one verification sweep of one column.

    Thin wrapper: maps the WV method onto its readout config and prices
    the sweep with `readout.cost.sweep_cost` (imported lazily — core.cost
    is a readout dependency, so the module level would cycle).
    """
    from repro_torch.readout import config as ro_config
    from repro_torch.readout import cost as ro_cost

    return ro_cost.sweep_cost(ro_config.for_wv_method(cfg), cost, n_compares)


def write_phase_cost(
    g_lsb: torch.Tensor,
    n_pulses: torch.Tensor,
    direction: torch.Tensor,
    dev: DeviceConfig,
    cost: CircuitCost,
    coarse: bool = False,
    column_axis: int = -1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(latency_ns, energy_pj) of one column-parallel write phase.

    SET and RESET are separate phases (Fig. 5): latency is
    t_write * (max SET pulses + max RESET pulses) over the column;
    energy integrates V^2 * G * t per pulse (G in siemens).
    """
    n_pulses = n_pulses.to(torch.float32)
    set_p = torch.where(direction > 0, n_pulses, 0.0)
    rst_p = torch.where(direction < 0, n_pulses, 0.0)
    lat = cost.t_write_pulse_ns * (
        torch.amax(set_p, dim=column_axis) + torch.amax(rst_p, dim=column_axis)
    )
    v = cost.v_coarse if coarse else cost.v_set
    g_us = torch.clamp(g_lsb, 0.0, dev.g_max_lsb) * cost.g_lsb_us
    # E = V^2 * G * t : us * ns * V^2 = 1e-15 J = fJ; * 1e-3 -> pJ.
    e_per_pulse_pj = (v * v) * g_us * cost.t_write_pulse_ns * 1e-3
    e = torch.sum(n_pulses * e_per_pulse_pj, dim=column_axis)
    return lat, e


def inference_token_cost(
    n_conversions: int,
    n_row_drives: int,
    planes: int,
    adc: ADCConfig,
    cost: CircuitCost,
) -> tuple[float, float]:
    """(latency_ns, energy_pj) of serving ONE token through the arrays.

    Each of the `planes` bit-serial DAC phases drives every macro's rows
    and full-SAR-converts every sensed signed column pair; slices and
    tiles have their own converters, so a phase's latency is one
    drive + read + convert, and phases are sequential.  One tail add of
    the shift-and-add recombination sits on the critical path; every
    conversion pays an accumulate.

    Args:
      n_conversions: ADC conversions per plane (sum over analog leaves
        of layers * tiles * slices * outputs).
      n_row_drives: DAC row drives per plane (layers * tiles * rows).
      planes: bit-serial phases per token (`cim.planes_per_token`).
    """
    lat = planes * (cost.t_dac_ns + adc.t_read_pulse_ns + adc.t_sar_ns)
    lat += cost.t_adder_ns
    e_plane = (
        n_row_drives * cost.e_dac_pj
        + n_conversions * (adc.e_tia_pj + adc.e_sar_pj + cost.e_adder_hdpv_pj)
    )
    return float(lat), float(planes * e_plane)


def decode_cost(cfg: WVConfig, cost: CircuitCost) -> tuple[float, float]:
    """Standalone decode-only cost (already folded into read_phase_cost)."""
    if cfg.method == WVMethod.HD_PV:
        return cost.t_adder_ns, cfg.n_cells * cost.e_adder_hdpv_pj
    if cfg.method == WVMethod.HARP:
        return cost.t_adder_ns, cfg.n_cells * cost.e_adder_harp_pj
    return 0.0, 0.0
