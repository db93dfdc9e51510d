"""Configuration dataclasses for the HARP write-and-verify stack.

All conductances are expressed in *cell-LSB units*: LSB = G_max / (2^Bc - 1),
so a Bc-bit cell stores integer target levels in {0, ..., 2^Bc - 1} and
G_max == (2^Bc - 1) LSB.  sigma_map/G_max = 0.10 from the paper therefore
becomes sigma_map_lsb = 0.10 * (2^Bc - 1) = 0.7 LSB at Bc = 3.

Configs are plain frozen dataclasses of host constants (never tensors).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class WVMethod(str, enum.Enum):
    """Write-and-verify scheme (paper Section 5 naming)."""

    CW_SC = "cw_sc"      # column-wise single-cell: one-hot reads + compare-only ADC
    MRA = "mra"          # multi-read averaging: M x one-hot reads, full SAR each
    HD_PV = "hd_pv"      # Hadamard reads + full SAR + inverse-Hadamard decode
    HARP = "harp"        # Hadamard reads + compare-only + ternary inverse decode


@dataclasses.dataclass(frozen=True)
class DeviceConfig:
    """RRAM cell behaviour (paper Table 1 + Fig. 3)."""

    bc: int = 3                      # bits per cell
    g_max_us: float = 13.0           # max conductance (microsiemens), LRS
    fine_step_lsb: float = 0.25      # fine SET/RESET pulse: ~0.25 LSB / pulse
    coarse_step_lsb: float = 1.25    # coarse SET pulse: 5 steps/pulse = 1.25 LSB
    sigma_map_frac: float = 0.10     # sigma_map / G_max per write event (eq. 1)
    # Nonlinearity / asymmetry (Fig. 3): effective step shrinks near the
    # rails; RESET is slightly weaker than SET (asymmetric switching).
    nonlinearity: float = 0.35       # 0 = linear; exponent of the rail taper
    reset_asymmetry: float = 0.85    # RESET step = asymmetry * SET step
    sigma_c2c_frac: float = 0.15     # cycle-to-cycle multiplicative step jitter
    sigma_d2d_frac: float = 0.10     # device-to-device static step spread
    # eq. (1) interpretation: "event" = additive sigma_map per write event
    # (one-shot mapping error); "pulse" = per-pulse noise proportional to
    # the pulse step (sigma_map is realized by a full-swing coarse write).
    map_noise_mode: str = "pulse"

    @property
    def levels(self) -> int:
        return 1 << self.bc

    @property
    def g_max_lsb(self) -> float:
        return float(self.levels - 1)

    @property
    def sigma_map_lsb(self) -> float:
        return self.sigma_map_frac * self.g_max_lsb


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Static cell-fault population + spatially correlated variation.

    Models the faulty-silicon regime real RRAM macros deploy into
    (DESIGN.md Sec. 15): a fraction of cells never switch (stuck-at),
    a fraction switch with collapsed efficiency (weak), and fault rates
    / step efficiency vary systematically per tile and per chip.  All
    probabilities are per-cell; the spatial geometry maps a physical
    column uid onto a (chip, tile) coordinate, so the same uid always
    lands on the same silicon — the fault map is a device property,
    sampled once per deployment from per-column RNG sub-streams
    (bucketed deploys stay bit-identical, DESIGN.md Sec. 10).

    The all-zero default is contractually inert: a `FaultConfig()` map
    pins no cell and multiplies every step by exactly 1.0, so the
    programmed conductances are bit-identical to a fault-free run.
    """

    p_stuck_hrs: float = 0.0        # SA0: filament never forms; g pinned at 0
    p_stuck_lrs: float = 0.0        # SA1: shorted filament; g pinned at G_max
    p_weak: float = 0.0             # step-efficiency collapse (still moves)
    weak_efficiency: float = 0.05   # weak cell step multiplier
    p_exhausted: float = 0.0        # endurance-dead: frozen at a random level
    # Physical geometry: column uid -> tile -> chip.
    columns_per_tile: int = 128
    tiles_per_chip: int = 64
    # Spatially correlated variation: lognormal per-tile fault-rate
    # multiplier (decades) and per-tile / per-chip systematic step-
    # efficiency spread (fractional).  Columns in one tile share a draw.
    sigma_tile_fault_dec: float = 0.0
    sigma_tile_eff_frac: float = 0.0
    sigma_chip_eff_frac: float = 0.0

    @property
    def any_faults(self) -> bool:
        return (
            max(self.p_stuck_hrs, self.p_stuck_lrs, self.p_weak,
                self.p_exhausted) > 0.0
            or max(self.sigma_tile_fault_dec, self.sigma_tile_eff_frac,
                   self.sigma_chip_eff_frac) > 0.0
        )

    def replace(self, **kw) -> "FaultConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ADCConfig:
    """Column TIA + SAR ADC (paper Table 1, Fig. 7)."""

    bits: int = 9                    # 9-bit for N=32, 10-bit for N=64
    # Full scale covers the whole column current range: N * (2^Bc - 1) LSB.
    # One-hot reads use the same hardware (same full scale) -> coarser
    # effective quantization for single-cell SAR reads; Hadamard reads use
    # the full dynamic range.  V_sam switching (Sec. 3.2) re-centres the
    # range for balanced rows without changing the bit budget.
    t_read_pulse_ns: float = 32.0
    t_sar_ns: float = 47.5           # TIA+ADC latency, full SAR conversion
    t_compare_ns: float = 30.0       # TIA+ADC latency, compare-only decision
    e_tia_pj: float = 1.44           # TIA energy per read
    e_sar_pj: float = 32.0           # full n-bit SAR conversion energy
    # one-shot compare: comparator + CDAC preset to the target code
    # (Table 1 ADC range 1.8-32 pJ; calibrated against the paper's
    # 9.5x HARP-vs-MRA energy ratio, see benchmarks/fig12)
    e_compare_pj: float = 3.6


@dataclasses.dataclass(frozen=True)
class NoiseConfig:
    """Verify-read noise (eqs. 2-4), in cell-LSB units."""

    sigma_read_lsb: float = 0.7      # total read-noise std: sqrt(uc^2 + cm^2)
    rho_cm: float = 0.0              # common-mode fraction: cm^2/(uc^2+cm^2)

    @property
    def sigma_uc_lsb(self) -> float:
        return self.sigma_read_lsb * (1.0 - self.rho_cm) ** 0.5

    @property
    def sigma_cm_lsb(self) -> float:
        return self.sigma_read_lsb * self.rho_cm ** 0.5


@dataclasses.dataclass(frozen=True)
class WVConfig:
    """End-to-end write-and-verify configuration."""

    method: WVMethod = WVMethod.HARP
    n_cells: int = 32                # column length N
    weight_bits: int = 6             # B
    k_streak: int = 2                # consecutive in-threshold reads to freeze
    # Streaks begin accumulating only after the open-loop coarse residual has
    # been worked off; freezing during the high-interference transient would
    # defeat the streak counter's stated purpose ("preventing premature
    # freezing from noisy observations", Sec. 3.1).  Magnitude methods
    # (MRA/HD-PV) clear the transient in 1-2 multi-pulse sweeps; ternary
    # methods (CW-SC/HARP) need ~residual/fine_step single-pulse sweeps.
    # See DESIGN.md Sec. 8.
    freeze_warmup_iters: int = 7
    freeze_warmup_ternary_extra: int = 4
    max_fine_iters: int = 50
    max_coarse_iters: int = 10
    decision_threshold_lsb: float = 0.5
    tau_w: float = 4.0               # HARP cell-domain threshold (unnormalized)
    mra_reads: int = 5               # M for multi-read averaging
    max_pulses_per_iter: int = 16    # magnitude methods: pulse burst cap
    # Bounded retry budget (DESIGN.md Sec. 15): a per-cell write-pulse
    # budget after which an unconverged cell is declared unprogrammable
    # and frozen (give-up).  None = legacy unbounded behaviour; the
    # give-up machinery then compiles to the exact current computation.
    give_up_pulses: Optional[int] = None
    device: DeviceConfig = dataclasses.field(default_factory=DeviceConfig)
    adc: ADCConfig = dataclasses.field(default_factory=ADCConfig)
    noise: NoiseConfig = dataclasses.field(default_factory=NoiseConfig)
    # Kept for field parity with the JAX reference's WVConfig only: the
    # port reads it nowhere.  The port always runs the fused structure
    # (verify aggregate -> pre-sampled write noise -> wv_step cell update)
    # and picks kernel or plain version by the tensors' device.
    use_pallas: bool = False

    @property
    def slices_per_weight(self) -> int:
        assert self.weight_bits % self.device.bc == 0
        return self.weight_bits // self.device.bc

    def replace(self, **kw) -> "WVConfig":
        return dataclasses.replace(self, **kw)


def default_config_for_array(n_cells: int) -> WVConfig:
    """Paper defaults: 9-bit ADC at N=32, 10-bit ADC at N=64 (Figs. 10/11).

    tau_w scales linearly with N: the unnormalized aggregate s_w = H^T s_y
    has signal gain ~N and noise ~sqrt(N), so the paper's tau_w = 4 at
    N = 32 corresponds to tau_w = 8 at N = 64 (validated: keeps HARP the
    energy-optimal mode at 64-cell columns, Fig. 13(c)-(d))."""
    bits = 9 if n_cells <= 32 else 10
    return WVConfig(
        n_cells=n_cells,
        adc=ADCConfig(bits=bits),
        tau_w=4.0 * n_cells / 32.0,
    )
