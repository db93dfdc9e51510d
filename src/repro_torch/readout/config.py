"""Readout-path configuration: basis x converter x averaging x impairments.

One `ReadoutConfig` describes everything between "cell conductances" and
"digital numbers the periphery sees" for ONE column readout:

* **basis** — which row-drive patterns sense the column.  `ONE_HOT`
  reads cells individually (rows of I); `HADAMARD` reads Sylvester
  +-1 patterns (rows of H_N), the paper's contribution (Sec. 3.2).
* **converter** — what the column TIA feeds.  `SAR` is a full n-bit
  binary search (uniform quantization over the column full scale);
  `COMPARE` is HARP's one-shot ternary compare against a preset target
  code (Fig. 7); `IDEAL` is an infinite-resolution converter (the
  algebraic limit used by equivalence contracts and what `adc_bits=None`
  means on the CIM side).
* **avg_reads** — M repeated reads averaged per measurement (MRA).
  Uncorrelated noise averages down ~1/sqrt(M); common-mode and static
  offsets do NOT (they are constant within the sweep).
* **noise** — per-read uncorrelated + per-sweep common-mode injection
  (`core.types.NoiseConfig`, eqs. 2-4).
* **sigma_col_offset_lsb** — *static* per-column ADC reference offset
  (reference/bias drift a la ADC reference tuning, arXiv:2502.05948).
  Unlike mu_cm it persists across sweeps, so it is sampled once per
  column (like d2d) and can be *calibrated out* from K reads of a known
  reference level (`readout.calibrate.calibrate_offsets`).

The four paper WV methods are points in this space
(`for_wv_method` / `ReadoutConfig.for_wv`):

    method | basis    | converter | avg_reads
    CW-SC  | one-hot  | compare   | 1
    MRA-M  | one-hot  | SAR       | M
    HD-PV  | Hadamard | SAR       | 1
    HARP   | Hadamard | compare   | 1

and new scenarios (reference-tuned converters, per-column offset drift,
mixed SAR/compare fleets) are configs, not code.
"""

from __future__ import annotations

import dataclasses
import enum

from repro_torch.core.types import ADCConfig, NoiseConfig, WVConfig, WVMethod

__all__ = ["ReadoutBasis", "Converter", "ReadoutConfig", "for_wv_method"]


class ReadoutBasis(str, enum.Enum):
    ONE_HOT = "one_hot"      # identity read patterns (single-cell sensing)
    HADAMARD = "hadamard"    # Sylvester +-1 patterns (parallel sensing)


class Converter(str, enum.Enum):
    IDEAL = "ideal"          # infinite resolution (analysis/equivalence limit)
    SAR = "sar"              # full n-bit SAR conversion -> code on the ADC grid
    COMPARE = "compare"      # one-shot ternary compare vs a preset target code


@dataclasses.dataclass(frozen=True)
class ReadoutConfig:
    """Static description of one column read path (host constants)."""

    basis: ReadoutBasis = ReadoutBasis.HADAMARD
    converter: Converter = Converter.SAR
    n_cells: int = 32                # column length N (Hadamard order)
    levels: int = 8                  # cell levels 2^Bc (full-scale units)
    avg_reads: int = 1               # M averaged reads per measurement
    deadzone_lsb: float = 0.5        # COMPARE 'Equal' band half-width
    adc: ADCConfig = dataclasses.field(default_factory=ADCConfig)
    noise: NoiseConfig = dataclasses.field(default_factory=NoiseConfig)
    sigma_col_offset_lsb: float = 0.0  # static per-column reference offset std
    # Field parity with the reference only; the port reads it nowhere (the
    # basis transforms pick the FWHT kernel by the tensors' device).
    use_pallas: bool = False

    def __post_init__(self):
        if self.avg_reads < 1:
            raise ValueError(f"avg_reads must be >= 1, got {self.avg_reads}")
        if self.converter == Converter.COMPARE and self.avg_reads != 1:
            # One-shot by construction (Fig. 7): the comparator makes a
            # decision, it produces no code that could be averaged.
            raise ValueError(
                f"compare-mode readout is one-shot; avg_reads={self.avg_reads}"
            )
        if self.basis == ReadoutBasis.HADAMARD:
            n = self.n_cells
            if n < 1 or n & (n - 1):
                raise ValueError(f"Hadamard order must be a power of 2: {n}")

    def replace(self, **kw) -> "ReadoutConfig":
        return dataclasses.replace(self, **kw)

    @property
    def reads_per_sweep(self) -> int:
        """Physical column reads per verification sweep."""
        return self.avg_reads * self.n_cells

    @classmethod
    def for_wv(cls, cfg: WVConfig) -> "ReadoutConfig":
        """The readout a WVConfig's verify phase uses (method matrix above)."""
        return for_wv_method(cfg)


def for_wv_method(cfg: WVConfig) -> ReadoutConfig:
    basis, converter, m = {
        WVMethod.CW_SC: (ReadoutBasis.ONE_HOT, Converter.COMPARE, 1),
        WVMethod.MRA: (ReadoutBasis.ONE_HOT, Converter.SAR, cfg.mra_reads),
        WVMethod.HD_PV: (ReadoutBasis.HADAMARD, Converter.SAR, 1),
        WVMethod.HARP: (ReadoutBasis.HADAMARD, Converter.COMPARE, 1),
    }[cfg.method]
    return ReadoutConfig(
        basis=basis,
        converter=converter,
        n_cells=cfg.n_cells,
        levels=cfg.device.levels,
        avg_reads=m,
        deadzone_lsb=cfg.decision_threshold_lsb,
        adc=cfg.adc,
        noise=cfg.noise,
        use_pallas=cfg.use_pallas,
    )
