"""Column converter models: the one place SAR/compare math lives.

Paper Fig. 7: a standard n-bit SAR ADC either

* runs the full n-step binary search ("SAR logic"), producing a digital
  code — modelled as uniform quantization over the converter's
  full-scale range; or
* is put in HARP's one-shot *compare* mode ("compare logic"): the
  capacitor array is preset to the target code and the comparator makes
  one (or two) decisions, yielding ternary {Low, Equal, High} — no code.

Full-scale convention (Sec. 3.2, V_sam reference switching): the verify
ADC always spans ``N * (2^Bc - 1)`` cell-LSB of column current.

* one-hot reads / first Hadamard row: range [0, FS]        (V_sam = GND)
* balanced Hadamard rows:            range [-FS/2, +FS/2]  (V_sam = Vcm/2)
"""

from __future__ import annotations

import torch

from repro_torch.core.numerics import true_div
from repro_torch.core.types import ADCConfig

__all__ = [
    "full_scale_lsb",
    "code_width_lsb",
    "sar_quantize",
    "sar_read",
    "compare_read",
]


def full_scale_lsb(n_cells: int, levels: int) -> float:
    return float(n_cells * (levels - 1))


def code_width_lsb(adc: ADCConfig, n_cells: int, levels: int) -> float:
    return full_scale_lsb(n_cells, levels) / float(1 << adc.bits)


def sar_quantize(
    y: torch.Tensor, bits: int, full_scale: float, centered: bool = True
) -> torch.Tensor:
    """n-bit uniform quantization over the full-scale range (dequantized).

    `centered` selects [-FS/2, +FS/2]; otherwise [0, FS].  Returns
    code * width + lo in the input units, saturating at the rails.
    """
    w = full_scale / float(1 << bits)
    lo = -full_scale / 2.0 if centered else 0.0
    code = torch.clamp(
        torch.round(true_div(torch.clamp(y, lo, lo + full_scale) - lo, w)),
        0,
        (1 << bits) - 1,
    )
    return lo + code * w


def sar_read(
    y: torch.Tensor, adc: ADCConfig, n_cells: int, levels: int, centered: bool
) -> torch.Tensor:
    """Full SAR conversion of a verify read over ``N * (2^Bc - 1)``."""
    return sar_quantize(y, adc.bits, full_scale_lsb(n_cells, levels), centered)


def compare_read(
    y: torch.Tensor, target: torch.Tensor, deadzone_lsb: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """One-shot compare mode (eq. 9): ternary sign of (y - target).

    Returns (sign in {-1, 0, +1}, comparisons in {1, 2}): the first
    comparison resolves "below target"; only a not-below outcome needs
    the second comparison to separate Equal from High (Fig. 7(c)).
    """
    diff = y - target
    below = diff < -deadzone_lsb
    above = diff > deadzone_lsb
    sign = torch.where(below, -1.0, torch.where(above, 1.0, 0.0))
    n_cmp = torch.where(below, 1, 2).to(torch.int32)
    return sign, n_cmp
