"""Symmetric per-output-channel quantization of weight matrices.

The paper stores B-bit signed weights on pos/neg RRAM column pairs
(Fig. 2): each polarity holds the magnitude across k = B/Bc cell slices,
so the integer magnitude range is [0, 2^B - 1] and signed weights live
in [-(2^B - 1), 2^B - 1] with a per-channel scale.

Low-precision leaves (bf16) are quantized in their own dtype, as the
reference does: every elementwise step is computed in float32 and
rounded back to the leaf dtype, which is how the reference's compiler
evaluates bf16 arithmetic on the CPU.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.numerics import true_div

__all__ = ["QuantConfig", "quantize_weight", "dequantize_weight"]


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    weight_bits: int = 6         # B
    cell_bits: int = 3           # Bc
    channel_axis: int = -1       # per-output-channel scales
    clip_quantile: float = 1.0   # 1.0 = absmax scaling

    @property
    def q_max(self) -> int:
        return (1 << self.weight_bits) - 1

    @property
    def slices(self) -> int:
        assert self.weight_bits % self.cell_bits == 0
        return self.weight_bits // self.cell_bits


def quantize_weight(
    w: torch.Tensor, cfg: QuantConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """float weights -> (int32 levels in [-q_max, q_max], per-channel scale).

    The scale keeps the leaf's dtype.
    """
    dt = w.dtype
    axis = cfg.channel_axis % w.ndim
    red = tuple(i for i in range(w.ndim) if i != axis)
    a = torch.abs(w)
    if cfg.clip_quantile >= 1.0:
        amax = torch.amax(a, dim=red, keepdim=True)
    else:
        keep = [1 if i in red else s for i, s in enumerate(w.shape)]
        flat = torch.movedim(a.float(), axis, -1).reshape(-1, w.shape[axis])
        amax = torch.quantile(flat, cfg.clip_quantile, dim=0).reshape(keep).to(dt)
    floor = float(torch.tensor(1e-12, dtype=dt))
    scale = true_div(
        torch.clamp_min(amax.float(), floor).to(dt).float(), float(cfg.q_max)
    ).to(dt)
    q = torch.round((w.float() / scale.float()).to(dt).float()).to(dt).float()
    q = torch.clamp(q, -cfg.q_max, cfg.q_max)
    return q.to(torch.int32), scale


def dequantize_weight(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Integer (or programmed analog) levels -> float32 weights."""
    return q.to(torch.float32) * scale
