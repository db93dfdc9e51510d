"""Bit-slicing between B-bit integer magnitudes and Bc-bit cell levels.

Signed mapping (paper Fig. 5(d)): w = w+ - w-, with exactly one of the
pair nonzero (the other cell stays at HRS to encode zero).  Magnitudes
split base-2^Bc, LSB slice first:  mag = sum_l (2^Bc)^l * s_l.
"""

from __future__ import annotations

import torch


def signed_to_pair(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Signed integers -> (positive, negative) magnitude planes."""
    return torch.clamp_min(q, 0), torch.clamp_min(-q, 0)


def pair_to_signed(pos: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """Inverse of signed_to_pair (works on analog read-back values too)."""
    return pos - neg


def slice_magnitudes(mag: torch.Tensor, bc: int, k: int) -> torch.Tensor:
    """(...,) int magnitudes -> (..., k) cell levels, LSB slice first."""
    base = 1 << bc
    out = []
    rem = mag.to(torch.int32)
    for _ in range(k):
        out.append(rem % base)
        rem = rem // base
    return torch.stack(out, dim=-1)


def unslice_magnitudes(slices: torch.Tensor, bc: int) -> torch.Tensor:
    """(..., k) cell levels (analog OK) -> (...,) magnitudes."""
    out = slices[..., 0] * 1.0
    for l in range(1, slices.shape[-1]):
        out = out + slices[..., l] * float(1 << (bc * l))
    return out
