"""Plain PyTorch version of the bit-sliced ACiM VMM kernel.

Simulates the CBA macro's inference datapath: a weight matrix stored as
k = B/Bc conductance slices on signed column pairs, each slice's partial
sums quantized by a per-column ADC, slices recombined digitally:

    y = sum_l 2^(Bc*l) * ADC( x @ (G+_l - G-_l) + n_l )

`adc_quantize` is `readout.converter.sar_quantize` in centered mode
(n-bit over [-FS/2, FS/2]), the same converter model the verify path
reads through.  `noise` enters each slice's analog partial sum before
the ADC; ``adc_bits=None`` is an ideal converter (the identity).

The association is the reference's and part of the contract: the slice
difference ``g_pos[l] - g_neg[l]`` is formed before the product, noise
is added before the ADC, slices recombine into a tile's accumulator,
and each tile's accumulator is added to the leaf's in tile order.
"""

from __future__ import annotations

import torch

from repro_torch.readout.converter import sar_quantize

__all__ = ["adc_quantize", "acim_vmm", "acim_vmm_tiled", "split_bf16x3"]


def adc_quantize(y: torch.Tensor, bits: int, full_scale: float) -> torch.Tensor:
    """n-bit uniform quantization over [-FS/2, FS/2] (dequantized)."""
    return sar_quantize(y, bits, full_scale, centered=True)


def acim_vmm(
    x: torch.Tensor,            # (B, K) activations
    g_pos: torch.Tensor,        # (S, K, M) positive-column conductance levels
    g_neg: torch.Tensor,        # (S, K, M) negative-column conductance levels
    bc: int,                    # bits per cell
    adc_bits: int | None,
    full_scale: float,
    noise: torch.Tensor | None = None,  # (S, B, M) pre-ADC read noise
) -> torch.Tensor:
    """Bit-sliced signed VMM with per-slice ADC quantization: (B, M) f32."""
    s = g_pos.shape[0]
    xf = x.to(torch.float32)
    acc = torch.zeros((x.shape[0], g_pos.shape[2]), dtype=torch.float32,
                      device=x.device)
    for l in range(s):
        part = xf @ (g_pos[l] - g_neg[l]).to(torch.float32)
        if noise is not None:
            part = part + noise[l].to(torch.float32)
        if adc_bits is not None:
            part = adc_quantize(part, adc_bits, full_scale)
        acc = acc + part * float(1 << (bc * l))
    return acc


def acim_vmm_tiled(
    x: torch.Tensor,            # (B, T*R) row drives, tiles contiguous on K
    g_pos: torch.Tensor,        # (T, S, R, M) per-tile positive planes
    g_neg: torch.Tensor,        # (T, S, R, M) per-tile negative planes
    bc: int,
    adc_bits: int | None,
    full_scale: float,
    noise: torch.Tensor | None = None,  # (T, S, B, M) per-tile pre-ADC noise
) -> torch.Tensor:
    """Whole-leaf tiled VMM: every macro tile's readout, summed in tile
    order (``acc + tile_result``, the reference's scan)."""
    n_tiles, _, r, m = g_pos.shape
    b = x.shape[0]
    acc = torch.zeros((b, m), dtype=torch.float32, device=x.device)
    for ti in range(n_tiles):
        xi = x[:, ti * r:(ti + 1) * r]
        nz = None if noise is None else noise[ti]
        acc = acc + acim_vmm(xi, g_pos[ti], g_neg[ti], bc, adc_bits,
                             full_scale, nz)
    return acc


def split_bf16x3(d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CUDA kernel's split of float32 slice differences into three
    bfloat16 parts, h = bf16(d), m = bf16(d - h), l = bf16(d - h - m),
    each rounded to nearest even.  h + m + l == d exactly for d == 0 and
    |d| >= 2^-110 (3 x 8 significand bits cover float32's 24, and each
    remainder is exact in float32), so with x in {0, 1} the three
    bf16 products sum to x @ d up to the order of the float32 sum.
    Plain version of the device code; nothing on the main path calls it.
    """
    d = d.to(torch.float32)
    h = d.to(torch.bfloat16)
    r = d - h.to(torch.float32)
    m = r.to(torch.bfloat16)
    lo = (r - m.to(torch.float32)).to(torch.bfloat16)
    return h, m, lo
