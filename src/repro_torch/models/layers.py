"""Shared neural-net primitives (plain functions over tensors).

The reference's mixed-precision policy: parameters are stored in
cfg.dtype (bf16), matmuls accumulate in float32 and cast back to the
activation dtype, norm statistics reduce in float32 and the normalizer
is applied in the activation dtype.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.cim.mvm import cim_matmul, current_token_ids
from repro_torch.cim.tile import CIMWeight
from repro_torch.core.numerics import true_div

__all__ = ["truncated_normal", "dense_init", "slice_layer", "matmul", "rms_norm",
           "head_rms_norm", "swiglu", "rope_freqs", "apply_rope",
           "sinusoidal_positions", "cross_entropy_loss"]


def truncated_normal(gen, shape, std, dtype, device) -> torch.Tensor:
    """std * N(0, 1) truncated to [-2, 2], cast to `dtype`."""
    x = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (x * std).to(dtype)


def dense_init(gen, n_layers, d_in, d_out, dtype, device, std=None) -> torch.Tensor:
    """A stack of `n_layers` (d_in, d_out) weights, std 1/sqrt(d_in) unless
    `std` is given (the reference's `dense_init` under a layer vmap)."""
    std = std if std is not None else 1.0 / math.sqrt(d_in)
    return truncated_normal(gen, (n_layers, d_in, d_out), std, dtype, device)


def slice_layer(tree: Any, idx: int) -> Any:
    """Layer `idx` of a stacked layer tree (the reference's
    ``tree.map(lambda a: a[idx], lay)``); `CIMWeight` leaves slice every
    tensor field through `CIMWeight.layer`, so a served leaf keeps its
    `layer_id`."""
    if isinstance(tree, dict):
        return {k: slice_layer(v, idx) for k, v in tree.items()}
    if isinstance(tree, CIMWeight):
        return tree.layer(idx)
    return tree[idx]


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w with float32 accumulation, cast back to x.dtype.

    A `CIMWeight` leaf (analog serving, `repro_torch.cim`) goes through
    the in-array forward instead: the programmed conductance tiles
    compute the product, noise and ADC included, under the same
    contract.  The ambient token-id stream (`cim.token_stream_ids`) keys
    the per-row noise sub-streams.
    """
    if isinstance(w, CIMWeight):
        return cim_matmul(x, w, token_ids=current_token_ids())
    y = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    return y.to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm: the square in x.dtype, its mean in float32, the
    normalizer applied in x.dtype."""
    var = torch.mean(torch.square(x), dim=-1, keepdim=True, dtype=torch.float32)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * (1.0 + scale).to(x.dtype)


def head_rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Per-head RMS norm over head_dim (Qwen3 qk-norm)."""
    return rms_norm(x, scale, eps)


def swiglu(x, w_gate, w_up, w_down) -> torch.Tensor:
    g = matmul(x, w_gate)
    u = matmul(x, w_up)
    return matmul(F.silu(g.to(torch.float32)).to(x.dtype) * u, w_down)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = true_div(torch.arange(0, head_dim, 2, dtype=torch.float32,
                                 device=device), float(head_dim))
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) integer."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)               # (hd/2,)
    angles = positions[..., :, None].to(torch.float32) * freqs   # (..., S, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """(..., S) -> (..., S, D) fixed sinusoidal embeddings (MusicGen-style),
    float32."""
    half = d_model // 2
    dev = positions.device
    log_base = torch.log(torch.full((), 10000.0, dtype=torch.float32, device=dev))
    freqs = torch.exp(true_div(-log_base * torch.arange(half, dtype=torch.float32, device=dev),
                               float(max(half - 1, 1))))
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE over masked positions; logits (..., V) against
    integer targets (...), taken in float32."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].to(torch.int64))[..., 0]
    nll = (logz - gold) * mask
    return torch.sum(nll) / torch.clamp_min(torch.sum(mask), 1.0)
