"""Counter-based threefry2x32 streams: a frozen plain-PyTorch copy of the
generator the system under test uses (the legacy `jax.random` layout).

Keys are int64 tensors of shape ``(..., 2)`` holding uint32 words; a
leading batch axis means one key per column, and each key then draws
its own tail shape.  uint32 arithmetic is emulated in int64 with
``& 0xFFFFFFFF``.  `normal` is ``sqrt(2) * erfinv(u)`` with XLA's
float32 erf_inv polynomial (Giles).

Nothing here imports the system under test: the benchmark's reference
regenerates every random field from the seed with this copy.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["PRNGKey", "split", "fold_in", "normal", "uniform"]

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """Raw key ``[seed >> 32, seed & 0xFFFFFFFF]``."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK],
                        dtype=torch.int64, device=device)


def _rotl(x, r):
    return ((x << r) & _MASK) | (x >> (32 - r))


def _threefry2x32(k1, k2, x0, x1):
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def _hash_counts(key, n: int):
    """threefry_2x32(key, iota(n)) per key, legacy layout: the counter
    vector (odd-padded) is split in halves and hashed pairwise."""
    half = (n + 1) // 2
    counts = torch.arange(2 * half, dtype=torch.int64, device=key.device)
    if n % 2:
        counts[-1:].zero_()
    o0, o1 = _threefry2x32(key[..., 0:1], key[..., 1:2], counts[:half], counts[half:])
    return torch.cat([o0, o1], dim=-1)[..., :n]


def split(key, num: int = 2):
    ks = _hash_counts(key, 2 * num).reshape(*key.shape[:-1], num, 2)
    return tuple(ks[..., j, :] for j in range(num))


def fold_in(key, data):
    if isinstance(data, torch.Tensor):
        x1 = data.to(torch.int64) & _MASK
    else:
        x1 = torch.full(key.shape[:-1], int(data) & _MASK, dtype=torch.int64,
                        device=key.device)
    o0, o1 = _threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(x1), x1)
    return torch.stack([o0, o1], dim=-1)


def _bits(key, shape):
    shape = tuple(int(s) for s in shape)
    if key.ndim > 1:
        tail = shape[1:]
        return _hash_counts(key, int(np.prod(tail, dtype=np.int64))).reshape(shape)
    return _hash_counts(key, int(np.prod(shape, dtype=np.int64))).reshape(shape)


def _unit(key, shape):
    f = ((_bits(key, shape) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key, shape):
    return _unit(key, shape)


_LT5 = tuple(float(np.float32(c)) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941))
_GE5 = tuple(float(np.float32(c)) for c in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))


def _sqrt_f32(w):
    """Correctly rounded float32 sqrt (the CPU's vector sqrt is not)."""
    if w.device.type != "cpu":
        return torch.sqrt(w)
    w64 = w.to(torch.float64)
    s = torch.sqrt(w64)
    fine = torch.isfinite(s) & (s > 0)
    return torch.where(fine, 0.5 * (s + w64 / s), s).to(torch.float32)


def _erfinv(x):
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, _sqrt_f32(w) - 3.0)
    p = torch.where(lt, _LT5[0], _GE5[0])
    for a, b in zip(_LT5[1:], _GE5[1:]):
        p = torch.where(lt, a, b) + p * w
    res = p * x
    return torch.where(torch.abs(x) == 1.0, x * float("inf"), res)


_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SPAN = float(np.float32(1.0) - np.float32(_LO))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def normal(key, shape):
    """Standard normal float32 of `shape` (a key batch owns axis 0)."""
    u = torch.clamp_min(_unit(key, shape) * _SPAN + _LO, _LO)
    return _erfinv(u) * _SQRT2
