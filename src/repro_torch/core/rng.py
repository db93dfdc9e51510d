"""Counter-based threefry2x32 streams in torch (DESIGN.md Sec. 10).

The reference engine draws every stochastic field from threefry2x32 keys
and gives every physical column its own stream,

    col_key[c] = fold_in(master_key, col_uid[c])

so a column's realization depends only on (master key, uid), never on
the bucket it rode in.  `torch.Generator` cannot express a stream keyed
by a column uid, so this module reimplements the reference's generator:
threefry2x32 with the *legacy* (non-partitionable) counter layout of
`jax.random` — `PRNGKey`, `split`, `fold_in`, `uniform` and `normal` give
the same raw bits as the reference for the same key.

Keys are int64 tensors of shape ``(..., 2)`` holding uint32 words; a
leading batch axis means one key per column, and each key then draws
its own tail shape (the reference's ``vmap`` over keys).  uint32
arithmetic is emulated in int64 with ``& 0xFFFFFFFF``.

`normal` is ``sqrt(2) * erfinv(u)`` with XLA's float32 erf_inv (Giles'
polynomial), not `torch.erfinv`, which rounds differently in most of
the range.  `normal_cols` draws only a column range of the last axis,
each value bitwise the whole draw's: in the legacy layout word e pairs
counter e with e + n/2, so a range of columns is not a run of counters
and is hashed pair by pair.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["PRNGKey", "batch_ndim", "fold_col_keys", "split", "fold_in",
           "random_bits", "uniform", "normal", "normal_cols", "erfinv_f32",
           "categorical", "randint"]

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def PRNGKey(seed: int, device="cuda") -> torch.Tensor:
    """Raw key ``[seed >> 32, seed & 0xFFFFFFFF]`` (uint32 words in int64)."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK],
                        dtype=torch.int64, device=device)


def batch_ndim(key: torch.Tensor) -> int:
    """Number of leading batch axes on a key (0 = single key)."""
    return key.ndim - 1


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def _threefry2x32(k1, k2, x0, x1):
    """The threefry2x32 hash (20 rounds) on broadcastable int64 words."""
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


def _hash_counts(key: torch.Tensor, n: int) -> torch.Tensor:
    """threefry_2x32(key, iota(n)) per key: (..., 2) -> (..., n) words.

    The legacy layout splits the (odd-padded) counter vector in halves
    and hashes the pairs (count[j], count[half + j]).
    """
    half = (n + 1) // 2
    counts = torch.arange(2 * half, dtype=torch.int64, device=key.device)
    if n % 2:
        counts[-1:].zero_()
    k1 = key[..., 0:1]
    k2 = key[..., 1:2]
    o0, o1 = _threefry2x32(k1, k2, counts[:half], counts[half:])
    return torch.cat([o0, o1], dim=-1)[..., :n]


def _hash_counts_at(key: torch.Tensor, n: int, idx: torch.Tensor) -> torch.Tensor:
    """Words `idx` ((k,) int64) of ``_hash_counts(key, n)``: (..., 2) ->
    (..., k).  Word e < half is the first output of the pair (e, half +
    e), word e >= half the second output of (e - half, e); an odd n's
    last counter is 0."""
    half = (n + 1) // 2
    second = idx >= half
    c0 = torch.where(second, idx - half, idx)
    c1 = c0 + half
    if n % 2:
        c1 = torch.where(c1 == 2 * half - 1, torch.zeros_like(c1), c1)
    o0, o1 = _threefry2x32(key[..., 0:1], key[..., 1:2], c0, c1)
    return torch.where(second, o1, o0)


def split(key: torch.Tensor, num: int = 2) -> tuple[torch.Tensor, ...]:
    """`jax.random.split` (legacy layout), element-wise over a key batch."""
    ks = _hash_counts(key, 2 * num).reshape(*key.shape[:-1], num, 2)
    return tuple(ks[..., j, :] for j in range(num))


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in` with the same scalar (or a per-key tensor)."""
    if isinstance(data, torch.Tensor):
        x1 = data.to(torch.int64) & _MASK
    else:
        x1 = torch.full(key.shape[:-1], int(data) & _MASK, dtype=torch.int64,
                        device=key.device)
    o0, o1 = _threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(x1), x1)
    return torch.stack([o0, o1], dim=-1)


def fold_col_keys(key: torch.Tensor, col_ids: torch.Tensor) -> torch.Tensor:
    """Derive one key per column: ``fold_in(key, col_ids[c])`` -> (C, 2)."""
    return fold_in(key, col_ids)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """Raw uint32 words (in int64) of `shape`; a key batch owns axis 0."""
    shape = tuple(int(s) for s in shape)
    if batch_ndim(key):
        assert shape[0] == key.shape[0], (shape, key.shape)
        tail = shape[1:]
        return _hash_counts(key, int(np.prod(tail, dtype=np.int64))).reshape(shape)
    return _hash_counts(key, int(np.prod(shape, dtype=np.int64))).reshape(shape)


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """``a * b mod 2^32`` for uint32 words in int64, in 16-bit halves of
    `b` so that no int64 product overflows."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def randint(key: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """`jax.random.randint(key, shape, minval, maxval)` (int32, legacy
    layout): two 32-bit draws per value, combined modulo the span.

    The reference's arithmetic in uint32, every product and sum wrapping
    at 2^32 (the multiplier's square too): the span is ``maxval -
    minval`` (1 where ``maxval <= minval``), ``multiplier = (2^16 mod
    span)^2 mod span``, and the value ``minval + ((hi mod span) *
    multiplier + lo mod span) mod span``.
    """
    minval, maxval = int(minval), int(maxval)
    if not (-2**31 <= minval < 2**31 and -2**31 <= maxval < 2**31):
        raise ValueError(f"randint bounds must fit int32, got [{minval}, {maxval})")
    k1, k2 = split(key)
    hi, lo = random_bits(k1, shape), random_bits(k2, shape)
    span = (maxval - minval) & _MASK if maxval > minval else 1
    mult = ((((1 << 16) % span) ** 2) & _MASK) % span
    offset = (_mul32(hi % span, mult) + lo % span) & _MASK
    out = (offset % span + minval) & _MASK
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)


def _floats_of(bits: torch.Tensor) -> torch.Tensor:
    """Floats in [0, 1) from the top 23 bits (the reference's mantissa trick)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def _unit_floats(key: torch.Tensor, shape) -> torch.Tensor:
    return _floats_of(random_bits(key, shape))


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """U[minval, maxval) float32 draw of `shape`; batch-transparent like
    `normal`.

    The reference's affine map in float32: ``max(minval, f * (maxval -
    minval) + minval)`` with the span rounded to float32 first.  Bitwise
    the reference's for a unit span; otherwise within one rounding of
    ``f * span`` (XLA contracts the multiply-add into an FMA).
    """
    f = _unit_floats(key, shape)
    if minval == 0.0 and maxval == 1.0:
        return f  # the affine map is the identity
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp_min(f * span + lo, lo)


# XLA's float32 ErfInv (Giles, "Approximating the erfinv function").
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
_ERFINV_LT5 = tuple(float(np.float32(c)) for c in _ERFINV_LT5)
_ERFINV_GE5 = tuple(float(np.float32(c)) for c in _ERFINV_GE5)


def _sqrt_f32(w: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt, as XLA's.

    On the CPU, PyTorch's `sqrt` goes through a vector math library.  Its
    first call after the process's first `log1p` sometimes runs one
    2048-element chunk at about 3e-4 relative accuracy, and in erf^-1's
    tail (|z| > 2.97) that moves the draw by up to 7e-4.  A float64 square
    root refined by one Newton step is exact to float32 either way.
    """
    if w.device.type != "cpu":
        return torch.sqrt(w)
    w64 = w.to(torch.float64)
    s = torch.sqrt(w64)
    fine = torch.isfinite(s) & (s > 0)
    return torch.where(fine, 0.5 * (s + w64 / s), s).to(torch.float32)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 erf^-1 with XLA's polynomial and operation order."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, _sqrt_f32(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, a, b) + p * w
    res = p * x
    return torch.where(torch.abs(x) == 1.0, x * float("inf"), res)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_NORMAL_SPAN = float(np.float32(1.0) - np.float32(_NORMAL_LO))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """Standard normal float32 draw of `shape`.

    With a single key this is ``jax.random.normal(key, shape)``.  With a
    batch of C keys, `shape` leads with C and each column draws its
    ``shape[1:]`` tail from its own stream.
    """
    return _normal_of(_unit_floats(key, shape))


def _normal_of(f: torch.Tensor) -> torch.Tensor:
    u = torch.clamp_min(f * _NORMAL_SPAN + _NORMAL_LO, _NORMAL_LO)
    return erfinv_f32(u) * _SQRT2


def normal_cols(key: torch.Tensor, shape, lo: int, hi: int) -> torch.Tensor:
    """``normal(key, shape)[..., lo:hi]``, bitwise, hashing only those
    columns' counter pairs (one hash per value instead of one per two
    values of the whole draw)."""
    shape = tuple(int(s) for s in shape)
    tail = shape[1:] if batch_ndim(key) else shape
    n = int(np.prod(tail, dtype=np.int64))
    m = tail[-1]
    rows = n // m
    dev = key.device
    idx = (torch.arange(rows, dtype=torch.int64, device=dev)[:, None] * m
           + torch.arange(lo, hi, dtype=torch.int64, device=dev)[None, :]).reshape(-1)
    bits = _hash_counts_at(key, n, idx)
    return _normal_of(_floats_of(bits)).reshape(*shape[:-1], hi - lo)


_TINY = float(np.finfo(np.float32).tiny)


def categorical(key: torch.Tensor, logits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """`jax.random.categorical(key, logits, axis)` for float32 logits.

    The Gumbel-max trick with the reference's default ("low") Gumbel
    sampler: ``argmax(logits - log(-log(u)))``, u drawn from one key as
    ``uniform(key, logits.shape, minval=tiny, maxval=1)``.  Ties go to
    the first index, as in `jnp.argmax`.
    """
    if logits.dtype != torch.float32:
        raise TypeError(f"categorical takes float32 logits, got {logits.dtype}")
    u = uniform(key, tuple(logits.shape), minval=_TINY, maxval=1.0)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(gumbel + logits, dim=axis)
