"""Bytes and operations of one call of each hand-written kernel, at the
shapes the call needs (the same formulas the kernels document).

fwht: c rows of n float32 values read once and written once (8 c n
bytes) and log2(n) adds or subtracts per value (float32).
wv_step: the ternary cell update reads eight (C, N) planes but not the
magnitude plane (25 bytes a cell), writes five (17 bytes a cell), and
runs about 30 float32 operations a cell.
acim_vmm: x (B, T R), the two (T, S, R, M) conductance planes and the
(T, S, B, M) read noise read once and the (B, M) result written once,
all float32; binary DAC planes multiply as three exact bfloat16
tensor-core products per multiply-add (6 bfloat16 operations).
Priced by `work.bound_s` at the rates of `peaks.json`.

A deploy's kernel calls run over buckets of columns: `wv_buckets` is the
port's plan (`core/pipeline.bucket_sizes`: greedy powers of two between
the bounds the harness passes, only the last padded), and `wv_calls`
the work of the calls a deploy launched, spread evenly over its buckets
(every bucket runs the same fixed trip count).
"""

from __future__ import annotations

import math


def fwht(c: int, n: int) -> tuple[float, dict]:
    return 8.0 * c * n, {"f32": c * n * math.log2(n)}


def wv_step(c: int, n: int) -> tuple[float, dict]:
    return (25.0 + 17.0) * c * n, {"f32": 30.0 * c * n}


def acim_vmm(b: int, n_tiles: int, s: int, r: int, m: int) -> tuple[float, dict]:
    macs = b * n_tiles * r * m * s
    nbytes = 4.0 * (b * n_tiles * r + 2 * n_tiles * s * r * m + n_tiles * s * b * m + b * m)
    return nbytes, {"bf16": 6.0 * macs}


def wv_buckets(columns: int, min_bucket: int, max_bucket: int) -> list[int]:
    """The column counts of a deploy's buckets, the C of each kernel call."""
    sizes, rem = [], columns
    while rem >= min_bucket:
        s = min(max_bucket, 1 << (rem.bit_length() - 1))
        sizes.append(s)
        rem -= s
    if rem > 0 or not sizes:
        sizes.append(min_bucket)
    return sizes


def wv_calls(kernel, launches: int, buckets: list[int], n: int) -> dict | None:
    """The work of `launches` calls of `kernel` (`fwht` or `wv_step`)
    shared evenly by the buckets, each call at its bucket's C and `n`;
    None where the launches do not divide evenly."""
    if not launches or launches % len(buckets):
        return None
    total: dict = {}
    for c in buckets:
        add(total, *kernel(c, n), times=launches // len(buckets))
    return total


def add(total: dict, nbytes: float, ops: dict, times: float = 1.0) -> dict:
    """Accumulate `times` calls' work into `total` ({"bytes", "ops"})."""
    total["bytes"] = total.get("bytes", 0.0) + times * nbytes
    acc = total.setdefault("ops", {})
    for k, v in ops.items():
        acc[k] = acc.get(k, 0.0) + times * v
    return total
