"""Fixed-bucket streaming histograms for hot-path percentiles.

`StreamingDigest` holds a fixed-bucket histogram (counts + sum +
min/max + out-of-range counts) over a declared value range.  Two
accumulation paths, one rule: instrumentation adds no host sync.

* `add(x)` / `add_weighted(x, w)` are the device path: torch ops on the
  digest's tensors, returning a NEW digest, no host sync.  A device
  digest comes back to the host only on a fetch the hot path already
  performs (the scheduler's per-step token fetch, the scrub's health
  fetch): `as_tree()` gives its tensors to `obs.metrics.fetch`, and
  `from_tree` rebuilds the fetched host digest.
* `observe(x)` is the host path: numpy, in place, for host-born values
  (wall-clock step latency, TTFT).

Quantiles are rank-based over the bucket midpoints: for n observed
values the q-quantile estimate is the midpoint of the bucket holding the
rank-``floor(q*(n-1))`` value, within half a bucket width of the exact
order statistic (`rank_quantile`) for in-range inputs.  Merging adds
counts elementwise, so per-replica digests fold into fleet digests.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = [
    "StreamingDigest",
    "DigestRegistry",
    "digests",
    "observe",
    "rank_quantile",
    "snapshot",
    "reset",
]

_QUANTILES = (0.50, 0.95, 0.99)
_FIELDS = ("counts", "total", "vmin", "vmax", "n_under", "n_over")


def rank_quantile(values, q: float) -> float:
    """The repo-wide quantile: the exact order statistic at rank
    ``floor(q * (n - 1))`` (``np.quantile(..., method="lower")``), which
    `StreamingDigest.quantile` estimates to bucket resolution."""
    x = np.sort(np.asarray(values, np.float64).ravel())
    if x.size == 0:
        raise ValueError("rank_quantile of empty input")
    return float(x[int(np.floor(float(q) * (x.size - 1)))])


class StreamingDigest:
    """A fixed-bucket histogram over ``[lo, hi)`` with ``n`` buckets.

    Values below ``lo`` clamp into the first bucket and values at or
    above ``hi`` into the last, so no count leaks; they are also counted
    in ``n_under`` / ``n_over``, so a clamped top bucket cannot pass for
    a true p99.  Leaves are float32 tensors (a device digest) or numpy
    float32 (a host digest).
    """

    def __init__(self, lo: float, hi: float, counts, total, vmin, vmax,
                 n_under=None, n_over=None):
        self.lo = float(lo)
        self.hi = float(hi)
        self.counts = counts
        self.total = total
        self.vmin = vmin
        self.vmax = vmax
        self.n_under = np.float32(0.0) if n_under is None else n_under
        self.n_over = np.float32(0.0) if n_over is None else n_over

    # ------------------------------------------------------------ ctor
    @classmethod
    def zeros(cls, lo: float, hi: float, n_buckets: int,
              device="cuda") -> "StreamingDigest":
        """Zero digest with tensor leaves on `device` (the device path)."""
        assert hi > lo and n_buckets >= 1, (lo, hi, n_buckets)

        def full(v, shape=()):
            return torch.full(shape, v, dtype=torch.float32, device=device)

        return cls(lo, hi, full(0.0, (n_buckets,)), full(0.0),
                   full(float("inf")), full(float("-inf")), full(0.0), full(0.0))

    @classmethod
    def host(cls, lo: float, hi: float, n_buckets: int) -> "StreamingDigest":
        """Host-side (numpy) zero digest; never touches the device."""
        assert hi > lo and n_buckets >= 1, (lo, hi, n_buckets)
        return cls(
            lo, hi,
            np.zeros((n_buckets,), np.float32),
            np.float32(0.0),
            np.float32(np.inf),
            np.float32(-np.inf),
            np.float32(0.0),
            np.float32(0.0),
        )

    def as_tree(self) -> dict[str, Any]:
        """The leaves by name (the operand of `obs.metrics.fetch`)."""
        return {f: getattr(self, f) for f in _FIELDS}

    @classmethod
    def from_tree(cls, lo: float, hi: float, tree) -> "StreamingDigest":
        return cls(lo, hi, *(tree[f] for f in _FIELDS))

    # ------------------------------------------------------- properties
    @property
    def n_buckets(self) -> int:
        return int(self.counts.shape[0])

    @property
    def width(self) -> float:
        return (self.hi - self.lo) / self.n_buckets

    @property
    def count(self) -> float:
        return float(np.sum(np.asarray(self.counts)))

    # ------------------------------------------------------ accumulate
    def _bucket(self, x: torch.Tensor) -> torch.Tensor:
        return torch.clamp(torch.floor((x - self.lo) / self.width).to(torch.int64),
                           0, self.n_buckets - 1)

    def add(self, x) -> "StreamingDigest":
        """Device-side accumulation: a NEW digest, torch ops only."""
        x = torch.as_tensor(x, dtype=torch.float32,
                            device=self.counts.device).reshape(-1)
        if x.numel() == 0:
            return self
        return StreamingDigest(
            self.lo, self.hi,
            self.counts.index_add(0, self._bucket(x), torch.ones_like(x)),
            self.total + torch.sum(x),
            torch.minimum(self.vmin, torch.amin(x)),
            torch.maximum(self.vmax, torch.amax(x)),
            self.n_under + torch.sum(x < self.lo).to(torch.float32),
            self.n_over + torch.sum(x >= self.hi).to(torch.float32),
        )

    def add_weighted(self, x, weights) -> "StreamingDigest":
        """Device-side accumulation with per-value weights (counts);
        zero-weight entries contribute nothing, min/max included."""
        dev = self.counts.device
        x = torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(-1)
        w = torch.as_tensor(weights, dtype=torch.float32, device=dev).reshape(-1)
        if x.numel() == 0:
            return self
        live = w > 0
        inf = float("inf")
        return StreamingDigest(
            self.lo, self.hi,
            self.counts.index_add(0, self._bucket(x), w),
            self.total + torch.sum(x * w),
            torch.minimum(self.vmin, torch.amin(torch.where(live, x, inf))),
            torch.maximum(self.vmax, torch.amax(torch.where(live, x, -inf))),
            self.n_under + torch.sum(torch.where(x < self.lo, w, 0.0)),
            self.n_over + torch.sum(torch.where(x >= self.hi, w, 0.0)),
        )

    def observe(self, x) -> None:
        """Host-side accumulation (numpy, in place); zero device work."""
        x = np.asarray(x, np.float32).ravel()
        if x.size == 0:
            return
        idx = np.clip(
            np.floor((x - self.lo) / self.width).astype(np.int64),
            0, self.n_buckets - 1,
        )
        np.add.at(self.counts, idx, 1.0)
        self.total = np.float32(self.total + np.sum(x))
        self.vmin = np.float32(min(float(self.vmin), float(np.min(x))))
        self.vmax = np.float32(max(float(self.vmax), float(np.max(x))))
        self.n_under = np.float32(self.n_under + np.sum(x < self.lo))
        self.n_over = np.float32(self.n_over + np.sum(x >= self.hi))

    def merge(self, other: "StreamingDigest") -> "StreamingDigest":
        """Elementwise merge of host digests with identical buckets."""
        assert (self.lo, self.hi, self.n_buckets) == (
            other.lo, other.hi, other.n_buckets,
        ), "digest merge requires identical bucket configuration"
        a, b = self.as_tree(), other.as_tree()
        ops = dict(counts=np.add, total=np.add, vmin=np.minimum,
                   vmax=np.maximum, n_under=np.add, n_over=np.add)
        return StreamingDigest.from_tree(self.lo, self.hi, {
            f: ops[f](np.asarray(a[f]), np.asarray(b[f])) for f in _FIELDS})

    # -------------------------------------------------------- quantiles
    def quantile(self, q: float) -> float | None:
        """Rank-based quantile estimate (bucket midpoint); None if empty."""
        counts = np.asarray(self.counts, np.float64)
        n = counts.sum()
        if n <= 0:
            return None
        rank = int(np.floor(float(q) * (n - 1)))
        cum = np.cumsum(counts)
        b = int(np.searchsorted(cum, rank + 1, side="left"))
        b = min(b, self.n_buckets - 1)
        return float(self.lo + (b + 0.5) * self.width)

    def summary(self) -> dict[str, Any]:
        """JSON-safe summary: count/mean/min/max + p50/p95/p99; an empty
        digest reports ``count: 0`` with null statistics."""
        n = self.count
        out: dict[str, Any] = {
            "lo": self.lo, "hi": self.hi, "n_buckets": self.n_buckets,
            "count": n,
        }
        if n > 0:
            out["mean"] = float(np.asarray(self.total)) / n
            out["min"] = float(np.asarray(self.vmin))
            out["max"] = float(np.asarray(self.vmax))
        else:
            out["mean"] = None
            out["min"] = None
            out["max"] = None
        out["n_under"] = float(np.asarray(self.n_under))
        out["n_over"] = float(np.asarray(self.n_over))
        for q in _QUANTILES:
            out[f"p{int(q * 100)}"] = self.quantile(q)
        return out

    def __repr__(self) -> str:
        return (
            f"StreamingDigest(lo={self.lo}, hi={self.hi}, "
            f"n_buckets={self.n_buckets}, count={self.count})"
        )


def _host_copy(d: StreamingDigest) -> StreamingDigest:
    """Deep-copy a fetched digest onto host numpy leaves."""
    return StreamingDigest(
        d.lo, d.hi,
        np.asarray(d.counts, np.float32).copy(),
        *(np.float32(np.asarray(getattr(d, f))) for f in _FIELDS[1:]),
    )


class DigestRegistry:
    """Host-side named digests: the fold target for everything fetched.

    `observe` is for host-born values; `put` / `fold` take an already
    fetched digest (numpy leaves: folding a live device digest would be
    a hidden sync, so callers fetch first on an existing sync).
    """

    def __init__(self):
        self._digests: dict[str, StreamingDigest] = {}

    def ensure(self, name: str, lo: float, hi: float,
               n_buckets: int = 64) -> StreamingDigest:
        d = self._digests.get(name)
        if d is None:
            d = StreamingDigest.host(lo, hi, n_buckets)
            self._digests[name] = d
        return d

    def observe(self, name: str, x, *, lo: float, hi: float,
                n_buckets: int = 64) -> None:
        self.ensure(name, lo, hi, n_buckets).observe(x)

    def put(self, name: str, fetched: StreamingDigest) -> None:
        """Replace the named slot with a fetched CUMULATIVE digest (one
        that already holds the whole history; merging would double-count)."""
        self._digests[name] = _host_copy(fetched)

    def fold(self, name: str, fetched: StreamingDigest) -> None:
        """Merge a fetched (numpy-leaved) digest into the named slot."""
        d = self._digests.get(name)
        if d is None:
            self._digests[name] = _host_copy(fetched)
        else:
            self._digests[name] = d.merge(fetched)

    def get(self, name: str) -> StreamingDigest | None:
        return self._digests.get(name)

    def names(self) -> tuple[str, ...]:
        return tuple(sorted(self._digests))

    def snapshot(self) -> dict[str, dict[str, Any]]:
        return {n: d.summary() for n, d in sorted(self._digests.items())}

    def emit(self) -> None:
        """Mirror every digest summary into the trace as cat="digest"
        instants, so a reader of the exported trace sees percentiles."""
        from . import trace

        for name, d in sorted(self._digests.items()):
            trace.instant(f"digest.{name}", cat="digest", **d.summary())

    def reset(self, prefix: str | None = None) -> None:
        if prefix is None:
            self._digests = {}
        else:
            for k in [k for k in self._digests if k.startswith(prefix)]:
                del self._digests[k]


# The global registry (one process = one digest namespace).
digests = DigestRegistry()


def observe(name: str, x, *, lo: float, hi: float, n_buckets: int = 64) -> None:
    digests.observe(name, x, lo=lo, hi=hi, n_buckets=n_buckets)


def snapshot() -> dict[str, dict[str, Any]]:
    return digests.snapshot()


def reset(prefix: str | None = None) -> None:
    digests.reset(prefix)
