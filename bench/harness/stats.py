"""Window arithmetic: percentiles and per-request latencies from host
timestamps (seconds on one monotonic clock)."""

from __future__ import annotations

import numpy as np


def p95(values) -> float | None:
    """The 95th percentile (linear between order statistics)."""
    v = np.asarray(list(values), dtype=np.float64)
    return float(np.percentile(v, 95)) if v.size else None


def ttfts(requests) -> list[float]:
    """Send to first token, of every request that got one."""
    return [r["first"] - r["sent"] for r in requests if r.get("first") is not None]


def tpots(requests) -> list[float]:
    """(last token - first token) / (tokens - 1) of every completed
    request with two tokens or more."""
    return [(r["done"] - r["first"]) / (r["n"] - 1) for r in requests
            if r.get("done") is not None and r["n"] > 1]
