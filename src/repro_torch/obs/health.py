"""Per-tile health maps.

* **Device-side reduction**: `tile_reduce` sums per-column values into
  per-tile bins with one `index_add`.  The tile axis is small (columns /
  columns_per_tile), so the per-tile sums ride a host fetch the path
  already makes (the scrub's per-epoch health fetch).  The column->tile
  assignment comes from the deploy's physical column uids (host numpy),
  so routing it needs no device work.
* **Host-side registry**: `HealthRegistry` folds the fetched per-tile
  values into named maps (e.g. drift RMS per tile) and keeps scalar
  gauges (e.g. refresh debt).  Its inputs are host values: folding a
  live device tensor would be a hidden sync.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = ["tile_reduce", "HealthRegistry", "health"]


def tile_reduce(values: torch.Tensor, tile_inv, num_tiles: int) -> torch.Tensor:
    """Segment-sum per-column `values` into `num_tiles` tile bins.

    `tile_inv` is the host (numpy) column -> tile-slot index; it crosses
    to the device once, and the only device work is one `index_add`.
    """
    v = values.to(torch.float32).reshape(-1)
    idx = torch.as_tensor(np.asarray(tile_inv, np.int64)).to(v.device, non_blocking=True)
    return torch.zeros((int(num_tiles),), dtype=torch.float32,
                       device=v.device).index_add(0, idx, v)


class HealthRegistry:
    """Host-side per-tile health maps and scalar gauges.

    `fold_tiles` folds fetched per-tile values into a named map (one
    float per physical tile id); `set_gauge` overwrites a scalar.
    """

    def __init__(self):
        self._tiles: dict[str, dict[int, float]] = {}
        self._gauges: dict[str, float] = {}

    # ------------------------------------------------------------ tiles
    def fold_tiles(self, metric: str, tile_ids, values,
                   mode: str = "sum") -> None:
        m = self._tiles.setdefault(metric, {})
        for tid, v in zip(np.asarray(tile_ids), np.asarray(values)):
            tid, v = int(tid), float(v)
            if mode == "sum":
                m[tid] = m.get(tid, 0.0) + v
            elif mode == "max":
                m[tid] = max(m.get(tid, float("-inf")), v)
            elif mode == "last":
                m[tid] = v
            else:
                raise ValueError(f"unknown fold mode {mode!r}")

    def tiles(self, metric: str) -> dict[int, float]:
        return dict(self._tiles.get(metric, {}))

    def worst(self, metric: str, k: int = 8) -> list[tuple[int, float]]:
        m = self._tiles.get(metric, {})
        return sorted(m.items(), key=lambda kv: -kv[1])[:k]

    # ----------------------------------------------------------- gauges
    def set_gauge(self, name: str, value: float) -> None:
        self._gauges[name] = float(value)

    def gauge(self, name: str, default: float = 0.0) -> float:
        return self._gauges.get(name, default)

    # -------------------------------------------------------- reporting
    def snapshot(self) -> dict[str, Any]:
        """JSON-safe snapshot: tile maps keyed by stringified tile id."""
        return {
            "tiles": {
                metric: {str(t): v for t, v in sorted(m.items())}
                for metric, m in sorted(self._tiles.items())
            },
            "gauges": dict(sorted(self._gauges.items())),
        }

    def reset(self, prefix: str | None = None) -> None:
        if prefix is None:
            self._tiles = {}
            self._gauges = {}
        else:
            for d in (self._tiles, self._gauges):
                for k in [k for k in d if k.startswith(prefix)]:
                    del d[k]


# The global health registry (one process = one fleet view).
health = HealthRegistry()
