"""Per-tile health maps and declarative fleet SLO rules.

* **Device-side reduction**: `tile_reduce` / `tile_deploy_stats` sum
  per-column values into per-tile bins: one `index_add` each on the
  CPU, and on the card a sum in a fixed order (`tile_reduce_fixed`),
  so that two equal deploys give the same bits.  The
  tile axis is small (columns / columns_per_tile), so the per-tile sums
  ride a host fetch the path already makes: the deploy's one fetch
  (`DeployReport.collect`) and the scrub's per-epoch health fetch.  The
  column->tile assignment comes from the deploy's physical column uids
  (host numpy), so routing it needs no device work beyond the index.
* **Host-side registry**: `HealthRegistry` folds the fetched per-tile
  values into named maps (give-up density, retry pulses, drift RMS,
  remapped columns) and keeps scalar gauges (refresh debt, tokens
  served).  Its inputs are host values: folding a live device tensor
  would be a hidden sync.  `emit` mirrors the maps into the trace.
* **Host-side policy**: `SLORule` / `SLOPolicy` evaluate declarative
  ceilings against a `fleet_status()` snapshot, emitting ``cat="slo"``
  trace instants on breach and bumping ``slo.breaches.*`` counters
  (contract-bearing: not gated on anything).

The dashboard (`repro_torch.obs.dashboard`) only reads exported files.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

__all__ = [
    "tile_reduce",
    "tile_reduce_fixed",
    "tile_deploy_stats",
    "HealthRegistry",
    "health",
    "SLORule",
    "SLOPolicy",
    "fleet_status",
    "resolve_metric",
]


def tile_reduce(values: torch.Tensor, tile_inv, num_tiles: int,
                width: int | None = None) -> torch.Tensor:
    """Segment-sum per-column `values` into `num_tiles` tile bins.

    `tile_inv` is the column -> tile-slot index: host numpy, which
    crosses to the device once, or a tensor already there.  On the CPU
    the device work is one `index_add`.  On the card an `index_add` is
    a float atomic per column, which sums in arrival order, so two equal
    calls could differ in the last bits: there the sums go through
    `tile_reduce_fixed`, in a fixed order.  That needs `width`, the most
    columns of any tile, from the host: pass it with a device index (it
    is read off a host index), so that no sync is needed to size it.
    """
    v = values.to(torch.float32).reshape(-1)
    if not isinstance(tile_inv, torch.Tensor):
        host = np.asarray(tile_inv, np.int64)
        if width is None and v.device.type != "cpu":
            width = int(np.bincount(host, minlength=1).max()) if host.size else 0
        tile_inv = torch.as_tensor(host)
    idx = tile_inv.to(v.device, non_blocking=True)
    if v.device.type == "cpu":
        return torch.zeros((int(num_tiles),), dtype=torch.float32,
                           device=v.device).index_add(0, idx, v)
    if width is None:
        raise ValueError("tile_reduce on the card needs `width` (the most columns "
                         "of any tile) with a device index: sizing it would sync")
    return tile_reduce_fixed(v, idx, num_tiles, width)


def tile_reduce_fixed(values: torch.Tensor, idx: torch.Tensor, num_tiles: int,
                      width: int) -> torch.Tensor:
    """`tile_reduce` in a fixed order, with no atomics: each tile's
    columns, in column order, are placed in one row of a (num_tiles,
    width) zero-padded matrix (a stable sort of the index and one
    scatter to distinct places), and each row is summed.  The same
    inputs give the same bits on every call."""
    v = values.to(torch.float32).reshape(-1)
    n_tiles = int(num_tiles)
    order = torch.argsort(idx, stable=True)
    tiles = idx[order]
    first = torch.searchsorted(tiles, torch.arange(n_tiles, dtype=tiles.dtype,
                                                   device=tiles.device))
    slot = torch.arange(tiles.numel(), device=tiles.device) - first[tiles]
    padded = torch.zeros((n_tiles, int(width)), dtype=torch.float32, device=v.device)
    padded[tiles, slot] = v[order]
    return torch.sum(padded, dim=1)


def _uid_run(uids: np.ndarray) -> int | None:
    """The first uid when `uids` is one contiguous ascending run, else None."""
    if uids.size and (uids.size == 1 or bool(np.all(np.diff(uids) == 1))):
        return int(uids[0])
    return None


def _tile_index(uids_list: list[np.ndarray], cpt: int, device
                ) -> tuple[np.ndarray, torch.Tensor, np.ndarray]:
    """(tile_ids, column -> tile-slot index on `device`, columns per tile).

    Equal to ``np.unique(concat(uids) // cpt, return_inverse=True)`` and
    its bincount.  A leaf whose uids form one contiguous run (every
    deploy without fault-aware placement) spans a contiguous range of
    tiles, which are consecutive in the sorted `tile_ids`: its slots are
    an `arange` built on the device and its counts arithmetic, so no
    host sort runs over its columns.  Other leaves go through the host.
    """
    runs = [_uid_run(u) for u in uids_list]
    parts = [np.arange(u0 // cpt, (u0 + u.size - 1) // cpt + 1) if u0 is not None
             else np.unique(u // cpt) for u, u0 in zip(uids_list, runs)]
    tile_ids = np.unique(np.concatenate(parts)) if parts else np.zeros((0,), np.int64)
    columns = np.zeros(tile_ids.shape, np.float64)
    inv = []
    for u, u0 in zip(uids_list, runs):
        if u.size == 0:
            continue
        if u0 is not None:
            t = np.arange(u0 // cpt, (u0 + u.size - 1) // cpt + 1)
            off = int(np.searchsorted(tile_ids, t[0]))
            columns[off: off + t.size] += (np.minimum(u0 + u.size, (t + 1) * cpt)
                                           - np.maximum(u0, t * cpt))
            inv.append(torch.div(torch.arange(u0, u0 + u.size, device=device),
                                 cpt, rounding_mode="floor") - (int(t[0]) - off))
        else:
            slots = np.searchsorted(tile_ids, u // cpt)
            columns += np.bincount(slots, minlength=tile_ids.size)
            host = torch.from_numpy(slots.astype(np.int64))
            if torch.device(device).type == "cuda":
                host = host.pin_memory()
            inv.append(host.to(device, non_blocking=True))
    idx = torch.cat(inv) if inv else torch.zeros((0,), dtype=torch.int64, device=device)
    return tile_ids.astype(np.int64), idx, columns


def tile_deploy_stats(
    stats_map: Mapping[str, Any],
    uids_map: Mapping[str, np.ndarray],
    columns_per_tile: int,
    extra_columns: Mapping[str, Mapping[str, Any]] | None = None,
) -> tuple[np.ndarray, dict[str, Any]]:
    """Per-tile deployment health reductions (on the device).

    Returns ``(tile_ids, device_tree)``: `tile_ids` is the host numpy
    array of physical tile ids in this deploy, and `device_tree` maps
    metric name -> per-tile float32 tensor (same order), plus
    ``"columns"``, the columns per tile (host numpy).  The caller
    appends `device_tree` to a fetch it already makes; nothing here
    synchronizes.  `stats_map` values are `WVStats`-shaped (gave_up /
    retry_pulses / write_pulses / reads / rms_error_lsb per column);
    `uids_map` holds each leaf's physical column uids.  `extra_columns`
    adds per-column vectors (metric -> leaf name -> (C,) tensor) reduced
    with the same tile assignment, e.g. the spare deploy's per-column
    remapped flags.
    """
    names = [n for n in stats_map if n in uids_map]
    if not names:
        return np.zeros((0,), np.int64), {}
    device = stats_map[names[0]].gave_up.device
    tile_ids, inv, columns = _tile_index(
        [np.asarray(uids_map[n], np.int64) for n in names], int(columns_per_tile), device)
    n_tiles = int(tile_ids.shape[0])
    width = int(columns.max()) if columns.size else 0

    def cat(attr):
        return torch.cat([getattr(stats_map[n], attr).reshape(-1) for n in names])

    tree = {
        "gave_up_cells": tile_reduce(cat("gave_up"), inv, n_tiles, width),
        "retry_pulses": tile_reduce(cat("retry_pulses"), inv, n_tiles, width),
        "write_pulses": tile_reduce(cat("write_pulses"), inv, n_tiles, width),
        "verify_reads": tile_reduce(cat("reads"), inv, n_tiles, width),
        "err2_sum": tile_reduce(cat("rms_error_lsb") ** 2, inv, n_tiles, width),
    }
    for metric, leaf_vecs in (extra_columns or {}).items():
        tree[metric] = tile_reduce(
            torch.cat([leaf_vecs[n].reshape(-1) for n in names]), inv, n_tiles, width)
    tree["columns"] = columns
    return tile_ids, tree


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

    def emit(self) -> None:
        """Mirror the health maps into the trace as ``cat="health"``
        instants (per-metric summary + worst tiles), so the dashboard
        reads them from the exported trace."""
        from . import trace

        for metric, m in sorted(self._tiles.items()):
            vals = np.array(list(m.values()), np.float64)
            trace.instant(
                f"health.{metric}", cat="health",
                n_tiles=len(m),
                total=float(vals.sum()) if len(m) else 0.0,
                max=float(vals.max()) if len(m) else 0.0,
                worst={str(t): v for t, v in self.worst(metric)},
            )
        for name, v in sorted(self._gauges.items()):
            trace.instant(f"health.gauge.{name}", cat="health", value=v)

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


# ------------------------------------------------------------- SLOs
def resolve_metric(status: Mapping[str, Any], path: str):
    """Resolve a dotted metric path against a nested status dict.

    Key names themselves contain dots ("serve.latency_steps"), so
    resolution tries the longest matching key prefix at every level;
    missing paths resolve to None (a rule on an absent metric does not
    breach: it reports value None).
    """
    if not path:
        return status
    if not isinstance(status, Mapping):
        return None
    if path in status:
        return status[path]
    parts = path.split(".")
    for i in range(len(parts) - 1, 0, -1):
        head = ".".join(parts[:i])
        if head in status:
            return resolve_metric(status[head], ".".join(parts[i:]))
    return None


@dataclasses.dataclass(frozen=True)
class SLORule:
    """One declarative service-level objective: `metric <= ceiling`.

    `metric` is a dotted path into the `fleet_status()` dict, e.g.
    ``digests.serve.latency_steps.p99`` or
    ``counters.deploy.gave_up_cells``.
    """

    name: str
    metric: str
    ceiling: float

    def evaluate(self, status: Mapping[str, Any]) -> dict[str, Any]:
        v = resolve_metric(status, self.metric)
        value = float(v) if isinstance(v, (int, float)) else None
        return {
            "name": self.name,
            "metric": self.metric,
            "ceiling": float(self.ceiling),
            "value": value,
            "breached": value is not None and value > self.ceiling,
        }


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """A set of SLO rules evaluated on the host against a status snapshot.

    Evaluation is pure host work on fetched floats; a breach emits a
    ``cat="slo"`` trace instant and bumps ``slo.breaches.<rule>``.
    """

    rules: tuple[SLORule, ...]

    def evaluate(self, status: Mapping[str, Any],
                 emit: bool = True, **context: Any) -> list[dict[str, Any]]:
        from . import metrics, trace

        results = []
        for rule in self.rules:
            res = rule.evaluate(status)
            res.update(context)
            results.append(res)
            if res["breached"]:
                metrics.registry.inc(f"slo.breaches.{rule.name}")
                if emit:
                    trace.instant(
                        f"slo.breach.{rule.name}", cat="slo",
                        **{k: v for k, v in res.items() if k != "name"},
                    )
        metrics.registry.inc("slo.evaluations")
        return results


def fleet_status(extra: Mapping[str, Any] | None = None) -> dict[str, Any]:
    """Machine-readable fleet snapshot joining every obs namespace.

    The SLO evaluation input: digest percentile summaries, per-tile
    health maps, gauges and the counter registry; host floats, JSON-safe,
    no device work.
    """
    from . import digest, metrics

    status: dict[str, Any] = {
        "digests": digest.snapshot(),
        "health": health.snapshot(),
        "counters": metrics.snapshot(),
    }
    if extra:
        status.update(extra)
    return status
