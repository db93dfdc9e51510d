"""Spare-column remapping and fault-aware placement (DESIGN.md Sec. 15).

The system's answer to unprogrammable cells is detection plus
redundancy, not endless retry.  The device samples faults
(`core.device.sample_fault_map`), the WV engine gives up on a cell
after a bounded pulse budget (`core.wv`), and this module decides where
weight lives:

* **Spare-column remapping**: each leaf provisions
  ``ceil(spare_frac * C)`` spare physical columns; after the primary
  programming pass the worst columns (by `WVStats.gave_up`) are
  re-targeted onto spares, and a `RemapTable` permutation makes served
  traffic and scrubs see the repaired geometry.  Every decision is a
  tensor op on the stats still on the device (gathers and scatters by
  index; no `nonzero`, no boolean-mask index, no `.item()`), so a remap
  adds no host sync to a deploy.
* **Fault-aware placement**: a factory probe of per-tile quality (the
  correlated fault-rate field `device.tile_quality`) ranks physical
  tiles, and sensitive leaves go onto the cleanest.  The probe is one
  small device->host copy before the first programming dispatch (a
  part ships with its known-bad-block map), so it is not a stream sync.

The permutation invariant: `RemapTable.perm` maps the C logical columns
onto C distinct physical rows of the (C + S)-row array, and `active`
marks exactly the image of `perm`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from . import device as dev_mod
from .types import FaultConfig

__all__ = [
    "RemapConfig",
    "RemapTable",
    "n_spares",
    "spare_candidates",
    "build_table",
    "identity_table",
    "apply_remap",
    "plan_placement",
]


@dataclasses.dataclass(frozen=True)
class RemapConfig:
    """Spare provisioning and placement policy.

    `min_gave_up`: a primary column is remapped only when at least this
    many of its cells gave up AND its spare programmed no worse.
    """

    spare_frac: float = 0.25        # spares per leaf as a fraction of C
    min_gave_up: int = 1
    placement: bool = False         # steer leaves away from bad tiles
    placement_provision: float = 2.0  # probed tiles / needed tiles

    def replace(self, **kw) -> "RemapConfig":
        return dataclasses.replace(self, **kw)


class RemapTable(NamedTuple):
    """Logical -> physical column view of one leaf's (C + S)-row array.

    perm:   (C,) int64 — logical column c is served by physical row
            ``perm[c]``: c where nothing moved, ``C + i`` for a column
            repaired onto spare i.
    active: (C + S,) bool — physical rows carrying live weight (exactly
            the image of `perm`); remapped-away primaries and unused
            spares are inactive, so scrubs skip them.
    """

    perm: torch.Tensor
    active: torch.Tensor


def n_spares(c: int, cfg: RemapConfig) -> int:
    """Spare columns provisioned for a C-column leaf (host-side)."""
    if cfg.spare_frac <= 0.0:
        return 0
    return max(1, min(c, math.ceil(cfg.spare_frac * c)))


def spare_candidates(gave_up: torch.Tensor, s: int) -> torch.Tensor:
    """The s worst primary columns by give-up count (on the device).

    Gave-up counts are small integers, so many columns tie: a stable
    sort of the negated counts resolves ties by column index.
    """
    return torch.argsort(-gave_up, stable=True)[:s]


def build_table(
    primary_gave_up: torch.Tensor,
    cand: torch.Tensor,
    spare_gave_up: torch.Tensor,
    min_gave_up: int = 1,
) -> RemapTable:
    """Decide the remap from the programming evidence (on the device).

    Candidate i (primary column ``cand[i]``) moves onto spare i iff the
    primary had >= `min_gave_up` unprogrammable cells and the spare
    programmed no worse (fewer or equal gave-up cells).
    """
    c = int(primary_gave_up.shape[0])
    s = int(cand.shape[0])
    dev = primary_gave_up.device
    sidx = torch.arange(s, dtype=torch.int64, device=dev)
    prim = primary_gave_up[cand]
    take = (prim >= float(min_gave_up)) & (spare_gave_up <= prim)
    perm = torch.arange(c, dtype=torch.int64, device=dev).index_copy(
        0, cand, torch.where(take, c + sidx, cand))
    active = (torch.ones((c + s,), dtype=torch.bool, device=dev)
              .index_copy(0, cand, ~take)
              .index_copy(0, c + sidx, take))
    return RemapTable(perm=perm, active=active)


def identity_table(c: int, s: int = 0, device="cuda") -> RemapTable:
    """No-op table: identity perm, spares (if any) inactive."""
    return RemapTable(
        perm=torch.arange(c, dtype=torch.int64, device=device),
        active=torch.cat([torch.ones((c,), dtype=torch.bool, device=device),
                          torch.zeros((s,), dtype=torch.bool, device=device)]),
    )


def apply_remap(x: torch.Tensor, table: RemapTable | None) -> torch.Tensor:
    """Physical (C + S, ...) tensor -> logical (C, ...) view."""
    if table is None:
        return x
    return x[table.perm]


def plan_placement(
    key: torch.Tensor,
    counts: Sequence[int],
    fault_cfg: FaultConfig,
    sensitivities: Sequence[float] | None = None,
    provision: float = 2.0,
) -> list[np.ndarray]:
    """Assign each leaf's physical column uids onto the cleanest tiles.

    Args:
      key: the deployment master key: `device.tile_quality` depends only
        on (key, tile id), so the probe sees the silicon the deploy's
        fault sampler will realize.
      counts: per-leaf physical column counts (primaries + spares).
      fault_cfg: fault population (geometry and correlated fields).
      sensitivities: per-leaf placement priority (higher = placed first,
        onto better tiles); default ``1 / count``.
      provision: probed tiles / needed tiles (> 1 gives placement real
        choices).

    Returns one int64 uid array per leaf (whole tiles, so a leaf's
    columns share tile fields with their own spares, not a neighbour's),
    on disjoint uid ranges.  The probe is one small device->host copy
    issued before any programming dispatch, and is not a pipeline sync
    (`pipeline.host_sync_count` does not count it).
    """
    counts = [int(c) for c in counts]
    if sensitivities is None:
        sensitivities = [1.0 / max(c, 1) for c in counts]
    assert len(sensitivities) == len(counts)
    cpt = fault_cfg.columns_per_tile
    tiles_needed = [max(1, -(-c // cpt)) for c in counts]
    total = sum(tiles_needed)
    n_avail = max(total, math.ceil(total * max(provision, 1.0)))
    # The factory probe: the per-tile fault-rate multiplier, fetched once.
    q = dev_mod.tile_quality(
        key, torch.arange(n_avail, dtype=torch.int64, device=key.device),
        fault_cfg).cpu().numpy()
    tile_order = np.argsort(q, kind="stable")  # cleanest first
    leaf_order = np.argsort(-np.asarray(sensitivities, dtype=np.float64),
                            kind="stable")
    uid_arrays: list[np.ndarray | None] = [None] * len(counts)
    t = 0
    for li in leaf_order:
        k = tiles_needed[li]
        tiles = np.sort(tile_order[t: t + k])
        t += k
        uid_arrays[li] = (tiles[:, None] * cpt + np.arange(cpt, dtype=np.int64)
                          ).reshape(-1)[: counts[li]].astype(np.int64)
    return uid_arrays  # type: ignore[return-value]
