"""Crossbar macro tiling: packed WV columns -> inference operand planes.

The WV engine programs verify columns: (C, N) rows of N cells sharing
one TIA/ADC (quant/pack layout).  Inference reads the same cells along
the orthogonal axis: a vector-matrix multiply drives the array's K input
rows and senses every signed column pair at once.  This module re-views
the programmed `ArrayState` conductances in the inference layout:

    packed columns (C, N)
      -> per-slice signed planes  g_pos/g_neg : (S, K, M)   (slice_planes)
      -> macro tiles of <= `macro_rows` rows : (T, S, R, M) (tile_planes)

Pack padding rows (K..K_padded) are dropped as `materialize()` drops
them; tile padding rows are zero conductance and are driven with zero
input, so they add nothing to any partial sum.

A stacked per-layer leaf (L, d, M) gets a leading L axis on every
tensor field (tiles, scale, key, layer id); `CIMWeight.layer(idx)`
slices one layer out, as the forward slices a dense leaf ``a[idx]``.
Served on a mesh (`launch.shardings.shard_cim_weight`) the fields are
DTensors, the tiles and the scale split on their output axis M, and a
sliced layer keeps that layout.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.quant.pack import PackedLayout

__all__ = ["CIMWeight", "slice_planes", "tile_planes", "broadcast_key",
           "build_weight", "rekey"]


@dataclasses.dataclass
class CIMWeight:
    """One weight leaf living on crossbar macro tiles.

    Tensor fields (all lead with L for stacked leaves):
      g_pos/g_neg : ([L,] T, S, R, M) per-tile signed conductance planes
      scale       : ([L,] M) per-output-channel dequantization scale
      key         : ([L,] 2) per-access read-noise key, the same key
                    broadcast over L
      layer_id    : ([L,]) int32 layer index of stacked leaves (folded
                    into the noise stream after slicing); None for 2-D
    Static fields:
      rows_in : real input rows per layer (before tile padding)
      bc      : bits per cell (slice recombination weight base)
      levels  : cell levels (ADC full scale in LSB units)
      cfg     : CIMConfig (consumed by mvm.cim_matmul)
      name    : leaf name (diagnostics)
      uid     : executor leaf uid folded into the noise stream (None =
                no uid sub-stream, for direct `build_weight` users)
    """

    g_pos: torch.Tensor
    g_neg: torch.Tensor
    scale: torch.Tensor
    key: torch.Tensor
    layer_id: torch.Tensor | None = None
    rows_in: int = 0
    bc: int = 0
    levels: int = 0
    cfg: Any = None
    name: str = ""
    uid: int | None = None

    @property
    def n_tiles(self) -> int:
        return self.g_pos.shape[-4]

    @property
    def n_slices(self) -> int:
        return self.g_pos.shape[-3]

    @property
    def tile_rows(self) -> int:
        return self.g_pos.shape[-2]

    @property
    def n_outputs(self) -> int:
        return self.g_pos.shape[-1]

    @property
    def stacked_layers(self) -> int:
        """Leading per-layer stack size (1 for a plain 2-D leaf)."""
        return self.g_pos.shape[0] if self.g_pos.ndim == 5 else 1

    def layer(self, idx: int) -> "CIMWeight":
        """Layer `idx` of a stacked leaf: every tensor field indexed."""
        if self.g_pos.ndim != 5:
            raise ValueError(f"CIMWeight {self.name!r} is not a layer stack")
        return dataclasses.replace(
            self, g_pos=_index(self.g_pos, idx), g_neg=_index(self.g_neg, idx),
            scale=_index(self.scale, idx), key=_index(self.key, idx),
            layer_id=_index(self.layer_id, idx),
        )


def _index(x: torch.Tensor, idx: int) -> torch.Tensor:
    """``x[idx]`` on the leading (layer) axis.  A DTensor (never split on
    that axis) is indexed in its local block and stays a DTensor with
    its placements moved down one dim."""
    from repro_torch.distributed.sharding import is_dtensor

    if not is_dtensor(x):
        return x[idx]
    from torch.distributed.tensor import DTensor, Shard

    placements = tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p
                       for p in x.placements)
    shape = x.shape[1:]
    return DTensor.from_local(x.to_local()[idx], x.device_mesh, placements,
                              run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def slice_planes(columns: torch.Tensor,
                 layout: PackedLayout) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed verify columns (C, N) -> signed slice planes (S, K, M).

    The inverse view of `quant.pack.pack_columns` with polarity and slice
    axes kept apart: programming error on any cell lands on the same
    (slice, row, output) the inference VMM reads.  Pack padding rows are
    dropped.
    """
    kp, n = layout.k_padded, layout.n_cells
    cells = columns.reshape(kp // n, layout.m_out, 2, layout.slices, n)
    cells = torch.movedim(cells, -1, 1).reshape(kp, layout.m_out, 2, layout.slices)
    planes = cells.permute(3, 0, 1, 2)[:, : layout.k_in]  # (S, K, M, 2)
    return planes[..., 0].contiguous(), planes[..., 1].contiguous()


def tile_planes(
    g_pos: torch.Tensor,
    g_neg: torch.Tensor,
    macro_rows: int,
    n_layers: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-partition slice planes (S, K, M) into <= `macro_rows` macro tiles.

    Returns contiguous ([L,] T, S, R, M) pairs.  With `n_layers` the K
    axis is first split into L per-layer row groups of d = K/L rows
    (layer idx owns rows [idx*d, (idx+1)*d)), each tiled on its own so a
    sliced layer is a self-contained macro set.
    """
    s, k, m = g_pos.shape
    if n_layers is None:
        r = min(macro_rows, k)
        n_t = -(-k // r)
        pad = n_t * r - k

        def _tile(g):
            if pad:
                g = F.pad(g, (0, 0, 0, pad))
            return g.reshape(s, n_t, r, m).movedim(1, 0).contiguous()

        return _tile(g_pos), _tile(g_neg)
    if k % n_layers:
        raise ValueError(
            f"stacked tiling needs K divisible by the layer stack: "
            f"{k} rows over {n_layers} layers")
    d = k // n_layers
    r = min(macro_rows, d)
    n_t = -(-d // r)
    pad = n_t * r - d

    def _tile_stacked(g):
        g = g.reshape(s, n_layers, d, m)
        if pad:
            g = F.pad(g, (0, 0, 0, pad))
        g = g.reshape(s, n_layers, n_t, r, m)
        return g.permute(1, 2, 0, 3, 4).contiguous()  # (L, T, S, R, M)

    return _tile_stacked(g_pos), _tile_stacked(g_neg)


def broadcast_key(key: torch.Tensor, n_layers: int | None) -> torch.Tensor:
    """One key per stacked layer (a view, no fold: the layer sub-stream
    comes from folding `layer_id`).  None = 2-D leaf: the key as is."""
    if n_layers is None:
        return key
    return key.expand(n_layers, *key.shape)


def build_weight(state, cfg: Any, key: torch.Tensor, name: str = "",
                 uid: int | None = None) -> CIMWeight:
    """Re-view one programmed `ArrayState` as inference macro tiles.

    A 3-D leaf (L, d, M), a layer stack, gets a leading L axis on every
    tensor field: per-layer tiles, broadcast scale, the key broadcast per
    layer, and a `layer_id` arange whose sliced value folds the layer
    sub-stream into the noise key.  Other shapes tile the flattened
    (K, M) view.  Rebuilding after `g` changed re-views the new
    conductances.  `uid` is the executor's per-leaf noise sub-stream id.

    A state carrying a spare-column `RemapTable` holds PHYSICAL (C + S)
    rows; served traffic sees the repaired logical geometry, so the
    ``g[remap.perm]`` gather comes before the slice re-view.
    """
    layout: PackedLayout = state.layout
    g = state.g
    remap = getattr(state, "remap", None)
    if remap is not None:
        g = g[remap.perm]
    g_pos, g_neg = slice_planes(g, layout)
    dev = g_pos.device
    if len(state.shape) == 3:
        n_layers = int(state.shape[0])
        if g_pos.shape[1] % n_layers:
            raise ValueError(
                f"leaf {name!r}: {g_pos.shape[1]} packed input rows do not "
                f"split over a {n_layers}-layer stack (state shape "
                f"{tuple(state.shape)})")
        g_pos, g_neg = tile_planes(g_pos, g_neg, cfg.macro_rows, n_layers)
        scale = state.scale.reshape(1, -1).to(torch.float32).expand(
            n_layers, layout.m_out)
        keys = broadcast_key(key, n_layers)
        layer_id = torch.arange(n_layers, dtype=torch.int32, device=dev)
        rows_in = int(state.shape[1])
    else:
        g_pos, g_neg = tile_planes(g_pos, g_neg, cfg.macro_rows)
        scale = state.scale.reshape(-1).to(torch.float32)
        keys = key
        layer_id = None
        rows_in = layout.k_in
    return CIMWeight(
        g_pos=g_pos, g_neg=g_neg, scale=scale, key=keys, layer_id=layer_id,
        rows_in=rows_in, bc=layout.bc, levels=1 << layout.bc, cfg=cfg,
        name=name, uid=uid,
    )


def rekey(w: CIMWeight, key: torch.Tensor) -> CIMWeight:
    """Swap the read-noise key: one broadcast, no per-layer fold."""
    n_layers = w.g_pos.shape[0] if w.g_pos.ndim == 5 else None
    return dataclasses.replace(w, key=broadcast_key(key, n_layers))
