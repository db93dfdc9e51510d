"""Activation sharding constraints at layer boundaries.

The reference pins the batch and tensor axes of the residual stream and
the logits with `with_sharding_constraint`, because GSPMD loses them
through reshapes and remat.  The port computes each rank's share with
plain tensors: under a mesh a model's activations are this rank's rows
(its block of the batch) and pass through `constrain` unchanged.  A
DTensor is redistributed to the placements the symbolic dims name, so
a global-view caller gets the reference's layout.

`constrain(x, mesh, dims)` is a no-op without a mesh.  dims entries:
"batch" (the largest ("pod", "data") prefix dividing that dim),
"model" (when its extent divides the dim), or None.

Serving on a mesh, `rows_like` gives a rank's rows back the global view
of the DTensor they came from, and `row_token_ids` the flattened batch
indices of those rows, which key an analog leaf's read noise as the
unsharded forward keys them.
"""

from __future__ import annotations

import torch

from repro_torch.launch.mesh import axis_sizes

__all__ = ["constrain", "batch_axes_for", "batch_rows", "rows_like", "row_token_ids"]


def batch_axes_for(mesh, dim: int):
    """The largest prefix of ("pod", "data") whose extent divides `dim`."""
    sizes = axis_sizes(mesh)
    chosen, total = [], 1
    for a in ("pod", "data"):
        if a in sizes and dim % (total * sizes[a]) == 0:
            chosen.append(a)
            total *= sizes[a]
    return tuple(chosen) if chosen else None


def constrain(x: torch.Tensor, mesh, dims: tuple):
    """`x` laid out as `dims` say on `mesh`; a plain tensor (a rank's
    local block) and any tensor without a mesh pass through."""
    from repro_torch.distributed.sharding import NamedSharding, P, is_dtensor

    if mesh is None or not is_dtensor(x):
        return x
    sizes = axis_sizes(mesh)
    spec = []
    for i, d in enumerate(dims):
        if d == "batch":
            spec.append(batch_axes_for(mesh, x.shape[i]))
        elif d is None:
            spec.append(None)
        else:
            spec.append(d if x.shape[i] % sizes.get(d, 1) == 0 else None)
    return x.redistribute(mesh, NamedSharding(mesh, P(*spec)).placements)


def batch_rows(batch: dict, mesh) -> tuple[dict, tuple[str, ...]]:
    """(this rank's rows of the batch, the mesh axes its rows differ
    along): a DTensor batch by its placements (all leaves alike), a
    plain batch as the rank's rows already (no axes)."""
    from torch.distributed.tensor import Shard

    from repro_torch.distributed.sharding import is_dtensor

    rows, out = None, {}
    for key, v in batch.items():
        if not is_dtensor(v):
            out[key] = v
            continue
        axes = tuple(n for n, pl in zip(mesh.mesh_dim_names, v.placements)
                     if isinstance(pl, Shard))
        if any(isinstance(pl, Shard) and pl.dim != 0 for pl in v.placements):
            raise ValueError(f"batch[{key!r}] is split on a dim other than its rows")
        if rows is not None and axes != rows:
            raise ValueError(f"batch[{key!r}] rows split over {axes}, others over {rows}")
        rows, out[key] = axes, v.to_local()
    return out, rows or ()


def rows_like(x: torch.Tensor, ref, dim: int = 0):
    """The rank's rows `x` (its block of `ref`'s rows, on `x`'s dim
    `dim`) as a DTensor whose `dim` is laid out as `ref`'s dim 0."""
    from torch.distributed.tensor import Shard

    from repro_torch.distributed.sharding import contiguous_strides, from_local

    placements = tuple(Shard(dim) if isinstance(pl, Shard) and pl.dim == 0 else pl
                       for pl in ref.placements)
    shape = list(x.shape)
    shape[dim] = ref.shape[0]
    return from_local(x, ref.device_mesh, placements, torch.Size(shape),
                      contiguous_strides(shape))


def row_token_ids(ref, n_rows: int, seq: int):
    """(n_rows * seq,) int32 flattened batch indices of the rank's rows of
    `ref` (dim 0 split over mesh axes), or None when the rank holds
    every row."""
    from repro_torch.distributed.collectives import block_of
    from repro_torch.distributed.sharding import split_axes

    axes = split_axes(ref, 0)
    if not axes:
        return None
    first = block_of(ref.device_mesh, axes)[0] * n_rows
    return torch.arange(first * seq, (first + n_rows) * seq, dtype=torch.int32,
                        device=ref.to_local().device)
