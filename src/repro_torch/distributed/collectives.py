"""Collectives over a mesh's axes, and the two that autograd goes through.

Every collective here is an `all_reduce` or `all_gather` on the process
group of one mesh axis (`DeviceMesh.get_group(name)`), which NCCL and
gloo both provide; an axis set is reduced one axis after the other.

Inside a model, the ranks along "model" hold the same tokens and
compute the same loss; each adds only its own experts' partial output.
So, as in Megatron-LM's tensor-parallel regions:

* `reduce_from` sums a partial over the axes in the forward (or takes
  the mean of values the ranks computed alike) and passes the gradient
  through unchanged: the result feeds a computation that every rank
  repeats, whose gradient every rank already holds whole;
* `copy_to` is the identity in the forward and sums the gradient over
  the axes in the backward: what enters the rank's own share of the
  work gets back the gradient of every rank's share.

A plain `dist.all_reduce` has no backward, and
`torch.distributed.nn.functional.all_reduce` sums the gradient too,
which would count the one loss once per rank.

Each collective adds its result bytes, per op type and mesh axis, to the
open counters (`obs.work`).  On a `launch.mesh.AbstractMesh`
(meta tensors only) that is all it does: every rank's block is rank 0's,
so a reduction keeps its shape and a gather concatenates copies of it.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import AbstractMesh, axis_sizes
from repro_torch.obs import work

__all__ = ["all_reduce_axes", "all_gather_axes", "block_of", "reduce_from", "mean_over",
           "copy_to"]


def _abstract(x: torch.Tensor, mesh) -> bool:
    """Whether `mesh` is an `AbstractMesh`, which takes meta tensors only."""
    if not isinstance(mesh, AbstractMesh):
        return False
    if x.device.type != "meta":
        raise ValueError(f"a collective on an AbstractMesh takes meta tensors, "
                         f"got {x.device}")
    return True


def all_reduce_axes(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """`x` summed in place over each of the mesh axes in turn."""
    abstract = _abstract(x, mesh)
    for a in axes:
        if not abstract:
            dist.all_reduce(x, group=mesh.get_group(a))
        work.add_collective("all-reduce", a, x.numel() * x.element_size())
    return x


def all_gather_axes(x: torch.Tensor, mesh, axes: Sequence[str], dim: int = 0
                    ) -> torch.Tensor:
    """The blocks of `x` that the ranks along `axes` hold, concatenated on
    `dim` in block order (`axes` major first, as `block_of` numbers
    them): gathered over the minor axis first.  A concatenation, so
    every value is the rank's own, bit for bit."""
    abstract = _abstract(x, mesh)
    for a in reversed(tuple(axes)):
        x = x.contiguous()
        n = axis_sizes(mesh)[a]
        if abstract:
            parts = [x] * n
        else:
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x, group=mesh.get_group(a))
        work.add_collective("all-gather", a, n * x.numel() * x.element_size())
        x = torch.cat(parts, dim=dim)
    return x


def block_of(mesh, axes: Sequence[str]) -> tuple[int, int]:
    """(this rank's block index, the number of blocks) when a dim is split
    over `axes`, the first the major one."""
    sizes = axis_sizes(mesh)
    idx, n = 0, 1
    for a in axes:
        idx = idx * sizes[a] + mesh.get_local_rank(a)
        n *= sizes[a]
    return idx, n


def _extent(mesh, axes: Sequence[str]) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, mean):
        out = all_reduce_axes(x.clone(), mesh, axes)
        return out / _extent(mesh, axes) if mean else out

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_axes(grad.clone(), ctx.mesh, ctx.axes), None, None


def reduce_from(x: torch.Tensor, mesh, axes: Sequence[str],
                mean: bool = False) -> torch.Tensor:
    """Sum (or mean) over `axes`; the gradient passes through."""
    axes = tuple(axes)
    return _ReduceFrom.apply(x, mesh, axes, mean) if axes else x


def mean_over(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """Mean over `axes` of values the ranks computed each from its own
    rows; the gradient of each rank's share is 1 / n of the mean's."""
    axes = tuple(axes)
    return reduce_from(x, mesh, axes) / _extent(mesh, axes) if axes else x


def copy_to(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """Identity; the gradient is summed over `axes`."""
    axes = tuple(axes)
    return _CopyTo.apply(x, mesh, axes) if axes else x
