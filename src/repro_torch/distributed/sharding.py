"""Name-based parameter sharding rules and stored shards (logical -> mesh axes).

Rules map parameter path patterns to partition specs, as the reference's
`distributed/sharding.py` does (DESIGN.md Sec. 4): 2-D weights FSDP on
the input dim over "data" and TP on the output dim over "model", MoE
expert stacks EP over "model", embeddings vocab over "model".

A `PartitionSpec` is a tuple with one entry per tensor dim: `None`, an
axis name, or a tuple of axis names (one dim split over several mesh
axes, the first the major one), equal to ``tuple(jax.sharding.
PartitionSpec(...))`` for the same entries.  A `NamedSharding` (mesh +
spec) gives the DTensor placements that store it: mesh axis ``a`` holds
``Shard(d)`` when spec entry ``d`` names it, else ``Replicate()``; an
entry ``("pod", "data")`` puts ``Shard(d)`` on both, and DTensor splits
the dim over them in mesh order, the block of rank (p, q) being
``p * data + q`` as in JAX.

Stored shards are `DTensor`s.  `shard_tree` cuts each rank's block out
of a full tensor that every rank holds (no communication); `gather`
rebuilds full tensors from the blocks with `all_gather` over the mesh's
groups, minor axis first, so that only the collectives both NCCL and
gloo provide are used.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Sequence

import torch
import torch.distributed as dist

from repro_torch import pytree

__all__ = ["PartitionSpec", "P", "ShardingRules", "spec_for_path",
           "shard_params_tree", "NamedSharding", "is_dtensor", "local",
           "shard_tree", "sharding_of", "sharding_leaves", "gather", "gather_tree",
           "local_block"]


class PartitionSpec(tuple):
    """Per-dim mesh axes; a one-name tuple entry is the bare name, as
    JAX normalises it."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Ordered (regex, spec) pairs; first match wins."""

    rules: Sequence[tuple[str, PartitionSpec]]
    default: PartitionSpec = P()

    def spec(self, path: str) -> PartitionSpec:
        for pat, spec in self.rules:
            if re.search(pat, path):
                return spec
        return self.default


def spec_for_path(rules: ShardingRules, path: str) -> PartitionSpec:
    return rules.spec(path)


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (`DeviceMesh`, or `AbstractMesh` for layout only)."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard

        names = tuple(self.mesh.mesh_dim_names)
        where: dict[str, int] = {}
        for d, entry in enumerate(self.spec):
            axes = _axes(entry)
            idx = []
            for a in axes:
                if a not in names:
                    raise ValueError(f"spec {self.spec} names {a!r}, not an axis of "
                                     f"the mesh {names}")
                if a in where:
                    raise ValueError(f"spec {self.spec} uses axis {a!r} twice")
                where[a] = d
                idx.append(names.index(a))
            if idx != sorted(idx):
                raise ValueError(f"spec entry {entry} is not in mesh order {names}")
        return tuple(Shard(where[a]) if a in where else Replicate() for a in names)

    def shard(self, x: torch.Tensor):
        """The DTensor holding this rank's block of the full tensor `x`
        (every rank holds the same `x`; no communication)."""
        from torch.distributed.tensor import DTensor

        if len(self.spec) > x.ndim:
            raise ValueError(f"spec {self.spec} has more entries than a {x.ndim}-d tensor")
        placements = self.placements
        return DTensor.from_local(local_block(x, self.mesh, placements), self.mesh,
                                  placements, run_check=False, shape=x.shape,
                                  stride=x.stride())


def shard_params_tree(params: Any, mesh, rules: ShardingRules) -> Any:
    """`NamedSharding` tree matching `params` (trailing spec entries
    beyond a leaf's rank dropped)."""
    return pytree.unflatten(params, [
        NamedSharding(mesh, P(*rules.spec(path)[: getattr(leaf, "ndim", 0)]))
        for path, leaf in pytree.leaves_with_path(params)])


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def local(x):
    """This rank's block of a DTensor; a plain tensor as it is."""
    return x.to_local() if is_dtensor(x) else x


def local_block(x: torch.Tensor, mesh, placements,
                skip: tuple[str, ...] = ()) -> torch.Tensor:
    """This rank's block of the full tensor `x` under `placements`,
    cutting along every sharded mesh axis not in `skip`, major axis
    first."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    for i, (name, pl) in enumerate(zip(mesh.mesh_dim_names, placements)):
        if not isinstance(pl, Shard) or name in skip:
            continue
        n = mesh.size(i)
        if x.shape[pl.dim] % n:
            raise ValueError(f"dim {pl.dim} of {tuple(x.shape)} does not split over "
                             f"{n} ranks of {name!r}")
        chunk = x.shape[pl.dim] // n
        x = x.narrow(pl.dim, coord[i] * chunk, chunk)
    return x.contiguous()


def gather(x, keep: tuple[str, ...] = ()) -> torch.Tensor:
    """The full tensor of a DTensor, gathered over every sharded mesh
    axis not in `keep` (minor axis first); a plain tensor as it is.  An
    axis in `keep` stays split, which needs it alone on its tensor dim."""
    from torch.distributed.tensor import Shard

    if not is_dtensor(x):
        return x
    mesh, placements = x.device_mesh, x.placements
    t = x.to_local()
    names = mesh.mesh_dim_names
    for i in reversed(range(mesh.ndim)):
        pl = placements[i]
        if not isinstance(pl, Shard):
            continue
        if names[i] in keep:
            shared = [names[j] for j, q in enumerate(placements)
                      if j != i and isinstance(q, Shard) and q.dim == pl.dim]
            if shared:
                raise ValueError(f"cannot keep {names[i]!r} split: it shares dim "
                                 f"{pl.dim} with {shared}")
            continue
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(mesh.size(i))]
        dist.all_gather(parts, t, group=mesh.get_group(i))
        t = torch.cat(parts, dim=pl.dim)
    return t


def shard_tree(tree: Any, shardings: Any) -> Any:
    """Each leaf as the DTensor its `NamedSharding` says (a `None`
    sharding leaves the leaf as it is)."""
    return pytree.unflatten(tree, [
        s.shard(x) if s is not None else x
        for x, s in zip(pytree.leaves(tree), sharding_leaves(tree, shardings))])


def sharding_leaves(tree: Any, shardings: Any) -> list:
    """The sharding tree's leaves in the order of `tree`'s leaves (a
    `None` sharding stands for every leaf under it)."""
    out = []

    def walk(t, s):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], None if s is None else s[k])
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, None if s is None else s[i])
        elif t is not None:
            out.append(s)

    walk(tree, shardings)
    return out


def sharding_of(tree: Any) -> Any:
    """The tree's `NamedSharding`s, read off its DTensor leaves (None for
    a plain leaf); None when no leaf is a DTensor."""
    leaves = pytree.leaves(tree)
    if not any(is_dtensor(x) for x in leaves):
        return None
    return pytree.unflatten(tree, [
        NamedSharding(x.device_mesh, _spec_of(x)) if is_dtensor(x) else None
        for x in leaves])


def _spec_of(x) -> PartitionSpec:
    """The spec whose placements are `x`'s."""
    from torch.distributed.tensor import Shard

    entries: list[list[str]] = [[] for _ in range(x.ndim)]
    for name, pl in zip(x.device_mesh.mesh_dim_names, x.placements):
        if isinstance(pl, Shard):
            entries[pl.dim].append(name)
        elif not pl.is_replicate():
            raise ValueError(f"placement {pl} has no spec")
    return P(*(tuple(e) if e else None for e in entries))


def gather_tree(tree: Any) -> Any:
    """Every DTensor leaf gathered to its full tensor."""
    return pytree.tree_map(gather, tree)
