"""Nested containers of tensors, flattened as `jax.tree_util` flattens them.

The port's one tree walker.  The training stack (`optim`, `training`,
`checkpoint`) works on whole trees: parameter dicts, `AdamWState` and
`TrainState` named tuples; `core.programmer.flatten_with_names` names a
deploy's leaves and `obs.metrics.fetch` gathers a tree's tensors with it.
Leaves come in the reference's pytree order — dict keys sorted, named
tuple fields and list items in order — and carry the reference's
`jax.tree_util.keystr` path: ``['layers']['wq']`` for dict keys, ``[0]``
for list and tuple items, ``.opt`` for named tuple fields.  A checkpoint
keyed by these paths restores in either package.  `None` is an empty
subtree, as in JAX.
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["leaves_with_path", "leaves", "unflatten", "tree_map"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_path(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(keystr path, leaf) pairs in the reference's order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves_with_path(tree[k], f"{prefix}[{k!r}]")
        return out
    if _is_namedtuple(tree):
        out = []
        for name, v in zip(tree._fields, tree):
            out += leaves_with_path(v, f"{prefix}.{name}")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += leaves_with_path(v, f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def leaves(tree: Any) -> list[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def unflatten(tree: Any, values) -> Any:
    """`tree`'s structure with its leaves replaced, in order, by `values`."""
    it = iter(values)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            new = {k: build(t[k]) for k in sorted(t)}
            return {k: new[k] for k in t}  # keep the caller's key order
        if _is_namedtuple(t):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more values than the tree has leaves")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of `tree` and the matching leaves of `rest`
    (trees of the same structure)."""
    others = [leaves(r) for r in rest]
    base = leaves(tree)
    if any(len(o) != len(base) for o in others):
        raise ValueError("tree_map over trees of different structures")
    return unflatten(tree, [fn(*args) for args in zip(base, *others)])
