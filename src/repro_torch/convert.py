"""Carry the reference's weights and keys across to the port.

`params_from_numpy` takes a nested dict of numpy arrays (the reference's
params after ``jax.tree.map(np.asarray, params)``) and returns the
port's tensors.  The reference's bf16 comes out of numpy as an
``ml_dtypes.bfloat16`` array, which `torch.from_numpy` refuses, so it
crosses as its uint16 bit pattern.  `key_from_numpy` carries a raw
``uint32[2]`` threefry key (or a batch of them).  `deployed_from_numpy`
carries a whole deployment (programmed conductances and all), so the two
packages can serve the same arrays without deploying twice.
`train_state_from_numpy` carries training state (params and AdamW
moments) across, and `tree_to_numpy` carries any tree of the port's
tensors back.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = ["params_from_numpy", "key_from_numpy", "tensor_from_numpy",
           "deployed_from_numpy", "cell_state_from_numpy",
           "train_state_from_numpy", "tensor_to_numpy", "tree_to_numpy"]

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32, "float64": torch.float64}


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    # np.array(order="C") copies and keeps a 0-d array 0-d, where
    # np.ascontiguousarray would make it (1,).
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """Nested dict/list/tuple of numpy arrays -> same tree of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return tensor_from_numpy(tree, device)


def key_from_numpy(key, device="cuda") -> torch.Tensor:
    """Raw uint32 key(s) of shape (..., 2) -> the port's int64 key tensor."""
    k = np.asarray(key)
    if k.shape[-1] != 2 or k.dtype != np.uint32:
        raise ValueError(f"expected uint32[..., 2] key data, got {k.dtype}{k.shape}")
    return torch.from_numpy(k.astype(np.int64)).to(device)


def _uids(st) -> np.ndarray | None:
    u = st.get("uids") if isinstance(st, dict) else getattr(st, "uids", None)
    return None if u is None else np.asarray(u, np.int64).copy()


def deployed_from_numpy(tree: Any, arrays: dict[str, Any], wv_cfg=None,
                        cost=None, device="cuda"):
    """Carry the reference's `DeployedModel` across to the port.

    Args:
      tree: the deployed parameter tree with numpy leaves (e.g. the
        reference's ``materialize()`` through ``np.asarray``); the leaves
        that `arrays` names are ignored, every other leaf is a digital
        leaf, carried verbatim.
      arrays: leaf name (``['layers']['wq']``) -> mapping with the
        `ArrayState` fields ``g``, ``targets``, ``d2d``, ``scale`` (numpy),
        ``layout`` (mapping or object with ``k_in, m_out, n_cells,
        slices, bc``), ``shape``, ``dtype`` (numpy dtype or name) and,
        optionally, ``uids`` (the physical column uids, host numpy),
        ``fault`` (a `FaultMap`'s ``stuck, stuck_g, efficiency``) and
        ``remap`` (a `RemapTable`'s ``perm, active``), each a mapping or
        an object with those fields, so both packages hold the same
        silicon.
      wv_cfg, cost: the deployment's `WVConfig` / `CircuitCost`
        (defaults if None).
    """
    from repro_torch.core.cost import CircuitCost
    from repro_torch.core.device import FaultMap
    from repro_torch.core.programmer import (
        ArrayState,
        DeployedModel,
        flatten_with_names,
        names_tree,
    )
    from repro_torch.core.remap import RemapTable
    from repro_torch.core.types import WVConfig
    from repro_torch.quant.pack import PackedLayout

    def field(obj, name):
        return obj[name] if isinstance(obj, dict) else getattr(obj, name)

    def optional(obj, name, cls, dtypes):
        sub = obj.get(name) if isinstance(obj, dict) else getattr(obj, name, None)
        if sub is None:
            return None
        return cls(*(tensor_from_numpy(np.asarray(field(sub, f)).astype(d), device)
                     for f, d in zip(cls._fields, dtypes)))

    states = {}
    for name, st in arrays.items():
        lay = field(st, "layout")
        layout = PackedLayout(*(int(field(lay, f)) for f in
                                ("k_in", "m_out", "n_cells", "slices", "bc")))
        states[name] = ArrayState(
            g=tensor_from_numpy(field(st, "g"), device),
            targets=tensor_from_numpy(field(st, "targets"), device),
            d2d=tensor_from_numpy(field(st, "d2d"), device),
            scale=tensor_from_numpy(field(st, "scale"), device),
            layout=layout,
            shape=tuple(int(d) for d in field(st, "shape")),
            dtype=_DTYPES[np.dtype(field(st, "dtype")).name],
            uids=_uids(st),
            fault=optional(st, "fault", FaultMap, (bool, np.float32, np.float32)),
            remap=optional(st, "remap", RemapTable, (np.int64, bool)),
        )
    digital = {name: tensor_from_numpy(leaf, device)
               for name, leaf in flatten_with_names(tree) if name not in states}
    return DeployedModel(names=names_tree(tree), digital=digital, arrays=states,
                         wv_cfg=wv_cfg or WVConfig(), cost=cost or CircuitCost())


def cell_state_from_numpy(state, device="cuda"):
    """Carry the reference's lifetime `CellState` (numpy leaves, or any
    object with its fields) across to the port's `lifetime.CellState`."""
    from repro_torch.lifetime.drift import CellState

    def field(name):
        return state[name] if isinstance(state, dict) else getattr(state, name)

    return CellState(**{f: tensor_from_numpy(field(f), device)
                        for f in CellState._fields})


def train_state_from_numpy(state, device="cuda"):
    """Carry the reference's `TrainState` (numpy leaves, e.g. through
    ``jax.tree.map(np.asarray, state)``) across to the port's: any object
    or mapping with ``params`` and ``opt``, whose ``opt`` has ``step``,
    ``m`` and ``v``."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.training import TrainState

    def field(obj, name):
        return obj[name] if isinstance(obj, dict) else getattr(obj, name)

    opt = field(state, "opt")
    return TrainState(
        params=params_from_numpy(field(state, "params"), device),
        opt=AdamWState(
            step=tensor_from_numpy(np.asarray(field(opt, "step"), np.int32), device),
            m=params_from_numpy(field(opt, "m"), device),
            v=params_from_numpy(field(opt, "v"), device),
        ),
    )


def tensor_to_numpy(x) -> np.ndarray:
    """A tensor (or array-like) as a numpy array on the host.  numpy has
    no bfloat16, so a bf16 tensor comes out widened to float32, which is
    exact: cast it back on the other side (``jnp.asarray(a, jnp.bfloat16)``)."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach().cpu()
    return (x.to(torch.float32) if x.dtype == torch.bfloat16 else x).numpy()


def tree_to_numpy(tree: Any) -> Any:
    """The same tree (dicts, lists, tuples, named tuples) with numpy
    leaves on the host, each by `tensor_to_numpy`."""
    from repro_torch import pytree

    return pytree.tree_map(tensor_to_numpy, tree)
