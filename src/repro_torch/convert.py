"""Carry the reference's weights and keys across to the port.

`params_from_numpy` takes a nested dict of numpy arrays (the reference's
params after ``jax.tree.map(np.asarray, params)``) and returns the
port's tensors.  The reference's bf16 comes out of numpy as an
``ml_dtypes.bfloat16`` array, which `torch.from_numpy` refuses, so it
crosses as its uint16 bit pattern.  `key_from_numpy` carries a raw
``uint32[2]`` threefry key (or a batch of them).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = ["params_from_numpy", "key_from_numpy", "tensor_from_numpy"]


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
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
