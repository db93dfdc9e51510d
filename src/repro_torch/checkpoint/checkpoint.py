"""Atomic, async checkpoints in the reference's on-disk format.

A checkpoint is a directory ``step_<n:08d>/`` holding one ``.npy`` per
leaf (``leaf_<i:05d>.npy``, in the reference's pytree order) and a
``manifest.json`` mapping each leaf's `jax.tree_util.keystr` path to its
file, shape and dtype.  It is written to ``step_<n>.tmp/`` and renamed
only after the manifest is fsynced, so a crashed save never shadows a
good checkpoint.  numpy has no bfloat16, so bf16 leaves are stored
widened to float32 (exactly) with ``"bfloat16"`` in the manifest, as the
reference stores them.  So either package restores what the other wrote.

`CheckpointManager.save(..., blocking=False)` copies the tree to host
memory on the caller's thread (the point that must be consistent with
the step) and writes it on a background thread.

A sharded tree (DTensor leaves, one block per rank) is saved whole: every
rank gathers the full arrays on the caller's thread, before any write
starts, rank 0 writes them, and every rank waits at a barrier for that
write when the manager next waits (before a restore or the next save).
`restore_checkpoint(..., sharding_tree=)` cuts each rank's block of the
full arrays on the mesh the sharding tree names, which may differ in
shape from the mesh that saved them (elastic restore).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.convert import tensor_to_numpy
from repro_torch.distributed.sharding import gather, is_dtensor, sharding_leaves

__all__ = ["save_checkpoint", "latest_step", "restore_checkpoint",
           "CheckpointManager"]

_MANIFEST = "manifest.json"


def _to_savable(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a numpy array numpy can save, and its true dtype name."""
    arr = tensor_to_numpy(leaf)
    if isinstance(leaf, torch.Tensor):
        return arr, str(leaf.dtype).removeprefix("torch.")
    return arr, str(arr.dtype)


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    """Blocking atomic save; returns the final checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": {}}
    for i, (key, leaf) in enumerate(pytree.leaves_with_path(tree)):
        fname = f"leaf_{i:05d}.npy"
        arr, orig_dtype = _to_savable(leaf)
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = {
            "file": fname,
            "shape": list(arr.shape),
            "dtype": orig_dtype,
        }
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _steps(directory: str) -> list[int]:
    return sorted(int(n.split("_")[1]) for n in os.listdir(directory)
                  if n.startswith("step_") and not n.endswith(".tmp"))


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [s for s in _steps(directory)
             if os.path.exists(os.path.join(directory, f"step_{s:08d}", _MANIFEST))]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int | None = None,
                       template: Any = None, device="cuda",
                       sharding_tree: Any = None) -> tuple[int, Any]:
    """Restore (step, tree), the latest step if `step` is None.

    With a template, the tree's structure, leaf order, dtypes and devices
    come from it; otherwise a flat ``{path: tensor}`` dict is returned,
    each leaf in its manifest dtype on `device`.  `sharding_tree` (the
    template's structure, `NamedSharding` leaves or None) makes each leaf
    the DTensor of its sharding, on its mesh's device; a template with
    DTensor leaves needs one.
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)

    def load(info) -> torch.Tensor:
        t = torch.from_numpy(np.load(os.path.join(path, info["file"])))
        # numpy's dtype names are torch's ("bfloat16", "int32", "bool", ...)
        dtype = getattr(torch, info["dtype"], None)
        return t.to(dtype) if isinstance(dtype, torch.dtype) else t

    loaded = {key: load(info) for key, info in manifest["leaves"].items()}
    if template is None:
        return step, {k: v.to(device) for k, v in loaded.items()}
    if sharding_tree is None and any(is_dtensor(x) for x in pytree.leaves(template)):
        raise ValueError("the template is sharded: pass its sharding_tree= "
                         "(distributed.sharding.sharding_of)")
    named = pytree.leaves_with_path(template)
    shardings = (sharding_leaves(template, sharding_tree) if sharding_tree is not None
                 else [None] * len(named))
    leaves = []
    for (key, leaf), sh in zip(named, shardings):
        if key not in loaded:
            raise KeyError(f"checkpoint missing leaf {key}")
        dev = (sh.mesh.device_type if sh is not None
               else leaf.device_mesh.device_type if is_dtensor(leaf) else leaf.device)
        x = loaded[key].to(device=dev, dtype=leaf.dtype)
        leaves.append(sh.shard(x) if sh is not None else x)
    return step, pytree.unflatten(template, leaves)


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


class CheckpointManager:
    """Keep-k rotation, background saves, restore of the latest step."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._barrier = False     # a sharded save: rank 0's write to wait for
        os.makedirs(directory, exist_ok=True)

    def wait(self) -> None:
        """Join the background save; re-raise what it raised.  After a
        sharded save every rank waits here for rank 0's write."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            import torch.distributed as dist

            self._barrier = False
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree: Any, blocking: bool = True) -> None:
        # The consistency point: a host copy of every leaf, taken now (a
        # sharded leaf gathered whole: a collective, so on this thread).
        sharded = any(is_dtensor(x) for x in pytree.leaves(tree))
        host_tree = pytree.tree_map(
            lambda x: gather(x).detach().to("cpu", copy=True)
            if isinstance(x, torch.Tensor) else np.array(x), tree)
        self.wait()
        if sharded:
            self._barrier = True
            if _rank() != 0:
                return

        def work():
            save_checkpoint(self.directory, step, host_tree)
            self._gc()

        if blocking:
            work()
            return

        def run():
            try:
                work()
            except BaseException as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def _gc(self) -> None:
        for s in _steps(self.directory)[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, template: Any = None, device="cuda",
                       sharding_tree: Any = None):
        self.wait()
        return restore_checkpoint(self.directory, None, template=template,
                                  device=device, sharding_tree=sharding_tree)
