"""Rematerialisation under autograd: the reference's `jax.checkpoint`.

`checkpoint(fn, *args)` is ``fn(*args)``.  When autograd records the call
(grad mode on and some tensor among `args` requiring grad) it runs under
`torch.utils.checkpoint.checkpoint` instead: backward keeps the call's
arguments and recomputes the rest when it needs it, one checkpointed
region at a time.  Otherwise (`torch.no_grad()`, or nothing to
differentiate: prefill, decode, the analog serving paths) it is the
plain call and runs exactly the plain call's ops.

The recompute runs the same ops on the same inputs, so it gives the
same values: a checkpointed loss and its gradients are bitwise those of
the plain call (on the card, under deterministic algorithms where a
scatter-add sums in atomic order).  The forward draws no random numbers,
so no RNG state is kept (``preserve_rng_state=False``).  Collectives
inside a checkpointed region run again in the recompute, in the same
order on every rank, as they do under `jax.checkpoint`.  A log that must
see one entry per forward call skips while `recomputing()` is true.

An output of a checkpointed call that is a view is copied: a view keeps
its base, an intermediate of the region, alive, and dropping those is
what the checkpoint is for.

`checkpoints` counts the checkpointed calls of forwards (not those of
recomputes); tests and `chip_smoke.py` zero and read it.
"""

from __future__ import annotations

import threading
from typing import Any, Callable

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch import pytree

__all__ = ["checkpoint", "recomputing", "checkpoints"]

# Checkpointed calls made by forwards (recomputes not counted).
checkpoints = 0
# The backward recompute runs on the thread that runs the backward.
_tls = threading.local()


def recomputing() -> bool:
    """Whether this thread is inside a backward recompute."""
    return getattr(_tls, "depth", 0) > 0


def _records(args) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in pytree.leaves(args))


def _copy_views(out):
    if isinstance(out, torch.Tensor):
        return out.clone() if out._base is not None else out
    if type(out) is tuple:
        return tuple(_copy_views(o) for o in out)
    return out


def checkpoint(fn: Callable, *args: Any):
    """``fn(*args)``, rematerialised in backward when autograd records it
    (see the module docstring)."""
    global checkpoints
    if not _records(args):
        return fn(*args)
    if not recomputing():
        checkpoints += 1
    calls = [0]

    def run(*a):
        calls[0] += 1
        if calls[0] == 1:
            return fn(*a)
        _tls.depth = getattr(_tls, "depth", 0) + 1
        try:
            return fn(*a)
        finally:
            _tls.depth -= 1

    return _copy_views(_ckpt.checkpoint(run, *args, use_reentrant=False,
                                        preserve_rng_state=False))
