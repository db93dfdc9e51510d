"""The hook through which kernels and collectives report their work.

A kernel wrapper calls `add_kernel` where it launches (and on a meta
tensor instead of launching); a collective calls `add_collective`.  Each
call goes to every counter open in this process.  `launch.roofline`'s
`WorkCounter` opens itself here with `push` and closes with `pop`; with
no counter open both calls do nothing.
"""

from __future__ import annotations

__all__ = ["push", "pop", "add_kernel", "add_collective"]

# The counters open in this process, innermost last.
_active: list = []


def push(counter) -> None:
    """Open `counter`: it takes `add_kernel` and `add_collective` calls."""
    _active.append(counter)


def pop(counter) -> None:
    """Close `counter`."""
    _active.remove(counter)


def add_kernel(name: str, nbytes: float, flops: dict[str, float]) -> None:
    """A kernel call's work, added to every open counter."""
    for c in _active:
        c.add_kernel(name, nbytes, flops)


def add_collective(op: str, axis: str, nbytes: float) -> None:
    """A collective's result bytes on one mesh axis, added to every open
    counter."""
    for c in _active:
        c.add_collective(op, axis, nbytes)
