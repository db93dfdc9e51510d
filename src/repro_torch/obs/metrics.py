"""Device-side metric scalars, the host-side counter registry and the
counted device->host fetch.

`MetricAccumulator` holds named float32 0-d tensors on the device; `inc`
returns a new accumulator, so a loop can carry it and fetch it once at
a sync it already makes.  Named float counters (`pipeline.compiles`, `pipeline.host_syncs`,
`serve.decode_tokens`, `lifetime.health_syncs`, ...) that the contracts
are asserted on; they are not gated on the obs enable flag.  `fetch(tree, counter=...)`
is the counted transfer chokepoint: one call = one device->host copy =
one bump of its counter.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping

import torch

from repro_torch import pytree

__all__ = ["MetricAccumulator", "MetricRegistry", "registry", "fetch", "inc", "value",
           "snapshot", "reset"]


class MetricAccumulator:
    """An immutable set of named device-side metric scalars.

    Functional, as the reference's pytree is: `inc` and `merge` return a
    NEW accumulator and leave this one as it is.  The values stay float32
    0-d tensors on their device until a `fetch`.
    """

    def __init__(self, values: Mapping[str, torch.Tensor]):
        self._values = dict(values)

    @classmethod
    def zeros(cls, names: Iterable[str], device="cuda") -> "MetricAccumulator":
        return cls({n: torch.zeros((), dtype=torch.float32, device=device)
                    for n in names})

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(sorted(self._values))

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._values[name]

    def inc(self, name: str, delta) -> "MetricAccumulator":
        """New accumulator with `delta` (a number or a tensor on the same
        device) added to `name`; no host sync."""
        vals = dict(self._values)
        old = vals[name]
        vals[name] = old + torch.as_tensor(delta, dtype=torch.float32, device=old.device)
        return MetricAccumulator(vals)

    def merge(self, other: "MetricAccumulator") -> "MetricAccumulator":
        if self.names != other.names:
            raise ValueError(f"cannot merge accumulators of {self.names} and {other.names}")
        return MetricAccumulator({n: self._values[n] + other._values[n]
                                  for n in self._values})

    def as_dict(self) -> dict[str, torch.Tensor]:
        return dict(self._values)

    def __repr__(self) -> str:
        return f"MetricAccumulator({self._values!r})"


class MetricRegistry:
    """Host-side named counters."""

    def __init__(self):
        self._counts: dict[str, float] = {}

    def inc(self, name: str, delta: float = 1.0) -> None:
        self._counts[name] = self._counts.get(name, 0.0) + float(delta)

    def fold(self, values: dict[str, Any], prefix: str = "") -> None:
        """Add a mapping of fetched metric values (numpy/python scalars)."""
        for k, v in values.items():
            self.inc(prefix + k, float(v))

    def value(self, name: str) -> float:
        return self._counts.get(name, 0.0)

    def snapshot(self) -> dict[str, float]:
        return dict(self._counts)

    def reset(self, prefix: str | None = None) -> None:
        """Zero all counters, or only those under `prefix`."""
        if prefix is None:
            self._counts = {}
        else:
            for k in [k for k in self._counts if k.startswith(prefix)]:
                del self._counts[k]


registry = MetricRegistry()


def fetch(tree: Any, counter: str | None = None) -> Any:
    """Copy every tensor of a nested dict/list/tuple to numpy in ONE transfer.

    The leaves are flattened into one float32 buffer on their device and
    copied with a single `.cpu()`; the result has the tree's structure
    with numpy arrays in place of tensors.
    """
    if counter is not None:
        registry.inc(counter)
    every = pytree.leaves(tree)
    leaves = [t for t in every if isinstance(t, torch.Tensor)]
    if not leaves:
        return tree
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in leaves])
    host = flat.cpu().numpy()
    parts, off = [], 0
    for t in leaves:
        parts.append(host[off: off + t.numel()].reshape(tuple(t.shape)))
        off += t.numel()
    it = iter(parts)
    return pytree.unflatten(tree, [next(it) if isinstance(x, torch.Tensor) else x
                                   for x in every])


def inc(name: str, delta: float = 1.0) -> None:
    registry.inc(name, delta)


def value(name: str) -> float:
    return registry.value(name)


def snapshot() -> dict[str, float]:
    return registry.snapshot()


def reset(prefix: str | None = None) -> None:
    registry.reset(prefix)
