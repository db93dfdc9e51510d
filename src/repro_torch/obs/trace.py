"""Host-side phase tracing: Chrome/Perfetto trace-event spans.

The port's phases (prefill admissions, prefill chunks, decode steps,
scrub epochs, serve runs) are recorded as *spans* on one global `Tracer`
and exported as Chrome trace-event JSON (`{"traceEvents": [...]}`), the
format Perfetto and `chrome://tracing` load, and the format the JAX
package's stdlib readers (`obs/report.py`, `obs/dashboard.py`) read.
Every span is a host-side wall-clock interval; nothing here touches the
device, so tracing never adds a host sync to an instrumented hot path.

Usage:

    from repro_torch.obs import trace
    with trace.span("serve.decode", cat="serve", step=i) as args:
        ...                      # args is mutable: fill in results
        args["tokens"] = 4

    trace.export("TRACE_run.json")

Span events are "ph": "X" (complete) events with `ts`/`dur` in
microseconds; `instant` emits "ph": "i" markers; ledger charges ride
along as "cat": "ledger" instants (`obs.ledger`); `counter` emits
"ph": "C" samples.

Recording honours the global enable flag (`obs.disabled()`): inside it
no event is kept, while `span` still times its body and yields its args.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Iterator

__all__ = [
    "Tracer",
    "tracer",
    "span",
    "instant",
    "export",
    "reset",
    "events",
    "is_enabled",
]

# The global enable flag, shared by the tracer and the ledger.  The
# contract counters (`obs.metrics` registry) are not gated on it.
_ENABLED = True


def _set_enabled(flag: bool) -> bool:
    global _ENABLED
    old = _ENABLED
    _ENABLED = bool(flag)
    return old


def is_enabled() -> bool:
    return _ENABLED

class Tracer:
    """An append-only list of Chrome trace events on one wall clock."""

    def __init__(self, pid: int | None = None):
        self.pid = os.getpid() if pid is None else pid
        self.t0_ns = time.perf_counter_ns()
        self._events: list[dict] = []

    # ------------------------------------------------------------ clock
    def now_us(self) -> float:
        """Microseconds since the tracer's epoch (reset rebases it)."""
        return (time.perf_counter_ns() - self.t0_ns) / 1e3

    # ----------------------------------------------------------- record
    def _append(self, ev: dict) -> None:
        if _ENABLED:
            self._events.append(ev)

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "phase", **args: Any) -> Iterator[dict]:
        """Record one complete ("ph": "X") event around the body.

        Yields the (mutable) args dict so the body can attach results —
        values filled in before exit land in the exported event.
        """
        ts = self.now_us()
        mutable = dict(args)
        try:
            yield mutable
        finally:
            self._append(
                {
                    "name": name,
                    "cat": cat,
                    "ph": "X",
                    "ts": ts,
                    "dur": self.now_us() - ts,
                    "pid": self.pid,
                    "tid": 1,
                    "args": mutable,
                }
            )

    def instant(self, name: str, cat: str = "phase", **args: Any) -> None:
        """Record a zero-duration marker event ("ph": "i")."""
        self._append(
            {
                "name": name,
                "cat": cat,
                "ph": "i",
                "s": "t",
                "ts": self.now_us(),
                "pid": self.pid,
                "tid": 1,
                "args": dict(args),
            }
        )

    def counter(self, name: str, cat: str = "metric", **values: float) -> None:
        """Record a counter sample ("ph": "C") — renders as a track."""
        self._append(
            {
                "name": name,
                "cat": cat,
                "ph": "C",
                "ts": self.now_us(),
                "pid": self.pid,
                "tid": 1,
                "args": {k: float(v) for k, v in values.items()},
            }
        )

    # ------------------------------------------------------- export/reset
    def events(self) -> list[dict]:
        return list(self._events)

    def export(self, path: str | os.PathLike) -> str:
        """Write the Chrome/Perfetto trace-event JSON; returns the path."""
        doc = {
            "traceEvents": self._events,
            "displayTimeUnit": "ms",
        }
        path = os.fspath(path)
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
        return path

    def reset(self) -> None:
        """Drop all events and rebase the clock (fresh run in-process)."""
        self._events = []
        self.t0_ns = time.perf_counter_ns()


# The global tracer every subsystem records onto (one process = one
# timeline; `reset` starts a fresh, self-contained one).
tracer = Tracer()


def span(name: str, cat: str = "phase", **args: Any):
    return tracer.span(name, cat=cat, **args)


def instant(name: str, cat: str = "phase", **args: Any) -> None:
    tracer.instant(name, cat=cat, **args)


def counter(name: str, cat: str = "metric", **values: float) -> None:
    tracer.counter(name, cat=cat, **values)


def events() -> list[dict]:
    return tracer.events()


def export(path: str | os.PathLike) -> str:
    return tracer.export(path)


def reset() -> None:
    tracer.reset()
