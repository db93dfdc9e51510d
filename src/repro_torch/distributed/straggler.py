"""Straggler detection and mitigation hooks (the reference's monitor).

At scale, tail-latency hosts dominate a synchronous step.  The monitor
runs the standard control loop:

  1. track per-step wall times (EWMA);
  2. flag a step whose duration exceeds `threshold` x the EWMA;
  3. after `strikes_to_escalate` consecutive flags, escalate: the
     `on_straggler` callback fires (in production: demote the host to a
     hot spare or shrink the data-parallel group; here it is recorded
     and can route through the fault-tolerant runner's restart path).

The detector is host-local and keeps no state across restarts, so it
keeps working when the membership changes under it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

__all__ = ["StragglerMonitor"]


@dataclasses.dataclass
class StragglerMonitor:
    threshold: float = 2.0          # x EWMA to flag
    strikes_to_escalate: int = 3
    ewma_alpha: float = 0.1
    warmup_steps: int = 5           # ignore the first steps (warm-up, builds)

    _ewma: float = 0.0
    _seen: int = 0
    _strikes: int = 0
    flagged_steps: list = dataclasses.field(default_factory=list)
    escalations: int = 0
    on_straggler: Callable[[int, float], None] | None = None

    def observe(self, step: int, duration_s: float) -> bool:
        """Record a step duration; returns True if flagged as straggler."""
        self._seen += 1
        if self._seen <= self.warmup_steps:
            self._ewma = duration_s if self._ewma == 0 else (
                0.5 * self._ewma + 0.5 * duration_s)
            return False
        flagged = duration_s > self.threshold * max(self._ewma, 1e-9)
        if flagged:
            self.flagged_steps.append((step, duration_s))
            self._strikes += 1
            if self._strikes >= self.strikes_to_escalate:
                self.escalations += 1
                self._strikes = 0
                if self.on_straggler is not None:
                    self.on_straggler(step, duration_s)
        else:
            self._strikes = 0
            self._ewma = (1 - self.ewma_alpha) * self._ewma + self.ewma_alpha * duration_s
        return flagged

    def timed(self, step: int):
        """Context manager: ``with monitor.timed(step): run_step()``."""
        monitor = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                monitor.observe(step, time.perf_counter() - self.t0)
                return False

        return _Ctx()
