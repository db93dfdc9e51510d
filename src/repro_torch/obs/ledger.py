"""Energy / latency ledger: where the modeled joules and nanoseconds went.

The cost model prices single operations (a verify sweep, a write phase,
a served token); `EnergyLedger` attributes those prices to the run.
Every subsystem charges its modeled cost to a named phase:

    obs.charge("lifetime.scrub", energy_pj=..., latency_ns=...)

Charges aggregate per phase (energy_pj / latency_ns / reads / tokens /
n_charges) and mirror into the global tracer as `cat: "ledger"`
instants, so an exported trace carries the whole attribution next to
the span wall times.  Charging is host arithmetic on
already-fetched floats: it never adds a host sync.  These are outputs of
the simulation's cost model, not times of the card.
"""

from __future__ import annotations

import dataclasses

from . import trace

__all__ = ["EnergyLedger", "ledger", "charge", "summary", "reset", "FIELDS"]

FIELDS = ("energy_pj", "latency_ns", "reads", "tokens")


@dataclasses.dataclass
class PhaseTotals:
    """Accumulated attribution for one named phase."""

    energy_pj: float = 0.0
    latency_ns: float = 0.0
    reads: float = 0.0
    tokens: float = 0.0
    n_charges: int = 0

    def as_dict(self) -> dict[str, float]:
        return dataclasses.asdict(self)


class EnergyLedger:
    """Per-phase accumulation of modeled energy/latency/reads/tokens."""

    def __init__(self):
        self._phases: dict[str, PhaseTotals] = {}

    def charge(
        self,
        phase: str,
        *,
        energy_pj: float = 0.0,
        latency_ns: float = 0.0,
        reads: float = 0.0,
        tokens: float = 0.0,
        **annotations,
    ) -> None:
        """Attribute modeled cost to `phase` (and mirror into the trace);
        nothing inside `obs.disabled()`."""
        if not trace.is_enabled():
            return
        tot = self._phases.get(phase)
        if tot is None:
            tot = self._phases[phase] = PhaseTotals()
        tot.energy_pj += float(energy_pj)
        tot.latency_ns += float(latency_ns)
        tot.reads += float(reads)
        tot.tokens += float(tokens)
        tot.n_charges += 1
        trace.instant(
            phase,
            cat="ledger",
            energy_pj=float(energy_pj),
            latency_ns=float(latency_ns),
            reads=float(reads),
            tokens=float(tokens),
            **annotations,
        )

    def summary(self) -> dict[str, dict[str, float]]:
        return {name: tot.as_dict() for name, tot in sorted(self._phases.items())}

    def total(self, field: str = "energy_pj") -> float:
        """`field` summed over every phase."""
        return sum(getattr(t, field) for t in self._phases.values())

    def reset(self) -> None:
        self._phases = {}


# The global ledger (one process = one attribution namespace).
ledger = EnergyLedger()


def charge(phase: str, **kw) -> None:
    ledger.charge(phase, **kw)


def summary() -> dict[str, dict[str, float]]:
    return ledger.summary()


def reset() -> None:
    ledger.reset()
