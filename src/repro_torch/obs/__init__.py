"""Telemetry of the port: counters, digests, trace spans, the energy
ledger and per-tile health maps.

* `obs.metrics`: device-side `MetricAccumulator`s, the host-side
  counter registry and `fetch`, the counted device->host chokepoint
  (one call = one copy);
* `obs.digest`: fixed-bucket streaming histograms (`StreamingDigest`,
  accumulated on the device or the host) and the `digests` registry;
* `obs.trace`: host-side Chrome/Perfetto trace-event spans;
* `obs.ledger`: per-phase modeled energy/latency (`obs.charge`);
* `obs.health`: per-tile health maps and gauges, reduced on the device
  on syncs the paths already make, and declarative `SLORule` /
  `SLOPolicy` ceilings evaluated on the host over `fleet_status()`;
* `obs.report`: ``python -m repro_torch.obs.report TRACE.json`` renders
  the per-phase run summary (+ digest percentiles, SLO breaches);
* `obs.dashboard`: ``python -m repro_torch.obs.dashboard`` joins trace
  files, ledger charges and fleet-status snapshots into an HTML or text
  report.

The rule: spans and charges are host-side only, and device values reach
the host only on syncs the hot path already makes.  `disabled()`
silences span and ledger recording (the contract counters keep
counting); `reset_all()` starts a fresh run in-process.
"""

from __future__ import annotations

import contextlib

from . import digest, health, ledger, metrics, trace
from .digest import StreamingDigest, digests, rank_quantile
from .health import SLOPolicy, SLORule, fleet_status
from .health import health as health_registry
from .ledger import charge
from .metrics import MetricAccumulator, registry
from .trace import instant, span, tracer

__all__ = [
    "digest",
    "health",
    "ledger",
    "metrics",
    "trace",
    "charge",
    "MetricAccumulator",
    "StreamingDigest",
    "SLOPolicy",
    "SLORule",
    "digests",
    "rank_quantile",
    "fleet_status",
    "health_registry",
    "registry",
    "instant",
    "span",
    "tracer",
    "disabled",
    "reset_all",
]


@contextlib.contextmanager
def disabled():
    """Silence span and ledger recording inside the block.  Only the
    verbosity is gated: the registry's counters (host-sync and launch
    contracts) keep counting."""
    old = trace._set_enabled(False)
    try:
        yield
    finally:
        trace._set_enabled(old)


def reset_all() -> None:
    """Fresh telemetry state: events, charges, counters, digests, health."""
    trace.reset()
    ledger.reset()
    metrics.reset()
    digest.reset()
    health_registry.reset()
