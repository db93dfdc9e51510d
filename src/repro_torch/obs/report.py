"""Run-summary reporting over exported trace files.

    python -m repro_torch.obs.report build/chip_smoke_obs/TRACE_registry.json

Loads a Chrome/Perfetto trace-event JSON written by
`repro_torch.obs.trace` and renders one table row per phase name: span
count, wall time (total/mean), and the ledger attribution (energy,
modeled latency, reads, tokens) charged to that phase.  This is the
"where did the reads, joules, and milliseconds go" view of a run: the
paper's latency/energy headline numbers, per phase, from one artifact.

When the trace carries fleet-observability events, two extra sections
follow the phase table: digest percentiles (cat="digest" instants
written by `obs.digests.emit()`: p50/p95/p99 per named histogram, with
empty digests rendered explicitly as count 0) and SLO breaches
(cat="slo" instants written by `obs.SLOPolicy.evaluate`: one row per
rule with breach count and last observed value).

The module itself uses the standard library only (no torch); it
renders a trace exactly as the reference package's report does.  Exits
non-zero when a trace cannot be parsed or contains no spans.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any

__all__ = [
    "load", "summarize", "render",
    "digest_rows", "slo_rows", "render_digests", "render_slo", "main",
]

_LEDGER_FIELDS = ("energy_pj", "latency_ns", "reads", "tokens")


def load(path: str) -> dict[str, Any]:
    """Read and validate a trace file; raises ValueError when malformed."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise ValueError(f"cannot read trace {path!r}: {e}") from e
    if not isinstance(doc, dict) or not isinstance(doc.get("traceEvents"), list):
        raise ValueError(f"{path!r} is not a trace-event file (no traceEvents)")
    return doc


def summarize(doc: dict[str, Any]) -> list[dict[str, Any]]:
    """Aggregate events into one row per phase name.

    Span ("ph": "X") events contribute count and wall time; ledger
    instants ("cat": "ledger") contribute the charged energy/latency/
    reads/tokens.  Rows join on the event name and sort by total wall
    time (ledger-only phases last, by energy).
    """
    rows: dict[str, dict[str, Any]] = {}

    def row(name: str) -> dict[str, Any]:
        r = rows.get(name)
        if r is None:
            r = rows[name] = dict(
                phase=name, count=0, total_ms=0.0,
                **{f: 0.0 for f in _LEDGER_FIELDS},
            )
        return r

    for ev in doc["traceEvents"]:
        if not isinstance(ev, dict) or "name" not in ev:
            continue
        if ev.get("cat") == "ledger":
            r = row(ev["name"])
            args = ev.get("args") or {}
            for f in _LEDGER_FIELDS:
                r[f] += float(args.get(f, 0.0))
        elif ev.get("ph") == "X":
            r = row(ev["name"])
            r["count"] += 1
            r["total_ms"] += float(ev.get("dur", 0.0)) / 1e3
    out = list(rows.values())
    for r in out:
        r["mean_ms"] = r["total_ms"] / r["count"] if r["count"] else 0.0
    out.sort(key=lambda r: (-r["total_ms"], -r["energy_pj"], r["phase"]))
    return out


def digest_rows(doc: dict[str, Any]) -> list[dict[str, Any]]:
    """One row per digest name from cat="digest" instants.

    Digests are cumulative at emit time, so when a trace carries
    several emits of the same name the LAST one wins (it already
    contains the earlier counts).  Empty digests (count 0, null
    percentiles) are kept — the table renders them as "-" rather than
    dropping the row, so a silent zero-sample digest is visible.
    """
    rows: dict[str, dict[str, Any]] = {}
    for ev in doc["traceEvents"]:
        if not isinstance(ev, dict) or ev.get("cat") != "digest":
            continue
        name = str(ev.get("name", ""))
        if name.startswith("digest."):
            name = name[len("digest."):]
        args = ev.get("args") or {}
        rows[name] = {
            "digest": name,
            "count": float(args.get("count") or 0.0),
            **{k: args.get(k) for k in ("mean", "p50", "p95", "p99", "max")},
            # Out-of-range counts (0.0 for traces emitted before digests
            # tracked them): a digest clamping mass into its edge
            # buckets reports fake percentiles, so the table shows it.
            "n_under": float(args.get("n_under") or 0.0),
            "n_over": float(args.get("n_over") or 0.0),
        }
    return [rows[k] for k in sorted(rows)]


def slo_rows(doc: dict[str, Any]) -> list[dict[str, Any]]:
    """One row per SLO rule from cat="slo" breach instants."""
    rows: dict[str, dict[str, Any]] = {}
    for ev in doc["traceEvents"]:
        if not isinstance(ev, dict) or ev.get("cat") != "slo":
            continue
        args = ev.get("args") or {}
        name = str(ev.get("name", ""))
        if name.startswith("slo.breach."):
            name = name[len("slo.breach."):]
        r = rows.setdefault(
            name,
            {"rule": name, "metric": args.get("metric"),
             "ceiling": args.get("ceiling"), "breaches": 0,
             "last_value": None},
        )
        r["breaches"] += 1
        r["last_value"] = args.get("value")
    return [rows[k] for k in sorted(rows)]


def _fmt_opt(v: Any) -> str:
    return "-" if v is None else _fmt(float(v))


def render_digests(rows: list[dict[str, Any]]) -> str:
    cols = ["digest", "count", "mean", "p50", "p95", "p99", "max",
            "under", "over"]
    table = [cols[:]]
    for r in rows:
        table.append(
            [r["digest"], f"{r['count']:,.0f}"]
            + [_fmt_opt(r[c]) for c in ("mean", "p50", "p95", "p99", "max")]
            + [f"{r.get('n_under', 0.0):,.0f}", f"{r.get('n_over', 0.0):,.0f}"]
        )
    return _render_table(table)


def render_slo(rows: list[dict[str, Any]]) -> str:
    cols = ["rule", "metric", "ceiling", "breaches", "last_value"]
    table = [cols[:]]
    for r in rows:
        table.append(
            [r["rule"], str(r["metric"] or "-"), _fmt_opt(r["ceiling"]),
             str(r["breaches"]), _fmt_opt(r["last_value"])]
        )
    return _render_table(table)


def _fmt(v: float) -> str:
    if v == 0.0:
        return "-"
    if abs(v) >= 1e6:
        return f"{v:.3e}"
    return f"{v:,.2f}" if abs(v) < 1e3 else f"{v:,.0f}"


def _render_table(table: list[list[str]]) -> str:
    """Align a header + rows string table (first column left-justified)."""
    n = len(table[0])
    widths = [max(len(line[i]) for line in table) for i in range(n)]
    lines = []
    for j, line in enumerate(table):
        lines.append(
            line[0].ljust(widths[0])
            + "  "
            + "  ".join(c.rjust(w) for c, w in zip(line[1:], widths[1:]))
        )
        if j == 0:
            lines.append("-" * len(lines[0]))
    return "\n".join(lines)


def render(rows: list[dict[str, Any]]) -> str:
    """Plain-text summary table (grep-able, fixed column order)."""
    cols = ["phase", "count", "total_ms", "mean_ms", *_LEDGER_FIELDS]
    table = [[str(c) for c in cols]]
    for r in rows:
        table.append(
            [r["phase"], str(r["count"])]
            + [_fmt(r[c]) for c in cols[2:]]
        )
    return _render_table(table)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.obs.report",
        description="Summarize an obs trace file per phase.",
    )
    ap.add_argument("trace", help="path to a TRACE_*.json trace-event file")
    args = ap.parse_args(argv)

    try:
        doc = load(args.trace)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    rows = summarize(doc)
    n_spans = sum(r["count"] for r in rows)
    if n_spans == 0:
        print(
            f"error: {args.trace!r} contains no span events "
            f"({len(doc['traceEvents'])} events total)",
            file=sys.stderr,
        )
        return 1
    print(f"# {args.trace}: {len(doc['traceEvents'])} events, {n_spans} spans")
    print(render(rows))
    total_e = sum(r["energy_pj"] for r in rows)
    total_ms = sum(r["total_ms"] for r in rows)
    print(
        f"# total: {total_ms:,.1f} ms wall across spans, "
        f"{total_e:,.1f} pJ attributed"
    )
    drows = digest_rows(doc)
    if drows:
        print(f"\n# digests ({len(drows)})")
        print(render_digests(drows))
    srows = slo_rows(doc)
    if srows:
        total_breaches = sum(r["breaches"] for r in srows)
        print(f"\n# slo breaches ({total_breaches})")
        print(render_slo(srows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
