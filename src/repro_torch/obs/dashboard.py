"""Fleet dashboard: join exported traces into one health report.

    python -m repro_torch.obs.dashboard build/chip_smoke_obs/TRACE_registry.json \
        --fleet build/chip_smoke_obs/fleet_status.json --out fleet.html

Reads one or more Chrome/Perfetto trace-event files written by
`repro_torch.obs.trace` (phase spans + ledger charges + cat="digest"/
"health"/"slo" instants) plus an optional machine-readable fleet
status JSON (`repro_torch.obs.fleet_status()` output) and renders a
single self-contained report: per-replica phase/ledger tables,
latency-digest percentiles, per-tile health worst lists, and SLO breach
rolls.  `--format text` prints the same content as aligned tables; the
default HTML output embeds all styling inline (one file, no assets).

The dashboard only reads files: the module uses the standard library
only, touches no device and recomputes no metric (digests accumulate on
the paths, health maps reduce on the device, SLO rules evaluate on the
host, the dashboard joins the artifacts), and renders a trace exactly
as the reference package's dashboard does.  Exits non-zero when
any input is malformed or when the joined inputs contain no events at
all, so a render step fails loudly instead of publishing an empty page.
"""

from __future__ import annotations

import argparse
import html as _html
import json
import sys
from typing import Any

from . import report as _report

__all__ = ["collect", "render_text", "render_html", "main"]


def _health_rows(doc: dict[str, Any]) -> list[dict[str, Any]]:
    """One row per health metric / gauge from cat="health" instants.

    Health emits are snapshots of cumulative maps, so the last instant
    per name wins (same rule as digest emits).
    """
    rows: dict[str, dict[str, Any]] = {}
    for ev in doc["traceEvents"]:
        if not isinstance(ev, dict) or ev.get("cat") != "health":
            continue
        name = str(ev.get("name", ""))
        args = ev.get("args") or {}
        if name.startswith("health.gauge."):
            rows[name] = {
                "metric": name[len("health.gauge."):],
                "kind": "gauge",
                "value": args.get("value"),
            }
        elif name.startswith("health."):
            rows[name] = {
                "metric": name[len("health."):],
                "kind": "tiles",
                "n_tiles": args.get("n_tiles"),
                "total": args.get("total"),
                "max": args.get("max"),
                "worst": args.get("worst") or {},
            }
    return [rows[k] for k in sorted(rows)]


def collect(trace_paths: list[str], fleet_path: str | None = None) -> dict:
    """Load and join every input into one plain-data report model.

    Raises ValueError on any malformed input (propagated from
    `report.load` / json) so `main` can turn it into a non-zero exit.
    """
    replicas = []
    for path in trace_paths:
        doc = _report.load(path)
        replicas.append(
            {
                "path": path,
                "n_events": len(doc["traceEvents"]),
                "phases": _report.summarize(doc),
                "digests": _report.digest_rows(doc),
                "slo": _report.slo_rows(doc),
                "health": _health_rows(doc),
            }
        )
    fleet = None
    if fleet_path is not None:
        try:
            with open(fleet_path) as f:
                fleet = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise ValueError(f"cannot read fleet status {fleet_path!r}: {e}")
        if not isinstance(fleet, dict):
            raise ValueError(f"{fleet_path!r} is not a fleet-status object")
    return {"replicas": replicas, "fleet": fleet}


# ------------------------------------------------------------- text view
def _fmt(v: Any) -> str:
    if v is None:
        return "-"
    if isinstance(v, (int, float)):
        return _report._fmt(float(v)) if v != 0 else "0"
    return str(v)


def _worst_str(worst: dict) -> str:
    items = sorted(worst.items(), key=lambda kv: -float(kv[1]))[:4]
    return ", ".join(f"{t}:{float(v):g}" for t, v in items) or "-"


def _health_table(rows: list[dict[str, Any]]) -> str:
    table = [["metric", "kind", "n_tiles", "total", "max", "worst tiles"]]
    for r in rows:
        if r["kind"] == "gauge":
            table.append(
                [r["metric"], "gauge", "-", _fmt(r["value"]), "-", "-"]
            )
        else:
            table.append(
                [r["metric"], "tiles", _fmt(r["n_tiles"]), _fmt(r["total"]),
                 _fmt(r["max"]), _worst_str(r["worst"])]
            )
    return _report._render_table(table)


def render_text(model: dict) -> str:
    out: list[str] = []
    for rep in model["replicas"]:
        out.append(f"## {rep['path']} ({rep['n_events']} events)")
        if rep["phases"]:
            out.append(_report.render(rep["phases"]))
        if rep["digests"]:
            out.append("# digests")
            out.append(_report.render_digests(rep["digests"]))
        if rep["health"]:
            out.append("# health")
            out.append(_health_table(rep["health"]))
        if rep["slo"]:
            out.append("# slo breaches")
            out.append(_report.render_slo(rep["slo"]))
        out.append("")
    fleet = model["fleet"]
    if fleet:
        out.append("## fleet status")
        out.append(json.dumps(fleet, indent=2, sort_keys=True, default=str))
    return "\n".join(out)


# ------------------------------------------------------------- html view
_CSS = """
body { font: 13px/1.5 -apple-system, 'Segoe UI', sans-serif; margin: 2em;
       color: #1a1a2e; background: #fafafa; max-width: 72em; }
h1 { font-size: 1.4em; } h2 { font-size: 1.1em; margin-top: 2em;
     border-bottom: 2px solid #d0d0e0; padding-bottom: .2em; }
h3 { font-size: .95em; color: #444; margin-bottom: .3em; }
table { border-collapse: collapse; margin: .5em 0 1.2em; }
th, td { padding: .25em .7em; border: 1px solid #e0e0e8; text-align: right; }
th { background: #eef; } td:first-child, th:first-child { text-align: left; }
.breach td { background: #ffe8e8; }
.ok { color: #2a7; } .bad { color: #c22; font-weight: 600; }
pre { background: #f0f0f5; padding: .8em; overflow-x: auto; }
"""


def _h(v: Any) -> str:
    return _html.escape(_fmt(v))


def _html_table(header: list[str], rows: list[list[Any]],
                row_classes: list[str] | None = None) -> str:
    parts = ["<table><tr>" + "".join(f"<th>{_html.escape(h)}</th>" for h in header) + "</tr>"]
    for i, row in enumerate(rows):
        cls = f' class="{row_classes[i]}"' if row_classes and row_classes[i] else ""
        parts.append(
            f"<tr{cls}>" + "".join(f"<td>{_h(c)}</td>" for c in row) + "</tr>"
        )
    parts.append("</table>")
    return "".join(parts)


def render_html(model: dict) -> str:
    body: list[str] = ["<h1>Fleet health dashboard</h1>"]
    total_breaches = sum(
        r["breaches"] for rep in model["replicas"] for r in rep["slo"]
    )
    cls = "bad" if total_breaches else "ok"
    body.append(
        f'<p>{len(model["replicas"])} trace(s) joined &middot; '
        f'<span class="{cls}">{total_breaches} SLO breach instant(s)</span></p>'
    )
    for rep in model["replicas"]:
        body.append(f"<h2>{_html.escape(rep['path'])} "
                    f"({rep['n_events']} events)</h2>")
        if rep["phases"]:
            body.append("<h3>Phases &amp; ledger</h3>")
            body.append(_html_table(
                ["phase", "count", "total_ms", "mean_ms", "energy_pj",
                 "latency_ns", "reads", "tokens"],
                [[r["phase"], r["count"], r["total_ms"], r["mean_ms"],
                  r["energy_pj"], r["latency_ns"], r["reads"], r["tokens"]]
                 for r in rep["phases"]],
            ))
        if rep["digests"]:
            body.append("<h3>Latency / pulse digests</h3>")
            body.append(_html_table(
                ["digest", "count", "mean", "p50", "p95", "p99", "max",
                 "under", "over"],
                [[r["digest"], r["count"], r["mean"], r["p50"], r["p95"],
                  r["p99"], r["max"], r.get("n_under", 0.0),
                  r.get("n_over", 0.0)] for r in rep["digests"]],
            ))
        if rep["health"]:
            body.append("<h3>Tile health</h3>")
            body.append(_html_table(
                ["metric", "kind", "n_tiles", "total", "max", "worst tiles"],
                [[r["metric"], r["kind"],
                  r.get("n_tiles"), r.get("total") if r["kind"] == "tiles"
                  else r.get("value"),
                  r.get("max"), _worst_str(r.get("worst") or {})]
                 for r in rep["health"]],
            ))
        if rep["slo"]:
            body.append("<h3>SLO breaches</h3>")
            body.append(_html_table(
                ["rule", "metric", "ceiling", "breaches", "last_value"],
                [[r["rule"], r["metric"], r["ceiling"], r["breaches"],
                  r["last_value"]] for r in rep["slo"]],
                row_classes=["breach" if r["breaches"] else "" for r in rep["slo"]],
            ))
    if model["fleet"]:
        body.append("<h2>Fleet status</h2>")
        body.append(
            "<pre>"
            + _html.escape(json.dumps(
                model["fleet"], indent=2, sort_keys=True, default=str))
            + "</pre>"
        )
    return (
        "<!doctype html><html><head><meta charset='utf-8'>"
        "<title>Fleet health dashboard</title>"
        f"<style>{_CSS}</style></head><body>"
        + "".join(body)
        + "</body></html>"
    )


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.obs.dashboard",
        description="Join obs trace files into one fleet health report.",
    )
    ap.add_argument("traces", nargs="+",
                    help="TRACE_*.json trace-event files (one per replica/run)")
    ap.add_argument("--fleet", default=None,
                    help="fleet-status JSON (repro_torch.obs.fleet_status() output)")
    ap.add_argument("--out", default=None,
                    help="output path (default: stdout)")
    ap.add_argument("--format", choices=("html", "text"), default=None,
                    help="output format (default: html when --out ends in "
                         ".html, else text)")
    args = ap.parse_args(argv)

    try:
        model = collect(args.traces, args.fleet)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if sum(rep["n_events"] for rep in model["replicas"]) == 0:
        print("error: joined traces contain no events", file=sys.stderr)
        return 1

    fmt = args.format or (
        "html" if args.out and args.out.endswith(".html") else "text"
    )
    text = render_html(model) if fmt == "html" else render_text(model)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        n_rules = sum(len(rep["slo"]) for rep in model["replicas"])
        print(f"wrote {args.out} ({len(text):,} bytes, "
              f"{len(model['replicas'])} trace(s), {n_rules} SLO rule(s))")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
