"""Find a cell's pieces by name: its entry in `BENCHMARK.json`, its
configuration, its traffic mix, the limits of its correctness check and
its per-layer metric readers."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(workload: str) -> dict:
    """Everything a run of `workload` needs, by name."""
    spec = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    cfg_entry = next(c for c in spec["configs"] if c["name"] == w["config"])
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    per_layer = [m for m in spec["per_layer"]
                 if "workloads" not in m or workload in m["workloads"]]
    return dict(
        workload=w,
        config=load_json(ROOT / cfg_entry["file"]),
        traffic=load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(BENCH / "limits" / f"{workload}.json"),
        end_to_end=e2e,
        per_layer=per_layer,
    )


def reader(metric: str):
    """The `read(ctx)` function of a per-layer metric's own file."""
    path = BENCH / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def driver(kind: str):
    """The module that runs traffic of this `kind`."""
    return importlib.import_module(f"harness.driver_{kind}")
