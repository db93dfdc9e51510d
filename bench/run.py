"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout on a machine with the cards the cell asks
for.  Set-up (weights from the seed, the cell's own warm-up) counts as
`setup_s`; the window then drives the system under test (`repro_torch`)
for `--seconds`; with `--trace 1` a part of the window is profiled and
the per-layer metrics are read instead of the end-to-end ones.  Once
the window has closed and the program's state is freed, the plain
reference under `bench/reference` checks what the timed path produced,
and the last line of standard output is one JSON object.  The numbers
compared, each beside its limit, are also the last lines of standard
error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH.parent / "src"))
sys.path.insert(0, str(BENCH))

# Top-level module names the run must never load (the JAX package and
# JAX itself), compared whole.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
             cell: dict | None = None) -> dict:
    """Set up, measure, check; returns the result line's object.
    `cell` overrides what `BENCHMARK.json` gives (small sizes in tests)."""
    import torch

    from harness import spec
    from harness.trace import Tracer

    cell = cell or spec.cell(workload)
    drv = spec.driver(cell["traffic"]["kind"])
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    with torch.no_grad():
        st = drv.setup(cell, seed, device)
        sync()
        setup_s = time.perf_counter() - T_START
        tracer = Tracer(bool(trace) and on_card,
                        host_ops=cell["traffic"].get("trace_host_ops", True))
        rec = drv.window(st, seconds, tracer)
        sync()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    e2e = drv.end_to_end(rec)
    metrics = {}
    if trace:
        ctx = drv.layer_context(st, rec, tracer.summary)
        for m in cell["per_layer"]:
            v = spec.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e["setup_s"] = setup_s
        for m in cell["end_to_end"]:
            if e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    drv.release(st, rec)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    with torch.no_grad():
        numbers = drv.check(st, rec)
    limits = cell["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = all(v <= limits[k] for k, v in numbers.items())
    if on_card:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
               "memory_peak_bytes": int(peak)}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    out = {"correct": bool(correct), "attempted": drv.attempted(rec),
           "failed": 0 if correct else drv.attempted(rec), "metrics": metrics,
           "device": dev}
    if trace and tracer.summary:
        s = tracer.summary
        dev["busy_s"] = s["busy_s"]
        dev["window_s"] = s["window_s"]
        out["breakdown"] = {"device_ops": s["device_ops"], "idle_gaps": s["idle_gaps"]}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from harness import spec

    cell = spec.cell(args.workload)
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), cell=cell)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(json.dumps(out))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
