"""Readings the correctness limits are set from, for one cell.

    python3 bench/calibrate.py --workload <name> --seeds 1,2,3 --seconds 15 [--control]

For each seed: set-up and a short window of the cell's own traffic, as
a run makes them; then the numbers the check compares, of the program
(its sound readings), and with `--control` also those of the
reference one precision step below put in the program's place.  One JSON line per
seed.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH.parent / "src"))
sys.path.insert(0, str(BENCH))


def readings(cell: dict, seed: int, seconds: float, device="cuda",
             control: bool = False) -> dict:
    """Set-up and a window of `cell` on `seed`, then the numbers the check
    compares: the program's, and with `control` the control's."""
    import torch

    from harness import spec
    from harness.trace import Tracer

    drv = spec.driver(cell["traffic"]["kind"])
    on_card = torch.device(device).type == "cuda"
    with torch.no_grad():
        st = drv.setup(cell, seed, device)
        rec = drv.window(st, seconds, Tracer(False))
    drv.release(st, rec)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    with torch.no_grad():
        nums = drv.check(st, rec)
        low = drv.check(st, rec, control=True) if control else None
    return {"numbers": nums, "control": low, "attempted": drv.attempted(rec)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    import torch

    from harness import spec

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = readings(cell, seed, args.seconds, control=args.control)
        print(json.dumps({"workload": args.workload, "seed": seed, **out,
                          "seconds": time.perf_counter() - t0}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
