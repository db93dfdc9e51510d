"""The benchmark's yardstick: the work a cell's algorithm needs, counted
from shapes and trip counts, and the card's peaks it is priced at.

`kernels` holds each hand-written kernel's bytes and operations for one
call, `wv_ops` the operations of HARP write-and-verify per column and
iteration, `model_flops` a served model's FLOPs per token, and
`peaks.json` the rates.  The counts come from shapes and trip counts,
not from the program under test, so a later change to the program moves
the time and not the count.  The one exception is the kernel shares:
they take how many calls a deploy launched from the program's launch
counters (`kernels.wv_calls`).
"""

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def bound_s(nbytes: float, ops: dict) -> float:
    """Least time the card could take: the larger of the bytes at HBM
    bandwidth and the operations at their class's peak."""
    compute = (ops.get("f32", 0.0) / PEAKS["f32_ops_per_s"]
               + ops.get("bf16", 0.0) / PEAKS["bf16_ops_per_s"])
    return max(nbytes / PEAKS["hbm_bytes_per_s"], compute)


def kernel_share(ctx: dict, kernel: str, names: tuple) -> float | None:
    """Percent of its roofline a kernel reached in the traced window: the
    least time of the traced calls' work (`ctx["kernel_work"][kernel]`)
    over the device time of the trace's kernels whose names hold any of
    `names`.  None where the trace or the work is missing, or no such
    kernel ran."""
    trace, work = ctx.get("trace"), ctx.get("kernel_work", {}).get(kernel)
    if not trace or not work:
        return None
    t = sum(s for n, s in trace["kernel_s"].items() if any(p in n for p in names))
    if t <= 0:
        return None
    return 100.0 * bound_s(work["bytes"], work["ops"]) / t
