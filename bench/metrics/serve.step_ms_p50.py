"""Median wall time of one decode step (`step`, ending in its one host
fetch), from the harness's spans.  Moves `tpot_p95_ms`."""

import statistics


def read(ctx):
    if ctx["kind"] != "serve" or not ctx["step_s"]:
        return None
    return 1e3 * statistics.median(ctx["step_s"])
