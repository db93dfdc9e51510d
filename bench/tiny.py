"""Tiny cells for the benchmark's CPU tests: a cell of `BENCHMARK.json`
with its widths cut to a smoke size and its traffic shortened, run on
the CPU through the same harness code."""

from __future__ import annotations

import copy

from harness import spec

SMOKE = dict(d_model=32, n_heads=2, n_kv_heads=1, head_dim=16, d_ff=64, vocab_size=128)


def cell(workload: str) -> dict:
    c = copy.deepcopy(spec.cell(workload))
    c["config"].update(SMOKE)
    t = c["traffic"]
    if t["kind"] == "serve_closed":
        t.update(clients=4, prompt_len=[4, 8], new_tokens=[8, 12], check_requests=3,
                 trace_start_s=0.0, trace_s=0.5)
    else:
        t.update(check_columns=64)
    return c
