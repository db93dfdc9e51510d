"""Share of the window's wall time spent inside the scheduler's
admissions (each a prefill ending in its first token's fetch), from the
harness's own spans around `admit`.  Moves `ttft_p95_ms`."""


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    return 100.0 * sum(ctx["admit_s"]) / ctx["window_s"]
