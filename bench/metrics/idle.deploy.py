"""Share of the traced window in which no operation ran on the device:
1 - (union of device op intervals) / (window).  Moves
`deploy_cells_per_s`."""


def read(ctx):
    trace = ctx.get("trace")
    if ctx["kind"] != "deploy" or not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
