"""Mean active slots over the window's decode steps, as a share of the
slots (the harness reads `active_slots()` before each step).  Moves
`serve_tokens_per_s`."""


def read(ctx):
    if ctx["kind"] != "serve" or not ctx["occupancy"]:
        return None
    occ = ctx["occupancy"]
    return 100.0 * sum(occ) / len(occ) / ctx["n_slots"]
