"""The whole deploy's share of the card: HARP's needed operations over
the window's deploys (`work.wv_ops`, from the cells' columns and the
sweeps each ran), at the float32 peak, over the window's wall time
(first deploy's start to last deploy's end).  Moves
`deploy_cells_per_s`."""

from work import PEAKS


def read(ctx):
    if ctx["kind"] != "deploy":
        return None
    return 100.0 * ctx["wv_ops"] / (ctx["window_s"] * PEAKS["f32_ops_per_s"])
