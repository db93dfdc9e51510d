"""Share of its roofline the `wv_step` kernel reached in the traced window.

The least time the `wv_step` calls the traced deploy launched could
take on the card (`work.bound_s` of `work.kernels.wv_step`, each call at
its bucket's columns: `work.kernels.wv_calls`), over the device time of
the kernels whose names hold "wv_step" in the trace.  Moves
`deploy_cells_per_s`.  Silent when the trace holds none of them or the
traced calls' work is unknown.
"""

from work import kernel_share


def read(ctx):
    return kernel_share(ctx, "wv_step", ("wv_step",))
