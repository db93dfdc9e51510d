"""Share of its roofline the `fwht` kernel reached in the traced window.

The least time the `fwht` calls the traced deploy launched could take on
the card (`work.bound_s` of `work.kernels.fwht`, each call at its
bucket's columns: `work.kernels.wv_calls`), over the device time of the
kernels whose names hold "fwht" in the trace.  Moves
`deploy_cells_per_s`.  Silent when the trace holds none of them or the
traced calls' work is unknown.
"""

from work import kernel_share


def read(ctx):
    return kernel_share(ctx, "fwht", ("fwht",))
