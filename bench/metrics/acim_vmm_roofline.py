"""Share of its roofline the `acim_vmm` kernel reached in the traced window.

The least time the traced calls' analog matmuls could take on the card
(`work.bound_s` of `work.kernels.acim_vmm` for every analog leaf of
every traced call, at 10 DAC planes a real token: prompt tokens at
admission, active slots at decode), over the device time of the
kernels whose names hold "acim_vmm" or "epilogue_kernel" in the trace.
Moves `serve_tokens_per_s`.  Silent when the trace holds none of them
or the traced calls' work is unknown.
"""

from work import kernel_share


def read(ctx):
    return kernel_share(ctx, "acim_vmm", ("acim_vmm", "epilogue_kernel"))
