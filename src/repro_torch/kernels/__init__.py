# Hand-written Hopper kernels for the port, each beside its plain PyTorch
# version: `fwht` (Hadamard butterfly), `wv_step` (fused fine-WV cell
# update) and `acim_vmm` (bit-sliced analog VMM with its ADC epilogue).
# `build` compiles `csrc/*.cu` into one ctypes-loaded library.


def launch_counts() -> dict[str, int]:
    """Launches of each kernel so far: every wrapper's own count."""
    from .acim_vmm import ops as vmm_ops
    from .fwht import ops as fwht_ops
    from .wv_step import ops as wv_ops

    return {"fwht": fwht_ops.launches, "wv_step": wv_ops.launches,
            "acim_vmm_tiled": vmm_ops.launches, "acim_vmm": vmm_ops.launches_single}


def launches_since(before: dict[str, int]) -> dict[str, int]:
    """The kernels launched since `before` (a `launch_counts()`), with
    their counts; kernels not launched are left out."""
    now = launch_counts()
    return {k: n - before[k] for k, n in now.items() if n != before[k]}
