"""Public wrappers for the bit-sliced ACiM VMM kernel.

A CPU tensor goes to the plain version (`ref.py`); a CUDA tensor
launches the CUDA kernel (`csrc/acim_vmm.cu`) or raises.  Both entry
points launch the same kernel: `acim_vmm` is its one-tile view.
`launches` counts calls of `acim_vmm_tiled` (the serving path's entry)
that launched the kernel and `launches_single` those of `acim_vmm`;
nothing else touches them.

The grid plan is chosen here from the shapes (`_plan`).  Unsplit, one
block per (64-row B-block, M-block) walks every tile and slice in order
with the epilogue in registers.  Where that grid would leave the card's
SMs idle (decode: B = 40 rows), the work is split into (tile, slice,
B-block, M-block) items walked by persistent blocks; their raw partial
sums go to a (T, S, B, M) workspace allocated here with `torch.empty`,
and a second kernel adds the noise, converts and recombines in the
reference's order.  Which products a block uses (exact bf16 x 3
tensor-core products for chunks whose x is all 0 or 1, f32 FMAs
otherwise) is decided on the card, per staged chunk, with no flag and no
host sync.  Times and bounds on the card are in PERF.md.
"""

from __future__ import annotations

import torch

from . import ref

launches = 0
launches_single = 0

MAX_SPLIT_TILES = 384   # csrc/acim_vmm.cu kMaxSplitTiles
_SMS: dict = {}


def _plan(b: int, n_tiles: int, m: int, sms: int = 132) -> bool:
    """Whether to split the leaf into (tile, slice, B-block, M-block)
    items.  The unsplit grid of csrc/acim_vmm.cu is one block per 64 rows
    of x and per 64 columns (B <= 64; two resident per SM) or 128 columns
    (B > 64; one resident per SM).  Split when there is more than one
    tile (and at most `MAX_SPLIT_TILES`) and that grid would leave any
    of the card's `sms` SMs idle."""
    if b <= 64:
        blocks, resident = -(-m // 64), 2 * sms
    else:
        blocks, resident = -(-b // 64) * -(-m // 128), sms
    return 1 < n_tiles <= MAX_SPLIT_TILES and blocks < resident


def _sm_count(device: torch.device) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device]


def acim_vmm(x, g_pos, g_neg, *, bc: int, adc_bits: int | None,
             full_scale: float, noise=None):
    """Bit-sliced signed ACiM VMM with per-slice ADC quantization.

    x (B, K) drives slice pairs g_pos/g_neg (S, K, M); `noise` (S, B, M)
    is added to each slice's partial sums before conversion;
    ``adc_bits=None`` is the ideal converter.  Returns (B, M) float32.
    """
    global launches_single
    if x.device.type == "cpu":
        return ref.acim_vmm(x, g_pos, g_neg, bc, adc_bits, full_scale, noise)
    if g_pos.ndim != 3:
        raise ValueError(f"acim_vmm takes (S, K, M) planes, got {tuple(g_pos.shape)}")
    s, k, m = g_pos.shape
    nz = None if noise is None else noise.reshape(1, *noise.shape)
    out = _launch(x, g_pos.reshape(1, s, k, m), g_neg.reshape(1, s, k, m), nz,
                  bc, adc_bits, full_scale)
    if out.numel():
        launches_single += 1
    return out


def acim_vmm_tiled(x, g_pos, g_neg, *, bc: int, adc_bits: int | None,
                   full_scale: float, noise=None):
    """Whole-leaf ACiM VMM: every macro tile in one launch.

    x (B, T*R) drives per-tile planes g_pos/g_neg (T, S, R, M) with
    per-tile pre-ADC `noise` (T, S, B, M); the result (B, M) is the sum
    over tiles, in tile order, of each tile's ADC-quantized slice
    recombination.
    """
    global launches
    if x.device.type == "cpu":
        return ref.acim_vmm_tiled(x, g_pos, g_neg, bc, adc_bits, full_scale,
                                  noise)
    out = _launch(x, g_pos, g_neg, noise, bc, adc_bits, full_scale)
    if out.numel():
        launches += 1
    return out


def _launch(x, g_pos, g_neg, noise, bc, adc_bits, full_scale) -> torch.Tensor:
    """Check the operands and launch the CUDA kernel on the current stream."""
    if g_pos.ndim != 4 or g_neg.shape != g_pos.shape:
        raise ValueError(f"acim_vmm kernel takes (T, S, R, M) planes, got "
                         f"{tuple(g_pos.shape)} and {tuple(g_neg.shape)}")
    n_tiles, s, r, m = g_pos.shape
    if x.ndim != 2 or x.shape[1] != n_tiles * r:
        raise ValueError(f"acim_vmm kernel: x {tuple(x.shape)} does not drive "
                         f"{n_tiles} tiles of {r} rows")
    b = x.shape[0]
    ops = dict(x=x, g_pos=g_pos, g_neg=g_neg)
    if noise is not None:
        if tuple(noise.shape) != (n_tiles, s, b, m):
            raise ValueError(f"acim_vmm kernel: noise {tuple(noise.shape)} != "
                             f"{(n_tiles, s, b, m)}")
        ops["noise"] = noise
    for name, t in ops.items():
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"acim_vmm kernel: {name} must be a CUDA tensor "
                             f"on {x.device}, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"acim_vmm kernel: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"acim_vmm kernel: {name} must be contiguous")
    if adc_bits is None:
        bits, w, lo, hi, code_max = -1, 1.0, 0.0, 0.0, 0.0
    else:
        # The plain version's constants (readout.converter.sar_quantize).
        bits = int(adc_bits)
        w = full_scale / float(1 << bits)
        lo = -full_scale / 2.0
        hi = lo + full_scale
        code_max = float((1 << bits) - 1)
    from repro_torch.kernels import build

    lib = build.load()
    out = torch.empty((b, m), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    ws = None
    if _plan(b, n_tiles, m, _sm_count(x.device)):
        ws = torch.empty((n_tiles, s, b, m), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.harp_acim_vmm_tiled(
            x.data_ptr(), g_pos.data_ptr(), g_neg.data_ptr(),
            None if noise is None else noise.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            b, n_tiles, s, r, m, int(bc), bits, w, lo, hi, code_max, stream,
        )
    if rc != 0:
        raise RuntimeError(f"acim_vmm kernel launch failed: cudaError {rc}")
    return out
