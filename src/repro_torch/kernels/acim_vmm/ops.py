"""Public wrappers for the bit-sliced ACiM VMM kernel.

A CPU tensor goes to the plain version (`ref.py`); a CUDA tensor
launches the CUDA kernel (`csrc/acim_vmm.cu`) or raises; a meta tensor
(shapes only) gets an empty result and launches nothing.  Both entry
points launch the same kernel: `acim_vmm` is its one-tile view.  `work`
is a call's bytes and operations, which a launch and a meta call add to
the open counters (`obs.work`).
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

from repro_torch.obs import work as work_hook

from . import ref

launches = 0
launches_single = 0

MAX_SPLIT_TILES = 384   # csrc/acim_vmm.cu kMaxSplitTiles
_SMS: dict = {}


def work(b: int, n_tiles: int, s: int, r: int, m: int, *, binary: bool = True,
         noise: bool = True) -> tuple[float, dict[str, float]]:
    """(bytes, FLOPs by dtype class) of one call: x (B, T*R), the two
    (T, S, R, M) conductance planes and the (T, S, B, M) noise read once
    and the (B, M) result written once, all float32; and the products.
    A chunk of x that is all 0 or 1 (DAC planes) runs as 3 exact bf16
    tensor-core products per multiply-add, other x as one float32 FMA.
    The kernel picks per chunk from the values, which a meta tensor does
    not have: a meta call and a launch count the DAC-plane route, the
    one `cim.mvm.cim_matmul` feeds, whose time at the card's rates is
    the smaller of the two (a bound either way)."""
    macs = b * n_tiles * r * m * s
    nbytes = 4.0 * (b * n_tiles * r + 2 * n_tiles * s * r * m
                    + (n_tiles * s * b * m if noise else 0) + b * m)
    return nbytes, ({"bf16": 6.0 * macs} if binary else {"f32": 2.0 * macs})


def _meta(name: str, x, g_pos, g_neg, noise) -> torch.Tensor:
    """The result of a call on meta tensors: checked as a launch is, its
    work added to the open counters, nothing launched."""
    b, n_tiles, s, r, m = _check(x, g_pos, g_neg, noise)
    work_hook.add_kernel(name, *work(b, n_tiles, s, r, m, noise=noise is not None))
    return torch.empty((b, m), dtype=torch.float32, device=x.device)


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
    planes = (g_pos.reshape(1, s, k, m), g_neg.reshape(1, s, k, m))
    if x.device.type == "meta":
        return _meta("acim_vmm", x, *planes, nz)
    out = _launch("acim_vmm", x, *planes, nz, bc, adc_bits, full_scale)
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
    if x.device.type == "meta":
        return _meta("acim_vmm_tiled", x, g_pos, g_neg, noise)
    out = _launch("acim_vmm_tiled", x, g_pos, g_neg, noise, bc, adc_bits, full_scale)
    if out.numel():
        launches += 1
    return out


def _check(x, g_pos, g_neg, noise) -> tuple[int, int, int, int, int]:
    """The kernel's operand rules; returns (B, T, S, R, M)."""
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
        if t.device != x.device:
            raise ValueError(f"acim_vmm kernel: {name} must be on {x.device}, "
                             f"got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"acim_vmm kernel: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"acim_vmm kernel: {name} must be contiguous")
    return b, n_tiles, s, r, m


def _launch(name: str, x, g_pos, g_neg, noise, bc, adc_bits, full_scale) -> torch.Tensor:
    """Check the operands and launch the CUDA kernel on the current stream;
    `name` is the entry whose work the launch adds to the open counters."""
    if not x.is_cuda:
        raise ValueError(f"acim_vmm kernel needs CUDA tensors, got {x.device}")
    b, n_tiles, s, r, m = _check(x, g_pos, g_neg, noise)
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
    work_hook.add_kernel(name, *work(b, n_tiles, s, r, m, noise=noise is not None))
    return out
