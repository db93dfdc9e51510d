"""Noisy analog matrix-vector multiply through programmed macro tiles.

The inference datapath of the paper's CBA macro, in cell-LSB units:

1. **Input DAC, bit-serial.**  Activations are scaled per token to a
   signed `dac_bits` code and streamed as binary row-drive planes, one
   per magnitude bit and polarity (positive and negative magnitudes
   drive separate phases; their ADC results subtract digitally).
   ``dac_bits=None`` is an ideal analog driver: one plane, the raw
   activation.
2. **Analog column sums + per-slice ADC, every tile at once.**  All
   planes multiply into every macro tile's signed conductance pair in
   one `kernels.acim_vmm.acim_vmm_tiled` call: per-read TIA/ADC noise
   lands on the analog partial sums, the ADC clamps and quantizes, the
   slices recombine by 2^(Bc*l) per tile, and the tiles sum.  Noise for
   the whole (tile, plane, token) lattice is one batched
   `sample_token_read_noise` draw.
3. **Digital recombination.**  Planes recombine with their bit weights
   and the per-token DAC scale; the per-output-channel quantization
   scale dequantizes to model units.

Read-noise RNG policy: every read draws from

    leaf key -> [uid] -> [layer] -> tile -> plane -> token_id

where the leaf key is the executor's per-access key, `uid` and
`layer_id` ride on the `CIMWeight`, and `token_id` is the flattened
batch index unless the caller passes ids (`token_ids=` or the ambient
`token_stream_ids` context, request ids in a serving scheduler).  A
token's noise so depends only on (access key, uid, layer, tile, plane,
token id), not on its slot or on the batch around it.

In the ideal limit (``dac_bits=None``, ``adc_bits=None``,
``sigma_read_lsb=0``) the pipeline is ``x @ materialize(w)`` in float32
up to reassociation.

On a mesh (a `CIMWeight` of DTensors, `launch.shardings.
shard_cim_weight`) each rank runs the kernel on its own block of the
output columns, with only those columns' read noise drawn
(`rng.normal_cols`), and the kernel's output blocks are gathered over
the mesh axes that split them: a concatenation, so the result is
bitwise the unsharded one.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import rng
from repro_torch.core.numerics import true_div
from repro_torch.distributed.collectives import all_gather_axes, block_of
from repro_torch.distributed.sharding import is_dtensor, local, split_axes
from repro_torch.kernels.acim_vmm import ops as vmm_ops
from repro_torch.readout import noise as ro_noise

from .tile import CIMWeight

__all__ = [
    "CIMConfig",
    "cim_vmm",
    "cim_matmul",
    "planes_per_token",
    "token_stream_ids",
    "current_token_ids",
]


@dataclasses.dataclass(frozen=True)
class CIMConfig:
    """Analog inference configuration.

    `None` for dac_bits/adc_bits selects the ideal converter on that
    side.  `use_pallas` is the reference's field, kept so the two configs
    compare field for field; the port reads the tensors' device instead.
    """

    macro_rows: int = 128            # max rows per crossbar macro tile
    dac_bits: int | None = 6         # input DAC resolution; None = ideal analog
    adc_bits: int | None = 10        # per-slice column ADC; None = ideal
    full_scale_frac: float = 1.0     # ADC range as fraction of +-R*(2^Bc-1)
    sigma_read_lsb: float = 0.0      # per-read TIA/ADC noise std (cell-LSB)
    use_pallas: bool = False         # unread in the port

    def __post_init__(self):
        # dac_bits counts sign + magnitude: >= 2 leaves >= 1 magnitude bit.
        if self.dac_bits is not None and self.dac_bits < 2:
            raise ValueError(f"dac_bits must be >= 2 or None: {self.dac_bits}")
        if self.adc_bits is not None and self.adc_bits < 1:
            raise ValueError(f"adc_bits must be >= 1 or None: {self.adc_bits}")
        if self.macro_rows < 1:
            raise ValueError(f"macro_rows must be >= 1: {self.macro_rows}")

    def replace(self, **kw) -> "CIMConfig":
        return dataclasses.replace(self, **kw)


def planes_per_token(cfg: CIMConfig) -> int:
    """Row-drive planes (= reads of every physical column) per token."""
    if cfg.dac_bits is None:
        return 1
    return 2 * (cfg.dac_bits - 1)  # magnitude bits x {pos, neg} phases


# Ambient per-row token-id stream for the CIM noise sub-streams: a
# serving loop wraps a step in `token_stream_ids(request_ids)` so every
# analog leaf folds the request id instead of the flattened batch row.
_TOKEN_IDS: list = []


@contextlib.contextmanager
def token_stream_ids(ids: torch.Tensor):
    """Route `ids` ((T,) int32) into every `cim_matmul` in the block."""
    _TOKEN_IDS.append(ids)
    try:
        yield
    finally:
        _TOKEN_IDS.pop()


def current_token_ids() -> torch.Tensor | None:
    """The ambient token-id stream, or None (= flattened batch index)."""
    return _TOKEN_IDS[-1] if _TOKEN_IDS else None


def cim_vmm(x, g_pos, g_neg, *, bc: int, adc_bits: int | None,
            full_scale: float, noise=None):
    """One macro-tile readout: (B, R) drives x (S, R, M) slice pairs ->
    (B, M) float32, with pre-ADC `noise` (S, B, M) and the ADC."""
    return vmm_ops.acim_vmm(x, g_pos, g_neg, bc=bc, adc_bits=adc_bits,
                            full_scale=full_scale, noise=noise)


def _dac_stream(xf: torch.Tensor,
                cfg: CIMConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """(T, K) f32 activations -> (P, T, K) row-drive planes, (P, T) weights.

    Ideal driver: one plane, unit weight.  Bit-serial: per-token absmax
    scaling to a signed `dac_bits` code, positive and negative magnitudes
    split into binary planes LSB first; plane order [pos b0..b_{n-1},
    neg b0..b_{n-1}], plane p recombining with weight +-2^bit * s_tok.
    """
    if cfg.dac_bits is None:
        return xf[None], torch.ones((1, xf.shape[0]), dtype=torch.float32,
                                    device=xf.device)
    n_mag = cfg.dac_bits - 1
    q_max = float((1 << n_mag) - 1)
    s_tok = true_div(torch.amax(torch.abs(xf), dim=-1, keepdim=True), q_max)
    s_tok = torch.clamp_min(s_tok, 1e-12)
    q = torch.clamp(torch.round(xf / s_tok), -q_max, q_max).to(torch.int32)
    mag = torch.stack([torch.clamp_min(q, 0), torch.clamp_min(-q, 0)])  # (2, T, K)
    bits = torch.arange(n_mag, dtype=torch.int32, device=xf.device)
    planes = ((mag[:, None] >> bits[None, :, None, None]) & 1).to(torch.float32)
    pow2 = torch.exp2(bits.to(torch.float32))
    bit_w = torch.stack([pow2, -pow2])                         # (2, n_mag)
    weights = bit_w.reshape(-1)[:, None] * s_tok[:, 0][None, :]  # (P, T)
    t, k = xf.shape
    return planes.reshape(2 * n_mag, t, k), weights


def cim_matmul(x: torch.Tensor, w: CIMWeight, *,
               token_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Analog forward of one weight leaf: x (..., K) -> (..., M).

    Drop-in for `models.layers.matmul` (f32 accumulation, result cast to
    x.dtype), computed through the live conductance tiles: one kernel
    call and, when noisy, one batched noise draw for the whole leaf.
    `token_ids` overrides the per-row noise sub-stream ids (default: the
    ambient `token_stream_ids`, else the flattened batch index).
    """
    cfg: CIMConfig = w.cfg
    if w.g_pos.ndim != 4:
        raise ValueError(
            f"CIMWeight {w.name!r}: tile planes must be layer-sliced 4-D "
            f"(T, S, R, M) at matmul time, got shape {tuple(w.g_pos.shape)}; "
            "slice stacked leaves with `CIMWeight.layer` first")
    lead, k = x.shape[:-1], x.shape[-1]
    if k != w.rows_in:
        raise ValueError(
            f"CIMWeight {w.name!r}: input features {k} do not match the "
            f"leaf's {w.rows_in} input rows (tile geometry "
            f"{tuple(w.g_pos.shape)} = (tiles, slices, rows, outputs))")
    xf = x.reshape(-1, k).to(torch.float32)
    t = xf.shape[0]
    if token_ids is None:
        token_ids = current_token_ids()
    if token_ids is not None and tuple(token_ids.shape) != (t,):
        raise ValueError(
            f"CIMWeight {w.name!r}: token_ids shape {tuple(token_ids.shape)} "
            f"does not match the {t} flattened input rows")

    mesh = w.g_pos.device_mesh if is_dtensor(w.g_pos) else None
    axes = split_axes(w.g_pos, w.g_pos.ndim - 1)     # the ones splitting M
    g_pos, g_neg, scale = local(w.g_pos), local(w.g_neg), local(w.scale)
    m_all, cols = w.g_pos.shape[-1], None
    if axes:
        blk = block_of(mesh, axes)[0]
        cols = (blk * g_pos.shape[-1], (blk + 1) * g_pos.shape[-1])

    planes, weights = _dac_stream(xf, cfg)        # (P, T, K), (P, T)
    p = planes.shape[0]
    n_tiles, s, r, m = g_pos.shape
    pad = n_tiles * r - k
    if pad:
        planes = F.pad(planes, (0, pad))
    xp = planes.reshape(p * t, n_tiles * r)
    full_scale = cfg.full_scale_frac * 2.0 * r * float(w.levels - 1)

    noise = None
    if cfg.sigma_read_lsb > 0.0:
        key = local(w.key)
        if w.uid is not None:
            key = rng.fold_in(key, w.uid)
        if w.layer_id is not None:
            key = rng.fold_in(key, local(w.layer_id))
        noise = ro_noise.sample_token_read_noise(
            key, t, s, m_all, cfg.sigma_read_lsb,
            token_ids=token_ids, tiles=n_tiles, planes=p, cols=cols,
        )  # (T_tiles, S, P*T, M of this rank)
    acc = vmm_ops.acim_vmm_tiled(
        xp.contiguous(), g_pos, g_neg, bc=w.bc, adc_bits=cfg.adc_bits,
        full_scale=full_scale, noise=noise,
    )
    if axes:
        # The kernel's outputs are gathered (with the scale, in one
        # collective), not the recombined ones: the plane sum below
        # rounds alike only on operands of the same shape.
        both = all_gather_axes(torch.cat([acc, scale[None]]), mesh, axes, dim=1)
        acc, scale = both[:-1], both[-1]
    y = torch.einsum("pt,ptm->tm", weights, acc.reshape(p, t, m_all))
    y = y * scale[None, :]
    return y.reshape(*lead, m_all).to(x.dtype)
