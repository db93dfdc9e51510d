"""Plain reference of a dense decoder (qwen3-style: GQA, qk-norm, RoPE,
SwiGLU, tied head) served through programmed RRAM tiles.

One layer stack, computed over whole sequences (prompt then served
tokens), with no cache and no batching across requests: each row's
attention sees its own request's earlier rows.  The analog leaves
(wq, wk, wv, wo, w_gate, w_up, w_down) run the in-array datapath as the
system under test states it: per-token absmax scaling to a signed
`dac_bits` code streamed as binary planes, macro tiles of 128 rows,
per-read noise drawn before a centred `adc_bits` converter in each
slice, slices recombined by 2^(3 l), tiles summed in order, planes by
their bit weights, then the per-channel scale.  Every other leaf is
served digitally; norm scales deployed on the arrays are read back from
the reference's own programmed conductances.

Read noise of a row is drawn from
``fold_in(fold_in(fold_in(fold_in(fold_in(fold_in(master, access), uid),
layer), tile), plane), token_id)``: `access` is the engine access that
computed the row, `uid` the leaf's index among the deployed leaves in
name order, and `token_id` the row's index in its prefill or, at
decode, the request id.

Precision follows the configuration (bfloat16 storage and activations,
float32 accumulation).  `lowp=True` computes one step below it, the
control: activations and digital weights rounded through float8 e4m3,
the analog column sums in bfloat16.
"""

from __future__ import annotations


import torch
import torch.nn.functional as F

from . import rng
from .wv import HARP, SLICES

__all__ = ["AnalogConfig", "slice_tiles", "analog_matmul", "forward_rows"]

_F32 = torch.float32


class AnalogConfig:
    def __init__(self, dac_bits: int, adc_bits: int, sigma_read: float,
                 macro_rows: int = 128):
        self.dac_bits, self.adc_bits = dac_bits, adc_bits
        self.sigma_read, self.macro_rows = sigma_read, macro_rows


def _div(x, s: float):
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def slice_tiles(g: torch.Tensor, k_in: int, m: int, macro_rows: int):
    """(C, N) programmed columns of a (K, M) leaf -> (T, S, R, M) signed
    tile planes (pack padding rows dropped, tile padding rows zero)."""
    n = HARP["n_cells"]
    kp = -(-k_in // n) * n
    cells = torch.movedim(g.reshape(kp // n, m, 2, SLICES, n), -1, 1)
    planes = cells.reshape(kp, m, 2, SLICES).permute(3, 0, 1, 2)[:, :k_in]
    r = min(macro_rows, k_in)
    n_t = -(-k_in // r)
    out = []
    for pol in (0, 1):
        p = planes[..., pol]
        if n_t * r != k_in:
            p = F.pad(p, (0, 0, 0, n_t * r - k_in))
        out.append(p.reshape(SLICES, n_t, r, m).movedim(1, 0).contiguous())
    return out[0], out[1]


def _round_act(x, lowp: bool):
    """Round to the activation dtype (or one step below it)."""
    if lowp:
        return x.to(torch.float8_e4m3fn).to(torch.bfloat16)
    return x.to(torch.bfloat16)


def _row_noise(keys, tiles: int, planes: int, token_ids, s: int, m: int, sigma):
    """(Ti, S, P*R, M) read noise: row r of plane p on tile ti draws
    (S, M) from ``fold_in(fold_in(fold_in(keys[r], ti), p), ids[r])``."""
    r = keys.shape[0]
    dev = keys.device
    ti = torch.arange(tiles, dtype=torch.int64, device=dev)
    pi = torch.arange(planes, dtype=torch.int64, device=dev)
    k = rng.fold_in(keys[None].expand(tiles, r, 2), ti[:, None].expand(tiles, r))
    k = rng.fold_in(k[:, None].expand(tiles, planes, r, 2),
                    pi[None, :, None].expand(tiles, planes, r))
    k = rng.fold_in(k, token_ids[None, None].expand(tiles, planes, r))
    nz = rng.normal(k.reshape(-1, 2), (tiles * planes * r, s, m))
    nz = nz.reshape(tiles, planes, r, s, m).permute(0, 3, 1, 2, 4).contiguous()
    return sigma * nz.reshape(tiles, s, planes * r, m)


def _adc(y, bits: int, fs: float):
    w = fs / float(1 << bits)
    lo = -fs / 2.0
    code = torch.clamp(torch.round(_div(torch.clamp(y, lo, lo + fs) - lo, w)),
                       0, (1 << bits) - 1)
    return lo + code * w


def analog_matmul(x, tiles, scale, keys, token_ids, cfg: AnalogConfig,
                  lowp: bool = False, block: int = 64):
    """x (R, K) bf16 through one leaf's tiles; `keys` (R, 2) are each
    row's leaf noise keys.  Returns (R, M) in x's dtype."""
    g_pos, g_neg = tiles
    n_t, s, r, m = g_pos.shape
    k = x.shape[-1]
    diff = [(g_pos[t] - g_neg[t]).to(_F32) for t in range(n_t)]
    if lowp:
        diff = [d.to(torch.bfloat16) for d in diff]
    outs = []
    for lo in range(0, x.shape[0], block):
        xf = x[lo:lo + block].to(_F32)
        rows = xf.shape[0]
        n_mag = cfg.dac_bits - 1
        q_max = float((1 << n_mag) - 1)
        s_tok = torch.clamp_min(_div(torch.amax(torch.abs(xf), dim=-1, keepdim=True),
                                     q_max), 1e-12)
        q = torch.clamp(torch.round(xf / s_tok), -q_max, q_max).to(torch.int32)
        mag = torch.stack([torch.clamp_min(q, 0), torch.clamp_min(-q, 0)])
        bits = torch.arange(n_mag, dtype=torch.int32, device=x.device)
        planes = ((mag[:, None] >> bits[None, :, None, None]) & 1).to(_F32)
        pow2 = torch.exp2(bits.to(_F32))
        weights = torch.stack([pow2, -pow2]).reshape(-1)[:, None] * s_tok[:, 0][None, :]
        p = planes.shape[0] * planes.shape[1]
        xp = planes.reshape(p * rows, k)
        if n_t * r != k:
            xp = F.pad(xp, (0, n_t * r - k))
        noise = _row_noise(keys[lo:lo + block], n_t, p, token_ids[lo:lo + block],
                           s, m, cfg.sigma_read)
        fs = 1.0 * 2.0 * r * float((1 << HARP["bc"]) - 1)
        acc = torch.zeros((p * rows, m), dtype=_F32, device=x.device)
        for t in range(n_t):
            xi = xp[:, t * r:(t + 1) * r]
            tile_acc = torch.zeros_like(acc)
            for sl in range(s):
                if lowp:
                    part = (xi.to(torch.bfloat16) @ diff[t][sl]).to(_F32)
                else:
                    part = xi @ diff[t][sl]
                part = _adc(part + noise[t, sl], cfg.adc_bits, fs)
                tile_acc = tile_acc + part * float(1 << (HARP["bc"] * sl))
            acc = acc + tile_acc
        y = torch.einsum("pt,ptm->tm", weights, acc.reshape(p, rows, m))
        outs.append(_round_act(y * scale[None, :], lowp))
    return torch.cat(outs)


def _rms_norm(x, scale, eps, lowp):
    var = torch.mean(torch.square(x), dim=-1, keepdim=True, dtype=_F32)
    inv = _round_act(torch.rsqrt(var + eps), lowp)
    return _round_act(x * inv * _round_act(1.0 + scale, lowp), lowp)


def _rope(x, positions, theta, lowp):
    hd = x.shape[-1]
    exps = _div(torch.arange(0, hd, 2, dtype=_F32, device=x.device), float(hd))
    freqs = 1.0 / torch.pow(theta, exps)
    ang = positions[:, None].to(_F32) * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = torch.chunk(x.to(_F32), 2, dim=-1)
    return _round_act(torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1), lowp)


def _attention(q, k, v, lowp):
    """Causal GQA attention of one request's rows: q (L, H, hd), k/v
    (L, KV, hd); float32 scores and softmax, probabilities rounded to
    the activation dtype."""
    L, h, hd = q.shape
    kv = k.shape[1]
    qg = q.reshape(L, kv, h // kv, hd).to(_F32)
    s = torch.einsum("lkgd,skd->kgls", qg, k.to(_F32)) * hd ** -0.5
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    s = torch.where(mask, s, -1e30)
    p = _round_act(torch.softmax(s, dim=-1), lowp)
    out = torch.einsum("kgls,skd->lkgd", p.to(_F32), v.to(_F32))
    return _round_act(out.reshape(L, h * hd), lowp)


def forward_rows(model: dict, seqs: list[dict], cfg: AnalogConfig, lowp: bool = False):
    """Logits of every row of every sequence.

    `model`: dims (d_model, n_heads, n_kv_heads, head_dim, rope_theta,
    norm_eps), `tok_embed` (V, D) and `final_norm` (D,) digital,
    `norms` {attn_norm, mlp_norm, q_norm, k_norm} read back, and
    `analog` {leaf: (tiles, scale, uid)}; `master` the executor's key.
    Each seq: `tokens` (L,) int64, `access` (L,) int64 and `token_ids`
    (L,) int64 per row, `positions` (L,).  Returns a list of (L, V)
    float32 logits.
    """
    dev = model["tok_embed"].device
    toks = torch.cat([s["tokens"] for s in seqs]).to(dev)
    access = torch.cat([s["access"] for s in seqs]).to(dev)
    ids = torch.cat([s["token_ids"] for s in seqs]).to(dev)
    lens = [int(s["tokens"].shape[0]) for s in seqs]
    master = model["master"].to(dev)
    base = rng.fold_in(master[None].expand(toks.shape[0], 2), access)
    eps = model["norm_eps"]
    embed = model["tok_embed"]
    if lowp:
        embed = embed.to(torch.float8_e4m3fn).to(torch.bfloat16)

    def mm(x, name):
        tiles, scale, uid = model["analog"][name]
        keys = rng.fold_in(rng.fold_in(base, uid), 0)
        return analog_matmul(x, tiles, scale, keys, ids, cfg, lowp)

    nh, nkv, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    norms = model["norms"]
    x = _round_act(embed[toks], lowp)
    h = _rms_norm(x, norms["attn_norm"], eps, lowp)
    q = mm(h, "wq").reshape(-1, nh, hd)
    k = mm(h, "wk").reshape(-1, nkv, hd)
    v = mm(h, "wv").reshape(-1, nkv, hd)
    q = _rms_norm(q, norms["q_norm"], eps, lowp)
    k = _rms_norm(k, norms["k_norm"], eps, lowp)
    pos = torch.cat([s["positions"] for s in seqs]).to(dev)
    q = _rope(q, pos, model["rope_theta"], lowp)
    k = _rope(k, pos, model["rope_theta"], lowp)
    outs, off = [], 0
    for L in lens:
        outs.append(_attention(q[off:off + L], k[off:off + L], v[off:off + L], lowp))
        off += L
    x = _round_act(x + mm(torch.cat(outs), "wo"), lowp)
    h = _rms_norm(x, norms["mlp_norm"], eps, lowp)
    gate = mm(h, "w_gate")
    up = mm(h, "w_up")
    act = _round_act(_round_act(F.silu(gate.to(_F32)), lowp) * up, lowp)
    x = _round_act(x + mm(act, "w_down"), lowp)
    h = _rms_norm(x, model["final_norm"], eps, lowp)
    if lowp:
        logits = (h.to(torch.bfloat16) @ embed.t()).to(_F32)
    else:
        logits = torch.matmul(h.to(_F32), embed.to(_F32).t())
    return list(torch.split(logits, lens))
