"""RWKV6 "Finch" block: time-mix with data-dependent decay + channel-mix
(the reference's `models/rwkv6.py`).

  * token-shift lerp between x_t and x_{t-1} feeding r/k/v/w/g;
  * data-dependent decay w_t = exp(-exp(w0 + tanh(x W_a) W_b)), its log
    clamped to [LOG_W_MIN, -1e-4];
  * per-head wkv state S in R^{hd x hd}: y_t = r_t (S_{t-1} + u * k_t^T v_t),
    S_t = diag(w_t) S_{t-1} + k_t^T v_t;
  * squared-ReLU channel mix.

`time_mix` is the reference's chunked linear-attention (GLA) form in
float32: CHUNK-token chunks (the tail zero-padded to a whole chunk), two
matmuls per chunk and a cross-chunk state carried from chunk to chunk.
The reference groups the chunks 16 at a time (for its backward's memory)
and pads the last group with identity chunks (zero k, v and log-decay);
the port walks the same padded chunk sequence.  An identity chunk leaves
the state as it was (``exp(0) * S + 0``).  Under autograd each group is
a checkpoint (`remat`, the reference's `jax.checkpoint` of its group
body): backward keeps only the groups' boundary states and recomputes
one group's chunk chain at a time.  S == 1 (decode) takes the same
path: the chunk is padded with zero k/v and zero log-decay.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from . import remat
from .act_sharding import constrain
from .config import ModelConfig
from .layers import dense_init, matmul, slice_layer

__all__ = ["CHUNK", "LOG_W_MIN", "DECAY_LORA", "RWKVState", "init_rwkv_params",
           "time_mix", "channel_mix", "init_rwkv_state"]

CHUNK = 16
LOG_W_MIN = -3.5
DECAY_LORA = 64
_F32 = torch.float32


class RWKVState(NamedTuple):
    wkv: torch.Tensor      # (B, H, hd, hd) float32
    shift_t: torch.Tensor  # (B, D) last token's x (time-mix shift)
    shift_c: torch.Tensor  # (B, D) last token's x (channel-mix shift)


def init_rwkv_params(gen, cfg: ModelConfig, n_layers: int, device) -> dict[str, Any]:
    d, dt, ff, L = cfg.d_model, cfg.dtype, cfg.d_ff, n_layers
    hd = cfg.head_dim
    h = d // hd

    def stack(din, dout, std=None):
        return dense_init(gen, L, din, dout, dt, device, std)

    def half():
        return torch.full((L, d), 0.5, dtype=dt, device=device)

    p = {f"mix_{n}": half() for n in ("r", "k", "v", "w", "g", "c")}
    p.update({
        "w_r": stack(d, d),
        "w_k": stack(d, d),
        "w_v": stack(d, d),
        "w_g": stack(d, d),
        "w_o": stack(d, d),
        "decay_base": torch.linspace(-6.0, -1.0, d, dtype=_F32, device=device)
        [None].repeat(L, 1),
        "decay_a": stack(d, DECAY_LORA, std=0.01),
        "decay_b": stack(DECAY_LORA, d, std=0.01),
        "bonus_u": torch.zeros((L, h, hd), dtype=_F32, device=device),
        "ln_x": torch.zeros((L, d), dtype=_F32, device=device),
        "cm_k": stack(d, ff),
        "cm_v": stack(ff, d),
        "cm_r": stack(d, d),
    })
    return p


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """The x_{t-1} sequence (first slot = the carried token); x: (B, S, D)."""
    return torch.cat([prev[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _decay_logw(x_mix, p, li):
    """Data-dependent per-channel log decay (float32), clamped."""
    a = torch.tanh(matmul(x_mix, slice_layer(p["decay_a"], li))).to(x_mix.dtype)
    b = slice_layer(p["decay_b"], li).to(x_mix.dtype)
    lora = torch.matmul(a.to(_F32), b.to(_F32))
    raw = slice_layer(p["decay_base"], li)[None, None].to(_F32) + lora
    return torch.clamp(-torch.exp(raw), LOG_W_MIN, -1e-4)


def _wkv_chunk(s_carry, rc, kc, vc, lw, u):
    """One chunk (B, H, c, hd) of the GLA form; returns (S', y)."""
    rf, kf, vf = rc.to(_F32), kc.to(_F32), vc.to(_F32)
    lcum = torch.cumsum(lw, dim=2)                       # inclusive
    lc = lcum[:, :, -1:, :]                              # chunk-total log decay
    lm1 = torch.cat([torch.zeros_like(lcum[:, :, :1]), lcum[:, :, :-1]], dim=2)
    q_t = rf * torch.exp(lm1 - lc)
    k_s = kf * torch.exp(lc - lcum)
    att = torch.einsum("bhtd,bhsd->bhts", q_t, k_s)
    tri = torch.tril(torch.ones((CHUNK, CHUNK), dtype=torch.bool, device=rc.device),
                     diagonal=-1)
    att = torch.where(tri[None, None], att, 0.0)
    diag = torch.einsum("bhtd,bhtd->bht", rf, u[None, :, None] * kf)
    y = torch.einsum("bhts,bhsd->bhtd", att, vf)
    y = y + diag[..., None] * vf
    y = y + torch.einsum("bhtd,bhde->bhte", rf * torch.exp(lm1), s_carry)
    s_new = torch.exp(lc.squeeze(2))[..., None] * s_carry + torch.einsum(
        "bhsd,bhse->bhde", k_s, vf)
    return s_new, y


def _wkv_group(s_carry, rc, kc, vc, lwc, u, n_identity: int):
    """A group of chunks (nc, B, H, c, hd) and then `n_identity` identity
    chunks; returns (S', y of each real chunk...)."""
    ys = []
    for i in range(rc.shape[0]):
        s_carry, y = _wkv_chunk(s_carry, rc[i], kc[i], vc[i], lwc[i], u)
        ys.append(y)
    for _ in range(n_identity):
        zero = torch.zeros_like(rc[0])
        s_carry, _ = _wkv_chunk(s_carry, zero, zero, zero, zero.to(_F32), u)
    return (s_carry, *ys)


def time_mix(x: torch.Tensor, p: dict, li: int, cfg: ModelConfig, state: RWKVState,
             mesh=None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (y, new_wkv, new_shift); x: (B, S, D), `p` the stacked
    layer tree, `li` the layer.  On a mesh, x is this rank's rows."""
    b, s, d = x.shape
    hd = cfg.head_dim
    h = d // hd
    xprev = _token_shift(x, state.shift_t)

    def mixed(name):
        mu = slice_layer(p[f"mix_{name}"], li)[None, None].to(x.dtype)
        return x * mu + xprev * (1.0 - mu)

    def proj(name, w):
        return matmul(mixed(name), slice_layer(p[w], li)).reshape(b, s, h, hd)

    r, k, v = (constrain(proj(n, w), mesh, ("batch", None, "model", None))
               for n, w in (("r", "w_r"), ("k", "w_k"), ("v", "w_v")))
    g = F.silu(matmul(mixed("g"), slice_layer(p["w_g"], li)).to(_F32))
    logw = _decay_logw(mixed("w"), p, li).reshape(b, s, h, hd)
    u = slice_layer(p["bonus_u"], li).to(_F32)

    pad = (-s) % CHUNK
    if pad:
        r, k, v, logw = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v, logw))
    nc = (s + pad) // CHUNK

    def to_chunks(t):  # (nc, B, H, c, hd)
        return t.reshape(b, nc, CHUNK, h, hd).permute(1, 0, 3, 2, 4)

    rc, kc, vc, lwc = map(to_chunks, (r, k, v, logw))
    group = min(16, nc)
    n_padded = -(-nc // group) * group      # the reference's identity chunks
    s_carry = state.wkv.to(_F32)
    ys = []
    for g0 in range(0, n_padded, group):
        g1 = min(g0 + group, nc)
        s_carry, *y = remat.checkpoint(_wkv_group, s_carry, rc[g0:g1], kc[g0:g1],
                                       vc[g0:g1], lwc[g0:g1], u, g0 + group - g1)
        ys += y
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(b, s + pad, h, hd)[:, :s]

    # per-head group norm, gate, output projection
    mean = torch.mean(y, dim=-1, keepdim=True)
    var = torch.var(y, dim=-1, keepdim=True, unbiased=False)
    yn = (y - mean) * torch.rsqrt(var + 64e-5)
    yn = yn.reshape(b, s, d) * (1.0 + slice_layer(p["ln_x"], li)[None, None])
    out = matmul((yn * g).to(x.dtype), slice_layer(p["w_o"], li))
    return out, s_carry, x[:, -1]


def channel_mix(x: torch.Tensor, p: dict, li: int, cfg: ModelConfig, state: RWKVState,
                mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Squared-ReLU channel mix; returns (y, new_shift).  On a mesh, x is
    this rank's rows."""
    xprev = _token_shift(x, state.shift_c)
    mu = slice_layer(p["mix_c"], li)[None, None].to(x.dtype)
    xk = x * mu + xprev * (1.0 - mu)
    k = constrain(matmul(xk, slice_layer(p["cm_k"], li)), mesh, ("batch", None, "model"))
    k = torch.square(torch.relu(k.to(_F32))).to(x.dtype)
    r = torch.sigmoid(matmul(xk, slice_layer(p["cm_r"], li)).to(_F32))
    out = r * matmul(k, slice_layer(p["cm_v"], li)).to(_F32)
    return out.to(x.dtype), x[:, -1]


def init_rwkv_state(cfg: ModelConfig, batch: int, device="cuda") -> RWKVState:
    h = cfg.d_model // cfg.head_dim
    return RWKVState(
        wkv=torch.zeros((batch, h, cfg.head_dim, cfg.head_dim), dtype=_F32, device=device),
        shift_t=torch.zeros((batch, cfg.d_model), dtype=cfg.dtype, device=device),
        shift_c=torch.zeros((batch, cfg.d_model), dtype=cfg.dtype, device=device),
    )
