"""The dense attention decoder: parameter tree and full-sequence forward.

`init_params` builds the reference's `models/transformer.py:init_params`
tree for the dense attention block: the same key names, shapes and
dtypes, so deployment flattens it into the same leaves and column uids.
Values come from an explicit `torch.Generator` and are not the
reference's; parity tests carry the reference's params across with
`repro_torch.convert.params_from_numpy`.

`forward` is the reference's homogeneous dense stack (GQA, qk-norm,
RoPE), its `lax.scan` over layers a Python loop over `slice_layer`.
Other blocks (MoE, rwkv6, hymba, cross-attention, multi-codebook heads,
stub frontends) raise `NotImplementedError`.  `loss_fn` is the
reference's next-token loss over `forward`, differentiable by autograd
and, on a served tree of `CIMWeight` leaves, the in-array eval loss.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.cim.tile import CIMWeight

from .attention import chunked_causal_attention
from .config import ModelConfig
from .layers import (
    apply_rope,
    cross_entropy_loss,
    head_rms_norm,
    matmul,
    rms_norm,
    swiglu,
)

__all__ = ["init_params", "slice_layer", "embed_inputs", "output_logits",
           "forward", "loss_fn"]


def _truncated_normal(gen, shape, std, dtype, device) -> torch.Tensor:
    """std * N(0, 1) truncated to [-2, 2], cast to `dtype`."""
    x = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (x * std).to(dtype)


def _dense(gen, n_layers, d_in, d_out, dtype, device) -> torch.Tensor:
    return _truncated_normal(gen, (n_layers, d_in, d_out),
                             1.0 / math.sqrt(d_in), dtype, device)


def init_params(seed: int, cfg: ModelConfig, device="cuda") -> dict[str, Any]:
    """The dense attention decoder's parameter tree, from `seed`."""
    if (cfg.block != "attn" or cfg.is_moe or cfg.cross_attn_every
            or cfg.frontend != "none" or not cfg.tie_embeddings):
        raise NotImplementedError(
            f"init_params covers the dense attention block only, got {cfg.name} "
            "(the other families are ROADMAP.md A4)")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    d, dt, L = cfg.d_model, cfg.dtype, cfg.n_layers
    f32 = torch.float32
    layers: dict[str, Any] = {
        "attn_norm": torch.zeros((L, d), dtype=f32, device=device),
        "wq": _dense(gen, L, d, cfg.q_dim, dt, device),
        "wk": _dense(gen, L, d, cfg.kv_dim, dt, device),
        "wv": _dense(gen, L, d, cfg.kv_dim, dt, device),
        "wo": _dense(gen, L, cfg.q_dim, d, dt, device),
        "mlp_norm": torch.zeros((L, d), dtype=f32, device=device),
    }
    if cfg.qk_norm:
        layers["q_norm"] = torch.zeros((L, cfg.head_dim), dtype=f32, device=device)
        layers["k_norm"] = torch.zeros((L, cfg.head_dim), dtype=f32, device=device)
    layers["w_gate"] = _dense(gen, L, d, cfg.d_ff, dt, device)
    layers["w_up"] = _dense(gen, L, d, cfg.d_ff, dt, device)
    layers["w_down"] = _dense(gen, L, cfg.d_ff, d, dt, device)
    return {
        "final_norm": torch.zeros((d,), dtype=f32, device=device),
        "tok_embed": _truncated_normal(gen, (cfg.vocab_size, d), 0.02, dt, device),
        "layers": layers,
    }


# --------------------------------------------------------------------------
# Forward (dense attention stack)
# --------------------------------------------------------------------------
def _check_dense(cfg: ModelConfig) -> None:
    if cfg.block != "attn" or cfg.is_moe:
        raise NotImplementedError(
            f"the port's forward covers the dense attention stack, got "
            f"block={cfg.block!r} moe={cfg.is_moe} ({cfg.name}; ROADMAP.md A4)")
    if cfg.cross_attn_every or cfg.cross_kv_len or cfg.cross_d_cond:
        raise NotImplementedError(
            f"cross-attention is not ported ({cfg.name}; ROADMAP.md A4)")
    if cfg.n_codebooks > 1 or cfg.frontend != "none":
        raise NotImplementedError(
            f"multi-codebook heads and stub frontends are not ported "
            f"({cfg.name}; ROADMAP.md A4)")
    if cfg.pos_embedding == "sinusoidal":
        raise NotImplementedError(
            f"sinusoidal positions are not ported ({cfg.name}; ROADMAP.md A4)")


def slice_layer(tree: Any, idx: int) -> Any:
    """Layer `idx` of a stacked layer tree (the reference's
    ``tree.map(lambda a: a[idx], lay)``); `CIMWeight` leaves slice every
    tensor field through `CIMWeight.layer`."""
    if isinstance(tree, dict):
        return {k: slice_layer(v, idx) for k, v in tree.items()}
    if isinstance(tree, CIMWeight):
        return tree.layer(idx)
    return tree[idx]


def _project_qkv(x, pl, cfg: ModelConfig, positions):
    b, s, _ = x.shape
    h = rms_norm(x, pl["attn_norm"], cfg.norm_eps)
    q = matmul(h, pl["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = matmul(h, pl["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = matmul(h, pl["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = head_rms_norm(q, pl["q_norm"], cfg.norm_eps)
        k = head_rms_norm(k, pl["k_norm"], cfg.norm_eps)
    if cfg.pos_embedding == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _ffn(x, pl, cfg: ModelConfig):
    h = rms_norm(x, pl["mlp_norm"], cfg.norm_eps)
    return (swiglu(h, pl["w_gate"], pl["w_up"], pl["w_down"]),
            torch.zeros((), dtype=torch.float32, device=x.device))


def _attn_block_train(x, pl, cfg: ModelConfig, positions, window: int):
    """One layer over the full sequence; returns (x_out, aux, k, v)."""
    q, k, v = _project_qkv(x, pl, cfg, positions)
    attn = chunked_causal_attention(
        q, k, v, chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv,
        window=window)
    attn = matmul(attn.reshape(*x.shape[:2], cfg.q_dim), pl["wo"])
    x = x + attn
    ff, aux = _ffn(x, pl, cfg)
    return x + ff, aux, k, v


def embed_inputs(params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    _check_dense(cfg)
    return params["tok_embed"][batch["tokens"]].to(cfg.dtype)


def output_logits(params, x, cfg: ModelConfig) -> torch.Tensor:
    """Final norm and head: float32 logits (..., V).  The untied
    `lm_head` goes through `matmul` (an analog leaf when served by an
    executor); the tied head multiplies by `tok_embed` in float32."""
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if "lm_head" in params:
        return matmul(h, params["lm_head"]).to(torch.float32)
    return torch.matmul(h.to(torch.float32),
                        params["tok_embed"].to(torch.float32).t())


def forward(params, batch: dict, cfg: ModelConfig, *,
            collect_cache: bool = False, pos_offset: int = 0):
    """Full-sequence forward.  batch: tokens (B, S).  Returns (logits,
    aux_loss, caches | None); caches k/v are (L, B, S, KV, hd)."""
    if batch.get("cond") is not None:
        raise NotImplementedError(
            "cross-attention conditioning is not ported (ROADMAP.md A4)")
    x = embed_inputs(params, batch, cfg)
    s = x.shape[1]
    positions = pos_offset + torch.arange(s, device=x.device)[None, :]
    lay = params["layers"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ks, vs = [], []
    for idx in range(cfg.n_layers):
        x, aux_i, k, v = _attn_block_train(
            x, slice_layer(lay, idx), cfg, positions, window=cfg.sliding_window)
        aux = aux + aux_i
        if collect_cache:
            ks.append(k)
            vs.append(v)
    caches = {"k": torch.stack(ks), "v": torch.stack(vs)} if collect_cache else None
    return output_logits(params, x, cfg), aux / cfg.n_layers, caches


def loss_fn(params, batch: dict, cfg: ModelConfig, mesh=None):
    """Next-token CE (+ router aux); returns (loss, metrics).

    batch: tokens, targets (B, S) integer and mask (B, S) float32.  Dense
    configs only: multi-codebook heads raise, as `forward` does.
    """
    if mesh is not None:
        raise NotImplementedError("mesh= is not ported (ROADMAP.md A5)")
    if cfg.n_codebooks > 1:
        raise NotImplementedError(
            f"multi-codebook heads are not ported ({cfg.name}; ROADMAP.md A4)")
    logits, aux, _ = forward(params, batch, cfg)
    ce = cross_entropy_loss(logits, batch["targets"], batch["mask"])
    loss = ce + cfg.router_aux_coef * aux
    return loss, {"loss": loss, "ce": ce, "router_aux": aux}
