"""The decoder of every model family: parameter trees and full-sequence
forwards (the reference's `models/transformer.py`).

* dense / MoE transformer blocks (GQA, qk-norm, RoPE or sinusoidal
  positions);
* RWKV6 blocks (attention-free, `rwkv6.py`);
* Hymba hybrid blocks: parallel GQA and SSM heads (`ssm.py`), sliding
  window attention with a few global layers;
* cross-attention conditioning: the VLM's gated block every k layers,
  MusicGen's in every layer;
* multi-codebook output heads (MusicGen) and the stub frontend that
  takes precomputed embeddings.

`init_params` builds the reference's tree for each family: the same key
names, shapes and dtypes, so deployment flattens it into the same leaves
and column uids.  Values come from an explicit `torch.Generator` and are
not the reference's; parity tests carry the reference's params across
with `repro_torch.convert.params_from_numpy`.

The reference's `lax.scan`s over stacked layers are Python loops over
`slice_layer`, which also slices a served `CIMWeight` leaf with its
`layer_id`; layers are always indexed by their place in the whole stack.
MusicGen's per-layer cross-attention comes after the FFN here and before
it in decode, as in the reference (ROADMAP.md C9); so does the VLM's
missing cross block at ``cross_attn_every == n_layers`` (C10).  `loss_fn` is the
reference's next-token loss, differentiable by autograd and, on a served
tree of `CIMWeight` leaves, the in-array eval loss.

On a mesh (`mesh=`, a `DeviceMesh` with axes "data" / "model" and maybe
"pod") each rank computes its own rows of the batch: DTensor parameters
are gathered at use (`moe.params_at_use`: whole, expert stacks to the
rank's own experts), activations are plain tensors holding the rank's
rows (`constrain` marks the reference's layout points and passes them
through), and MoE layers run expert-parallel.  A batch of DTensors is
the global view: `forward` returns DTensor logits laid out over the
batch axes and `loss_fn` the loss of the whole batch, every rank's
masked CE sum over the global count of valid tokens plus the mean of
the per-block aux losses (the reference's value under `shard_map`).  A
plain batch is the rank's own rows, and the results are those rows'.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.distributed.collectives import all_reduce_axes, mean_over, reduce_from
from repro_torch.distributed.sharding import is_dtensor

from . import rwkv6 as rwkv_mod
from . import ssm as ssm_mod
from .act_sharding import batch_rows, constrain
from .attention import chunked_causal_attention, cross_attention
from .config import ModelConfig
from .layers import (
    apply_rope,
    cross_entropy_loss,
    dense_init,
    head_rms_norm,
    matmul,
    rms_norm,
    sinusoidal_positions,
    slice_layer,
    swiglu,
    truncated_normal,
)
from .moe import init_moe_params, moe_block, params_at_use

__all__ = ["init_params", "slice_layer", "embed_inputs", "output_logits",
           "forward", "loss_fn"]

_F32 = torch.float32


# --------------------------------------------------------------------------
# Parameter initialization
# --------------------------------------------------------------------------
def _attn_layer_params(gen, cfg: ModelConfig, n_layers: int, device) -> dict[str, Any]:
    d, dt, L = cfg.d_model, cfg.dtype, n_layers

    def stack(din, dout):
        return dense_init(gen, L, din, dout, dt, device)

    p = {
        "attn_norm": torch.zeros((L, d), dtype=_F32, device=device),
        "wq": stack(d, cfg.q_dim),
        "wk": stack(d, cfg.kv_dim),
        "wv": stack(d, cfg.kv_dim),
        "wo": stack(cfg.q_dim, d),
        "mlp_norm": torch.zeros((L, d), dtype=_F32, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((L, cfg.head_dim), dtype=_F32, device=device)
        p["k_norm"] = torch.zeros((L, cfg.head_dim), dtype=_F32, device=device)
    if cfg.is_moe:
        p["moe"] = init_moe_params(gen, cfg, L, device)
    else:
        p["w_gate"] = stack(d, cfg.d_ff)
        p["w_up"] = stack(d, cfg.d_ff)
        p["w_down"] = stack(cfg.d_ff, d)
    return p


def _cross_layer_params(gen, cfg: ModelConfig, n_layers: int, device) -> dict[str, Any]:
    d, dt, dc, L = cfg.d_model, cfg.dtype, cfg.cross_d_cond or cfg.d_model, n_layers
    return {
        "norm": torch.zeros((L, d), dtype=_F32, device=device),
        "wq": dense_init(gen, L, d, cfg.q_dim, dt, device),
        "wk": dense_init(gen, L, dc, cfg.kv_dim, dt, device),
        "wv": dense_init(gen, L, dc, cfg.kv_dim, dt, device),
        "wo": dense_init(gen, L, cfg.q_dim, d, dt, device),
        "gate": torch.zeros((L,), dtype=_F32, device=device),  # zero-init gated residual
    }


def init_params(seed: int, cfg: ModelConfig, device="cuda") -> dict[str, Any]:
    """The parameter tree of `cfg`'s family, from `seed` (the layer
    stacks drawn first, so a dense config's values are those the port
    drew before the other families were added)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    d = cfg.d_model
    params: dict[str, Any] = {
        "final_norm": torch.zeros((d,), dtype=_F32, device=device),
    }
    if cfg.block == "rwkv6":
        params["layers"] = rwkv_mod.init_rwkv_params(gen, cfg, cfg.n_layers, device)
    else:
        params["layers"] = _attn_layer_params(gen, cfg, cfg.n_layers, device)
    if cfg.block == "hymba":
        params["ssm"] = ssm_mod.init_ssm_params(gen, cfg, cfg.n_layers, device)
        params["branch_norm"] = torch.zeros((cfg.n_layers, 2, d), dtype=_F32,
                                            device=device)
    if cfg.block != "rwkv6" and (cfg.cross_attn_every > 0 or cfg.cross_kv_len > 0):
        # grouped (VLM, every k layers) or per-layer (MusicGen) conditioning
        n_cross = cfg.num_cross_layers if cfg.cross_attn_every > 0 else cfg.n_layers
        params["cross_layers"] = _cross_layer_params(gen, cfg, n_cross, device)
    if cfg.frontend != "embed_stub":
        params["tok_embed"] = truncated_normal(
            gen, (cfg.vocab_size, d), 0.02, cfg.dtype, device)
    if not cfg.tie_embeddings or cfg.frontend == "embed_stub":
        shape = ((cfg.n_codebooks, d, cfg.vocab_size) if cfg.n_codebooks > 1
                 else (d, cfg.vocab_size))
        params["lm_head"] = truncated_normal(gen, shape, 0.02, cfg.dtype, device)
    return params


# --------------------------------------------------------------------------
# Blocks (one layer, given sliced params)
# --------------------------------------------------------------------------
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


def _ffn(x, pl, cfg: ModelConfig, mesh=None):
    h = rms_norm(x, pl["mlp_norm"], cfg.norm_eps)
    if cfg.is_moe:
        return moe_block(h, pl["moe"], cfg, mesh)
    return (swiglu(h, pl["w_gate"], pl["w_up"], pl["w_down"]),
            torch.zeros((), dtype=_F32, device=x.device))


def _res_spec(cfg: ModelConfig) -> tuple:
    return ("batch", None, "model" if cfg.shard_residual else None)


def _attn_block_train(x, pl, cfg: ModelConfig, positions, window: int, mesh=None):
    """One layer over the full sequence; returns (x_out, aux, k, v)."""
    x = constrain(x, mesh, ("batch", None, None))
    q, k, v = _project_qkv(x, pl, cfg, positions)
    q = constrain(q, mesh, ("batch", None, "model", None))
    k = constrain(k, mesh, ("batch", None, "model", None))
    v = constrain(v, mesh, ("batch", None, "model", None))
    attn = chunked_causal_attention(
        q, k, v, chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv,
        window=window)
    attn = matmul(attn.reshape(*x.shape[:2], cfg.q_dim), pl["wo"])
    x = constrain(x + attn, mesh, ("batch", None, None))
    ff, aux = _ffn(x, pl, cfg, mesh)
    return constrain(x + ff, mesh, _res_spec(cfg)), aux, k, v


def _gated(x, cl, out):
    gate = torch.tanh(cl["gate"].to(_F32)).to(x.dtype)
    return x + gate * out


def _cross_block(x, cl, cond_kv, cfg: ModelConfig):
    """Gated cross-attention conditioning block (precomputed cond k/v)."""
    b, s, _ = x.shape
    h = rms_norm(x, cl["norm"], cfg.norm_eps)
    q = matmul(h, cl["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k, v = cond_kv
    out = cross_attention(q, k, v, chunk_q=cfg.attn_chunk_q)
    return _gated(x, cl, matmul(out.reshape(b, s, cfg.q_dim), cl["wo"]))


def _cond_kv(cond, cl, cfg: ModelConfig):
    b, t, _ = cond.shape
    c = cond.to(cfg.dtype)
    k = matmul(c, cl["wk"]).reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    v = matmul(c, cl["wv"]).reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    return k, v


def _hymba_window(cfg: ModelConfig, li: int) -> int:
    """Hymba: every `global_layer_every`-th layer (plus the first and the
    last) is global full attention; the rest use the sliding window."""
    if cfg.block != "hymba" or cfg.sliding_window <= 0:
        return cfg.sliding_window if cfg.block != "hymba" else 0
    is_global = (
        li == 0
        or li == cfg.n_layers - 1
        or (cfg.global_layer_every > 0 and li % cfg.global_layer_every == 0)
    )
    return 0 if is_global else cfg.sliding_window


def _hymba_runs(cfg: ModelConfig) -> list[tuple[int, int, int]]:
    """Consecutive layer runs with equal attention window: (start, end, win)."""
    runs: list[tuple[int, int, int]] = []
    for li in range(cfg.n_layers):
        w = _hymba_window(cfg, li)
        if runs and runs[-1][2] == w:
            runs[-1] = (runs[-1][0], li + 1, w)
        else:
            runs.append((li, li + 1, w))
    return runs


def _hymba_layers(cfg: ModelConfig):
    """(layer, window) in stack order, walked run by run as the reference
    scans its runs."""
    for start, end, win in _hymba_runs(cfg):
        for li in range(start, end):
            yield li, win


def _hymba_mix(x, attn, ssm_out, bn, cfg: ModelConfig):
    """Fuse the two heads: x + (norm(attn) + norm(ssm)) / 2."""
    return x + 0.5 * (rms_norm(attn, bn[0], cfg.norm_eps)
                      + rms_norm(ssm_out, bn[1], cfg.norm_eps))


# --------------------------------------------------------------------------
# Embedding / heads
# --------------------------------------------------------------------------
def embed_inputs(params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    if cfg.frontend == "embed_stub":
        x = batch["embeds"].to(cfg.dtype)
    else:
        x = params["tok_embed"][batch["tokens"]].to(cfg.dtype)
    if cfg.pos_embedding == "sinusoidal":
        s = x.shape[1]
        pos = batch.get("pos_offset", 0) + torch.arange(s, device=x.device)
        x = x + sinusoidal_positions(pos, cfg.d_model)[None].to(cfg.dtype)
    return x


def output_logits(params, x, cfg: ModelConfig, mesh=None) -> torch.Tensor:
    """Final norm and head: float32 logits (..., V), or (..., C, V) with
    C codebooks.  The untied 2-D `lm_head` goes through `matmul` (an
    analog leaf when served by an executor); the tied head multiplies by
    `tok_embed` in float32."""
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.n_codebooks > 1:
        out = torch.einsum("bsd,cdv->bscv", h.to(_F32), params["lm_head"].to(_F32))
        return constrain(out, mesh, ("batch", None, None, "model"))
    if "lm_head" in params:
        out = matmul(h, params["lm_head"]).to(_F32)
    else:
        out = torch.matmul(h.to(_F32), params["tok_embed"].to(_F32).t())
    return constrain(out, mesh, ("batch", None, "model"))


# --------------------------------------------------------------------------
# Full-sequence forward (training / prefill)
# --------------------------------------------------------------------------
def forward(params, batch: dict, cfg: ModelConfig, mesh=None, *,
            collect_cache: bool = False, pos_offset: int = 0):
    """Full-sequence forward.  batch: tokens (B, S) or embeds (B, S, D),
    optional cond (B, T, dc).  Returns (logits, aux_loss, caches | None).

    On a mesh: the rank's rows (see the module docstring); with a DTensor
    batch the logits are a DTensor over the batch axes and aux the mean
    over the row blocks.  Caches on a mesh are the serving half of
    ROADMAP.md A5."""
    if mesh is None:
        return _forward(params, batch, cfg, None, collect_cache, pos_offset)
    if collect_cache:
        raise NotImplementedError("forward(mesh=, collect_cache=True): caches on a mesh "
                                  "are the serving half of ROADMAP.md A5")
    lb, rows = batch_rows(batch, mesh)
    logits, aux, _ = _forward(params_at_use(params), lb, cfg, mesh, False, pos_offset)
    if not any(is_dtensor(v) for v in batch.values()):
        return logits, aux, None
    from torch.distributed.tensor import DTensor

    ref = next(v for v in batch.values() if is_dtensor(v))
    shape = (ref.shape[0],) + tuple(logits.shape[1:])
    logits = DTensor.from_local(logits, mesh, ref.placements, run_check=False,
                                shape=torch.Size(shape),
                                stride=torch.empty(shape, device="meta").stride())
    return logits, mean_over(aux, mesh, rows), None


def _forward(params, batch: dict, cfg: ModelConfig, mesh, collect_cache: bool,
             pos_offset: int):
    """The forward over plain tensors: all rows, or a rank's rows."""
    x = embed_inputs(params, batch, cfg)
    s = x.shape[1]
    positions = pos_offset + torch.arange(s, device=x.device)[None, :]

    if cfg.block == "rwkv6":
        return _forward_rwkv(params, x, cfg, mesh, collect_cache)
    cond = batch.get("cond")
    if cfg.block == "hymba":
        return _forward_hymba(params, x, cfg, mesh, positions, collect_cache)
    # Grouped cross-attention only below n_layers: at cross_attn_every >=
    # n_layers this forward runs no cross block, while decode runs one
    # (the reference's paths, ROADMAP.md C10).
    if 0 < cfg.cross_attn_every < cfg.n_layers:
        return _forward_grouped_cross(params, x, cond, cfg, mesh, positions,
                                      collect_cache)

    # Homogeneous stack, with per-layer cross-attention (MusicGen) after
    # each layer's FFN when a conditioning is given.
    per_layer_cross = cfg.cross_attn_every == 0 and cond is not None
    lay = params["layers"]
    aux = torch.zeros((), dtype=_F32, device=x.device)
    ks, vs = [], []
    for idx in range(cfg.n_layers):
        x, aux_i, k, v = _attn_block_train(
            x, slice_layer(lay, idx), cfg, positions, window=cfg.sliding_window,
            mesh=mesh)
        if per_layer_cross:
            cl = slice_layer(params["cross_layers"], idx)
            x = _cross_block(x, cl, _cond_kv(cond, cl, cfg), cfg)
        aux = aux + aux_i
        if collect_cache:
            ks.append(k)
            vs.append(v)
    caches = {"k": torch.stack(ks), "v": torch.stack(vs)} if collect_cache else None
    return output_logits(params, x, cfg, mesh), aux / cfg.n_layers, caches


def _forward_rwkv(params, x, cfg: ModelConfig, mesh, collect_cache: bool):
    lay = params["layers"]
    st0 = rwkv_mod.init_rwkv_state(cfg, x.shape[0], device=x.device)
    states = []
    for idx in range(cfg.n_layers):
        x = constrain(x, mesh, ("batch", None, None))
        y, wkv_fin, shift_t = rwkv_mod.time_mix(x, lay, idx, cfg, st0, mesh)
        x = x + y
        cm, shift_c = rwkv_mod.channel_mix(x, lay, idx, cfg, st0, mesh)
        x = constrain(x + cm, mesh, _res_spec(cfg))
        if collect_cache:
            states.append((wkv_fin, shift_t, shift_c))
    caches = None
    if collect_cache:
        caches = {name: torch.stack([st[i] for st in states])
                  for i, name in enumerate(("wkv", "shift_t", "shift_c"))}
    return (output_logits(params, x, cfg, mesh),
            torch.zeros((), dtype=_F32, device=x.device), caches)


def _forward_hymba(params, x, cfg: ModelConfig, mesh, positions, collect_cache: bool):
    """Global and SWA layers in order; an SWA layer's cache is cut to its
    last `window` positions."""
    lay, ssm_p = params["layers"], params["ssm"]
    aux = torch.zeros((), dtype=_F32, device=x.device)
    kv_global, kv_swa, ssm_finals = [], [], []
    st0 = ssm_mod.init_ssm_state(cfg, x.shape[0], device=x.device)
    for li, win in _hymba_layers(cfg):
        pl = slice_layer(lay, li)
        x = constrain(x, mesh, ("batch", None, None))
        q, k, v = _project_qkv(x, pl, cfg, positions)
        q = constrain(q, mesh, ("batch", None, "model", None))
        k = constrain(k, mesh, ("batch", None, "model", None))
        v = constrain(v, mesh, ("batch", None, "model", None))
        attn = chunked_causal_attention(
            q, k, v, chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv, window=win)
        attn = matmul(attn.reshape(*x.shape[:2], cfg.q_dim), pl["wo"])
        ssm_out, ssm_fin = ssm_mod.ssm_branch(x, slice_layer(ssm_p, li), cfg, st0, mesh)
        x = _hymba_mix(x, attn, ssm_out, params["branch_norm"][li], cfg)
        ff, aux_i = _ffn(x, pl, cfg, mesh)
        x = constrain(x + ff, mesh, _res_spec(cfg))
        aux = aux + aux_i
        if collect_cache:
            kv = (k[:, -win:], v[:, -win:]) if win else (k, v)
            (kv_global if win == 0 else kv_swa).append(kv)
            ssm_finals.append(ssm_fin.h)
    caches = None
    if collect_cache:
        caches = {
            "k_global": torch.stack([k for k, _ in kv_global]),
            "v_global": torch.stack([v for _, v in kv_global]),
            "k_swa": torch.stack([k for k, _ in kv_swa]),
            "v_swa": torch.stack([v for _, v in kv_swa]),
            "ssm_h": torch.stack(ssm_finals),
        }
    return output_logits(params, x, cfg, mesh), aux / cfg.n_layers, caches


def _forward_grouped_cross(params, x, cond, cfg: ModelConfig, mesh, positions,
                           collect_cache):
    """VLM: a cross-attention block before each group of self-attention
    layers."""
    n_groups = cfg.num_cross_layers
    per = cfg.n_layers // n_groups
    lay = params["layers"]
    aux = torch.zeros((), dtype=_F32, device=x.device)
    ks, vs = [], []
    for gi in range(n_groups):
        cl = slice_layer(params["cross_layers"], gi)
        x = _cross_block(x, cl, _cond_kv(cond, cl, cfg), cfg)
        for li in range(gi * per, (gi + 1) * per):
            x, aux_i, k, v = _attn_block_train(
                x, slice_layer(lay, li), cfg, positions, window=cfg.sliding_window,
                mesh=mesh)
            aux = aux + aux_i
            if collect_cache:
                ks.append(k)
                vs.append(v)
    caches = {"k": torch.stack(ks), "v": torch.stack(vs)} if collect_cache else None
    return output_logits(params, x, cfg, mesh), aux / cfg.n_layers, caches


def loss_fn(params, batch: dict, cfg: ModelConfig, mesh=None):
    """Next-token CE (+ router aux); returns (loss, metrics).

    batch: tokens (B, S) or embeds, optional cond, targets (B, S) integer
    ((B, S, C) with C codebooks) and mask (B, S) float32.

    On a mesh, every rank returns the same loss of the batch (a DTensor
    batch) or of its rows (a plain one), and autograd through it gives
    each rank the gradient of its own rows' share: summed over the
    batch axes it is the gradient of the whole batch's loss.
    """
    if mesh is None:
        logits, aux, _ = _forward(params, batch, cfg, None, False, 0)
        lb, rows = batch, ()
    else:
        lb, rows = batch_rows(batch, mesh)
        logits, aux, _ = _forward(params_at_use(params), lb, cfg, mesh, False, 0)
    mask = lb["mask"]
    if cfg.n_codebooks > 1:
        mask = mask[..., None] * torch.ones((1, 1, cfg.n_codebooks), dtype=_F32,
                                            device=mask.device)
    ce = cross_entropy_loss(logits, lb["targets"], mask)
    if mesh is not None:
        # This rank's masked CE sum over the whole batch's mask sum (the
        # clamps are `cross_entropy_loss`'s).
        n_mine = torch.clamp_min(torch.sum(mask), 1.0)
        n_all = torch.clamp_min(all_reduce_axes(torch.sum(mask), mesh, rows), 1.0)
        ce = reduce_from(ce * (n_mine / n_all), mesh, rows)
        aux = mean_over(aux, mesh, rows)
    loss = ce + cfg.router_aux_coef * aux
    return loss, {"loss": loss, "ce": ce, "router_aux": aux}
