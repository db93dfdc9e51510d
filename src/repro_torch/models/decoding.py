"""KV caches, prefill and single-token decode for every model family
(the reference's `models/decoding.py`).

Cache layouts (the reference's; batch on axis 1 of every stacked leaf):

  attn models : k/v (L, B, Smax, KV, hd) in cfg.dtype + pos (B,) int32
  + cross-attn: cross_k/cross_v (L_cross, B, T, KV, hd), computed once
                at prefill from the conditioning
  rwkv6       : wkv (L, B, H, hd, hd) float32, shift_t/shift_c (L, B, D)
  hymba       : k/v_global (Lg, B, Smax, KV, hd) for the global layers;
                k/v_swa (Ls, B, W, KV, hd) ring buffers of
                W = min(window, Smax) slots for the sliding-window layers
                (RoPE is applied at write time, so ring order does not
                matter); ssm_h (L, B, d, n) float32

`pos` is the position of each row's last token.  Cache writes follow the
reference's scatter semantics: a decode step writes row b's new k/v at
slot ``pos[b]`` (``pos[b] % W`` in a ring), and a slot outside the cache
is dropped, not an error.  Updates are functional, as in the reference:
a step returns a new cache and leaves its input as it was.
"""

from __future__ import annotations

from typing import Any

import torch

from . import rwkv6 as rwkv_mod
from . import ssm as ssm_mod
from .attention import chunked_causal_attention, decode_attention
from .config import ModelConfig
from .layers import matmul, rms_norm, slice_layer
from .transformer import (
    _cond_kv,
    _ffn,
    _gated,
    _hymba_layers,
    _hymba_mix,
    _hymba_window,
    _project_qkv,
    embed_inputs,
    forward,
    output_logits,
)

__all__ = ["init_cache", "prefill", "prefill_chunk", "decode_step",
           "write_cache_slot"]


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "mesh= for prefill / decode is the serving half of ROADMAP.md A5, "
            "not ported yet (training takes a mesh: training.make_train_step)")


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> dict[str, Any]:
    def zeros(shape, dtype=cfg.dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    def kvshape(n_layers, s):
        return (n_layers, batch, s, cfg.n_kv_heads, cfg.head_dim)

    pos = zeros((batch,), torch.int32)
    if cfg.block == "rwkv6":
        h = cfg.d_model // cfg.head_dim
        return {
            "wkv": zeros((cfg.n_layers, batch, h, cfg.head_dim, cfg.head_dim),
                         torch.float32),
            "shift_t": zeros((cfg.n_layers, batch, cfg.d_model)),
            "shift_c": zeros((cfg.n_layers, batch, cfg.d_model)),
            "pos": pos,
        }
    if cfg.block == "hymba":
        n_global = sum(1 for li in range(cfg.n_layers) if _hymba_window(cfg, li) == 0)
        n_swa = cfg.n_layers - n_global
        w = min(cfg.sliding_window, max_len)
        return {
            "k_global": zeros(kvshape(n_global, max_len)),
            "v_global": zeros(kvshape(n_global, max_len)),
            "k_swa": zeros(kvshape(n_swa, w)),
            "v_swa": zeros(kvshape(n_swa, w)),
            "ssm_h": zeros((cfg.n_layers, batch, cfg.d_model, cfg.ssm_state),
                           torch.float32),
            "pos": pos,
        }
    cache: dict[str, Any] = {
        "k": zeros(kvshape(cfg.n_layers, max_len)),
        "v": zeros(kvshape(cfg.n_layers, max_len)),
        "pos": pos,
    }
    if cfg.cross_attn_every > 0 or cfg.cross_d_cond > 0:
        lc = cfg.num_cross_layers if cfg.cross_attn_every > 0 else cfg.n_layers
        cache["cross_k"] = zeros(kvshape(lc, cfg.cross_kv_len))
        cache["cross_v"] = zeros(kvshape(lc, cfg.cross_kv_len))
    return cache


def prefill(params, batch: dict, cfg: ModelConfig, mesh=None,
            max_len: int | None = None, true_len: torch.Tensor | None = None):
    """Run the full prompt; materialize a cache of `max_len` (default:
    the prompt length).  Returns (last_logits, cache).

    `true_len` (B,) supports right-padded prompts: logits are gathered at
    each row's true last token and ``pos = true_len - 1``; causal
    attention and the decode-time pos mask keep the padding inert.  Only
    for pure attention caches: recurrent rwkv6 / hymba states would
    absorb the padding, and cross-attention caches and multi-codebook
    heads are refused, as the reference refuses them.
    """
    _no_mesh(mesh)
    inputs = batch.get("tokens", batch.get("embeds"))
    b, s = inputs.shape[:2]
    max_len = max_len or s
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens does not fit a cache of {max_len}")
    if true_len is not None and cfg.block in ("rwkv6", "hymba"):
        raise ValueError(
            f"padded prefill (true_len) is attention-only; got block={cfg.block}")
    cache = init_cache(cfg, b, max_len, device=inputs.device)
    if true_len is not None:
        if "cross_k" in cache:
            raise ValueError("padded prefill does not support cross-attention caches")
        if cfg.n_codebooks > 1:
            raise ValueError("padded prefill does not support multi-codebook heads")
    logits, _aux, kv = forward(params, batch, cfg, collect_cache=True)
    if true_len is not None:
        cache["k"][:, :, :s] = kv["k"]
        cache["v"][:, :, :s] = kv["v"]
        cache["pos"] = (true_len - 1).to(torch.int32)
        idx = (true_len - 1).to(torch.int64)[:, None, None]
        last = torch.gather(logits, 1, idx.expand(b, 1, logits.shape[-1]))[:, 0]
        return last, cache
    cache["pos"].fill_(s - 1)

    if cfg.block == "rwkv6":
        cache.update(kv)
        return logits[:, -1], cache
    if cfg.block == "hymba":
        w = min(cfg.sliding_window, max_len)
        cache["k_global"][:, :, :s] = kv["k_global"]
        cache["v_global"][:, :, :s] = kv["v_global"]
        # The SWA caches were cut to the window by the forward; write them
        # at the ring slots of their absolute positions.
        wlen = kv["k_swa"].shape[2]
        slots = (s - wlen + torch.arange(wlen, device=inputs.device)) % w
        cache["k_swa"][:, :, slots] = kv["k_swa"][:, :, -w:]
        cache["v_swa"][:, :, slots] = kv["v_swa"][:, :, -w:]
        cache["ssm_h"] = kv["ssm_h"]
        return logits[:, -1], cache

    cache["k"][:, :, :s] = kv["k"]
    cache["v"][:, :, :s] = kv["v"]
    if "cross_k" in cache and batch.get("cond") is not None:
        cls = params["cross_layers"]
        pairs = [_cond_kv(batch["cond"], slice_layer(cls, gi), cfg)
                 for gi in range(cache["cross_k"].shape[0])]
        cache["cross_k"] = torch.stack([k for k, _ in pairs])
        cache["cross_v"] = torch.stack([v for _, v in pairs])
    return logits[:, -1], cache


def prefill_chunk(params, cache: dict, tokens: torch.Tensor, cfg: ModelConfig,
                  mesh=None, *,
                  start: int, slot: int, true_len: int | None = None,
                  park_pos: int | None = None):
    """Prefill ONE chunk of a prompt into batch row `slot` of the shared
    decode cache (chunked prefill).

    tokens: (1, C), the prompt slice [start, start + C), right-padded.
    Each layer mirrors the whole-prompt layer body, with
    `chunked_causal_attention(..., pos_offset=start)` over the prefix k/v
    read back from the cache plus this chunk's k/v.  Decode steps that
    run between chunks advance and write every row; `park_pos` (first
    chunk) moves this row's position to `max_len`, so their writes fall
    outside the cache and are dropped.  The final chunk (`true_len`
    given) restores ``pos = true_len - 1`` and returns the logits of the
    last real token, (1, V); other chunks return ``(None, cache)``.
    The cache update is functional: the input cache is left as it was.

    Dense attention stacks only: recurrent blocks absorb padding, MoE
    capacity routing couples tokens across the whole sequence, and
    cross-attention caches and multi-codebook heads are refused as in
    padded `prefill`.  C and `start` must be multiples of both attention
    chunk sizes.
    """
    _no_mesh(mesh)
    if cfg.block in ("rwkv6", "hymba"):
        raise ValueError(f"chunked prefill is attention-only; got block={cfg.block}")
    if cfg.is_moe:
        raise ValueError(
            "chunked prefill does not support MoE blocks: capacity-based "
            "routing couples tokens across the whole sequence, so chunk "
            "boundaries would change the routed computation")
    if cfg.n_codebooks > 1 or "cross_k" in cache:
        raise ValueError(
            "chunked prefill does not support cross-attention caches or "
            "multi-codebook heads")
    c = tokens.shape[1]
    for nm, cs in (("attn_chunk_q", cfg.attn_chunk_q),
                   ("attn_chunk_kv", cfg.attn_chunk_kv)):
        if c % cs or start % cs:
            raise ValueError(
                f"chunk [{start}, {start + c}) must align to {nm}={cs}, the "
                "attention's chunk grid of the whole-prompt prefill")
    x = embed_inputs(params, {"tokens": tokens, "pos_offset": start}, cfg)
    b = x.shape[0]
    positions = start + torch.arange(c, device=x.device)[None, :]
    lay = params["layers"]
    ks, vs = [], []
    for idx in range(cfg.n_layers):
        pl = slice_layer(lay, idx)
        q, k, v = _project_qkv(x, pl, cfg, positions)
        if start > 0:
            kf = torch.cat([cache["k"][idx, slot:slot + 1, :start], k], dim=1)
            vf = torch.cat([cache["v"][idx, slot:slot + 1, :start], v], dim=1)
        else:
            kf, vf = k, v
        attn = chunked_causal_attention(
            q, kf, vf, chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv,
            window=cfg.sliding_window, pos_offset=start)
        x = x + matmul(attn.reshape(b, c, cfg.q_dim), pl["wo"])
        ff, _ = _ffn(x, pl, cfg)
        x = x + ff
        ks.append(k)
        vs.append(v)
    new_cache = dict(cache)
    for name, new in (("k", ks), ("v", vs)):
        leaf = cache[name].clone()
        leaf[:, slot, start:start + c] = torch.stack(new)[:, 0].to(leaf.dtype)
        new_cache[name] = leaf
    if true_len is None and park_pos is None:
        return None, new_cache
    pos = cache["pos"].clone()
    # A fill, not an indexed assignment of a Python scalar (which copies
    # from the host).
    pos.narrow(0, slot, 1).fill_(true_len - 1 if true_len is not None else park_pos)
    new_cache["pos"] = pos
    if true_len is None:
        return None, new_cache
    logits = output_logits(params, x, cfg)
    return logits[:, true_len - 1 - start], new_cache


def write_cache_slot(shared: dict, single: dict, slot: int) -> dict:
    """Insert a single-request cache (B = 1, same max_len) into batch row
    `slot` of a pre-allocated decode cache; returns the new cache.

    Every leaf carries the batch on axis 1 ((L, B, ...) layouts) except
    "pos" (B,).
    """
    out = dict(shared)
    for name, dst in shared.items():
        src = single[name].to(dst.dtype)
        axis = 0 if name == "pos" else 1
        new = dst.clone()
        new.narrow(axis, int(slot), src.shape[axis]).copy_(src)
        out[name] = new
    return out


def _write_slot(cache: torch.Tensor, new: torch.Tensor,
                slot: torch.Tensor) -> torch.Tensor:
    """``cache[b, slot[b]] = new[b]`` for every row b, dropping a slot
    outside the cache (the reference's scatter), without a host sync."""
    hit = torch.arange(cache.shape[1], device=cache.device)[None, :] == slot[:, None]
    return torch.where(hit[:, :, None, None], new[:, None], cache)


def _decode_attn_layer(x, pl, cfg, kc, vc, pos, window, positions):
    """One decode attention sublayer; returns (attn_out, kc', vc')."""
    b = x.shape[0]
    q, k1, v1 = _project_qkv(x, pl, cfg, positions)
    slot = pos % kc.shape[1] if window > 0 else pos
    kc = _write_slot(kc, k1[:, 0], slot)
    vc = _write_slot(vc, v1[:, 0], slot)
    if window > 0:
        # Ring buffer: mask slots not yet written while pos < window.
        valid_count = torch.clamp_max(pos + 1, kc.shape[1])
        attn = decode_attention(q, kc, vc, torch.clamp_min(valid_count - 1, 0))
    else:
        attn = decode_attention(q, kc, vc, pos)
    return matmul(attn.reshape(b, 1, cfg.q_dim), pl["wo"]), kc, vc


def _decode_cross(x, cl, ck, cv, cfg):
    """Gated cross-attention of one decode token over a layer's
    precomputed conditioning k/v (all T of them attended)."""
    b = x.shape[0]
    h = rms_norm(x, cl["norm"], cfg.norm_eps)
    q = matmul(h, cl["wq"]).reshape(b, 1, cfg.n_heads, cfg.head_dim)
    t = ck.shape[1]
    out = decode_attention(q, ck, cv, torch.full((b,), t - 1, dtype=torch.int32,
                                                 device=x.device))
    return _gated(x, cl, matmul(out.reshape(b, 1, cfg.q_dim), cl["wo"]))


def decode_step(params, cache: dict, batch: dict, cfg: ModelConfig, mesh=None):
    """One token for the whole batch.  batch: tokens (B, 1) or embeds
    (B, 1, D).  Returns (logits (B, 1, V) or (B, 1, C, V), new_cache)."""
    _no_mesh(mesh)
    x = embed_inputs(params, {**batch, "pos_offset": cache["pos"][0] + 1}, cfg)
    pos = cache["pos"] + 1  # position of the current token
    positions = pos[:, None]
    new_cache = dict(cache)
    new_cache["pos"] = pos
    lay = params["layers"]

    if cfg.block == "rwkv6":
        states = []
        for idx in range(cfg.n_layers):
            st = rwkv_mod.RWKVState(cache["wkv"][idx], cache["shift_t"][idx],
                                    cache["shift_c"][idx])
            y, wkv_new, shift_t = rwkv_mod.time_mix(x, lay, idx, cfg, st)
            x = x + y
            cm, shift_c = rwkv_mod.channel_mix(x, lay, idx, cfg, st)
            x = x + cm
            states.append((wkv_new, shift_t, shift_c))
        for i, name in enumerate(("wkv", "shift_t", "shift_c")):
            new_cache[name] = torch.stack([st[i] for st in states]).to(cache[name].dtype)
        return output_logits(params, x, cfg), new_cache

    if cfg.block == "hymba":
        # Global layers index the full caches in order, SWA layers the
        # rings, each through its own cursor.
        kv = {"k_global": [], "v_global": [], "k_swa": [], "v_swa": []}
        hs = []
        for li, win in _hymba_layers(cfg):
            tier = "global" if win == 0 else "swa"
            j = len(kv[f"k_{tier}"])
            pl = slice_layer(lay, li)
            attn, kc, vc = _decode_attn_layer(
                x, pl, cfg, cache[f"k_{tier}"][j], cache[f"v_{tier}"][j], pos, win,
                positions)
            ssm_out, st_new = ssm_mod.ssm_branch(
                x, slice_layer(params["ssm"], li), cfg, ssm_mod.SSMState(cache["ssm_h"][li]))
            x = _hymba_mix(x, attn, ssm_out, params["branch_norm"][li], cfg)
            ff, _ = _ffn(x, pl, cfg)
            x = x + ff
            kv[f"k_{tier}"].append(kc)
            kv[f"v_{tier}"].append(vc)
            hs.append(st_new.h)
        for name, leaves in kv.items():
            new_cache[name] = torch.stack(leaves) if leaves else cache[name]
        new_cache["ssm_h"] = torch.stack(hs)
        return output_logits(params, x, cfg), new_cache

    # attention stacks (dense / MoE / MusicGen / VLM)
    grouped_cross = cfg.cross_attn_every > 0
    per_layer_cross = (cfg.cross_attn_every == 0 and "cross_k" in cache
                       and cfg.cross_kv_len > 0)
    # The VLM runs its cross groups' layers (all of them when the groups
    # divide the stack, as in every registry config).
    per = cfg.n_layers // cfg.num_cross_layers if grouped_cross else 0
    n_run = cfg.num_cross_layers * per if grouped_cross else cfg.n_layers
    ks, vs = [], []
    for idx in range(n_run):
        if grouped_cross and idx % per == 0:
            gi = idx // per
            x = _decode_cross(x, slice_layer(params["cross_layers"], gi),
                              cache["cross_k"][gi], cache["cross_v"][gi], cfg)
        pl = slice_layer(lay, idx)
        attn, kc, vc = _decode_attn_layer(
            x, pl, cfg, cache["k"][idx], cache["v"][idx], pos, cfg.sliding_window,
            positions)
        x = x + attn
        if per_layer_cross:
            # MusicGen: cross-attention before the FFN here, after it in
            # the forward (ROADMAP.md C9).
            x = _decode_cross(x, slice_layer(params["cross_layers"], idx),
                              cache["cross_k"][idx], cache["cross_v"][idx], cfg)
        ff, _ = _ffn(x, pl, cfg)
        x = x + ff
        ks.append(kc)
        vs.append(vc)
    new_cache["k"] = torch.stack(ks)
    new_cache["v"] = torch.stack(vs)
    return output_logits(params, x, cfg), new_cache
