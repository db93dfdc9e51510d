"""KV cache, prefill and single-token decode for the dense attention stack.

Cache layout (the reference's): k/v stacked (L, B, Smax, KV, hd) in
cfg.dtype, plus pos (B,) int32, the position of each row's last token.

Cache writes follow the reference's scatter semantics: a decode step
writes row b's new k/v at slot ``pos[b]`` (``pos[b] % Smax`` with a
sliding window), and a slot outside the cache is dropped, not an error.
Updates are functional, as in the reference: a step returns a new cache
and leaves its input as it was.
"""

from __future__ import annotations

from typing import Any

import torch

from .attention import chunked_causal_attention, decode_attention
from .config import ModelConfig
from .layers import matmul
from .transformer import (
    _check_dense,
    _ffn,
    _project_qkv,
    embed_inputs,
    forward,
    output_logits,
    slice_layer,
)

__all__ = ["init_cache", "prefill", "prefill_chunk", "decode_step",
           "write_cache_slot"]


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> dict[str, Any]:
    _check_dense(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def prefill(params, batch: dict, cfg: ModelConfig, max_len: int | None = None,
            true_len: torch.Tensor | None = None):
    """Run the full prompt; materialize a cache of `max_len` (default:
    the prompt length).  Returns (last_logits, cache).

    `true_len` (B,) supports right-padded prompts: logits are gathered at
    each row's true last token and ``pos = true_len - 1``; causal
    attention and the decode-time pos mask keep the padding inert.
    """
    tokens = batch["tokens"]
    b, s = tokens.shape[:2]
    max_len = max_len or s
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens does not fit a cache of {max_len}")
    logits, _aux, kv = forward(params, batch, cfg, collect_cache=True)
    cache = init_cache(cfg, b, max_len, device=tokens.device)
    cache["k"][:, :, :s] = kv["k"]
    cache["v"][:, :, :s] = kv["v"]
    if true_len is not None:
        cache["pos"] = (true_len - 1).to(torch.int32)
        idx = (true_len - 1).to(torch.int64)[:, None, None]
        last = torch.gather(logits, 1, idx.expand(b, 1, logits.shape[-1]))[:, 0]
        return last, cache
    cache["pos"].fill_(s - 1)
    return logits[:, -1], cache


def prefill_chunk(params, cache: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
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

    Dense attention stacks only, like padded `prefill`; C and `start`
    must be multiples of both attention chunk sizes.
    """
    _check_dense(cfg)
    c = tokens.shape[1]
    for nm, cs in (("attn_chunk_q", cfg.attn_chunk_q),
                   ("attn_chunk_kv", cfg.attn_chunk_kv)):
        if c % cs or start % cs:
            raise ValueError(
                f"chunk [{start}, {start + c}) must align to {nm}={cs}, the "
                "attention's chunk grid of the whole-prompt prefill")
    x = embed_inputs(params, {"tokens": tokens}, cfg)
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


def decode_step(params, cache: dict, batch: dict, cfg: ModelConfig):
    """One token for the whole batch.  batch: tokens (B, 1).  Returns
    (logits (B, 1, V), new_cache)."""
    x = embed_inputs(params, batch, cfg)
    pos = cache["pos"] + 1  # position of the current token
    positions = pos[:, None]
    lay = params["layers"]
    ks, vs = [], []
    for idx in range(cfg.n_layers):
        pl = slice_layer(lay, idx)
        attn, kc, vc = _decode_attn_layer(
            x, pl, cfg, cache["k"][idx], cache["v"][idx], pos,
            cfg.sliding_window, positions)
        x = x + attn
        ff, _ = _ffn(x, pl, cfg)
        x = x + ff
        ks.append(kc)
        vs.append(vc)
    new_cache = dict(cache)
    new_cache["pos"] = pos
    new_cache["k"] = torch.stack(ks)
    new_cache["v"] = torch.stack(vs)
    return output_logits(params, x, cfg), new_cache
