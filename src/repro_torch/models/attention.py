"""Attention: chunked (flash-style) causal self-attention with GQA and a
sliding window, non-causal cross-attention over conditioning tokens, and
single-token decode over a KV cache.

The prefill path keeps the reference's structure and so its numbers: an
outer loop over query chunks, an inner loop over only the key/value
chunks inside each chunk's causal (and windowed) footprint, carrying the
online-softmax state (m, l, acc) in float32.  GQA is computed grouped:
q is reshaped to (KV, G) head groups, so k/v are never repeated.

Under autograd the (cq x ck) probability tiles are never saved for
backward (that would keep the O(S^2) matrix): as in the reference, each
query chunk and, inside it, each kv step is a checkpoint (`remat`), so
backward recomputes one chunk, then one tile, at a time.  Under
`torch.no_grad()` the same loops run plainly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import remat

__all__ = ["NEG_INF", "chunked_causal_attention", "cross_attention", "decode_attention"]

NEG_INF = -1e30
_F32 = torch.float32


def chunked_causal_attention(
    q: torch.Tensor,          # (B, S, H, hd)
    k: torch.Tensor,          # (B, S, KV, hd)
    v: torch.Tensor,          # (B, S, KV, hd)
    *,
    chunk_q: int,
    chunk_kv: int,
    window: int = 0,          # 0 = full causal; > 0 = sliding window
    pos_offset: int = 0,      # absolute position of q[0]
) -> torch.Tensor:
    b, s, h, hd = q.shape
    kv_heads = k.shape[2]
    cq = min(chunk_q, s)
    ck = min(chunk_kv, k.shape[1])
    # Padded kv sits beyond every real query, so the causal mask drops it;
    # padded q rows are cut off at the end.
    pad_q = (-s) % cq
    pad_k = (-k.shape[1]) % ck
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    s_orig, s = s, s + pad_q
    nq, nk = s // cq, k.shape[1] // ck
    scale = hd ** -0.5
    g = h // kv_heads
    qg = q.reshape(b, s, kv_heads, g, hd)
    dev = q.device

    def kv_step(m, l, acc, qi, kj, vj, qpos, j):
        s_ij = torch.einsum("bqkgd,bckd->bqkgc", qi, kj.to(_F32)) * scale
        kpos = j * ck + torch.arange(ck, device=dev)
        mask = qpos[:, None] >= kpos[None, :]
        if window > 0:
            mask &= qpos[:, None] - kpos[None, :] < window
        s_ij = torch.where(mask[None, :, None, None, :], s_ij, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s_ij, dim=-1))
        p = torch.exp(s_ij - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqkgc,bckd->bqkgd", p.to(v.dtype).to(_F32), vj.to(_F32))
        return m_new, l, acc

    def one_chunk(q_chunk, k_sl, v_sl, i, j_start):
        qpos = pos_offset + i * cq + torch.arange(cq, device=dev)
        qi = q_chunk.to(_F32)
        m = torch.full((b, cq, kv_heads, g), NEG_INF, dtype=_F32, device=dev)
        l = torch.zeros((b, cq, kv_heads, g), dtype=_F32, device=dev)
        acc = torch.zeros((b, cq, kv_heads, g, hd), dtype=_F32, device=dev)
        for n in range(k_sl.shape[1] // ck):
            m, l, acc = remat.checkpoint(
                kv_step, m, l, acc, qi, k_sl[:, n * ck:(n + 1) * ck],
                v_sl[:, n * ck:(n + 1) * ck], qpos, j_start + n)
        return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)

    outs = []
    for i in range(nq):
        if window > 0:
            j_start = max(0, (pos_offset + i * cq - window) // ck)
        else:
            j_start = 0
        j_end = min(nk, (pos_offset + (i + 1) * cq - 1) // ck + 1)
        outs.append(remat.checkpoint(
            one_chunk, qg[:, i * cq:(i + 1) * cq], k[:, j_start * ck:j_end * ck],
            v[:, j_start * ck:j_end * ck], i, j_start))

    out = torch.stack(outs, dim=1).reshape(b, s, kv_heads, g, hd)
    return out.reshape(b, s, h, hd)[:, :s_orig]


def decode_attention(
    q: torch.Tensor,          # (B, 1, H, hd)
    k_cache: torch.Tensor,    # (B, Smax, KV, hd)
    v_cache: torch.Tensor,    # (B, Smax, KV, hd)
    pos: torch.Tensor,        # (B,) index of the current token
    *,
    window: int = 0,
) -> torch.Tensor:
    """Single-token attention over a (possibly windowed) KV cache."""
    b, smax, kv_heads, hd = k_cache.shape
    h = q.shape[2]
    g = h // kv_heads
    qg = q.reshape(b, kv_heads, g, hd).to(_F32)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.to(_F32)) * hd ** -0.5
    idx = torch.arange(smax, device=q.device)[None, :]
    valid = idx <= pos[:, None]
    if window > 0:
        valid &= idx > pos[:, None] - window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(_F32), v_cache.to(_F32))
    return out.reshape(b, 1, h, hd).to(q.dtype)


def cross_attention(
    q: torch.Tensor,          # (B, S, H, hd)
    k: torch.Tensor,          # (B, T, KV, hd) conditioning keys
    v: torch.Tensor,          # (B, T, KV, hd)
    *,
    chunk_q: int,
) -> torch.Tensor:
    """Unmasked cross-attention, chunked over the query axis only (the
    conditioning context T, image patches or text tokens, is short);
    GQA grouped as in the causal path."""
    b, s, h, hd = q.shape
    kv_heads = k.shape[2]
    g = h // kv_heads
    cq = min(chunk_q, s)
    pad_q = (-s) % cq
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    s_orig, s = s, s + pad_q
    qg = q.reshape(b, s, kv_heads, g, hd)
    kf, vf = k.to(_F32), v.to(_F32)
    outs = []
    for i in range(s // cq):
        qi = qg[:, i * cq:(i + 1) * cq].to(_F32)
        sc = torch.einsum("bqkgd,btkd->bqkgt", qi, kf) * hd ** -0.5
        p = torch.softmax(sc, dim=-1).to(v.dtype)
        out = torch.einsum("bqkgt,btkd->bqkgd", p.to(_F32), vf)
        outs.append(out.to(q.dtype))
    out = torch.stack(outs, dim=1).reshape(b, s, h, hd)
    return out[:, :s_orig]
