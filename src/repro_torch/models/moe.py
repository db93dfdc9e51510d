"""Token-choice top-k Mixture-of-Experts (the reference's `models/moe.py`).

Routing: softmax over the router logits, `top_k`, gates renormalised
over the k choices.  Dispatch is the sort-free rank-via-cumsum
construction: the rank of each (token, choice) within its expert is the
exclusive cumsum of the assignment one-hots in token-major order, and a
choice whose rank reaches the capacity is dropped (its token passes
through the residual).  Kept choices are written into an (E, cap) token
buffer that has one spill slot at the end (the reference's
``.at[slot].set(mode="drop")``), tokens are gathered with a zero pad row
for the empty slots, the experts run as batched matmuls in float32, and
their gated outputs are scatter-added back per token in float32.

The capacity counts the tokens of the call: ``B * S`` in a forward, ``B``
in a decode step, as in the reference.  Only the single-device path is
ported: expert parallelism over a mesh (`shard_map`) is ROADMAP.md A5.
"""

from __future__ import annotations

import contextlib
from typing import Any

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import dense_init

__all__ = ["init_moe_params", "moe_block", "record_routing"]

_F32 = torch.float32
# Open `record_routing` logs: each `_moe_local` call appends its keep mask.
_routing_logs: list[list[torch.Tensor]] = []


def init_moe_params(gen, cfg: ModelConfig, n_layers: int, device) -> dict[str, Any]:
    d, e, f, dt = cfg.d_model, cfg.moe_experts, cfg.moe_d_ff, cfg.dtype

    def experts(d_in, d_out):
        w = dense_init(gen, n_layers * e, d_in, d_out, dt, device)
        return w.reshape(n_layers, e, d_in, d_out)

    return {
        "router": dense_init(gen, n_layers, d, e, _F32, device),
        "w_gate": experts(d, f),
        "w_up": experts(d, f),
        "w_down": experts(f, d),
    }


def _local_capacity(t_local: int, cfg: ModelConfig) -> int:
    cap = int(t_local * cfg.moe_top_k * cfg.capacity_factor / cfg.moe_experts)
    return max(cap, 4)


@contextlib.contextmanager
def record_routing():
    """Collect, in call order, every MoE call's keep mask (T, k) bool:
    True where a (token, choice) fit its expert's capacity."""
    log: list[torch.Tensor] = []
    _routing_logs.append(log)
    try:
        yield log
    finally:
        _routing_logs.remove(log)


def _moe_local(x, router_w, w_gate, w_up, w_down, *, cfg: ModelConfig, axis=None):
    """x: (T, D) tokens; the full expert set.  Returns (out (T, D) in
    x.dtype, Switch aux loss)."""
    if axis:
        raise NotImplementedError("expert parallelism over a mesh is ROADMAP.md A5")
    t, d = x.shape
    e = cfg.moe_experts
    e_local = w_gate.shape[0]
    k = cfg.moe_top_k
    cap = _local_capacity(t, cfg)

    logits = torch.matmul(x.to(_F32), router_w.to(_F32))
    probs = torch.softmax(logits, dim=-1)
    gate_vals, sel = torch.topk(probs, k, dim=-1)                 # (T, k)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)

    # rank of each (token, choice) within its expert, token-major
    flat = F.one_hot(sel, e).reshape(t * k, e)
    ranks = torch.cumsum(flat, dim=0) - flat                      # exclusive
    rank_te = torch.sum(ranks * flat, dim=-1).reshape(t, k)
    keep = rank_te < cap
    for log in _routing_logs:
        log.append(keep)

    # (E, cap) token-index buffer; dropped choices land in the spill slot
    slot = torch.where(keep, sel * cap + rank_te, e_local * cap).reshape(-1)
    tok_ids = torch.arange(t, device=x.device).repeat_interleave(k)
    buf_tok = torch.full((e_local * cap + 1,), t, dtype=torch.int64, device=x.device)
    buf_gate = torch.zeros((e_local * cap + 1,), dtype=_F32, device=x.device)
    buf_tok[slot] = tok_ids
    buf_gate[slot] = gate_vals.reshape(-1)
    buf_tok = buf_tok[:-1].reshape(e_local, cap)
    buf_gate = buf_gate[:-1].reshape(e_local, cap)

    # gather (pad row = zeros), grouped expert FFN, combine-scatter
    x_pad = torch.cat([x, torch.zeros((1, d), dtype=x.dtype, device=x.device)])
    xe = x_pad[buf_tok].to(_F32)                                  # (E, cap, D)
    g = torch.matmul(xe, w_gate.to(_F32))
    u = torch.matmul(xe, w_up.to(_F32))
    hmid = (F.silu(g) * u).to(x.dtype)
    ye = torch.matmul(hmid.to(_F32), w_down.to(_F32)) * buf_gate[..., None]

    out = torch.zeros((t + 1, d), dtype=_F32, device=x.device)
    out.index_add_(0, buf_tok.reshape(-1), ye.reshape(-1, d))
    out = out[:-1]

    # Switch-style load-balance loss
    me = torch.mean(probs, dim=0)
    ce = torch.mean(torch.sum(F.one_hot(sel, e).to(_F32), dim=1), dim=0)
    aux = e * torch.sum(me * ce)
    return out.to(x.dtype), aux


def moe_block(x: torch.Tensor, layer_params: dict, cfg: ModelConfig,
              mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN over x (B, S, D) with one layer's router / experts;
    returns (output, aux_loss)."""
    if mesh is not None:
        raise NotImplementedError("mesh= is not ported (ROADMAP.md A5)")
    b, s, d = x.shape
    out, aux = _moe_local(
        x.reshape(-1, d), layer_params["router"].to(_F32), layer_params["w_gate"],
        layer_params["w_up"], layer_params["w_down"], cfg=cfg)
    return out.reshape(x.shape), aux
