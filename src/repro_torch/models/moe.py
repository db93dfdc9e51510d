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
in a decode step, as in the reference.

On a mesh (expert parallelism, the reference's `shard_map` body): each
rank routes its own rows of the batch (its block over the batch axes,
replicated over "model"), runs only its ``E / model`` experts, the
block at its "model" coordinate, and the partial outputs are summed
over "model".  The ranks along "model" repeat the routing and the aux
loss alike; the tokens and gates entering a rank's own experts pass
`collectives.copy_to`, and the partial output `collectives.reduce_from`,
so that the gradient of the one loss is counted once (not once per
rank) and reaches every rank whole.
"""

from __future__ import annotations

import contextlib
import re
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.distributed.collectives import copy_to, mean_over, reduce_from
from repro_torch.distributed.sharding import gather, is_dtensor

from .act_sharding import constrain
from .config import ModelConfig
from .layers import dense_init
from .remat import recomputing

__all__ = ["init_moe_params", "moe_block", "record_routing", "ep_axes", "is_expert_stack",
           "params_at_use"]

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
    True where a (token, choice) fit its expert's capacity.  A backward
    recompute of a rematerialised layer adds none."""
    log: list[torch.Tensor] = []
    _routing_logs.append(log)
    try:
        yield log
    finally:
        _routing_logs.remove(log)


def _moe_local(x, router_w, w_gate, w_up, w_down, *, cfg: ModelConfig, axis=None,
               mesh=None):
    """x: (T, D) tokens; the experts of this rank (all of them without
    `axis`, else the block at this rank's coordinate on the mesh axis
    `axis`).  Returns (out (T, D) in x.dtype, Switch aux loss)."""
    t, d = x.shape
    e = cfg.moe_experts
    e_local = w_gate.shape[0]
    k = cfg.moe_top_k
    cap = _local_capacity(t, cfg)
    ep = (axis,) if axis else ()
    my_first = mesh.get_local_rank(axis) * e_local if axis else 0

    logits = torch.matmul(x.to(_F32), router_w.to(_F32))
    probs = torch.softmax(logits, dim=-1)
    gate_vals, sel = torch.topk(probs, k, dim=-1)                 # (T, k)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)

    # rank of each (token, choice) within its expert, token-major
    flat = F.one_hot(sel, e).reshape(t * k, e)
    ranks = torch.cumsum(flat, dim=0) - flat                      # exclusive
    rank_te = torch.sum(ranks * flat, dim=-1).reshape(t, k)
    keep = rank_te < cap
    if not recomputing():      # one mask per forward call, not per recompute
        for log in _routing_logs:
            log.append(keep)

    # (E_local, cap) token-index buffer of this rank's experts; dropped
    # choices and other ranks' experts land in the spill slot
    sel_local = sel - my_first
    mine = (sel_local >= 0) & (sel_local < e_local) & keep
    slot = torch.where(mine, sel_local * cap + rank_te, e_local * cap).reshape(-1)
    tok_ids = torch.arange(t, device=x.device).repeat_interleave(k)
    buf_tok = torch.full((e_local * cap + 1,), t, dtype=torch.int64, device=x.device)
    buf_gate = torch.zeros((e_local * cap + 1,), dtype=_F32, device=x.device)
    buf_tok[slot] = tok_ids
    buf_gate[slot] = copy_to(gate_vals, mesh, ep).reshape(-1)
    buf_tok = buf_tok[:-1].reshape(e_local, cap)
    buf_gate = buf_gate[:-1].reshape(e_local, cap)

    # gather (pad row = zeros), grouped expert FFN, combine-scatter
    x_pad = torch.cat([copy_to(x, mesh, ep),
                       torch.zeros((1, d), dtype=x.dtype, device=x.device)])
    xe = x_pad[buf_tok].to(_F32)                                  # (E, cap, D)
    g = torch.matmul(xe, w_gate.to(_F32))
    u = torch.matmul(xe, w_up.to(_F32))
    hmid = (F.silu(g) * u).to(x.dtype)
    ye = torch.matmul(hmid.to(_F32), w_down.to(_F32)) * buf_gate[..., None]

    out = torch.zeros((t + 1, d), dtype=_F32, device=x.device)
    out.index_add_(0, buf_tok.reshape(-1), ye.reshape(-1, d))
    # combine the partial expert outputs across the EP axis
    out = reduce_from(out[:-1], mesh, ep)

    # Switch-style load-balance loss, from this rank's token statistics
    me = torch.mean(probs, dim=0)
    ce = torch.mean(torch.sum(F.one_hot(sel, e).to(_F32), dim=1), dim=0)
    aux = reduce_from(e * torch.sum(me * ce), mesh, ep, mean=True)
    return out.to(x.dtype), aux


_EXPERT_PATH = re.compile(r"\['moe'\]\['(w_gate|w_up|w_down)'\]$")


def is_expert_stack(path: str) -> bool:
    """Whether the `keystr` path names an MoE expert stack."""
    return _EXPERT_PATH.search(path) is not None


def ep_axes(path: str, leaf) -> tuple[str, ...]:
    """``("model",)`` for an expert stack stored with its expert dim split
    over "model" (it stays split at use: each rank runs its own
    experts), else ``()``."""
    if not (is_expert_stack(path) and is_dtensor(leaf)):
        return ()
    from torch.distributed.tensor import Shard

    names = leaf.device_mesh.mesh_dim_names
    pl = leaf.placements[names.index("model")] if "model" in names else None
    return ("model",) if isinstance(pl, Shard) and pl.dim == leaf.ndim - 3 else ()


def params_at_use(params):
    """A parameter tree as a rank uses it: every DTensor gathered whole,
    expert stacks to this rank's experts; plain leaves as they are."""
    from repro_torch import pytree

    return pytree.unflatten(params, [gather(x, keep=ep_axes(path, x))
                                     for path, x in pytree.leaves_with_path(params)])


def _local_experts(w, cfg: ModelConfig, mesh) -> torch.Tensor:
    """This rank's block of an (E, ...) expert stack at its "model"
    coordinate: a DTensor is gathered over every axis but "model"; a
    plain stack is either the block already or all E experts."""
    m = mesh.size(mesh.mesh_dim_names.index("model"))
    e = cfg.moe_experts
    if e % m:
        raise ValueError(f"{e} experts do not split over {m} ranks of 'model'")
    w = gather(w, keep=("model",))
    if w.shape[0] == e // m:
        return w
    if w.shape[0] != e:
        raise ValueError(f"expert stack of {w.shape[0]}; expected {e} or {e // m}")
    first = mesh.get_local_rank("model") * (e // m)
    return w[first:first + e // m]


def moe_block(x: torch.Tensor, layer_params: dict, cfg: ModelConfig,
              mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN over x (B, S, D) with one layer's router / experts;
    returns (output, aux_loss).

    On a mesh, a plain `x` is this rank's rows and the result is its
    rows' output and their aux loss.  A DTensor `x` is the global view:
    it is laid out as the reference's ``P(batch, None, None)``, the
    output is a DTensor of that layout and the aux loss the mean over
    the batch blocks, as the reference's ``jnp.mean`` of the per-shard
    losses.  Expert stacks may be DTensors (EP-sharded storage), this
    rank's block, or all E experts."""
    b, s, d = x.shape
    if mesh is None:
        out, aux = _moe_local(
            x.reshape(-1, d), layer_params["router"].to(_F32), layer_params["w_gate"],
            layer_params["w_up"], layer_params["w_down"], cfg=cfg)
        return out.reshape(x.shape), aux
    xg = constrain(x, mesh, ("batch", None, None)) if is_dtensor(x) else None
    xl = xg.to_local() if xg is not None else x
    wg, wu, wd = (_local_experts(layer_params[n], cfg, mesh)
                  for n in ("w_gate", "w_up", "w_down"))
    out, aux = _moe_local(xl.reshape(-1, d), gather(layer_params["router"]).to(_F32),
                          wg, wu, wd, cfg=cfg, axis="model", mesh=mesh)
    out = out.reshape(xl.shape)
    if xg is None:
        return out, aux
    from torch.distributed.tensor import DTensor, Shard

    rows = [n for n, pl in zip(mesh.mesh_dim_names, xg.placements) if isinstance(pl, Shard)]
    aux = mean_over(aux, mesh, rows)
    return DTensor.from_local(out, mesh, xg.placements, run_check=False,
                              shape=xg.shape, stride=xg.stride()), aux
