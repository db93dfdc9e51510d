"""AdamW on parameter trees, with global-norm clipping and a state dtype.

The reference's `optim/adamw.py` as plain functions: `adamw_update`
takes a gradient tree and returns new parameter and state trees (no
`torch.optim`, whose update order and state layout differ), with the
reference's arithmetic: the clip ``min(1, clip / (gnorm + 1e-9))``,
float32 bias corrections ``1 - b^step``, decoupled weight decay on
every leaf, the update in float32 cast back to each leaf's dtype, and
`m` / `v` kept in `state_dtype`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch import pytree

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "global_norm",
           "adamw_update"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    state_dtype: torch.dtype = torch.float32  # bf16 for the largest configs


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    m: Any
    v: Any


def adamw_init(params: Any, cfg: AdamWConfig) -> AdamWState:
    """Zero moments in `cfg.state_dtype`, step 0 on the params' device."""
    zeros = lambda p: torch.zeros_like(p, dtype=cfg.state_dtype)  # noqa: E731
    first = pytree.leaves(params)[0]
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        m=pytree.tree_map(zeros, params),
        v=pytree.tree_map(zeros, params),
    )


def global_norm(tree: Any) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.to(torch.float32))) for x in pytree.leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


@torch.no_grad()
def adamw_update(grads: Any, state: AdamWState, params: Any, cfg: AdamWConfig,
                 lr: torch.Tensor, gnorm: torch.Tensor | None = None
                 ) -> tuple[Any, AdamWState, dict[str, torch.Tensor]]:
    """One AdamW step; returns (new_params, new_state, metrics).  `gnorm`
    is the global gradient norm to clip by when the trees are one rank's
    shards of larger ones (default: the norm of `grads`)."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.grad_clip_norm / (gnorm + 1e-9), 1.0)
    b1, b2 = cfg.betas
    step = state.step + 1
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m32, v32 = m.to(torch.float32), v.to(torch.float32)
        m_new = b1 * m32 + (1.0 - b1) * g
        v_new = b2 * v32 + (1.0 - b2) * g * g
        update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        p32 = p.to(torch.float32)
        p_new = p32 - lr * (update + cfg.weight_decay * p32)
        return (p_new.to(p.dtype), m_new.to(cfg.state_dtype),
                v_new.to(cfg.state_dtype))

    out = [upd(*a) for a in zip(*(pytree.leaves(t) for t in
                                   (params, grads, state.m, state.v)))]
    new_params, new_m, new_v = (pytree.unflatten(params, [o[i] for o in out])
                                for i in range(3))
    metrics = {"grad_norm": gnorm, "clip_scale": scale}
    return new_params, AdamWState(step, new_m, new_v), metrics
