"""Parameter tree of the dense attention decoder (init only).

`init_params` builds the reference's `models/transformer.py:init_params`
tree for the dense attention block: the same key names, shapes and
dtypes, so deployment flattens it into the same leaves and column uids.
Values come from an explicit `torch.Generator` and are not the
reference's; parity tests carry the reference's params across with
`repro_torch.convert.params_from_numpy`.  The forward pass is not
ported yet.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from .config import ModelConfig

__all__ = ["init_params"]


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
            f"init_params covers the dense attention block only, got {cfg.name}")
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
