"""Selective state-space (Mamba-style S6) branch for Hymba layers (the
reference's `models/ssm.py`).

Diagonal SSM with input-dependent (Delta, B, C):

    h_t = exp(Delta_t * A) * h_{t-1} + Delta_t * B_t * x_t
    y_t = C_t . h_t + D * x_t,   gated by silu(z)

A full sequence runs chunk by chunk: SSM_CHUNK tokens at a time (the
tail zero-padded), the (decay, drive) prefix of each chunk composed by an
inclusive scan, so the (B, c, d_inner, n) working set stays one chunk
wide.  The reference composes the prefix with `associative_scan`; the
port with a Hillis-Steele scan of the same operator, which associates
the float32 products in another order (the tests state the tolerance).
Under autograd each chunk is a checkpoint (`remat`, as the reference's
`jax.checkpoint` of its chunk body), so backward keeps the chunk
boundaries' states and recomputes one chunk's (B, c, d_inner, n)
tensors at a time.  Decode (S == 1) is the exact single-step recurrence
on the carried (B, d_inner, n) state.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from . import remat
from .act_sharding import constrain
from .config import ModelConfig
from .layers import dense_init, matmul

__all__ = ["SSM_CHUNK", "SSMState", "init_ssm_params", "ssm_branch", "init_ssm_state"]

SSM_CHUNK = 128
_F32 = torch.float32


class SSMState(NamedTuple):
    h: torch.Tensor  # (B, d_inner, n) float32


def init_ssm_params(gen, cfg: ModelConfig, n_layers: int, device) -> dict[str, Any]:
    d, n, L = cfg.d_model, cfg.ssm_state, n_layers
    d_in = d  # inner width = model width (parallel-branch design)

    def stack(din, dout):
        return dense_init(gen, L, din, dout, cfg.dtype, device)

    a_init = torch.log(torch.arange(1, n + 1, dtype=_F32, device=device))
    return {
        "in_x": stack(d, d_in),
        "in_z": stack(d, d_in),
        "w_bc": stack(d, 2 * n),
        "w_dt": stack(d, d_in),
        "dt_bias": torch.zeros((L, d_in), dtype=_F32, device=device),
        "a_log": a_init[None, None].repeat(L, d_in, 1),
        "d_skip": torch.ones((L, d_in), dtype=_F32, device=device),
        "out": stack(d_in, d),
    }


def _prefix_scan(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan over axis 1 of the operator
    ``(a1, b1) . (a2, b2) = (a1 * a2, a2 * b1 + b2)`` (earlier first)."""
    c = a.shape[1]
    for step in (1 << i for i in range(max(math.ceil(math.log2(c)), 0))):
        a_prev, b_prev = a[:, :-step], b[:, :-step]
        a_cur, b_cur = a[:, step:], b[:, step:]
        a = torch.cat([a[:, :step], a_prev * a_cur], dim=1)
        b = torch.cat([b[:, :step], a_cur * b_prev + b_cur], dim=1)
    return a, b


def _chunk(h0, dtc, xfc, btc, ctc, a):
    """One SSM_CHUNK of the recurrence from state h0: (last state, y)."""
    dec = torch.exp(dtc[..., None] * a[None, None])
    drv = (dtc * xfc)[..., None] * btc[:, :, None, :]
    acc_a, acc_b = _prefix_scan(dec, drv)
    h_all = acc_a * h0[:, None] + acc_b                   # (B, c, d_in, n)
    return h_all[:, -1], torch.einsum("bcdn,bcn->bcd", h_all, ctc)


def ssm_branch(x: torch.Tensor, pl: dict, cfg: ModelConfig, state: SSMState,
               mesh=None) -> tuple[torch.Tensor, SSMState]:
    """One layer's SSM branch with sliced params (no layer axis).
    x: (B, S, D) -> (y, new_state); S == 1 is the exact recurrence.  On
    a mesh, x is this rank's rows."""
    b, s, d = x.shape
    n = cfg.ssm_state
    xi = constrain(matmul(x, pl["in_x"]), mesh, ("batch", None, "model"))
    z = constrain(matmul(x, pl["in_z"]), mesh, ("batch", None, "model"))
    bc = matmul(x, pl["w_bc"]).to(_F32)                   # (B, S, 2n)
    b_t, c_t = bc[..., :n], bc[..., n:]
    dt = F.softplus(matmul(x, pl["w_dt"]).to(_F32) + pl["dt_bias"][None, None])
    a = -torch.exp(pl["a_log"].to(_F32))                  # (d_in, n)
    xf = xi.to(_F32)

    if s == 1:
        decay0 = torch.exp(dt[:, 0, :, None] * a[None])
        drive0 = (dt * xf)[:, 0, :, None] * b_t[:, 0, None, :]
        h = decay0 * state.h + drive0
        y = torch.einsum("bdn,bn->bd", h, c_t[:, 0])[:, None]
        h_fin = h
    else:
        pad = (-s) % SSM_CHUNK
        if pad:
            dt, xf_p, b_t, c_t = (F.pad(t, (0, 0, 0, pad)) for t in (dt, xf, b_t, c_t))
        else:
            xf_p = xf
        h_fin = state.h
        ys = []
        for i in range(dt.shape[1] // SSM_CHUNK):
            sl = slice(i * SSM_CHUNK, (i + 1) * SSM_CHUNK)
            h_fin, yc = remat.checkpoint(_chunk, h_fin, dt[:, sl], xf_p[:, sl],
                                         b_t[:, sl], c_t[:, sl], a)
            ys.append(yc)
        y = torch.cat(ys, dim=1)[:, :s]

    y = y + pl["d_skip"][None, None] * xf
    y = y * F.silu(z.to(_F32))
    out = matmul(y.to(x.dtype), pl["out"])
    return out, SSMState(h=h_fin)


def init_ssm_state(cfg: ModelConfig, batch: int, device="cuda") -> SSMState:
    return SSMState(h=torch.zeros((batch, cfg.d_model, cfg.ssm_state), dtype=_F32,
                                  device=device))
