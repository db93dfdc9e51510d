"""Plain reference of a HARP deploy: quantize, bit-slice, pack into
verify columns, then the write-and-verify loop, column by column.

A frozen plain-PyTorch copy of the paper's algorithm as the system under
test states it (default `WVConfig`: N = 32 cells a column, 3-bit cells,
6-bit weights in two slices, 10 open-loop coarse pulses at most, 50 fine
iterations, HARP: Hadamard reads, compare-only converter against the
target's code, ternary aggregate s_w = H^T s_y, threshold tau_w = 4,
one fine pulse an iteration, a column frozen after 2 in-threshold
sweeps once 11 sweeps have passed).  Every random field is drawn from
``fold_in(key, uid)`` of the column's uid with `reference.rng`, so any
subset of columns can be programmed on its own.

`dtype` is the precision the loop's state and arithmetic run in:
float32 as the configuration states, bfloat16 for the control that
the comparison has to reject.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import rng

__all__ = ["HARP", "eligible_leaves", "quantize", "pack", "leaf_columns",
           "program", "dequantize_columns"]

# The default configuration, as the system under test documents it.
HARP = dict(
    n_cells=32, bc=3, weight_bits=6, k_streak=2, warmup=7 + 4,
    max_fine_iters=50, max_coarse_iters=10, tau_w=4.0, deadzone=0.5,
    adc_bits=9, sigma_read=0.7, fine_step=0.25, coarse_step=1.25,
    sigma_map_frac=0.10, nonlinearity=0.35, reset_asymmetry=0.85,
    sigma_c2c=0.15, sigma_d2d=0.10,
)
G_MAX = float((1 << HARP["bc"]) - 1)
Q_MAX = (1 << HARP["weight_bits"]) - 1
SLICES = HARP["weight_bits"] // HARP["bc"]


def _div(x, s: float):
    """One IEEE division by a scalar, as on every backend."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}[{k!r}]")
        return out
    return [(prefix, tree)]


def eligible_leaves(params) -> list[tuple[str, torch.Tensor]]:
    """The leaves a deploy programs, in uid order: every tensor of two or
    more axes except the embeddings, dict keys visited sorted."""
    return [(n, t) for n, t in _flatten(params)
            if t.ndim >= 2 and "embed" not in n.lower()]


def quantize(w: torch.Tensor):
    """(K, M) weights -> int levels in [-63, 63] and per-channel scale,
    each step rounded to the leaf's own dtype."""
    dt = w.dtype
    amax = torch.amax(torch.abs(w), dim=0, keepdim=True)
    floor = float(torch.tensor(1e-12, dtype=dt))
    scale = _div(torch.clamp_min(amax.float(), floor).to(dt).float(), float(Q_MAX)).to(dt)
    q = torch.round((w.float() / scale.float()).to(dt).float()).to(dt).float()
    return torch.clamp(q, -Q_MAX, Q_MAX).to(torch.int32), scale


def pack(q: torch.Tensor):
    """Signed (K, M) levels -> (C, N) target cell levels, the layout
    (K/N groups, M outputs, +/- polarity, slice LSB first, N cells)."""
    n = HARP["n_cells"]
    k, m = q.shape
    kp = -(-k // n) * n
    if kp != k:
        q = F.pad(q, (0, 0, 0, kp - k))
    pair = torch.stack([torch.clamp_min(q, 0), torch.clamp_min(-q, 0)], dim=-1)
    base = 1 << HARP["bc"]
    cells = torch.stack([(pair // base ** i) % base for i in range(SLICES)], dim=-1)
    cells = torch.movedim(cells.reshape(kp // n, n, m, 2, SLICES), 1, -1)
    return cells.reshape(-1, n).to(torch.float32).contiguous()


def leaf_columns(params):
    """[(name, leaf, targets (C, N), scale, first uid)] of every leaf a
    deploy programs."""
    out, uid = [], 0
    for name, leaf in eligible_leaves(params):
        q, scale = quantize(leaf.reshape(-1, leaf.shape[-1]))
        cols = pack(q)
        out.append((name, leaf, cols, scale, uid))
        uid += cols.shape[0]
    return out


def dequantize_columns(g: torch.Tensor, leaf: torch.Tensor, scale: torch.Tensor):
    """Programmed (C, N) levels -> the effective dense leaf."""
    n = HARP["n_cells"]
    k = math.prod(leaf.shape[:-1])
    m = leaf.shape[-1]
    kp = -(-k // n) * n
    cells = torch.movedim(g.reshape(kp // n, m, 2, SLICES, n), -1, 1)
    cells = cells.reshape(kp, m, 2, SLICES)
    mags = cells[..., 0] * 1.0
    for i in range(1, SLICES):
        mags = mags + cells[..., i] * float(1 << (HARP["bc"] * i))
    w = (mags[..., 0] - mags[..., 1])[:k].to(torch.float32) * scale
    return w.reshape(leaf.shape).to(leaf.dtype)


def _fwht(x):
    n = x.shape[-1]
    shape = x.shape
    h = 1
    while h < n:
        y = x.reshape(shape[:-1] + (n // (2 * h), 2, h))
        x = torch.cat([y[..., 0, :] + y[..., 1, :], y[..., 0, :] - y[..., 1, :]],
                      dim=-1).reshape(shape)
        h *= 2
    return x


def _sar(y, centered: bool):
    fs = float(HARP["n_cells"] * G_MAX)
    bits = HARP["adc_bits"]
    w = fs / float(1 << bits)
    lo = -fs / 2.0 if centered else 0.0
    code = torch.clamp(torch.round(_div(torch.clamp(y, lo, lo + fs) - lo, w)),
                       0, (1 << bits) - 1)
    return lo + code * w


def _target_codes(targets):
    """The compare-only converter's preset: each Hadamard row's target
    code (row 0 over [0, FS], the balanced rows re-centred)."""
    t = _fwht(targets)
    centered = torch.arange(t.shape[-1], device=t.device) > 0
    return torch.where(centered, _sar(t, True), _sar(t, False))


def _step_eff(g, direction, step):
    frac = torch.clamp(_div(g, G_MAX), 0.0, 1.0)
    set_eff = (1.0 - frac) ** HARP["nonlinearity"]
    reset_eff = frac ** HARP["nonlinearity"] * HARP["reset_asymmetry"]
    return step * torch.where(direction > 0, set_eff, reset_eff)


def _map_sigma(step: float) -> float:
    sigma_map = HARP["sigma_map_frac"] * G_MAX
    n_swing = G_MAX / HARP["coarse_step"]
    return float(sigma_map / n_swing ** 0.5 * (step / HARP["coarse_step"]))


def _coarse_pulses(targets, max_pulses: int):
    """Open-loop pulse counts from the nominal SET curve from g = 0: the
    first count whose landing is nearest each target."""
    g_nom = torch.zeros((), dtype=torch.float32, device=targets.device)
    best = torch.abs(g_nom - targets)
    idx = torch.zeros_like(targets)
    one = torch.ones((), device=targets.device)
    for p in range(1, max_pulses + 1):
        g_nom = torch.clamp(g_nom + _step_eff(g_nom, one, HARP["coarse_step"]),
                            0.0, G_MAX)
        err = torch.abs(g_nom - targets)
        better = err < best
        idx = torch.where(better, float(p), idx)
        best = torch.where(better, err, best)
    return idx


def _program_block(key, targets, uids, dt):
    c, n = targets.shape
    col_keys = rng.fold_in(key, uids)
    k_d2d, k_coarse, k_loop = rng.split(col_keys, 3)
    d2d = (1.0 + HARP["sigma_d2d"] * rng.normal(k_d2d, (c, n))).to(dt)

    # Open-loop coarse SET from HRS.
    g = torch.zeros((c, n), dtype=dt, device=targets.device)
    n_coarse = _coarse_pulses(targets, HARP["max_coarse_iters"])
    direction = torch.where(n_coarse > 0, 1.0, 0.0)
    k_c2c, k_map = rng.split(k_coarse)
    c2c = (1.0 + HARP["sigma_c2c"] * rng.normal(k_c2c, (c, n))).to(dt)
    nmap = (_map_sigma(HARP["coarse_step"]) * rng.normal(k_map, (c, n))).to(dt)
    pulsed = n_coarse > 0
    step = _step_eff(g, direction, HARP["coarse_step"]) * d2d
    delta = direction.to(dt) * step * n_coarse.to(dt) * c2c
    nmap = nmap * torch.sqrt(torch.clamp_min(n_coarse, 1.0)).to(dt)
    g_new = torch.clamp(g + delta + torch.where(pulsed, nmap * 1.0, 0.0).to(dt), 0.0, G_MAX)
    g = torch.where(pulsed, g_new, g)

    # Fine loop: Hadamard verify, compare-only reads, ternary aggregate,
    # one pulse a cell an iteration.
    t_codes = _target_codes(targets).to(dt)
    streak = torch.zeros((c, n), dtype=torch.int32, device=targets.device)
    frozen = torch.zeros((c, n), dtype=torch.bool, device=targets.device)
    iters = torch.zeros((c,), dtype=torch.float32, device=targets.device)
    fine_sigma = _map_sigma(HARP["fine_step"])
    for it in range(HARP["max_fine_iters"]):
        k_v, k_w = rng.split(rng.fold_in(k_loop, it))
        col_active = ~torch.all(frozen, dim=-1)
        k_uc, k_cm = rng.split(k_v)
        n_uc = HARP["sigma_read"] * rng.normal(k_uc, (c, 1, n))
        mu_cm = 0.0 * rng.normal(k_cm, (c, 1, 1))
        y = _fwht(g) + (n_uc + mu_cm).reshape(c, n).to(dt)
        diff = y - t_codes
        dz = HARP["deadzone"]
        sign = torch.where(diff < -dz, -1.0, torch.where(diff > dz, 1.0, 0.0)).to(dt)
        agg = _fwht(sign)
        k_c2c, k_map = rng.split(k_w)
        c2c = (1.0 + HARP["sigma_c2c"] * rng.normal(k_c2c, (c, n))).to(dt)
        nmap = (fine_sigma * rng.normal(k_map, (c, n))).to(dt)
        # The ternary cell update.
        thr = HARP["tau_w"]
        decision = torch.where(agg > thr, 1.0, torch.where(agg < -thr, -1.0, 0.0))
        streak = torch.where(decision == 0.0, streak + 1, 0).to(torch.int32)
        new_frozen = frozen | (streak >= HARP["k_streak"]) if it >= HARP["warmup"] else frozen
        act = (~frozen) & (decision != 0.0) & col_active[:, None]
        n_p = torch.where(act, 1.0, 0.0)
        direction = torch.where(act, -decision, 0.0)
        frac = torch.clamp(_div(g, G_MAX), 0.0, 1.0)
        set_eff = (1.0 - frac) ** HARP["nonlinearity"]
        reset_eff = frac ** HARP["nonlinearity"] * HARP["reset_asymmetry"]
        eff = torch.where(direction > 0, set_eff, reset_eff)
        delta = (direction * HARP["fine_step"] * eff * d2d * n_p * c2c).to(dt)
        nm = nmap * torch.sqrt(torch.clamp_min(n_p, 1.0)).to(dt)
        g_new = torch.clamp(g + delta + torch.where(n_p > 0, nm, 0.0).to(dt), 0.0, G_MAX)
        g = torch.where(n_p > 0, g_new, g)
        frozen = new_frozen
        iters = iters + col_active.to(torch.float32)
    return g.to(torch.float32), iters


def program(key, targets, uids, dtype=torch.float32, block: int = 1 << 18):
    """Program (C, N) `targets` whose column uids are `uids`; returns the
    conductances (C, N) and the fine iterations each column ran while
    active.  Columns are independent, so any block size gives the same
    values."""
    gs, its = [], []
    for lo in range(0, targets.shape[0], block):
        g, it = _program_block(key, targets[lo:lo + block], uids[lo:lo + block], dtype)
        gs.append(g)
        its.append(it)
    return torch.cat(gs), torch.cat(its)
