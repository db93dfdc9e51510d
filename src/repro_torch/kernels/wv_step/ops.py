"""Public wrapper for the fused WV cell-update kernel.

A CPU tensor goes to the plain version (`ref.wv_cell_update`); a CUDA
tensor launches the CUDA kernel (`csrc/wv_step.cu`) or raises.
`launches` counts kernel launches and nothing else.
"""

from __future__ import annotations

import torch

from . import ref
from .ref import WVCellParams  # noqa: F401

launches = 0

_F32 = ("agg", "dev_mag", "g", "c2c", "nmap", "d2d")


def wv_cell_update(agg, dev_mag, g, streak, frozen, c2c, nmap, d2d,
                   p: WVCellParams):
    """Fused verify-tail + write for one WV iteration (see ref.py)."""
    if g.device.type == "cpu":
        return ref.wv_cell_update(agg, dev_mag, g, streak, frozen, c2c, nmap,
                                  d2d, p)
    return wv_cell_update_cuda(agg, dev_mag, g, streak, frozen, c2c, nmap,
                               d2d, p)


def wv_cell_update_cuda(agg, dev_mag, g, streak, frozen, c2c, nmap, d2d,
                        p: WVCellParams):
    """Launch the CUDA kernel; every plane (C, N), contiguous, on one card."""
    global launches
    planes = dict(agg=agg, dev_mag=dev_mag, g=g, streak=streak, frozen=frozen,
                  c2c=c2c, nmap=nmap, d2d=d2d)
    want = {**{k: torch.float32 for k in _F32}, "streak": torch.int32,
            "frozen": torch.bool}
    if g.ndim != 2:
        raise ValueError(f"wv_step kernel takes (C, N) planes, got {tuple(g.shape)}")
    for name, t in planes.items():
        if not t.is_cuda or t.device != g.device:
            raise ValueError(f"wv_step: {name} must be on {g.device}, got {t.device}")
        if t.dtype != want[name]:
            raise TypeError(f"wv_step: {name} must be {want[name]}, got {t.dtype}")
        if t.shape != g.shape:
            raise ValueError(f"wv_step: {name} shape {tuple(t.shape)} != {tuple(g.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"wv_step: {name} must be contiguous")
    c, n = g.shape
    if n < 1 or n & (n - 1) or n > 1024:
        raise ValueError(f"wv_step kernel supports power-of-two N <= 1024, got {n}")
    from repro_torch.kernels import build

    lib = build.load()
    g_out = torch.empty_like(g)
    streak_out = torch.empty_like(streak)
    frozen_out = torch.empty_like(frozen)
    np_out = torch.empty_like(g)
    dir_out = torch.empty_like(g)
    if c == 0:
        return g_out, streak_out, frozen_out, np_out, dir_out
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.harp_wv_step(
            agg.data_ptr(), dev_mag.data_ptr(), g.data_ptr(), streak.data_ptr(),
            frozen.data_ptr(), c2c.data_ptr(), nmap.data_ptr(), d2d.data_ptr(),
            g_out.data_ptr(), streak_out.data_ptr(), frozen_out.data_ptr(),
            np_out.data_ptr(), dir_out.data_ptr(), c, n,
            float(p.threshold), int(p.k_streak), int(bool(p.can_freeze)),
            int(bool(p.ternary)), float(p.fine_step), float(p.max_pulses),
            float(p.g_max), float(p.nonlinearity), float(p.reset_asymmetry),
            int(bool(p.nmap_sqrt_pulses)), stream,
        )
    if rc != 0:
        raise RuntimeError(f"wv_step kernel launch failed: cudaError {rc}")
    launches += 1
    return g_out, streak_out, frozen_out, np_out, dir_out
