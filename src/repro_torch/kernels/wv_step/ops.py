"""Public wrapper for the fused WV cell-update kernel.

A CPU tensor goes to the plain version (`ref.wv_cell_update`); a CUDA
tensor launches the CUDA kernel (`csrc/wv_step.cu`) or raises; a meta
tensor (shapes only) gets empty results and launches nothing.
`launches` counts kernel launches and nothing else.  `work` is a call's
bytes and operations, which a launch and a meta call add to the open
counters (`obs.work`).
"""

from __future__ import annotations

import torch

from repro_torch.obs import work as work_hook

from . import ref
from .ref import WVCellParams  # noqa: F401

launches = 0

_F32 = ("agg", "dev_mag", "g", "c2c", "nmap", "d2d")


def work(c: int, n: int, ternary: bool) -> tuple[float, dict[str, float]]:
    """(bytes, FLOPs by dtype class) of one call on (c, n) planes: the
    eight input planes read (`dev_mag` is not read when ternary: 25 or
    29 bytes a cell) and the five outputs written (17 bytes a cell), and
    about 30 float32 operations a cell."""
    read = (25 if ternary else 29) * c * n
    return read + 17.0 * c * n, {"f32": 30.0 * c * n}


def wv_cell_update(agg, dev_mag, g, streak, frozen, c2c, nmap, d2d,
                   p: WVCellParams):
    """Fused verify-tail + write for one WV iteration (see ref.py)."""
    if g.device.type == "cpu":
        return ref.wv_cell_update(agg, dev_mag, g, streak, frozen, c2c, nmap,
                                  d2d, p)
    if g.device.type == "meta":
        _check(agg, dev_mag, g, streak, frozen, c2c, nmap, d2d)
        work_hook.add_kernel("wv_step", *work(*g.shape, p.ternary))
        return (torch.empty_like(g), torch.empty_like(streak), torch.empty_like(frozen),
                torch.empty_like(g), torch.empty_like(g))
    return wv_cell_update_cuda(agg, dev_mag, g, streak, frozen, c2c, nmap,
                               d2d, p)


def _check(agg, dev_mag, g, streak, frozen, c2c, nmap, d2d) -> None:
    """The kernel's operand rules: every plane (C, N), contiguous, on
    `g`'s device, of its dtype."""
    planes = dict(agg=agg, dev_mag=dev_mag, g=g, streak=streak, frozen=frozen,
                  c2c=c2c, nmap=nmap, d2d=d2d)
    want = {**{k: torch.float32 for k in _F32}, "streak": torch.int32,
            "frozen": torch.bool}
    if g.ndim != 2:
        raise ValueError(f"wv_step kernel takes (C, N) planes, got {tuple(g.shape)}")
    for name, t in planes.items():
        if t.device != g.device:
            raise ValueError(f"wv_step: {name} must be on {g.device}, got {t.device}")
        if t.dtype != want[name]:
            raise TypeError(f"wv_step: {name} must be {want[name]}, got {t.dtype}")
        if t.shape != g.shape:
            raise ValueError(f"wv_step: {name} shape {tuple(t.shape)} != {tuple(g.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"wv_step: {name} must be contiguous")
    n = g.shape[1]
    if n < 1 or n & (n - 1) or n > 1024:
        raise ValueError(f"wv_step kernel supports power-of-two N <= 1024, got {n}")


def wv_cell_update_cuda(agg, dev_mag, g, streak, frozen, c2c, nmap, d2d,
                        p: WVCellParams):
    """Launch the CUDA kernel; every plane (C, N), contiguous, on one card."""
    global launches
    if not g.is_cuda:
        raise ValueError(f"wv_step kernel needs CUDA tensors, got {g.device}")
    _check(agg, dev_mag, g, streak, frozen, c2c, nmap, d2d)
    c, n = g.shape
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
    work_hook.add_kernel("wv_step", *work(c, n, p.ternary))
    return g_out, streak_out, frozen_out, np_out, dir_out
