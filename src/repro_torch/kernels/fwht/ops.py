"""Public wrapper for the FWHT kernel: dispatch by the tensor's device.

A CPU tensor goes to the plain version (`ref.fwht`); a CUDA tensor
launches the CUDA kernel (`csrc/fwht.cu`) or raises; a meta tensor
(shapes only) gets an empty result and launches nothing.  `launches`
counts kernel launches and nothing else.  `work` is a call's bytes and
operations, which a launch and a meta call add to the open
counters (`obs.work`).
"""

from __future__ import annotations

import math

import torch

from repro_torch.obs import work as work_hook

from . import ref

MAX_N = 1024
launches = 0


def work(c: int, n: int) -> tuple[float, dict[str, float]]:
    """(bytes, FLOPs by dtype class) of one call on c rows of n float32
    values: the batch read once and written once, and log2(n) adds or
    subtracts per value at the float32 rate."""
    return 8.0 * c * n, {"f32": c * n * math.log2(n)}


def fwht(x: torch.Tensor) -> torch.Tensor:
    """Walsh-Hadamard transform along the last axis (any leading dims)."""
    if x.device.type == "cpu":
        return ref.fwht(x)
    if x.device.type == "meta":
        n = _check(x)
        work_hook.add_kernel("fwht", *work(x.numel() // n, n))
        return torch.empty_like(x)
    return fwht_cuda(x)


def _check(x: torch.Tensor) -> int:
    """The kernel's operand rules; returns N."""
    if x.dtype != torch.float32:
        raise TypeError(f"fwht kernel takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fwht kernel needs a contiguous tensor")
    n = x.shape[-1]
    if n < 1 or n & (n - 1) or n > MAX_N:
        raise ValueError(f"fwht kernel supports power-of-two N <= {MAX_N}, got {n}")
    return n


def fwht_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on a float32, contiguous CUDA tensor."""
    global launches
    if not x.is_cuda:
        raise ValueError(f"fwht kernel needs a CUDA tensor, got {x.device}")
    n = _check(x)
    from repro_torch.kernels import build

    lib = build.load()
    out = torch.empty_like(x)
    c = x.numel() // n
    if c == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.harp_fwht_f32(x.data_ptr(), out.data_ptr(), c, n, stream)
    if rc != 0:
        raise RuntimeError(f"fwht kernel launch failed: cudaError {rc}")
    launches += 1
    work_hook.add_kernel("fwht", *work(c, n))
    return out
