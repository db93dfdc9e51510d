"""Device-independent float32 arithmetic helpers.

PyTorch's CUDA backend divides a tensor by a Python scalar as a multiply
by the scalar's reciprocal, which can differ from the true quotient in
the last bit; the CPU backend divides.  The reference divides.  Dividing
by a 0-d tensor on the operand's own device takes the true-division
path on both backends, so CPU and CUDA runs of the port round alike.
"""

from __future__ import annotations

import torch

__all__ = ["true_div"]


def true_div(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` rounded as one IEEE division on every backend."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)
