"""Plain PyTorch version of the batched FWHT kernel.

Delegates to the core butterfly; the CUDA kernel matches it bit for bit
in float32 (same stages, same operand order).
"""

from __future__ import annotations

import torch

from repro_torch.core.hadamard import fwht as _fwht_butterfly


def fwht(x: torch.Tensor) -> torch.Tensor:
    """(C, N) -> (C, N) Walsh-Hadamard transform along the last axis."""
    return _fwht_butterfly(x, axis=-1)
