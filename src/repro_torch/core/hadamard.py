"""Hadamard read-basis construction and fast Walsh-Hadamard transforms.

Port of the reference's measurement-basis machinery:

* Sylvester-Hadamard matrices ``H_N`` with entries in {-1, +1} and
  ``H^T H = N I`` (Prop. 2.1 optimality over +-1 read matrices).
* Forward encode ``y = H @ w`` — the *analog* column read, simulated.
* Inverse decode ``x = (1/N) H^T y`` — the *digital* periphery step.
* ``fwht``: the O(N log N) butterfly used by both (Sylvester H is
  symmetric, so encode and unnormalized decode are the same transform).
  The CUDA kernel in ``repro_torch.kernels.fwht`` runs the identical
  stage and operand order, so it is bitwise equal to this butterfly.

Shapes follow the WV engine convention: the *last* axis is the N-cell
column axis; any leading axes are batch (columns, slices, ...).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "hadamard_matrix",
    "is_hadamard",
    "fwht",
    "encode",
    "decode_unnormalized",
    "decode",
]


@functools.lru_cache(maxsize=None)
def _hadamard_np(n: int) -> np.ndarray:
    """Sylvester construction of the n x n Hadamard matrix (n a power of 2)."""
    if n < 1 or (n & (n - 1)) != 0:
        raise ValueError(f"Sylvester-Hadamard order must be a power of 2, got {n}")
    h = np.array([[1.0]], dtype=np.float64)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


def hadamard_matrix(n: int, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """The N x N Sylvester-Hadamard read matrix (rows are read patterns).

    Row 0 is the all +1 pattern (the only unbalanced row: it alone
    carries the common-mode offset after decoding, eq. (7)).
    """
    return torch.as_tensor(_hadamard_np(n), dtype=dtype, device=device)


def is_hadamard(a: np.ndarray) -> bool:
    """Check A in {-1,+1}^{NxN} with A^T A = N I (the Prop. 2.1 bound)."""
    a = np.asarray(a)
    n = a.shape[0]
    if a.shape != (n, n) or not np.all(np.isin(a, (-1.0, 1.0))):
        return False
    return np.array_equal(a.T @ a, n * np.eye(n))


def fwht(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Fast Walsh-Hadamard transform along ``axis`` (unnormalized).

    ``fwht(x) == x @ H_N``.  log2(N) butterfly stages; at stage h the
    pair (a, b) = (x[j], x[j + h]) becomes (a + b, a - b).
    """
    axis = axis % x.ndim
    if axis != x.ndim - 1:
        x = torch.movedim(x, axis, -1)
    n = x.shape[-1]
    if n & (n - 1):
        raise ValueError(f"FWHT length must be a power of 2, got {n}")
    shape = x.shape
    h = 1
    while h < n:
        y = x.reshape(shape[:-1] + (n // (2 * h), 2, h))
        a = y[..., 0, :]
        b = y[..., 1, :]
        x = torch.cat([a + b, a - b], dim=-1).reshape(shape)
        h *= 2
    if axis != x.ndim - 1:
        x = torch.movedim(x, -1, axis)
    return x


def encode(w: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Analog Hadamard column read (noiseless part): y = H w."""
    return fwht(w, axis=axis)


def decode_unnormalized(y: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """H^T y without the 1/N: HARP's ternary aggregation applies its
    threshold tau_w to the unnormalized sum (eq. 10)."""
    return fwht(y, axis=axis)


def decode(y: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse Hadamard decode: x = (1/N) H^T y (eq. 6)."""
    n = y.shape[axis % y.ndim]
    return fwht(y, axis=axis) / n
