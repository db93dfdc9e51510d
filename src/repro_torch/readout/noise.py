"""The read-noise sampler of the verify path (eqs. 2-4).

For one verification sweep of a column read with patterns a_1..a_N:

    y_hat_i = a_i^T w  +  n_uc,i  +  mu_cm  +  o_col

* n_uc,i ~ N(0, sigma_uc^2) i.i.d. per measurement and per repeated read;
* mu_cm ~ N(0, sigma_cm^2) per column per sweep, shared by all N patterns
  and all M averaged reads of that sweep;
* o_col — static per-column converter offset, injected by
  `readout.read_columns`, not sampled here.

RNG contract: the key is a single sweep key or a batch of per-column
keys (`core.rng` sub-streams, DESIGN.md Sec. 10).
"""

from __future__ import annotations

import torch

from repro_torch.core import rng
from repro_torch.core.types import NoiseConfig

__all__ = ["sample_read_fields"]


def sample_read_fields(
    key: torch.Tensor,
    batch_shape: tuple[int, ...],
    n_reads: int,
    n_meas: int,
    noise: NoiseConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw noise fields for one sweep of M averaged reads.

    Returns (n_uc, mu_cm): (*batch, M, n_meas) uncorrelated noise and a
    (*batch, 1, 1) per-column common-mode offset.  Kept separate so the
    caller controls the summation order against the true signal.
    """
    k_uc, k_cm = rng.split(key)
    n_uc = noise.sigma_uc_lsb * rng.normal(k_uc, (*batch_shape, n_reads, n_meas))
    mu_cm = noise.sigma_cm_lsb * rng.normal(k_cm, (*batch_shape,) + (1,) * 2)
    return n_uc, mu_cm
