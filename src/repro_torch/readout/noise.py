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

The CIM inference read noise (`sample_token_read_noise`) fans a
(tile, plane) key out to per-token sub-streams ``fold_in(key,
token_id)``, so a token's draw does not depend on the batch it rides
in; with request ids as token ids it does not depend on its slot.
"""

from __future__ import annotations

import torch

from repro_torch.core import rng
from repro_torch.core.types import NoiseConfig

__all__ = ["sample_read_fields", "sample_token_read_noise"]


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


def _lattice_keys(key: torch.Tensor, tiles: int, planes: int,
                  token_ids: torch.Tensor) -> torch.Tensor:
    """(Ti, P, T, 2) keys ``fold_in(fold_in(fold_in(key, ti), p), ids[t])``."""
    tile_ids = torch.arange(tiles, dtype=torch.int32, device=key.device)
    plane_ids = torch.arange(planes, dtype=torch.int32, device=key.device)
    k_tile = rng.fold_in(key, tile_ids)                          # (Ti, 2)
    k_tp = rng.fold_in(k_tile[:, None, :], plane_ids[None, :])   # (Ti, P, 2)
    return rng.fold_in(k_tp[:, :, None, :], token_ids[None, None, :])


def sample_token_read_noise(
    key: torch.Tensor,
    n_tokens: int,
    n_slices: int,
    m: int,
    sigma_lsb: float,
    *,
    token_ids: torch.Tensor | None = None,
    tiles: int | None = None,
    planes: int | None = None,
    cols: tuple[int, int] | None = None,
) -> torch.Tensor | None:
    """Per-read CIM inference noise; one batched draw for a whole leaf.

    Without `tiles`/`planes`: `key` is one (tile, plane) sub-key and the
    result is (S, T, M); token t draws from ``fold_in(key, ids[t])``.

    With `tiles`=Ti and `planes`=P: `key` is the leaf key and the result
    is a contiguous (Ti, S, P*T, M), the noise operand of
    `acim_vmm_tiled`, whose row
    ``p*T + t`` of tile ti draws from

        fold_in(fold_in(fold_in(key, ti), p), ids[t])

    The (tile, plane, token) key lattice is built by broadcasting
    `rng.fold_in` and drawn by one batched `rng.normal`.  `token_ids`
    defaults to ``arange(T)``.  `cols=(lo, hi)` draws only output
    columns [lo, hi) of the M, bitwise those of the whole draw
    (`rng.normal_cols`): a rank serving a block of a leaf's columns.
    Returns None when sigma <= 0.
    """
    if sigma_lsb <= 0.0:
        return None
    dev = key.device
    if token_ids is None:
        token_ids = torch.arange(n_tokens, dtype=torch.int32, device=dev)
    token_ids = token_ids.to(torch.int32)
    if (tiles is None) != (planes is None):
        raise ValueError("tiles and planes must be given together")
    lo, hi = cols if cols is not None else (0, m)
    whole = (lo, hi) == (0, m)

    def draw(keys, shape):
        return rng.normal(keys, shape) if whole else rng.normal_cols(keys, shape, lo, hi)

    if tiles is None:
        tok_keys = rng.fold_col_keys(key, token_ids)
        nz = draw(tok_keys, (n_tokens, n_slices, m))
        return sigma_lsb * nz.permute(1, 0, 2)
    flat = _lattice_keys(key, tiles, planes, token_ids).reshape(-1, 2)
    nz = draw(flat, (tiles * planes * n_tokens, n_slices, m))
    nz = nz.reshape(tiles, planes, n_tokens, n_slices, hi - lo)
    # (Ti, P, T, S, M) -> (Ti, S, P, T, M) -> (Ti, S, P*T, M), contiguous
    # as the kernel takes it.
    nz = nz.permute(0, 3, 1, 2, 4).contiguous()
    return sigma_lsb * nz.reshape(tiles, n_slices, planes * n_tokens, hi - lo)
