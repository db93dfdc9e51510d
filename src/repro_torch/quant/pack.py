"""Packing weight matrices into RRAM verify-columns and back.

A weight matrix W (K_in, M_out) deploys onto crossbar arrays whose
*physical columns* (the unit the WV engine programs: N cells sharing one
TIA/ADC) run along the input dimension.  Layout:

    (K, M) ->  pad K to multiple of N
           ->  (K/N, N, M) chunks
           ->  x2 polarities (pos/neg), x k slices
           ->  columns (K/N * M * 2 * k, N)
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .bitslice import pair_to_signed, signed_to_pair, slice_magnitudes, unslice_magnitudes


@dataclasses.dataclass(frozen=True)
class PackedLayout:
    """Static metadata needed to invert the packing."""

    k_in: int
    m_out: int
    n_cells: int
    slices: int
    bc: int

    @property
    def k_padded(self) -> int:
        return -(-self.k_in // self.n_cells) * self.n_cells

    @property
    def num_columns(self) -> int:
        return (self.k_padded // self.n_cells) * self.m_out * 2 * self.slices


def pack_columns(
    q: torch.Tensor, n_cells: int, bc: int, k_slices: int
) -> tuple[torch.Tensor, PackedLayout]:
    """Signed int weight matrix (K, M) -> target cell levels (C, N)."""
    k_in, m_out = q.shape
    layout = PackedLayout(k_in, m_out, n_cells, k_slices, bc)
    pad = layout.k_padded - k_in
    if pad:
        q = F.pad(q, (0, 0, 0, pad))
    pos, neg = signed_to_pair(q)
    pair = torch.stack([pos, neg], dim=-1)            # (Kp, M, 2)
    cells = slice_magnitudes(pair, bc, k_slices)      # (Kp, M, 2, S)
    kp = layout.k_padded
    cells = cells.reshape(kp // n_cells, n_cells, m_out, 2, k_slices)
    cells = torch.movedim(cells, 1, -1)               # (Kp/N, M, 2, S, N)
    # Contiguous even where the reshape is a view (one column group): the
    # kernels that later read these targets (`fwht` in a scrub's verify
    # sweep) take contiguous operands only.
    return cells.reshape(-1, n_cells).to(torch.float32).contiguous(), layout


def unpack_columns(columns: torch.Tensor, layout: PackedLayout) -> torch.Tensor:
    """Programmed cell levels (C, N) -> effective signed weights (K, M).

    Accepts continuous (analog read-back) levels: slices recombine with
    their binary weights and polarities subtract.
    """
    kp, n = layout.k_padded, layout.n_cells
    cells = columns.reshape(kp // n, layout.m_out, 2, layout.slices, n)
    cells = torch.movedim(cells, -1, 1).reshape(kp, layout.m_out, 2, layout.slices)
    mags = unslice_magnitudes(cells, layout.bc)  # (Kp, M, 2)
    signed = pair_to_signed(mags[..., 0], mags[..., 1])
    return signed[: layout.k_in]
