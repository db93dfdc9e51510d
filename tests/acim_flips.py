"""The tolerance of the `acim_vmm` kernel and its plain versions, shared
by the parity tests and the card-only tests (imports no JAX).

Without the ADC: rtol 1e-4, atol 1e-2.  With it, a partial sum taken in
another order can cross a code boundary, so an element outside that
tolerance must differ by a sum of whole code flips, at most one (+-1)
per (tile, slice), each worth ``w * 2^(bc*l)``; and such elements stay
under 1% of the output.
"""

import itertools

import numpy as np

RTOL, ATOL = 1e-4, 1e-2


def flip_sums(n_tiles: int, s: int, bc: int) -> np.ndarray:
    """Every nonzero integer sum of at most one code flip (+-1) per
    (tile, slice), each weighted 2^(bc*l)."""
    sums = {0}
    for _, l in itertools.product(range(n_tiles), range(s)):
        step = 1 << (bc * l)
        sums = {a + d * step for a in sums for d in (-1, 0, 1)}
    return np.array(sorted(sums - {0}), np.float64)


def assert_flip_rule(got, want, *, w, n_tiles, s, bc, adc: bool) -> int:
    """Hold `got` to `want`; returns the number of flipped elements."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    off = ~np.isclose(got, want, rtol=RTOL, atol=ATOL)
    if not adc:
        assert not off.any(), f"max |diff| {np.max(np.abs(got - want))}"
        return 0
    assert off.mean() < 0.01, f"{off.sum()} of {off.size} elements off"
    if off.any():
        diff = (got - want)[off] / w
        sums = flip_sums(n_tiles, s, bc)
        near = np.min(np.abs(diff[:, None] - sums[None, :]), axis=1)
        tol = (ATOL + RTOL * np.abs(want[off])) / w
        assert np.all(near <= tol), f"differences {diff[near > tol]} code widths"
    return int(off.sum())
