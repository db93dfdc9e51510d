"""The port's kernels: the plain versions against the JAX references.
The CUDA kernels are held against the plain versions on the card by
`test_torch_cuda.py` and `chip_smoke.py`.

Tolerances:
* `fwht` plain version vs `repro.core.hadamard.fwht`: bitwise (same
  butterfly, same operand order);
* `fwht` vs JAX `fwht_pallas(interpret=True)`: rtol 1e-4, atol 1e-3, as
  `tests/test_kernels.py` (the Pallas kernel is a matmul, another
  summation order);
* `wv_step` plain version vs JAX `wv_cell_update_pallas(interpret=True)`:
  streak / frozen / n_p / direction exactly; g within 1e-5 (float32
  `pow` differs by an ulp between XLA and torch);
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hadamard import fwht as jax_fwht
from repro.kernels.fwht.fwht import fwht_pallas
from repro.kernels.wv_step.ref import WVCellParams as JParams
from repro.kernels.wv_step.wv_step import wv_cell_update_pallas
from repro_torch.kernels.fwht import ops as fwht_ops, ref as fwht_ref
from repro_torch.kernels.wv_step import ops as wv_ops
from repro_torch.kernels.wv_step.ref import WVCellParams


@pytest.mark.parametrize("n", [2, 8, 32, 64, 256, 1024])
@pytest.mark.parametrize("c", [1, 300])
def test_fwht_ref_bitwise_vs_reference_butterfly(n, c):
    x = np.random.RandomState(c * 1000 + n).randn(c, n).astype(np.float32) * 4
    want = np.asarray(jax.jit(jax_fwht)(jnp.asarray(x)))
    got = fwht_ref.fwht(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("n", [8, 32, 64, 128])
def test_fwht_ref_vs_pallas_interpret(n):
    x = np.random.RandomState(n).randn(300, n).astype(np.float32)
    want = np.asarray(fwht_pallas(jnp.asarray(x), interpret=True))
    got = fwht_ops.fwht(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_fwht_wrapper_dispatches_cpu_to_plain_version():
    before = fwht_ops.launches
    x = torch.randn(5, 3, 32, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(fwht_ops.fwht(x), fwht_ref.fwht(x), rtol=0, atol=0)
    assert fwht_ops.launches == before
    with pytest.raises(ValueError):
        fwht_ops.fwht_cuda(x)


def _wv_args(c, n, seed=0):
    rs = np.random.RandomState(seed)
    return (
        (rs.randn(c, n) * 8).astype(np.float32),
        np.abs(rs.randn(c, n) * 2).astype(np.float32),
        rs.uniform(0, 7, (c, n)).astype(np.float32),
        rs.randint(0, 3, (c, n)).astype(np.int32),
        rs.rand(c, n) < 0.3,
        (1 + 0.15 * rs.randn(c, n)).astype(np.float32),
        (0.05 * rs.randn(c, n)).astype(np.float32),
        (1 + 0.1 * rs.randn(c, n)).astype(np.float32),
    )


def _params(cls, ternary, can_freeze, nmap_sqrt):
    return cls(
        threshold=4.0 if ternary else 0.5, k_streak=2, can_freeze=can_freeze,
        ternary=ternary, fine_step=0.25, max_pulses=16.0, g_max=7.0,
        nonlinearity=0.35, reset_asymmetry=0.85, nmap_sqrt_pulses=nmap_sqrt,
    )


def _check_wv(got, want):
    names = ("g", "streak", "frozen", "n_p", "direction")
    for name, a, b in zip(names, got, want):
        a = np.asarray(a)
        b = np.asarray(b)
        assert a.shape == b.shape, name
        if name == "g":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("c,n", [(16, 32), (300, 32), (128, 64), (64, 128)])
@pytest.mark.parametrize("ternary", [True, False])
@pytest.mark.parametrize("can_freeze", [True, False])
@pytest.mark.parametrize("nmap_sqrt", [True, False])
def test_wv_step_ref_vs_pallas_interpret(c, n, ternary, can_freeze, nmap_sqrt):
    args = _wv_args(c, n)
    # Make some rows wholly frozen so the column-active mask bites.
    args[4][: max(1, c // 8)] = True
    want = wv_cell_update_pallas(
        *[jnp.asarray(a) for a in args],
        _params(JParams, ternary, can_freeze, nmap_sqrt), interpret=True,
    )
    got = wv_ops.wv_cell_update(
        *[torch.from_numpy(a) for a in args],
        _params(WVCellParams, ternary, can_freeze, nmap_sqrt),
    )
    assert got[1].dtype == torch.int32 and got[2].dtype == torch.bool
    _check_wv([t.numpy() for t in got], [np.asarray(w) for w in want])
