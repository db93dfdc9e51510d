"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `requires_cuda`; without a card each test skips (decided inside
the fixture, at run time).  This file imports no JAX, so it also runs on
the machine with the card, which has none:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances: `fwht` bitwise (same butterfly, same operand order);
`wv_step` streak / frozen / n_p / direction exactly and g within 1e-5
(`powf` in the kernel vs `torch.pow`).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.fwht import ops as fwht_ops, ref as fwht_ref
from repro_torch.kernels.wv_step import ops as wv_ops, ref as wv_ref
from repro_torch.kernels.wv_step.ref import WVCellParams


@pytest.fixture
def cuda():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("c,n", [(1, 32), (1000, 32), (777, 64), (64, 1024), (5, 8)])
def test_fwht_kernel_bitwise_vs_plain(cuda, c, n):
    gen = torch.Generator(cuda).manual_seed(n)
    x = torch.randn(c, n, device=cuda, generator=gen)
    before = fwht_ops.launches
    got = fwht_ops.fwht(x)
    torch.cuda.synchronize()
    assert fwht_ops.launches == before + 1
    torch.testing.assert_close(got, fwht_ref.fwht(x), rtol=0, atol=0)


@pytest.mark.requires_cuda
def test_fwht_kernel_rejects_what_it_does_not_take(cuda):
    with pytest.raises(TypeError):
        fwht_ops.fwht(torch.zeros(4, 32, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):
        fwht_ops.fwht(torch.zeros(32, 4, device=cuda).t())
    with pytest.raises(ValueError):
        fwht_ops.fwht(torch.zeros(4, 2048, device=cuda))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("c,n", [(300, 32), (128, 64), (3, 1024)])
@pytest.mark.parametrize("ternary", [True, False])
@pytest.mark.parametrize("can_freeze", [True, False])
def test_wv_step_kernel_vs_plain(cuda, c, n, ternary, can_freeze):
    rs = np.random.RandomState(c + n)
    frozen = rs.rand(c, n) < 0.3
    frozen[: max(1, c // 8)] = True
    args = [
        (rs.randn(c, n) * 8).astype(np.float32),
        np.abs(rs.randn(c, n) * 2).astype(np.float32),
        rs.uniform(0, 7, (c, n)).astype(np.float32),
        rs.randint(0, 3, (c, n)).astype(np.int32),
        frozen,
        (1 + 0.15 * rs.randn(c, n)).astype(np.float32),
        (0.05 * rs.randn(c, n)).astype(np.float32),
        (1 + 0.1 * rs.randn(c, n)).astype(np.float32),
    ]
    targs = [torch.from_numpy(a).to(cuda) for a in args]
    p = WVCellParams(
        threshold=4.0 if ternary else 0.5, k_streak=2, can_freeze=can_freeze,
        ternary=ternary, fine_step=0.25, max_pulses=16.0, g_max=7.0,
        nonlinearity=0.35, reset_asymmetry=0.85, nmap_sqrt_pulses=True,
    )
    before = wv_ops.launches
    got = wv_ops.wv_cell_update(*targs, p)
    torch.cuda.synchronize()
    assert wv_ops.launches == before + 1
    want = wv_ref.wv_cell_update(*targs, p)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-5)
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)
