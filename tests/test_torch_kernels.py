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
* the `acim_vmm` kernel's bf16 x 3 split of slice differences
  (`ref.split_bf16x3`): h + m + l == d bitwise, and on {0, 1} x the three
  float64 products sum to x @ d bitwise;
* `acim_vmm` grid plan (`ops._plan`): split over tiles at every decode
  shape of qwen3-0.6b's analog leaves, never at prefill.
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
from repro_torch.configs.qwen3_0_6b import CONFIG as QWEN3
from repro_torch.kernels.acim_vmm import ops as vmm_ops, ref as vmm_ref
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


def _split_edges() -> np.ndarray:
    tiny = np.float32(2.0 ** -110)          # smallest magnitude split exactly
    one = np.float32(1.0)
    seven = np.float32(7.0)
    vals = [0.0, -0.0, 7.0, -7.0, tiny, -tiny, 1.0, -1.0, 0.1, -0.1, 1.0 / 3.0,
            np.nextafter(one, np.float32(2)), np.nextafter(one, np.float32(0)),
            np.nextafter(seven, np.float32(0)), -np.nextafter(seven, np.float32(0)),
            np.nextafter(tiny, np.float32(1)), np.float32(2.0 ** -24),
            np.float32(2.0 ** -24) * 3, np.float32(1.0 + 2.0 ** -8 + 2.0 ** -16),
            np.float32(1.0 + 2.0 ** -9 + 2.0 ** -17 + 2.0 ** -23)]
    # Every 24-bit significand pattern class at every exponent down to 2^-110.
    rs = np.random.RandomState(7)
    mant = rs.randint(1 << 23, 1 << 24, size=(114, 64)).astype(np.float64)
    exps = np.arange(-110, 4)[:, None].astype(np.float64)
    grid = (mant * 2.0 ** (exps - 23)).astype(np.float32).ravel()
    return np.concatenate([np.asarray(vals, np.float32), grid, -grid])


@pytest.mark.parametrize("source", ["conductance", "edges"])
def test_acim_split_bf16x3_sums_back_exactly(source):
    if source == "conductance":
        rs = np.random.RandomState(11)
        gp = rs.uniform(0, 7, (512, 384)).astype(np.float32)
        gn = rs.uniform(0, 7, (512, 384)).astype(np.float32)
        d = torch.from_numpy(gp) - torch.from_numpy(gn)      # in [-7, 7]
    else:
        d = torch.from_numpy(_split_edges())
    h, m, lo = vmm_ref.split_bf16x3(d)
    assert h.dtype == m.dtype == lo.dtype == torch.bfloat16
    torch.testing.assert_close(h.double() + m.double() + lo.double(), d.double(),
                               rtol=0, atol=0)
    torch.testing.assert_close((h.float() + m.float()) + lo.float(), d, rtol=0, atol=0)


@pytest.mark.parametrize("b,r,m", [(40, 128, 256), (130, 70, 65)])
def test_acim_split_bf16x3_binary_products_exact(b, r, m):
    rs = np.random.RandomState(b + r)
    x = torch.from_numpy((rs.rand(b, r) < 0.5).astype(np.float64))
    d = (torch.from_numpy(rs.uniform(0, 7, (r, m)).astype(np.float32))
         - torch.from_numpy(rs.uniform(0, 7, (r, m)).astype(np.float32)))
    h, mid, lo = vmm_ref.split_bf16x3(d)
    got = x @ h.double() + x @ mid.double() + x @ lo.double()
    torch.testing.assert_close(got, x @ d.double(), rtol=0, atol=0)


def _leaf_shapes(cfg, tile_rows=128):
    """(name, tiles, outputs) of qwen3-0.6b's 7 analog leaves per layer."""
    ins_outs = {"wq": (cfg.d_model, cfg.q_dim), "wk": (cfg.d_model, cfg.kv_dim),
                "wv": (cfg.d_model, cfg.kv_dim), "wo": (cfg.q_dim, cfg.d_model),
                "w_gate": (cfg.d_model, cfg.d_ff), "w_up": (cfg.d_model, cfg.d_ff),
                "w_down": (cfg.d_ff, cfg.d_model)}
    return [(n, -(-k // tile_rows), m) for n, (k, m) in ins_outs.items()]


@pytest.mark.parametrize("tokens,split", [(1, True), (4, True), (128, False)])
def test_acim_vmm_plan_splits_at_decode_only(tokens, split):
    planes = 10                     # DAC 6 bits: 2 x 5 magnitude planes
    b = planes * tokens             # decode batch 4 -> B = 40; prefill 128 tokens -> 1280
    for name, n_tiles, m in _leaf_shapes(QWEN3):
        assert vmm_ops._plan(b, n_tiles, m) is split, (name, b, n_tiles, m)
    assert [t for _, t, _ in _leaf_shapes(QWEN3)] == [8, 8, 8, 16, 8, 8, 24]
    assert vmm_ops._plan(b, 1, 3072) is False         # one tile: nothing to split
