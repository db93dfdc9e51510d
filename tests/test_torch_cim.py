"""Analog compute-in-memory in the port (`repro_torch.cim`, the
`acim_vmm` kernel's plain version, the CIM read noise) against the JAX
package, and the port's own RNG contracts.

Every JAX call runs inside a scoped ``jax.threefry_partitionable(False)``
block.  Inputs are made with numpy from a seed and fed to both sides.

Tolerances:
* noise keys (`sample_token_read_noise`, both paths): bitwise; noise
  values within 3 ulp (the `normal` bound of `test_torch_rng.py`; the
  sigmas are powers of two, so scaling keeps the ulp distance);
* `_dac_stream` planes and weights, tile planes and `build_weight`
  fields: bitwise;
* `acim_vmm` / `acim_vmm_tiled` plain versions against the JAX plain
  version and the Pallas kernel (interpret mode): rtol 1e-4, atol 1e-2
  (ROADMAP's kernel tolerance).  With the ADC on, an element outside it
  must differ by a sum of code flips, at most one per (tile, slice), of
  ``w * 2^(bc*l)`` each (a reordered K sum moves a partial sum by ulps,
  which can cross a code boundary), and such elements stay under 1%;
* `cim_matmul` in the ideal limit against ``x @ materialize``: rtol and
  atol 2e-5 (`tests/test_cim.py`);
* executor logits in the ideal limit against the JAX executor's on the
  same carried deployment: rtol 1e-4, atol 1e-5;
* request-id batch invariance and fresh noise per access, in the port
  alone: bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cim import CIMConfig as JCIMConfig
from repro.cim import CIMExecutor as JCIMExecutor
from repro.cim import build_weight as j_build_weight
from repro.cim import slice_planes as j_slice_planes
from repro.cim import tile_planes as j_tile_planes
from repro.cim.mvm import _dac_stream as j_dac_stream
from repro.cim.mvm import cim_matmul as j_cim_matmul
from repro.cim.tile import rekey as j_rekey
from repro.core import WVConfig as JWVConfig, WVMethod as JWVMethod, rng as jrng
from repro.core.cost import inference_token_cost as j_inference_token_cost
from repro.core.programmer import ArrayState as JArrayState
from repro.core.programmer import deploy_arrays as j_deploy_arrays
from repro.kernels.acim_vmm import ref as j_vmm_ref
from repro.kernels.acim_vmm.acim_vmm import (
    acim_vmm_pallas as j_acim_vmm_pallas,
    acim_vmm_tiled_pallas as j_acim_vmm_tiled_pallas,
)
from repro.models import ModelConfig as JModelConfig
from repro.models import init_params as j_init_params
from repro.models.transformer import forward as j_forward
from repro.quant import pack_columns as j_pack_columns
from repro.readout import noise as j_noise
from repro_torch.cim import (
    CIMConfig,
    CIMExecutor,
    CIMWeight,
    build_weight,
    cim_matmul,
    planes_per_token,
    slice_planes,
    tile_planes,
    token_stream_ids,
)
from repro_torch.cim.mvm import _dac_stream
from repro_torch.cim.tile import rekey
from repro_torch.convert import deployed_from_numpy, key_from_numpy
from repro_torch.core import ADCConfig, CircuitCost
from repro_torch.core.cost import inference_token_cost
from repro_torch.core.programmer import ArrayState
from repro_torch.kernels.acim_vmm import ops as vmm_ops
from repro_torch.kernels.acim_vmm import ref as vmm_ref
from repro_torch.models import ModelConfig
from repro_torch.models.transformer import forward
from repro_torch.quant.pack import PackedLayout
from repro_torch.readout import noise as t_noise

from acim_flips import assert_flip_rule

IDEAL = CIMConfig(dac_bits=None, adc_bits=None, sigma_read_lsb=0.0)
J_IDEAL = JCIMConfig(dac_bits=None, adc_bits=None, sigma_read_lsb=0.0)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads for the module, restored after it (the suite
    runs files side by side in worker processes, and a thread per core
    makes the port's many small CPU ops several times slower)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)



def _legacy():
    return jax.threefry_partitionable(False)


def _ulp(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.max(np.abs(a - b))) if a.size else 0


def _tk(k) -> torch.Tensor:
    return key_from_numpy(np.asarray(k), device="cpu")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ noise
@pytest.mark.parametrize("sigma", [0.5, 0.25])
def test_token_read_noise_single_path(sigma):
    ids = np.array([11, 3, 7, 5, 2], np.int32)
    with _legacy():
        jk = jax.random.fold_in(jax.random.PRNGKey(4), 9)
        want_keys = np.asarray(jrng.fold_col_keys(jk, jnp.asarray(ids)))
        want = np.asarray(j_noise.sample_token_read_noise(
            jk, 5, 2, 33, sigma, token_ids=jnp.asarray(ids)))
    tk = _tk(jk)
    from repro_torch.core import rng as trng
    np.testing.assert_array_equal(
        trng.fold_col_keys(tk, _t(ids)).numpy(), want_keys.astype(np.int64))
    got = t_noise.sample_token_read_noise(tk, 5, 2, 33, sigma, token_ids=_t(ids))
    assert got.shape == want.shape == (2, 5, 33)
    assert _ulp(got.numpy(), want) <= 3


@pytest.mark.parametrize("tiles,planes,ids", [
    (3, 4, None),
    (2, 10, np.array([40, 1, 7], np.int32)),
])
def test_token_read_noise_lattice_path(tiles, planes, ids):
    n_tok, s, m = 3, 2, 17
    with _legacy():
        jk = jax.random.PRNGKey(123)
        jids = jnp.arange(n_tok, dtype=jnp.int32) if ids is None else jnp.asarray(ids)
        # The reference's key lattice, as `sample_token_read_noise` builds it.
        k_tile = jrng.fold_col_keys(jk, jnp.arange(tiles, dtype=jnp.int32))
        k_tp = jax.vmap(lambda k: jrng.fold_col_keys(
            k, jnp.arange(planes, dtype=jnp.int32)))(k_tile)
        k_tpt = jax.vmap(jax.vmap(lambda k: jrng.fold_col_keys(k, jids)))(k_tp)
        want = np.asarray(j_noise.sample_token_read_noise(
            jk, n_tok, s, m, 0.5, token_ids=None if ids is None else jids,
            tiles=tiles, planes=planes))
    tids = None if ids is None else _t(ids)
    keys = t_noise._lattice_keys(
        _tk(jk), tiles, planes,
        torch.arange(n_tok, dtype=torch.int32) if ids is None else tids)
    np.testing.assert_array_equal(keys.numpy(), np.asarray(k_tpt).astype(np.int64))
    got = t_noise.sample_token_read_noise(_tk(jk), n_tok, s, m, 0.5,
                                          token_ids=tids, tiles=tiles, planes=planes)
    assert got.shape == want.shape == (tiles, s, planes * n_tok, m)
    assert got.is_contiguous()                    # as the kernel takes it
    assert _ulp(got.numpy(), want) <= 3
    assert t_noise.sample_token_read_noise(_tk(jk), n_tok, s, m, 0.0) is None


# ------------------------------------------------------------- DAC stream
@pytest.mark.parametrize("dac_bits", [None, 4, 6])
def test_dac_stream_bitwise(dac_bits):
    rs = np.random.RandomState(dac_bits or 0)
    x = (rs.randn(6, 40) * 3).astype(np.float32)
    x[2] = 0.0                                    # an all-zero token
    jp, jw = j_dac_stream(jnp.asarray(x), JCIMConfig(dac_bits=dac_bits))
    tp, tw = _dac_stream(_t(x), CIMConfig(dac_bits=dac_bits))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert tp.shape[0] == planes_per_token(CIMConfig(dac_bits=dac_bits))


def test_cim_config_fields_match_reference():
    mine = [(f.name, f.default) for f in dataclasses.fields(CIMConfig)]
    want = [(f.name, f.default) for f in dataclasses.fields(JCIMConfig)]
    assert mine == want
    with pytest.raises(ValueError):
        CIMConfig(dac_bits=1)


# ----------------------------------------------------------- acim_vmm ref
def _vmm_inputs(seed, b, n_tiles, s, r, m, noise: bool):
    rs = np.random.RandomState(seed)
    x = (rs.rand(b, n_tiles * r) < 0.5).astype(np.float32)       # DAC planes
    gp = rs.uniform(0.0, 7.0, (n_tiles, s, r, m)).astype(np.float32)
    gn = rs.uniform(0.0, 7.0, (n_tiles, s, r, m)).astype(np.float32)
    nz = (0.3 * rs.randn(n_tiles, s, b, m)).astype(np.float32) if noise else None
    return x, gp, gn, nz


@pytest.mark.parametrize("adc_bits", [None, 10, 6])
@pytest.mark.parametrize("noise", [False, True])
def test_acim_vmm_tiled_plain_vs_reference(adc_bits, noise):
    b, n_tiles, s, r, m, bc = 12, 3, 2, 32, 20, 3
    x, gp, gn, nz = _vmm_inputs(7, b, n_tiles, s, r, m, noise)
    fs = 2.0 * r * 7.0
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    want = np.asarray(j_vmm_ref.acim_vmm_tiled(j(x), j(gp), j(gn), bc, adc_bits, fs, j(nz)))
    pallas = np.asarray(j_acim_vmm_tiled_pallas(
        j(x), j(gp), j(gn), j(nz), bc=bc, adc_bits=adc_bits, full_scale=fs,
        block_b=8, block_m=16, interpret=True))
    tn = None if nz is None else _t(nz)
    got = vmm_ops.acim_vmm_tiled(_t(x), _t(gp), _t(gn), bc=bc, adc_bits=adc_bits,
                                 full_scale=fs, noise=tn)
    assert got.dtype == torch.float32 and got.shape == (b, m)
    w = fs / (1 << adc_bits) if adc_bits else 1.0
    for ref in (want, pallas):
        assert_flip_rule(got.numpy(), ref, w=w, n_tiles=n_tiles, s=s, bc=bc,
                         adc=adc_bits is not None)


@pytest.mark.parametrize("adc_bits", [None, 10])
@pytest.mark.parametrize("noise", [False, True])
def test_acim_vmm_single_tile_plain_vs_reference(adc_bits, noise):
    b, s, k, m, bc = 9, 2, 40, 24, 3
    x, gp, gn, nz = _vmm_inputs(11, b, 1, s, k, m, noise)
    gp, gn = gp[0], gn[0]
    nz = None if nz is None else nz[0]
    fs = 2.0 * k * 7.0
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    want = np.asarray(j_vmm_ref.acim_vmm(j(x), j(gp), j(gn), bc, adc_bits, fs, j(nz)))
    pallas = np.asarray(j_acim_vmm_pallas(
        j(x), j(gp), j(gn), j(nz), bc=bc, adc_bits=adc_bits, full_scale=fs,
        block_b=8, block_m=16, interpret=True))
    got = vmm_ops.acim_vmm(_t(x), _t(gp), _t(gn), bc=bc, adc_bits=adc_bits,
                           full_scale=fs, noise=None if nz is None else _t(nz))
    w = fs / (1 << adc_bits) if adc_bits else 1.0
    for ref in (want, pallas):
        assert_flip_rule(got.numpy(), ref, w=w, n_tiles=1, s=s, bc=bc,
                         adc=adc_bits is not None)


def test_adc_quantize_matches_reference_sar():
    rs = np.random.RandomState(3)
    y = (rs.randn(500) * 600).astype(np.float32)
    y[:3] = [-896.0, 896.0, 0.875]                # rails and a code tie
    want = np.asarray(j_vmm_ref.adc_quantize(jnp.asarray(y), 10, 1792.0))
    np.testing.assert_array_equal(vmm_ref.adc_quantize(_t(y), 10, 1792.0).numpy(), want)


def test_flip_rule_counts_code_widths():
    """The checker itself: one flip of slice 1 passes, half a code fails."""
    want = np.zeros((20, 20), np.float32)
    got = want.copy()
    got[0, 0] = 8 * 1.75                          # one flip of slice 1
    assert_flip_rule(got, want, w=1.75, n_tiles=2, s=2, bc=3, adc=True)
    got[0, 1] = 0.5 * 1.75
    with pytest.raises(AssertionError):
        assert_flip_rule(got, want, w=1.75, n_tiles=2, s=2, bc=3, adc=True)


# ------------------------------------------------------------ tile layout
def _synthetic_states(seed, k_in=48, m_out=20, n_cells=32, bc=3, slices=2,
                      stacked=None):
    """A JAX `ArrayState` with live (noisy) conductances, and the port's."""
    rs = np.random.RandomState(seed)
    q_max = (1 << (bc * slices)) - 1
    q = rs.randint(-q_max, q_max + 1, (k_in, m_out))
    cols, layout = j_pack_columns(jnp.asarray(q), n_cells, bc, slices)
    g = np.asarray(cols) + (0.1 * rs.randn(*cols.shape)).astype(np.float32)
    scale = (0.01 * (1.0 + np.arange(m_out, dtype=np.float32)))[None, :]
    shape = (k_in, m_out) if stacked is None else (stacked, k_in // stacked, m_out)
    jst = JArrayState(g=jnp.asarray(g), targets=cols, d2d=jnp.ones_like(cols),
                      scale=jnp.asarray(scale), layout=layout, shape=shape,
                      dtype=jnp.float32)
    tst = ArrayState(g=_t(g), targets=_t(np.asarray(cols)),
                     d2d=torch.ones(tuple(cols.shape)), scale=_t(scale),
                     layout=PackedLayout(k_in, m_out, n_cells, slices, bc),
                     shape=shape, dtype=torch.float32)
    return jst, tst


@pytest.mark.parametrize("macro_rows", [16, 32, 128])
def test_slice_and_tile_planes_bitwise(macro_rows):
    jst, tst = _synthetic_states(1, k_in=70, m_out=12)
    jgp, jgn = j_slice_planes(jst.g, jst.layout)
    tgp, tgn = slice_planes(tst.g, tst.layout)
    np.testing.assert_array_equal(tgp.numpy(), np.asarray(jgp))
    np.testing.assert_array_equal(tgn.numpy(), np.asarray(jgn))
    for n_layers in (None, 2):
        jt = j_tile_planes(jgp, jgn, macro_rows, n_layers)
        tt = tile_planes(tgp, tgn, macro_rows, n_layers)
        for a, b in zip(tt, jt):
            assert a.is_contiguous()
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("stacked", [None, 2])
def test_build_weight_fields_bitwise(stacked):
    jst, tst = _synthetic_states(2, k_in=64, m_out=10, stacked=stacked)
    jk = jax.random.PRNGKey(5)
    cfg, jcfg = CIMConfig(macro_rows=16), JCIMConfig(macro_rows=16)
    jw = j_build_weight(jst, jcfg, jk, name="w", uid=3)
    tw = build_weight(tst, cfg, _tk(jk), name="w", uid=3)
    for f in ("g_pos", "g_neg", "scale", "key", "layer_id"):
        a, b = getattr(tw, f), getattr(jw, f)
        if b is None:
            assert a is None, f
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(a.numpy().dtype))
    for f in ("rows_in", "bc", "levels", "name", "uid", "n_tiles", "n_slices",
              "tile_rows", "n_outputs", "stacked_layers"):
        assert getattr(tw, f) == getattr(jw, f), f
    if stacked:
        for idx in range(stacked):
            jl = jax.tree.map(lambda a: a[idx], jw)
            tl = tw.layer(idx)
            np.testing.assert_array_equal(tl.g_pos.numpy(), np.asarray(jl.g_pos))
            assert int(tl.layer_id) == int(jl.layer_id)
    # A remapped state holds physical rows (primaries, then spares); the
    # tiles serve the logical view g[perm], as the reference's do.
    from repro.core.remap import RemapTable as JRemapTable
    from repro_torch.core.remap import RemapTable

    c = int(tst.g.shape[0])
    spares = np.random.RandomState(3).rand(3, tst.g.shape[1]).astype(np.float32) * 7
    g_phys = np.concatenate([tst.g.numpy(), spares])
    perm = np.arange(c)
    perm[[1, 4, c - 1]] = [c + 2, c, c + 1]
    active = np.ones(c + 3, bool)
    active[[1, 4, c - 1]] = False
    jrm = dataclasses.replace(jst, g=jnp.asarray(g_phys), remap=JRemapTable(
        perm=jnp.asarray(perm, jnp.int32), active=jnp.asarray(active)))
    trm = dataclasses.replace(tst, g=_t(g_phys), remap=RemapTable(
        perm=torch.from_numpy(perm), active=torch.from_numpy(active)))
    jw = j_build_weight(jrm, jcfg, jk, name="w", uid=3)
    tw = build_weight(trm, cfg, _tk(jk), name="w", uid=3)
    for f in ("g_pos", "g_neg"):
        np.testing.assert_array_equal(getattr(tw, f).numpy(), np.asarray(getattr(jw, f)))
    assert not np.array_equal(tw.g_pos.numpy(),
                              build_weight(tst, cfg, _tk(jk)).g_pos.numpy())


# ------------------------------------------------------------- cim_matmul
@pytest.mark.parametrize("macro_rows", [16, 32, 128])
def test_cim_matmul_ideal_limit_is_materialize(macro_rows):
    _, tst = _synthetic_states(4, k_in=70, m_out=12)
    w = build_weight(tst, dataclasses.replace(IDEAL, macro_rows=macro_rows),
                     torch.zeros(2, dtype=torch.int64), name="t")
    assert w.tile_rows <= macro_rows
    x = _t(np.random.RandomState(6).randn(5, 70).astype(np.float32))
    want = x @ tst.materialize(dtype=torch.float32)
    torch.testing.assert_close(cim_matmul(x, w), want, rtol=2e-5, atol=2e-5)


def test_stacked_weight_layer_slice_matches_dense():
    _, tst = _synthetic_states(7, k_in=64, m_out=10)
    stacked = dataclasses.replace(tst, shape=(2, 32, 10))
    w = build_weight(stacked, IDEAL, torch.zeros(2, dtype=torch.int64), name="s")
    dense = tst.materialize(dtype=torch.float32)
    x = _t(np.random.RandomState(9).randn(3, 32).astype(np.float32))
    for idx in range(2):
        wl = w.layer(idx)
        assert isinstance(wl, CIMWeight) and wl.g_pos.ndim == 4
        torch.testing.assert_close(cim_matmul(x, wl), x @ dense[idx * 32:(idx + 1) * 32],
                                   rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError):
        cim_matmul(x, w)                              # an unsliced stack


@pytest.mark.parametrize("cfg_kw", [
    dict(dac_bits=5, adc_bits=9, sigma_read_lsb=0.4, macro_rows=32),
    dict(dac_bits=6, adc_bits=10, sigma_read_lsb=0.2),
])
def test_cim_matmul_noisy_vs_reference(cfg_kw):
    """The whole noisy bit-serial forward against the JAX one (eager): the
    same noise, planes and ADC; the output within rtol 1e-4 / atol 1e-4
    of its scale, outside it only where an ADC code flipped (< 1%)."""
    jst, tst = _synthetic_states(10, k_in=48, m_out=24)
    jk = jax.random.PRNGKey(11)
    with _legacy():
        jw = j_rekey(j_build_weight(jst, JCIMConfig(**cfg_kw), jk, name="b", uid=2), jk)
        x = np.random.RandomState(12).randn(6, 48).astype(np.float32)
        want = np.asarray(j_cim_matmul(jnp.asarray(x), jw))
    tw = rekey(build_weight(tst, CIMConfig(**cfg_kw), _tk(jk), name="b", uid=2), _tk(jk))
    got = cim_matmul(_t(x), tw).numpy()
    off = ~np.isclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    assert off.mean() < 0.01, f"{off.sum()} of {off.size} off"


def test_request_id_stream_batch_composition_invariant():
    """Request ids, not batch rows, key the noise: a row's output is
    bitwise the same alone, in any slot, and under `token_stream_ids`."""
    _, tst = _synthetic_states(20, k_in=48, m_out=16)
    key = _tk(jax.random.PRNGKey(21))
    w = rekey(build_weight(tst, CIMConfig(dac_bits=4, adc_bits=9, sigma_read_lsb=0.4),
                           key, name="inv"), key)
    x = _t(np.random.RandomState(22).randn(5, 48).astype(np.float32))
    ids = torch.tensor([11, 3, 7, 5, 2], dtype=torch.int32)
    y = cim_matmul(x, w, token_ids=ids)
    for row in (0, 2, 4):
        y1 = cim_matmul(x[row:row + 1], w, token_ids=ids[row:row + 1])
        assert torch.equal(y1[0], y[row])
    perm = torch.tensor([4, 0, 3, 1, 2])
    assert torch.equal(cim_matmul(x[perm], w, token_ids=ids[perm]), y[perm])
    with token_stream_ids(ids):
        assert torch.equal(cim_matmul(x, w), y)
    with pytest.raises(ValueError):
        cim_matmul(x, w, token_ids=ids[:3])


def test_inference_token_cost_matches_reference():
    for planes in (1, 10):
        got = inference_token_cost(1234, 567, planes, ADCConfig(), CircuitCost())
        from repro.core import ADCConfig as JADC, CircuitCost as JCost
        want = j_inference_token_cost(1234, 567, planes, JADC(), JCost())
        assert got == want


# --------------------------------------------------------------- executor
def tiny_cfgs():
    """The JAX CIM tests' tiny config (untied head: 8 analog leaves)."""
    kw = dict(name="cim-test", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
              head_dim=16, d_ff=64, vocab_size=32, attn_chunk_q=16,
              attn_chunk_kv=16, remat=False, tie_embeddings=False)
    return JModelConfig(dtype=jnp.float32, **kw), ModelConfig(dtype=torch.float32, **kw)


def carry_deployment(jmodel):
    """The reference's `DeployedModel` -> the port's (numpy in between)."""
    arrays = {
        name: dict(g=np.asarray(st.g), targets=np.asarray(st.targets),
                   d2d=np.asarray(st.d2d), scale=np.asarray(st.scale),
                   layout=st.layout, shape=st.shape, dtype=st.dtype,
                   uids=st.uids)
        for name, st in jmodel.arrays.items()
    }
    tree = jax.tree.map(np.asarray, jmodel.materialize())
    return deployed_from_numpy(tree, arrays, device="cpu")


@pytest.fixture(scope="module")
def tiny_deployment():
    jcfg, tcfg = tiny_cfgs()
    with _legacy():
        params = j_init_params(jax.random.PRNGKey(0), jcfg)
        wv = JWVConfig(method=JWVMethod.HARP, max_fine_iters=12, max_coarse_iters=4)
        jmodel, _ = j_deploy_arrays(jax.random.PRNGKey(1), params, wv)
    return jcfg, tcfg, jmodel, carry_deployment(jmodel)


def test_carried_deployment_materializes_like_reference(tiny_deployment):
    _, _, jmodel, tmodel = tiny_deployment
    want = jax.tree.map(np.asarray, jmodel.materialize())
    got = tmodel.materialize()
    from repro_torch.core.programmer import flatten_with_names
    for (nw, a), (ng, b) in zip(flatten_with_names(want), flatten_with_names(got)):
        assert nw == ng
        np.testing.assert_array_equal(b.numpy(), a)


def test_carried_deployment_num_columns_is_the_references(tiny_deployment):
    _, _, jmodel, tmodel = tiny_deployment
    assert tmodel.num_columns == jmodel.num_columns > 0
    assert tmodel.num_columns == sum(st.g.shape[0] for st in tmodel.arrays.values())


def test_executor_ideal_logits_match_reference(tiny_deployment):
    jcfg, tcfg, jmodel, tmodel = tiny_deployment
    toks = np.random.RandomState(20).randint(0, 32, (2, 6))
    with _legacy():
        jex = JCIMExecutor(jmodel, J_IDEAL, jax.random.PRNGKey(19))
        want, _, _ = j_forward(jex.params(), {"tokens": jnp.asarray(toks)}, jcfg)
    ex = CIMExecutor(tmodel, IDEAL, _tk(jax.random.PRNGKey(19)))
    assert len(ex._analog) == 8                     # 7 projections + lm_head
    got, _, _ = forward(ex.params(), {"tokens": _t(toks)}, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    # ... and the ideal analog forward is the digital one on materialize()
    dig, _, _ = forward(tmodel.materialize(), {"tokens": _t(toks)}, tcfg)
    torch.testing.assert_close(got, dig, rtol=1e-4, atol=1e-5)
    assert ex.summary() == jex.summary()


def test_read_noise_fresh_per_access(tiny_deployment):
    _, tcfg, _, tmodel = tiny_deployment
    noisy = CIMConfig(dac_bits=5, adc_bits=10, sigma_read_lsb=0.5)
    toks = _t(np.random.RandomState(17).randint(0, 32, (2, 4)))
    ex = CIMExecutor(tmodel, noisy, _tk(jax.random.PRNGKey(18)))
    la, _, _ = forward(ex.tick(8), {"tokens": toks}, tcfg)
    lb, _, _ = forward(ex.tick(8), {"tokens": toks}, tcfg)
    assert float((la - lb).abs().max()) > 0.0
    ex2 = CIMExecutor(tmodel, noisy, _tk(jax.random.PRNGKey(18)))
    lc, _, _ = forward(ex2.tick(8), {"tokens": toks}, tcfg)
    assert torch.equal(la, lc)
    from repro_torch.obs import metrics
    before = metrics.value("cim.tokens")
    ex2.tick(3)
    assert metrics.value("cim.tokens") == before + 3


def test_executor_reads_and_cost(tiny_deployment):
    _, _, jmodel, tmodel = tiny_deployment
    ex = CIMExecutor(tmodel, CIMConfig(dac_bits=6, adc_bits=10))
    ex.tick(5)
    reads = ex.drain_reads()
    assert set(reads) == set(ex._analog)
    assert all(v == 5.0 * ex.planes for v in reads.values())
    assert all(v == 0.0 for v in ex.drain_reads().values())
    jex = JCIMExecutor(jmodel, JCIMConfig(dac_bits=6, adc_bits=10))
    assert ex.token_cost() == jex.token_cost()


def test_executor_reviews_swapped_arrays(tiny_deployment):
    _, _, _, tmodel = tiny_deployment
    ex = CIMExecutor(tmodel, IDEAL)
    name = "['layers']['wq']"
    before = ex.params()["layers"]["wq"].g_pos
    old = tmodel.arrays[name].g
    try:
        tmodel.update_array(name, old + 0.5)
        after = ex.params()["layers"]["wq"].g_pos
        assert float((after - before).abs().max()) > 0.0
    finally:
        tmodel.update_array(name, old)
