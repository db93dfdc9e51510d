"""The port's readout stack, configs, cost model and quantizer against the
JAX reference.

Tolerances:
* `verify_aggregate` for all four methods: bitwise against the
  `agg_*`/`mag_*`/`ncmp_*`/`thr_*` goldens in
  `tests/golden/readout_golden.npz` and against the live (eager) JAX
  function.  The noise enters through `normal`, whose erf_inv can differ
  by 2 ulp; these inputs draw no such value, and a measurement that lands
  on a converter boundary would show as a code flip here;
* converter, cost and quantize/pack: bitwise (same float32 operations);
* read-noise fields: <= 3 ulp (see `test_torch_rng.py`).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import types as jtypes
from repro.core.cost import CircuitCost as JCost, write_phase_cost as j_write_cost
from repro.core.wv import verify_aggregate as j_verify
from repro.quant import QuantConfig as JQ, pack_columns as j_pack, quantize_weight as j_quant
from repro.quant import unpack_columns as j_unpack
from repro.readout import config as jro_config, converter as j_conv, noise as j_noise
from repro_torch.convert import key_from_numpy, tensor_from_numpy
from repro_torch.core import types as ttypes
from repro_torch.core.cost import CircuitCost, read_phase_cost, write_phase_cost
from repro_torch.core.wv import verify_aggregate
from repro_torch.quant import QuantConfig, pack_columns, quantize_weight, unpack_columns
from repro_torch.readout import config as tro_config, converter as t_conv, noise as t_noise

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "readout_golden.npz")
N = 16
METHODS = ["cw_sc", "mra", "hd_pv", "harp"]


def _cfgs(method):
    """The golden generator's config, on both sides."""
    kw = dict(n_cells=N, tau_w=4.0 * N / 32.0, max_fine_iters=25)
    j = jtypes.WVConfig(
        method=jtypes.WVMethod(method), adc=jtypes.ADCConfig(bits=9),
        noise=jtypes.NoiseConfig(sigma_read_lsb=0.7, rho_cm=0.3), **kw)
    t = ttypes.WVConfig(
        method=ttypes.WVMethod(method), adc=ttypes.ADCConfig(bits=9),
        noise=ttypes.NoiseConfig(sigma_read_lsb=0.7, rho_cm=0.3), **kw)
    return j, t


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def inputs():
    """The golden generator's targets and free-floating state."""
    with jax.threefry_partitionable(False):
        targets = jax.random.randint(jax.random.PRNGKey(0), (12, N), 0, 8)
        targets = targets.astype(jnp.float32)
        g_free = targets + 0.4 * jax.random.normal(jax.random.PRNGKey(1), targets.shape)
    return np.array(targets), np.array(g_free)


def _fields(cls):
    return [(f.name, f.default if f.default is not dataclasses.MISSING else
             f.default_factory()) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["DeviceConfig", "FaultConfig", "ADCConfig",
                                  "NoiseConfig", "WVConfig"])
def test_config_fields_and_defaults_match(name):
    j, t = getattr(jtypes, name), getattr(ttypes, name)
    jf, tf = _fields(j), _fields(t)
    assert [f for f, _ in jf] == [f for f, _ in tf]
    for (f, a), (_, b) in zip(jf, tf):
        if dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f
        elif f == "method":
            assert a.value == b.value
        else:
            assert a == b, f


@pytest.mark.parametrize("n", [32, 64])
def test_default_config_for_array_and_readout_matrix(n):
    j = jtypes.default_config_for_array(n)
    t = ttypes.default_config_for_array(n)
    assert (j.adc.bits, j.tau_w) == (t.adc.bits, t.tau_w)
    for m in METHODS:
        jr = jro_config.for_wv_method(j.replace(method=jtypes.WVMethod(m)))
        tr = tro_config.for_wv_method(t.replace(method=ttypes.WVMethod(m)))
        assert (jr.basis.value, jr.converter.value, jr.avg_reads, jr.reads_per_sweep) == (
            tr.basis.value, tr.converter.value, tr.avg_reads, tr.reads_per_sweep)


@pytest.mark.parametrize("method", METHODS)
def test_verify_aggregate_matches_goldens_and_jax(golden, inputs, method):
    targets, g_free = inputs
    jcfg, tcfg = _cfgs(method)
    with jax.threefry_partitionable(False):
        key = jax.random.PRNGKey(5)
        j_out = j_verify(key, jnp.asarray(g_free), jnp.asarray(targets), jcfg)
    agg, mag, ncmp, thr = verify_aggregate(
        key_from_numpy(np.asarray(key), "cpu"), torch.from_numpy(g_free),
        torch.from_numpy(targets), tcfg)
    for name, got, live in (("agg", agg, j_out[0]), ("mag", mag, j_out[1]),
                            ("ncmp", ncmp, j_out[2])):
        got = got.numpy()
        np.testing.assert_array_equal(got, golden[f"{name}_{method}"], err_msg=name)
        np.testing.assert_array_equal(got, np.asarray(live), err_msg=name)
    assert np.float32(thr) == golden[f"thr_{method}"] == np.float32(j_out[3])


@pytest.mark.parametrize("method", METHODS)
def test_read_cost_matches_goldens(golden, method):
    _, tcfg = _cfgs(method)
    lat, en = read_phase_cost(tcfg, CircuitCost())
    assert np.float32(lat) == golden[f"cost_lat_{method}"]
    assert np.float32(en) == golden[f"cost_en_{method}"]


def test_write_phase_cost_matches_jax():
    rs = np.random.RandomState(0)
    g = rs.uniform(-1, 8, (40, 32)).astype(np.float32)
    n_p = rs.randint(0, 5, (40, 32)).astype(np.float32)
    d = rs.choice([-1.0, 0.0, 1.0], (40, 32)).astype(np.float32)
    dev = jtypes.DeviceConfig()
    for coarse in (False, True):
        jl, je = j_write_cost(jnp.asarray(g), jnp.asarray(n_p), jnp.asarray(d), dev,
                              JCost(), coarse=coarse)
        tl, te = write_phase_cost(torch.from_numpy(g), torch.from_numpy(n_p),
                                  torch.from_numpy(d), ttypes.DeviceConfig(),
                                  CircuitCost(), coarse=coarse)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        # A 32-term float32 sum: torch and XLA may add in another order.
        np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5)


@pytest.mark.parametrize("centered", [True, False])
@pytest.mark.parametrize("bits", [1, 9, 10])
def test_sar_and_compare_bitwise(centered, bits):
    y = np.random.RandomState(bits).uniform(-150, 150, (64, 32)).astype(np.float32)
    want = np.asarray(j_conv.sar_quantize(jnp.asarray(y), bits, 224.0, centered))
    got = t_conv.sar_quantize(torch.from_numpy(y), bits, 224.0, centered).numpy()
    np.testing.assert_array_equal(got, want)
    tgt = np.round(y / 3).astype(np.float32)
    js, jn = j_conv.compare_read(jnp.asarray(y / 50), jnp.asarray(tgt / 50), 0.5)
    ts, tn = t_conv.compare_read(torch.from_numpy(y / 50), torch.from_numpy(tgt / 50), 0.5)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


@pytest.mark.parametrize("m", [1, 5])
def test_read_noise_fields_match(m):
    noise_j = jtypes.NoiseConfig(sigma_read_lsb=0.7, rho_cm=0.3)
    noise_t = ttypes.NoiseConfig(sigma_read_lsb=0.7, rho_cm=0.3)
    with jax.threefry_partitionable(False):
        k = jax.random.PRNGKey(9)
        keys = jax.vmap(lambda i: jax.random.fold_in(k, i))(jnp.arange(6))
        j_uc, j_cm = j_noise.sample_read_fields(keys, (6,), m, 16, noise_j)
    t_uc, t_cm = t_noise.sample_read_fields(
        key_from_numpy(np.asarray(keys), "cpu"), (6,), m, 16, noise_t)
    for a, b in ((j_uc, t_uc), (j_cm, t_cm)):
        a = np.asarray(a)
        b = b.numpy()
        assert a.shape == b.shape
        d = np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32))
        assert d.max() <= 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(70, 24), (3, 40, 48)])
def test_quantize_pack_unpack_bitwise(dtype, shape):
    w = (np.random.RandomState(1).randn(*shape) * 0.05).astype(np.float32)
    jw = jnp.asarray(w).astype(getattr(jnp, dtype))
    w2 = jw.reshape((-1, shape[-1]))
    jq, js = j_quant(w2, JQ())
    jcols, jlay = j_pack(jq, 32, 3, 2)
    tw = tensor_from_numpy(np.asarray(w2), "cpu")
    tq, ts = quantize_weight(tw, QuantConfig())
    tcols, tlay = pack_columns(tq, 32, 3, 2)
    assert tw.dtype == getattr(torch, dtype) and ts.dtype == tw.dtype
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.float().numpy(), np.asarray(js, np.float32))
    np.testing.assert_array_equal(tcols.numpy(), np.asarray(jcols))
    assert dataclasses.asdict(tlay) == dataclasses.asdict(jlay)
    noisy = np.asarray(jcols) + np.random.RandomState(2).randn(*jcols.shape).astype(np.float32) * 0.1
    np.testing.assert_array_equal(
        unpack_columns(torch.from_numpy(noisy), tlay).numpy(),
        np.asarray(j_unpack(jnp.asarray(noisy), jlay)))


@pytest.mark.parametrize("n", [1, 4, 32])
def test_hadamard_check_and_unnormalized_decode_match(n):
    """`is_hadamard` on the Sylvester matrix and on a broken copy, and
    `decode_unnormalized` bitwise against the reference's."""
    from repro.core import hadamard as jhad
    from repro_torch.core import hadamard as thad

    h = thad.hadamard_matrix(n, device="cpu").numpy()
    bad = h.copy()
    bad[0, 0] = 0.0
    for a in (h, bad, h[:, : max(n // 2, 1)]):
        assert thad.is_hadamard(a) == jhad.is_hadamard(a)
    assert thad.is_hadamard(h) and not thad.is_hadamard(bad)
    y = np.random.RandomState(n).randn(3, n).astype(np.float32)
    np.testing.assert_array_equal(thad.decode_unnormalized(torch.from_numpy(y)).numpy(),
                                  np.asarray(jhad.decode_unnormalized(jnp.asarray(y))))


def test_readout_package_exports_the_references_names():
    import repro.readout as jro
    import repro_torch.readout as tro

    assert tro.sample_token_read_noise is t_noise.sample_token_read_noise
    assert {n for n in dir(jro) if not n.startswith("_")} <= set(dir(tro))
