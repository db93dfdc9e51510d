"""Serving in the port (`models` forward, prefill and decode,
`serving.ServeEngine`, `rng.categorical`) against the JAX package.

Every JAX call runs inside a scoped ``jax.threefry_partitionable(False)``
block; weights and deployments are carried across as numpy.

Tolerances:
* digital logits (`forward`, `prefill`, `decode_step`) and caches on the
  four dense smoke configs of the registry (qwen3-0.6b, llama3.2-1b,
  smollm-360m, tinyllama-1.1b) in float32, params carried: rtol 1e-4,
  atol 1e-5 (float32 sums taken in another order; XLA's rsqrt, exp, sin
  and cos differ from PyTorch's by ulps);
* `categorical`: token for token (the same Gumbel draws, argmax);
  `uniform` over [minval, maxval): bitwise for a unit span, otherwise
  within one rounding of ``f * span`` (the reference contracts the
  affine map into an FMA);
* noisy analog serving (DAC 6 bits, ADC 10 bits, read noise 0.2 LSB) on
  the carried tiny deployment: logits within atol `SERVE_ATOL` = 0.05
  of the reference's at every step, both fed the same tokens.  The
  partial sums are taken in another order (and the reference's noise is
  up to 3 ulp off), so a few ADC codes in 10^5 move by one code or by
  one slice-1 code (8 codes); with the tiny model's 32-row tiles one
  such flip in a high DAC plane moves a logit by up to ~0.02 (measured
  0.019 over 4 seeds x 7 steps; 1e-4 where no code flipped); the same
  on smollm-360m's smoke config deployed by the reference and tiled in
  32-row macros, so its 60-row inputs end in a partial tile;
* greedy tokens from `generate`: equal at every step up to the first
  where the reference's top-2 margin is within the logit tolerance (a
  step after a legitimately different token sees another prompt).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cim import CIMConfig as JCIMConfig
from repro.cim import CIMExecutor as JCIMExecutor
from repro import configs as jconfigs
from repro.configs.qwen3_0_6b import SMOKE_CONFIG as J_SMOKE
from repro.core import WVConfig as JWVConfig, WVMethod as JWVMethod
from repro.core.programmer import deploy_arrays as j_deploy_arrays
from repro.models import init_params as j_init_params
from repro.models.decoding import decode_step as j_decode_step
from repro.models.decoding import init_cache as j_init_cache
from repro.models.decoding import prefill as j_prefill
from repro.models.decoding import write_cache_slot as j_write_cache_slot
from repro.models.transformer import forward as j_forward
from repro.serving import ServeEngine as JServeEngine
from repro_torch import configs
from repro_torch.cim import CIMConfig, CIMExecutor
from repro_torch.configs.qwen3_0_6b import SMOKE_CONFIG
from repro_torch.convert import key_from_numpy, params_from_numpy
from repro_torch.core import rng as trng
from repro_torch.models import decode_step, forward, init_cache, prefill, write_cache_slot
from repro_torch.serving import ServeEngine

from test_torch_cim import carry_deployment, tiny_cfgs

RTOL, ATOL = 1e-4, 1e-5
SERVE_ATOL = 0.05
NOISY = dict(dac_bits=6, adc_bits=10, sigma_read_lsb=0.2)


def _legacy():
    return jax.threefry_partitionable(False)


def _tk(k) -> torch.Tensor:
    return key_from_numpy(np.asarray(k), device="cpu")


def _close(got: torch.Tensor, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads for the module, restored after it (the suite
    runs files side by side in worker processes)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def dense_params():
    """arch -> (JAX smoke config, port smoke config, numpy params, port
    params): the reference's params, carried, made once per arch."""
    made = {}

    def get(arch):
        if arch not in made:
            jcfg = jconfigs.get_smoke_config(arch)
            with _legacy():
                p = j_init_params(jax.random.PRNGKey(0), jcfg)
            np_params = jax.tree.map(np.asarray, p)
            made[arch] = (jcfg, configs.get_smoke_config(arch), np_params,
                          params_from_numpy(np_params, device="cpu"))
        return made[arch]

    return get


@pytest.fixture(scope="module")
def smoke_params(dense_params):
    return dense_params("qwen3-0.6b")[2:]


def _cases(values):
    """(arch, value) cases over the dense smoke configs; qwen3-0.6b's
    cases keep the ids they had before the other archs joined."""
    return [pytest.param(a, v, id=str(v) if a == "qwen3-0.6b" else f"{a}-{v}")
            for a in configs.DENSE_ARCHS for v in values]


def _tokens(seed, shape, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(np.int32)


# ------------------------------------------------------------------ forward
@pytest.mark.parametrize("arch,seq", _cases([5, 40]))
def test_forward_logits_match_reference(dense_params, arch, seq):
    jcfg, tcfg, np_params, t_params = dense_params(arch)
    toks = _tokens(seq, (2, seq))
    want, want_aux, want_kv = j_forward(jax.tree.map(jnp.asarray, np_params),
                                        {"tokens": jnp.asarray(toks)}, jcfg,
                                        collect_cache=True)
    got, aux, kv = forward(t_params, {"tokens": torch.from_numpy(toks)},
                           tcfg, collect_cache=True)
    assert got.dtype == torch.float32 and got.shape == (2, seq, 256)
    _close(got, want)
    _close(kv["k"], want_kv["k"])
    _close(kv["v"], want_kv["v"])
    assert float(aux) == float(want_aux)


@pytest.mark.parametrize("arch", configs.DENSE_ARCHS)
def test_prefill_and_decode_match_reference(dense_params, arch):
    jcfg, tcfg, np_params, t_params = dense_params(arch)
    jp = jax.tree.map(jnp.asarray, np_params)
    toks = _tokens(1, (3, 7))
    want_last, jcache = j_prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, max_len=12)
    got_last, cache = prefill(t_params, {"tokens": torch.from_numpy(toks)},
                              tcfg, max_len=12)
    _close(got_last, want_last)
    for name in ("k", "v"):
        _close(cache[name], jcache[name])
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))
    cur = np.argmax(np.asarray(want_last), -1).astype(np.int32)[:, None]
    for _ in range(6):   # 7 + 6 > 12: the last writes fall outside the cache
        want, jcache = j_decode_step(jp, jcache, {"tokens": jnp.asarray(cur)}, jcfg)
        got, cache = decode_step(t_params, cache, {"tokens": torch.from_numpy(cur)},
                                 tcfg)
        _close(got, want)
        for name in ("k", "v"):
            _close(cache[name], jcache[name])
        np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))
        cur = np.argmax(np.asarray(want)[:, -1], -1).astype(np.int32)[:, None]


def test_padded_prefill_and_cache_slot_match_reference(smoke_params):
    np_params, t_params = smoke_params
    jp = jax.tree.map(jnp.asarray, np_params)
    toks = _tokens(2, (2, 8))
    true_len = np.array([5, 8], np.int32)
    want, jc = j_prefill(jp, {"tokens": jnp.asarray(toks)}, J_SMOKE, max_len=16,
                         true_len=jnp.asarray(true_len))
    got, tc = prefill(t_params, {"tokens": torch.from_numpy(toks)}, SMOKE_CONFIG,
                      max_len=16, true_len=torch.from_numpy(true_len))
    _close(got, want)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    shared_j = j_init_cache(J_SMOKE, 3, 16)
    shared_t = init_cache(SMOKE_CONFIG, 3, 16, device="cpu")
    single_j = jax.tree.map(lambda a: a[:1] if a.ndim == 1 else a[:, :1], jc)
    single_t = {k: (v[:1] if v.ndim == 1 else v[:, :1]) for k, v in tc.items()}
    out_j = j_write_cache_slot(shared_j, single_j, 2)
    out_t = write_cache_slot(shared_t, single_t, 2)
    for name in ("k", "v", "pos"):
        _close(out_t[name].to(torch.float32), np.asarray(out_j[name], np.float32))
    assert float(shared_t["k"].abs().max()) == 0.0          # functional update


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_categorical_matches_reference(seed):
    logits = np.random.RandomState(seed).randn(4, 300).astype(np.float32) * 2
    with _legacy():
        k = jax.random.PRNGKey(seed + 10)
        want = np.asarray(jax.random.categorical(k, jnp.asarray(logits), axis=-1))
    got = trng.categorical(_tk(k), torch.from_numpy(logits), axis=-1)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(TypeError):
        trng.categorical(_tk(k), torch.from_numpy(logits).double())


@pytest.mark.parametrize("minval,maxval", [
    (0.0, 1.0), (float(np.finfo(np.float32).tiny), 1.0), (-2.0, 3.0)])
def test_uniform_range(minval, maxval):
    """Bitwise for a unit span (categorical's); otherwise within one
    rounding of ``f * span`` (XLA contracts ``f * span + minval`` into an
    FMA)."""
    with _legacy():
        k = jax.random.PRNGKey(3)
        want = np.asarray(jax.random.uniform(k, (5, 33), minval=minval, maxval=maxval))
    got = trng.uniform(_tk(k), (5, 33), minval=minval, maxval=maxval).numpy()
    span = np.float32(maxval) - np.float32(minval)
    atol = 0.0 if span == 1.0 else float(np.spacing(span))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    assert got.min() >= minval


# ------------------------------------------------------------------ serving
def _assert_tokens_follow(got, want, margins, tol):
    """Equal tokens at every step up to the first one whose reference
    top-2 margin is within `tol` (compared column by column)."""
    for t in range(want.shape[1]):
        same = got[:, t] == want[:, t]
        if not same.all():
            assert np.all(margins[~same, t] <= tol), (t, got[:, t], want[:, t])
            return


def _margins(logits: np.ndarray) -> np.ndarray:
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


@pytest.mark.parametrize("arch,temperature", _cases([0.0, 0.7]))
def test_digital_generate_matches_reference(dense_params, arch, temperature):
    jcfg, tcfg, np_params, t_params = dense_params(arch)
    toks = _tokens(4, (2, 6))
    with _legacy():
        jeng = JServeEngine(jcfg, jax.tree.map(jnp.asarray, np_params),
                            temperature=temperature)
        want = np.asarray(jeng.generate(jnp.asarray(toks), max_new=5,
                                        key=jax.random.PRNGKey(9)))
    eng = ServeEngine(tcfg, t_params, temperature=temperature)
    got = eng.generate(torch.from_numpy(toks), max_new=5, key=_tk(jax.random.PRNGKey(9)))
    assert got.dtype == torch.int32 and got.shape == (2, 5)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def tiny_deployment():
    jcfg, tcfg = tiny_cfgs()
    with _legacy():
        params = j_init_params(jax.random.PRNGKey(0), jcfg)
        wv = JWVConfig(method=JWVMethod.HARP, max_fine_iters=12, max_coarse_iters=4)
        jmodel, _ = j_deploy_arrays(jax.random.PRNGKey(1), params, wv)
    return jcfg, tcfg, jmodel, carry_deployment(jmodel)


@pytest.mark.parametrize("seed", [0, 2])
def test_noisy_analog_steps_match_reference(tiny_deployment, seed):
    """Prefill and decode logits of noisy analog serving, step by step,
    both sides fed the reference's greedy tokens."""
    jcfg, tcfg, jmodel, tmodel = tiny_deployment
    toks = _tokens(5 + seed, (3, 6), vocab=32)
    with _legacy():
        jeng = JServeEngine(jcfg, executor=JCIMExecutor(
            jmodel, JCIMConfig(**NOISY), jax.random.PRNGKey(31 + seed)))
        jlast, jcache = jeng._prefill(jeng.access_params(18), {"tokens": jnp.asarray(toks)})
        j_steps = [np.asarray(jlast)]
        cur = np.argmax(j_steps[-1], -1).astype(np.int32)[:, None]
        feeds = [cur]
        for i in range(4):
            _, logits, jcache = jeng._decode(jeng.access_params(3), jcache,
                                             {"tokens": jnp.asarray(cur)}, None)
            j_steps.append(np.asarray(logits)[:, -1])
            cur = np.argmax(j_steps[-1], -1).astype(np.int32)[:, None]
            feeds.append(cur)
    ex = CIMExecutor(tmodel, CIMConfig(**NOISY), _tk(jax.random.PRNGKey(31 + seed)))
    eng = ServeEngine(tcfg, executor=ex)
    last, cache = eng._prefill(eng.access_params(18), {"tokens": torch.from_numpy(toks)})
    steps = [last]
    for i in range(4):
        _, logits, cache = eng._decode(eng.access_params(3), cache,
                                       {"tokens": torch.from_numpy(feeds[i])})
        steps.append(logits[:, -1])
    assert ex.access == jeng.executor.access == 5
    for got, want in zip(steps, j_steps):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SERVE_ATOL)


def test_noisy_analog_generate_matches_reference(tiny_deployment):
    jcfg, tcfg, jmodel, tmodel = tiny_deployment
    toks = _tokens(6, (4, 5), vocab=32)
    with _legacy():
        jex = JCIMExecutor(jmodel, JCIMConfig(**NOISY), jax.random.PRNGKey(41))
        want = np.asarray(JServeEngine(jcfg, executor=jex).generate(
            jnp.asarray(toks), max_new=6))
        # The reference's logits along its own tokens, for the margins.
        jex2 = JCIMExecutor(jmodel, JCIMConfig(**NOISY), jax.random.PRNGKey(41))
        jeng = JServeEngine(jcfg, executor=jex2)
        last, cache = jeng._prefill(jeng.access_params(20), {"tokens": jnp.asarray(toks)})
        margins = [_margins(np.asarray(last))]
        for t in range(5):
            _, logits, cache = jeng._decode(jeng.access_params(4), cache,
                                            {"tokens": jnp.asarray(want[:, t:t + 1])}, None)
            margins.append(_margins(np.asarray(logits)[:, -1]))
    ex = CIMExecutor(tmodel, CIMConfig(**NOISY), _tk(jax.random.PRNGKey(41)))
    got = ServeEngine(tcfg, executor=ex).generate(torch.from_numpy(toks), max_new=6)
    assert ex.tokens_served == jex.tokens_served == 20 + 5 * 4
    _assert_tokens_follow(got.numpy(), want, np.stack(margins, 1), 2 * SERVE_ATOL)


def test_generate_stops_at_eos(smoke_params):
    _, t_params = smoke_params
    eng = ServeEngine(SMOKE_CONFIG, t_params)
    toks = torch.from_numpy(_tokens(7, (1, 4)))
    full = eng.generate(toks, max_new=6)
    eos = int(full[0, 1])
    out = eng.generate(toks, max_new=6, eos_id=eos)
    assert out.shape[1] == 2 and torch.equal(out, full[:, :2])


@pytest.fixture(scope="module")
def smollm_deployment():
    """smollm-360m's smoke config (d_model 60, kv_dim 20) deployed by the
    reference, carried across."""
    jcfg = jconfigs.get_smoke_config("smollm-360m")
    with _legacy():
        params = j_init_params(jax.random.PRNGKey(0), jcfg)
        wv = JWVConfig(method=JWVMethod.HARP, max_fine_iters=12, max_coarse_iters=4)
        # One bucket for its 3888 columns: one compiled dispatch.
        jmodel, _ = j_deploy_arrays(jax.random.PRNGKey(1), params, wv,
                                    min_bucket=4096, max_bucket=4096)
    return jcfg, configs.get_smoke_config("smollm-360m"), jmodel, carry_deployment(jmodel)


def test_noisy_analog_partial_tile_matches_reference(smollm_deployment):
    """Noisy analog prefill and decode on smollm's smoke config in 32-row
    macros: its 60-row inputs fill one tile and end in a 28-row one."""
    jcfg, tcfg, jmodel, tmodel = smollm_deployment
    cim = dict(NOISY, macro_rows=32)
    toks = _tokens(8, (2, 6))
    with _legacy():
        jeng = JServeEngine(jcfg, executor=JCIMExecutor(
            jmodel, JCIMConfig(**cim), jax.random.PRNGKey(51)))
        jlast, jcache = jeng._prefill(jeng.access_params(12), {"tokens": jnp.asarray(toks)})
        j_steps = [np.asarray(jlast)]
        feeds = [np.argmax(j_steps[-1], -1).astype(np.int32)[:, None]]
        for _ in range(2):
            _, logits, jcache = jeng._decode(jeng.access_params(2), jcache,
                                             {"tokens": jnp.asarray(feeds[-1])}, None)
            j_steps.append(np.asarray(logits)[:, -1])
            feeds.append(np.argmax(j_steps[-1], -1).astype(np.int32)[:, None])
    ex = CIMExecutor(tmodel, CIMConfig(**cim), _tk(jax.random.PRNGKey(51)))
    wq = ex.params()["layers"]["wq"]
    assert (wq.rows_in, wq.n_tiles, wq.tile_rows) == (60, 2, 32)
    eng = ServeEngine(tcfg, executor=ex)
    last, cache = eng._prefill(eng.access_params(12), {"tokens": torch.from_numpy(toks)})
    steps = [last]
    for i in range(2):
        _, logits, cache = eng._decode(eng.access_params(2), cache,
                                       {"tokens": torch.from_numpy(feeds[i])})
        steps.append(logits[:, -1])
    for got, want in zip(steps, j_steps):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SERVE_ATOL)
