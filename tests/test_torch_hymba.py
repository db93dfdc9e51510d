"""The port's Hymba family (`models/ssm.py` and the hybrid decoder) against
the JAX package: `ssm_branch` on its own, then hymba-1.5b's smoke config
and `tests/test_models.py`'s hymba family through `init_params`,
`forward`, `prefill` + `decode_step`, `loss_fn` and one train step; the
sliding-window ring past its wraparound (`tests/test_decoding_long.py`'s
case); greedy generation; a deployment served through `CIMExecutor` and
`ServeEngine.generate` with ideal converters; and the rejections of
padded prefill and of continuous batching.

Tolerances: those of `torch_families`.  `ssm_branch`: output and state
within 2e-5 of their largest; the reference composes each 128-token
chunk's prefix by `associative_scan` and the port by a Hillis-Steele
scan of the same operator, so the float32 products associate in another
order (measured 4e-7).  The ring case holds the port's decode against
the reference's decode at every step and against the port's own full
forward within the reference's test bound, 5e-3 of the largest logit.
The served deployment (carried from the reference, ideal converters,
float32): logits within 1e-4 of the reference's served forward, greedy
tokens equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_models
import torch_families as fam
from repro.cim import CIMConfig as JCIMConfig
from repro.cim import CIMExecutor as JCIMExecutor
from repro.core import WVConfig as JWV, WVMethod as JWVMethod
from repro.core.programmer import deploy_arrays as j_deploy
from repro.models import ssm as j_ssm
from repro.models.decoding import decode_step as j_decode_step
from repro.models.decoding import prefill as j_prefill
from repro.models.transformer import forward as j_forward
from repro.serving import ServeEngine as JServeEngine
from repro_torch.cim import CIMConfig, CIMExecutor
from repro_torch.convert import key_from_numpy, params_from_numpy
from repro_torch.models import decode_step, forward, prefill, ssm
from repro_torch.models.layers import slice_layer
from repro_torch.serving import ContinuousScheduler, ServeEngine

from test_torch_cim import carry_deployment

CASES = ["hymba-1.5b", "family-hymba"]
IDEAL = dict(dac_bits=None, adc_bits=None, sigma_read_lsb=0.0)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads for the module, restored after it (the suite
    runs files side by side in worker processes)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _pair(case):
    if case.startswith("family-"):
        jcfg = test_models.FAMILIES[case.removeprefix("family-")]
        return jcfg, fam.port_cfg(jcfg)
    return fam.smoke_pair(case)


@pytest.fixture(scope="module")
def carried():
    return {case: fam.carried(_pair(case)[0]) for case in CASES}


@pytest.mark.parametrize("s", [1, 300])
def test_ssm_branch_matches(s, carried):
    """S == 1 (the decode recurrence) and a chunked sequence that is not
    a multiple of 128 tokens, from a nonzero state."""
    jcfg, tcfg = fam.smoke_pair("hymba-1.5b")
    rs = np.random.RandomState(s)
    layer = {k: v[1] for k, v in carried["hymba-1.5b"]["ssm"].items()}
    layer["dt_bias"] = 0.3 * rs.randn(*layer["dt_bias"].shape).astype(np.float32)
    x = rs.randn(2, s, jcfg.d_model).astype(np.float32)
    h0 = rs.randn(2, jcfg.d_model, jcfg.ssm_state).astype(np.float32)
    want, jst = j_ssm.ssm_branch(jnp.asarray(x), jax.tree.map(jnp.asarray, layer), jcfg,
                                 j_ssm.SSMState(jnp.asarray(h0)))
    got, tst = ssm.ssm_branch(torch.from_numpy(x), params_from_numpy(layer, device="cpu"),
                              tcfg, ssm.SSMState(torch.from_numpy(h0)))
    assert tuple(got.shape) == tuple(want.shape)
    assert fam.rel(got, want) <= fam.TOL, fam.rel(got, want)
    assert fam.rel(tst.h, jst.h) <= fam.TOL, fam.rel(tst.h, jst.h)


@pytest.mark.parametrize("case", CASES)
def test_init_params_tree_matches(case):
    fam.check_tree(*_pair(case))


@pytest.mark.parametrize("case", CASES)
def test_forward_matches(case, carried):
    jcfg, tcfg = _pair(case)
    fam.check_forward(jcfg, tcfg, carried[case], fam.make_batch(jcfg, 2, 21, seed=1))


@pytest.mark.parametrize("case", CASES)
def test_prefill_decode_match(case, carried):
    jcfg, tcfg = _pair(case)
    fam.check_decode(jcfg, tcfg, carried[case], fam.make_batch(jcfg, 2, 17, seed=2),
                     n_prompt=13, max_len=24)


@pytest.mark.parametrize("case", CASES)
def test_loss_fn_matches(case, carried):
    jcfg, tcfg = _pair(case)
    fam.check_loss(jcfg, tcfg, carried[case], fam.make_batch(jcfg, 2, 16, seed=4, labels=True))


@pytest.mark.parametrize("case", CASES)
def test_train_step_matches(case):
    jcfg, tcfg = _pair(case)
    fam.check_train_step(jcfg, tcfg, fam.make_batch(jcfg, 2, 16, seed=5, labels=True))


def test_ring_wraparound_matches():
    """`test_decoding_long.py`'s hymba case: a 6-slot ring, prefill 5
    tokens, 16 decode steps (the ring wraps twice)."""
    jcfg = test_models.FAMILIES["hymba"].replace(sliding_window=6)
    tcfg = fam.port_cfg(jcfg)
    params = fam.carried(jcfg)
    jp, tp = jax.tree.map(jnp.asarray, params), params_from_numpy(params, device="cpu")
    toks = fam.make_batch(jcfg, 2, 21, seed=1)["tokens"]
    full, _, _ = forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    _, jcache = fam.jitted(j_prefill, jcfg, max_len=21)(jp, {"tokens": jnp.asarray(toks[:, :5])})
    _, tcache = prefill(tp, {"tokens": torch.from_numpy(toks[:, :5])}, tcfg, max_len=21)
    assert tuple(tcache["k_swa"].shape) == tuple(jcache["k_swa"].shape) == (1, 2, 6, 2, 8)
    step = fam.jitted(j_decode_step, jcfg)
    for t in range(5, 21):
        one = toks[:, t:t + 1]
        want, jcache = step(jp, jcache, {"tokens": jnp.asarray(one)})
        got, tcache = decode_step(tp, tcache, {"tokens": torch.from_numpy(one)}, tcfg)
        assert fam.rel(got, want) <= fam.TOL, (t, fam.rel(got, want))
        assert fam.rel(got[:, 0], full[:, t]) < 5e-3, t
    for name in ("k_swa", "v_swa", "k_global", "ssm_h"):
        assert fam.rel(tcache[name], jcache[name]) <= 5 * fam.TOL, name


def test_generate_matches(carried):
    """The fixed-batch engine (C4: ``max_len = None``, so the SWA rings
    have the prompt's length and wrap)."""
    jcfg, tcfg = fam.smoke_pair("hymba-1.5b")
    toks = fam.make_batch(jcfg, 2, 6, seed=6)["tokens"]
    fam.check_generate(jcfg, tcfg, carried["hymba-1.5b"], toks, max_new=8)


@pytest.fixture(scope="module")
def served(carried):
    """The reference deploys the `['layers']` leaves of hymba's smoke
    params by HARP (a short fine loop; the SSM branch stays digital, as
    the executor serves it either way); the port serves the carried
    arrays."""
    with fam.legacy():
        wv = JWV(method=JWVMethod.HARP, max_fine_iters=8, max_coarse_iters=4)
        jmodel, _ = j_deploy(jax.random.PRNGKey(1),
                             jax.tree.map(jnp.asarray, carried["hymba-1.5b"]), wv,
                             predicate=lambda name, _: name.startswith("['layers']"),
                             min_bucket=4096, max_bucket=4096)
    return jmodel, carry_deployment(jmodel)


def test_served_deployment_matches_reference(served):
    jmodel, tmodel = served
    jcfg, tcfg = fam.smoke_pair("hymba-1.5b")
    toks = fam.make_batch(jcfg, 2, 10, seed=8)["tokens"]
    key = key_from_numpy(np.asarray(jax.random.PRNGKey(3)), "cpu")
    with fam.legacy():
        jex = JCIMExecutor(jmodel, JCIMConfig(**IDEAL), jax.random.PRNGKey(3))
        want, _, _ = fam.jitted(j_forward, jcfg)(jex.params(), {"tokens": jnp.asarray(toks)})
        want_toks = JServeEngine(jcfg, executor=jex).generate(jnp.asarray(toks), 6)
    ex = CIMExecutor(tmodel, CIMConfig(**IDEAL), key)
    assert sorted(ex._analog) == sorted(jex._analog)
    assert len(ex._analog) == 7 and "['ssm']['in_x']" in tmodel.digital
    tree = ex.params()
    assert slice_layer(tree["layers"], 2)["wq"].layer_id.item() == 2
    got, _, _ = forward(tree, {"tokens": torch.from_numpy(toks)}, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    dig, _, _ = forward(tmodel.materialize(), {"tokens": torch.from_numpy(toks)}, tcfg)
    np.testing.assert_allclose(got.numpy(), dig.numpy(), rtol=1e-4, atol=1e-4)
    got_toks = ServeEngine(tcfg, executor=ex).generate(torch.from_numpy(toks), 6)
    np.testing.assert_array_equal(got_toks.numpy(), np.asarray(want_toks))


def test_hybrid_cache_refuses_padding(carried):
    _, tcfg = fam.smoke_pair("hymba-1.5b")
    tp = params_from_numpy(carried["hymba-1.5b"], device="cpu")
    toks = torch.ones((1, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="padded prefill .* attention-only; got block=hymba"):
        prefill(tp, {"tokens": toks}, tcfg, max_len=32, true_len=torch.tensor([9]))
    with pytest.raises(ValueError, match=r"pure attention cache .*'k_swa'"):
        ContinuousScheduler(ServeEngine(tcfg, tp), device="cpu")
