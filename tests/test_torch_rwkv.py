"""The port's RWKV6 family (`models/rwkv6.py` and the recurrent decoder)
against the JAX package: `time_mix` and `channel_mix` on their own, then
rwkv6-1.6b's smoke config and `tests/test_models.py`'s rwkv6 family
through `init_params`, `forward`, `prefill` + `decode_step`, `loss_fn`
and one train step, a 50-step decode (`tests/test_decoding_long.py`'s
state-stability case), greedy generation and the rejections of padded
and chunked prefill and of continuous batching.

Tolerances: those of `torch_families`; `time_mix` / `channel_mix`
outputs and states within 2e-5 of their largest (float32 chunk sums
taken in another order).  The 50-step decode feeds both packages the
reference's greedy tokens and holds every step's logits and the final
state at the same tolerance (measured <= 1e-6 over the 50 steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_models
import torch_families as fam
from repro.models import rwkv6 as j_rwkv
from repro.models.decoding import decode_step as j_decode_step
from repro.models.decoding import prefill as j_prefill
from repro_torch.convert import params_from_numpy
from repro_torch.models import decode_step, prefill, prefill_chunk
from repro_torch.models import rwkv6
from repro_torch.serving import ContinuousScheduler, ServeEngine

CASES = ["rwkv6-1.6b", "family-rwkv6"]


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


def _live_layer(params, rs):
    """The smoke layers with a nonzero bonus and group-norm scale."""
    lay = dict(params["layers"])
    lay["bonus_u"] = 0.5 * rs.randn(*lay["bonus_u"].shape).astype(np.float32)
    lay["ln_x"] = 0.1 * rs.randn(*lay["ln_x"].shape).astype(np.float32)
    return lay


def _state(cfg, b, rs):
    h = cfg.d_model // cfg.head_dim
    return (rs.randn(b, h, cfg.head_dim, cfg.head_dim).astype(np.float32),
            rs.randn(b, cfg.d_model).astype(np.float32),
            rs.randn(b, cfg.d_model).astype(np.float32))


@pytest.mark.parametrize("s", [1, 16, 37])
def test_time_mix_and_channel_mix_match(s, carried):
    jcfg, tcfg = fam.smoke_pair("rwkv6-1.6b")
    rs = np.random.RandomState(s)
    lay = _live_layer(carried["rwkv6-1.6b"], rs)
    x = rs.randn(2, s, jcfg.d_model).astype(np.float32)
    st = _state(jcfg, 2, rs)
    jlay = jax.tree.map(jnp.asarray, lay)
    jst = j_rwkv.RWKVState(*map(jnp.asarray, st))
    tlay = params_from_numpy(lay, device="cpu")
    tst = rwkv6.RWKVState(*map(torch.from_numpy, st))
    for li in range(jcfg.n_layers):
        want = j_rwkv.time_mix(jnp.asarray(x), jlay, li, jcfg, jst)
        got = rwkv6.time_mix(torch.from_numpy(x), tlay, li, tcfg, tst)
        for g, w in zip(got, want):
            assert tuple(g.shape) == tuple(w.shape)
            assert fam.rel(g, w) <= fam.TOL, fam.rel(g, w)
        want = j_rwkv.channel_mix(jnp.asarray(x), jlay, li, jcfg, jst)
        got = rwkv6.channel_mix(torch.from_numpy(x), tlay, li, tcfg, tst)
        for g, w in zip(got, want):
            assert fam.rel(g, w) <= fam.TOL, fam.rel(g, w)


@pytest.mark.parametrize("case", CASES)
def test_init_params_tree_matches(case):
    fam.check_tree(*_pair(case))


@pytest.mark.parametrize("case", CASES)
def test_forward_matches(case, carried):
    jcfg, tcfg = _pair(case)
    fam.check_forward(jcfg, tcfg, carried[case], fam.make_batch(jcfg, 2, 37, seed=1))


@pytest.mark.parametrize("case", CASES)
def test_prefill_decode_match(case, carried):
    jcfg, tcfg = _pair(case)
    fam.check_decode(jcfg, tcfg, carried[case], fam.make_batch(jcfg, 2, 21, seed=2),
                     n_prompt=17, max_len=24)


@pytest.mark.parametrize("case", CASES)
def test_loss_fn_matches(case, carried):
    jcfg, tcfg = _pair(case)
    fam.check_loss(jcfg, tcfg, carried[case], fam.make_batch(jcfg, 2, 16, seed=4, labels=True))


@pytest.mark.parametrize("case", CASES)
def test_train_step_matches(case):
    jcfg, tcfg = _pair(case)
    fam.check_train_step(jcfg, tcfg, fam.make_batch(jcfg, 2, 16, seed=5, labels=True))


def test_long_decode_matches_reference():
    """`test_decoding_long.py`'s RWKV case: prefill 4 tokens, 50 greedy
    steps; the port fed the reference's tokens at every step."""
    jcfg = test_models.FAMILIES["rwkv6"].replace(n_layers=2)
    tcfg = fam.port_cfg(jcfg)
    params = fam.carried(jcfg)
    jp, tp = jax.tree.map(jnp.asarray, params), params_from_numpy(params, device="cpu")
    toks = fam.make_batch(jcfg, 2, 4, seed=1)["tokens"]
    _, jcache = fam.jitted(j_prefill, jcfg, max_len=8)(jp, {"tokens": jnp.asarray(toks)})
    _, tcache = prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg, max_len=8)
    step = fam.jitted(j_decode_step, jcfg)
    cur = toks[:, -1:]
    for _ in range(50):
        want, jcache = step(jp, jcache, {"tokens": jnp.asarray(cur)})
        got, tcache = decode_step(tp, tcache, {"tokens": torch.from_numpy(cur)}, tcfg)
        assert bool(torch.isfinite(got).all())
        assert fam.rel(got, want) <= fam.TOL
        cur = np.array(jnp.argmax(want[:, -1], axis=-1), np.int32)[:, None]
    assert bool(torch.isfinite(tcache["wkv"]).all())
    for name in ("wkv", "shift_t", "shift_c"):
        assert fam.rel(tcache[name], jcache[name]) <= fam.TOL, name
    assert int(tcache["pos"][0]) == int(jcache["pos"][0]) == 53


def test_generate_matches(carried):
    jcfg, tcfg = fam.smoke_pair("rwkv6-1.6b")
    toks = fam.make_batch(jcfg, 2, 9, seed=6)["tokens"]
    fam.check_generate(jcfg, tcfg, carried["rwkv6-1.6b"], toks, max_new=6)


def test_recurrent_state_refuses_padding(carried):
    """Padded and chunked prefill and continuous batching refuse the
    recurrent cache, with the reference's messages."""
    _, tcfg = fam.smoke_pair("rwkv6-1.6b")
    tp = params_from_numpy(carried["rwkv6-1.6b"], device="cpu")
    toks = torch.ones((1, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="padded prefill .* attention-only; got block=rwkv6"):
        prefill(tp, {"tokens": toks}, tcfg, max_len=32, true_len=torch.tensor([9]))
    _, cache = prefill(tp, {"tokens": toks}, tcfg, max_len=32)
    with pytest.raises(ValueError, match="chunked prefill is attention-only"):
        prefill_chunk(tp, cache, toks, tcfg, start=0, slot=0)
    with pytest.raises(ValueError, match=r"pure attention cache .*'wkv'"):
        ContinuousScheduler(ServeEngine(tcfg, tp), device="cpu")
