"""The port's cross-attention families against the JAX package:
`cross_attention` and `sinusoidal_positions` on their own, then the
smoke configs of llama-3.2-vision-11b (a gated cross block before each
group of layers) and musicgen-medium (stub frontend, sinusoidal
positions, cross-attention in every layer, four codebook heads), and
`tests/test_models.py`'s vlm and musicgen families, through
`init_params`, `forward`, `prefill` + `decode_step`, `loss_fn` and one
train step; MusicGen's two layer orders (ROADMAP.md C9); and the
rejections of padded and chunked prefill and of continuous batching.

Tolerances: those of `torch_families`; `cross_attention` within 2e-5 of
its largest; `sinusoidal_positions` within ``2e-7 * max position +
1e-6`` (XLA's exp an ulp off PyTorch's: an ulp of a frequency, times a
position of ~300, moves the angle by ~2e-5; measured 3.0e-5 at
position 297).

C9: the reference's forward applies MusicGen's per-layer cross block
after the layer's FFN and its decode applies it before; with the
zero-initialised gate the two agree.  With every gate at 0.7 the port's
forward equals the reference's forward and the port's decode the
reference's decode (both at the family tolerance), and the two orders
differ by far more than that.  C10, the same for the VLM at
``n_layers == cross_attn_every``: its forward runs no cross block, its
decode one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_models
import torch_families as fam
from repro.models.attention import cross_attention as j_cross_attention
from repro.models.layers import sinusoidal_positions as j_sinusoidal
from repro_torch.convert import params_from_numpy
from repro_torch.models import decode_step, forward, prefill, prefill_chunk
from repro_torch.models.attention import cross_attention
from repro_torch.models.layers import sinusoidal_positions
from repro_torch.serving import ContinuousScheduler, ServeEngine

CASES = ["llama-3.2-vision-11b", "musicgen-medium", "family-vlm", "family-musicgen"]


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


@pytest.mark.parametrize("s,t,heads,chunk", [(17, 9, (4, 4), 16), (5, 6, (8, 2), 16),
                                             (40, 33, (4, 1), 8)])
def test_cross_attention_matches(s, t, heads, chunk):
    rs = np.random.RandomState(s)
    h, kv = heads
    q = rs.randn(2, s, h, 8).astype(np.float32)
    k, v = (rs.randn(2, t, kv, 8).astype(np.float32) for _ in range(2))
    want = j_cross_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), chunk_q=chunk)
    got = cross_attention(*map(torch.from_numpy, (q, k, v)), chunk_q=chunk)
    assert tuple(got.shape) == tuple(want.shape)
    assert fam.rel(got, want) <= fam.TOL


@pytest.mark.parametrize("d", [64, 1536, 7])
def test_sinusoidal_positions_match(d):
    pos = np.arange(0, 300, 3)
    want = j_sinusoidal(jnp.asarray(pos), d)
    got = sinusoidal_positions(torch.from_numpy(pos), d)
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape)
    err = np.max(np.abs(got.numpy() - np.asarray(want)))
    assert err <= 2e-7 * pos.max() + 1e-6, err


@pytest.mark.parametrize("case", CASES)
def test_init_params_tree_matches(case):
    fam.check_tree(*_pair(case))


@pytest.mark.parametrize("case", CASES)
def test_forward_matches(case, carried):
    jcfg, tcfg = _pair(case)
    fam.check_forward(jcfg, tcfg, carried[case], fam.make_batch(jcfg, 2, 19, seed=1))


@pytest.mark.parametrize("case", CASES)
def test_prefill_decode_match(case, carried):
    jcfg, tcfg = _pair(case)
    fam.check_decode(jcfg, tcfg, carried[case], fam.make_batch(jcfg, 2, 17, seed=2),
                     n_prompt=13, max_len=24)


@pytest.mark.parametrize("case", CASES)
def test_loss_fn_matches(case, carried):
    jcfg, tcfg = _pair(case)
    fam.check_loss(jcfg, tcfg, carried[case], fam.make_batch(jcfg, 2, 16, seed=4, labels=True))


@pytest.mark.parametrize("case", ["llama-3.2-vision-11b", "musicgen-medium"])
def test_train_step_matches(case):
    jcfg, tcfg = _pair(case)
    fam.check_train_step(jcfg, tcfg, fam.make_batch(jcfg, 2, 16, seed=5, labels=True))


def test_musicgen_orders_follow_the_reference():
    """C9 with a nonzero gate: each package path against its own."""
    jcfg, tcfg = _pair("family-musicgen")
    params = fam.carried(jcfg, gate=0.7)
    batch = fam.make_batch(jcfg, 2, 17, seed=3)
    full = fam.check_forward(jcfg, tcfg, params, batch)
    errs = fam.check_decode(jcfg, tcfg, params, batch, n_prompt=16, max_len=21)
    assert max(errs) <= fam.TOL
    _, cache = prefill(params_from_numpy(params, device="cpu"),
                       fam.to_torch({k: (v[:, :16] if k == "embeds" else v)
                                     for k, v in batch.items()}), tcfg, max_len=21)
    last, _ = decode_step(params_from_numpy(params, device="cpu"), cache,
                          fam.to_torch({k: (v[:, 16:] if k == "embeds" else v)
                                        for k, v in batch.items()}), tcfg)
    assert fam.rel(last[:, 0], full[:, -1]) > 100 * fam.TOL


def test_vlm_single_group_follows_the_reference():
    """C10 with a nonzero gate: at ``n_layers == cross_attn_every`` the
    reference's forward runs no cross block (it groups only when
    ``cross_attn_every < n_layers``) while its decode runs one; the port
    follows each path."""
    jcfg = test_models.FAMILIES["vlm"].replace(n_layers=2)
    tcfg = fam.port_cfg(jcfg)
    params = fam.carried(jcfg, gate=0.7)
    batch = fam.make_batch(jcfg, 2, 17, seed=3)
    full = fam.check_forward(jcfg, tcfg, params, batch)
    fam.check_decode(jcfg, tcfg, params, batch, n_prompt=16, max_len=21)
    tp = params_from_numpy(params, device="cpu")
    _, cache = prefill(tp, fam.to_torch({k: (v[:, :16] if k == "tokens" else v)
                                         for k, v in batch.items()}), tcfg, max_len=21)
    last, _ = decode_step(tp, cache, fam.to_torch({k: (v[:, 16:] if k == "tokens" else v)
                                                   for k, v in batch.items()}), tcfg)
    assert fam.rel(last[:, 0], full[:, -1]) > 0.1


def test_cross_caches_refuse_padding(carried):
    """Padded and chunked prefill and continuous batching refuse the
    cross caches and the codebook heads, with the reference's messages."""
    for case, what in (("llama-3.2-vision-11b", "cross-attention caches"),
                       ("musicgen-medium", "cross-attention caches")):
        jcfg, tcfg = _pair(case)
        tp = params_from_numpy(carried[case], device="cpu")
        batch = fam.to_torch(fam.make_batch(jcfg, 1, 16, seed=7))
        with pytest.raises(ValueError, match=f"padded prefill does not support {what}"):
            prefill(tp, batch, tcfg, max_len=32, true_len=torch.tensor([9]))
        _, cache = prefill(tp, batch, tcfg, max_len=32)
        with pytest.raises(ValueError, match="cross-attention caches or multi-codebook"):
            prefill_chunk(tp, cache, torch.ones((1, 16), dtype=torch.int32), tcfg,
                          start=0, slot=0)
        with pytest.raises(ValueError, match=r"pure attention cache .*'cross_k'"):
            ContinuousScheduler(ServeEngine(tcfg, tp), device="cpu")
    # A dense stack with a codebook head and no cross-attention.
    _, tcfg = fam.smoke_pair("qwen3-0.6b")
    tp = {"tokens": torch.ones((1, 16), dtype=torch.int32)}
    with pytest.raises(ValueError, match="multi-codebook heads"):
        prefill({}, tp, tcfg.replace(n_codebooks=2), max_len=32, true_len=torch.tensor([9]))
    with pytest.raises(ValueError, match="not admissible"):
        ContinuousScheduler(ServeEngine(tcfg.replace(n_codebooks=2), {}), device="cpu")
