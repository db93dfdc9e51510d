"""Continuous batching in the port (`repro_torch.serving.scheduler`,
`models.decoding.prefill_chunk`) against the JAX package's scheduler, on
the JAX scheduler tests' tiny config (`tests/test_serving_scheduler.py`).

Every JAX call runs inside a scoped ``jax.threefry_partitionable(False)``
block; params and deployments are carried across as numpy.

Tolerances:
* `select_next`, `admission_key`, `poisson_requests`: equal;
* `prefill_chunk` against the JAX `prefill_chunk` (prompt 37, chunks of
  16): caches and last logits within rtol 1e-4, atol 1e-5 (float32 sums
  in another order; the port's digital forward is held to the same);
* the port's chunked prefill against its own whole-bucket prefill, and
  its right-padded prefill against its unpadded prefill: caches over the
  real positions and logits within rtol 1e-5, atol 1e-6 (the JAX package
  is not bitwise here either: ROADMAP.md C3 and C6), first tokens equal;
* scheduler runs, digital and analog (with a lifetime scrub between
  decode steps), against the JAX scheduler on one request stream: the
  records' admit / first-token / done steps, bucket lengths and chunk
  counts, `trace_counts`, the executor's token count and the scrub's
  flag and re-program counts exactly; `host_syncs == decode_steps`;
  tokens equal at every step up to the first one where the JAX side's
  top-2 margin (of the logits, or of logits / T + Gumbel when sampling)
  is within `2 * atol` (the rule of `tests/test_torch_serve.py`): atol
  1e-4 digital, 0.05 analog (ADC code flips);
* a request alone against the same request in a full batch, and an
  analog decode row beside other or empty slots: bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cim import CIMConfig as JCIMConfig
from repro.cim import CIMExecutor as JCIMExecutor
from repro.core import WVConfig as JWVConfig, WVMethod as JWVMethod
from repro.core.programmer import deploy_arrays as j_deploy_arrays
from repro.lifetime import LifetimeSimulator as JLifetimeSimulator
from repro.lifetime import RefreshConfig as JRefreshConfig
from repro.lifetime import RefreshPolicy as JRefreshPolicy
from repro.models import ModelConfig as JModelConfig
from repro.models import init_params as j_init_params
from repro.models.decoding import init_cache as j_init_cache
from repro.models.decoding import prefill_chunk as j_prefill_chunk
from repro.serving import ContinuousScheduler as JContinuousScheduler
from repro.serving import ServeEngine as JServeEngine
from repro.serving import admission_key as j_admission_key
from repro.serving import poisson_requests as j_poisson_requests
from repro.serving import select_next as j_select_next
from repro_torch import obs
from repro_torch.cim import CIMConfig, CIMExecutor, token_stream_ids
from repro_torch.convert import key_from_numpy, params_from_numpy
from repro_torch.core import WVConfig, WVMethod, rng as trng
from repro_torch.lifetime import LifetimeSimulator, RefreshConfig, RefreshPolicy
from repro_torch.models import (
    ModelConfig,
    decode_step,
    init_cache,
    prefill,
    prefill_chunk,
    write_cache_slot,
)
from repro_torch.serving import (
    ADMISSION_POLICIES,
    ContinuousScheduler,
    Request,
    ServeEngine,
    admission_key,
    make_prefill_chunk_step,
    poisson_requests,
    select_next,
)

from test_torch_cim import carry_deployment

RTOL, ATOL = 1e-4, 1e-5
SELF_RTOL, SELF_ATOL = 1e-5, 1e-6
DIGITAL_ATOL, ANALOG_ATOL = 1e-4, 0.05
NOISY = dict(dac_bits=4, adc_bits=10, sigma_read_lsb=0.2)
WV_KW = dict(max_fine_iters=12, max_coarse_iters=4)


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


def _tk(k) -> torch.Tensor:
    return key_from_numpy(np.asarray(k), device="cpu")


def _cfgs(**kw):
    """The JAX scheduler tests' `_tiny_cfg`, on both sides."""
    base = dict(name="sched-test", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                head_dim=16, d_ff=64, vocab_size=64, attn_chunk_q=16,
                attn_chunk_kv=16, remat=False, tie_embeddings=False)
    base.update(kw)
    return JModelConfig(dtype=jnp.float32, **base), ModelConfig(dtype=torch.float32, **base)


@pytest.fixture(scope="module")
def digital():
    jcfg, tcfg = _cfgs()
    with _legacy():
        params = j_init_params(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree.map(np.asarray, params)
    return jcfg, tcfg, params, params_from_numpy(np_params, device="cpu")


@pytest.fixture(scope="module")
def deployed(digital):
    jcfg, tcfg, params, _ = digital
    with _legacy():
        jmodel, _ = j_deploy_arrays(jax.random.PRNGKey(1), params,
                                    JWVConfig(method=JWVMethod.HARP, **WV_KW))
    return jcfg, tcfg, jmodel


def _carry(jmodel):
    tm = carry_deployment(jmodel)
    tm.wv_cfg = WVConfig(method=WVMethod.HARP, **WV_KW)
    return tm


class _JRecording(JContinuousScheduler):
    """The JAX scheduler, recording the top-2 margin of every sampled row
    by (rid, token index): of the logits, or of logits / T + Gumbel (the
    score `categorical` takes the argmax of) when sampling."""

    def __init__(self, *args, **kw):
        self.margins = {}
        super().__init__(*args, **kw)

    def _select_token(self, logits, key, rid, gen):
        tok = super()._select_token(logits, key, rid, gen)
        score = logits.astype(jnp.float32)
        if self.temperature > 0.0:
            k = jax.random.fold_in(jax.random.fold_in(key, rid), gen)
            score = score / self.temperature + jax.random.gumbel(k, score.shape)
        top2 = jax.lax.top_k(score, 2)[0]
        jax.debug.callback(self._record, rid, gen, top2[0] - top2[1])
        return tok

    def _record(self, rid, gen, margin):
        self.margins[(int(rid), int(gen))] = float(margin)


def _assert_tokens_follow(got, want, margins, tol):
    """Per request: equal tokens up to the first differing one, whose
    JAX-side margin must be within `tol`."""
    diverged = 0
    for rid, toks in want.items():
        assert len(got[rid]) == len(toks), rid
        for t, (a, b) in enumerate(zip(got[rid], toks)):
            if a != b:
                assert margins[(rid, t)] <= tol, (rid, t, a, b, margins[(rid, t)])
                diverged += 1
                break
    assert diverged <= len(want) // 2, f"{diverged} of {len(want)} requests diverged"


def _same_records(got, want):
    assert [r.rid for r in got] == [r.rid for r in want]
    for a, b in zip(got, want):
        for f in ("arrival", "prompt_len", "bucket_len", "admit_step",
                  "first_token_step", "done_step", "deadline", "n_chunks"):
            assert getattr(a, f) == getattr(b, f), (a.rid, f)
        assert a.n_generated == b.n_generated


def _jreqs(reqs):
    from repro.serving import Request as JRequest

    return [JRequest(**dataclasses.asdict(r)) for r in reqs]


# ------------------------------------------------------------ pure parts
def test_select_next_and_admission_key_match_reference():
    from repro.serving import Request as JRequest

    rs = np.random.RandomState(0)
    for trial in range(50):
        n = rs.randint(1, 12)
        rows = [(int(rid), float(rs.randint(0, 20)), int(rs.randint(1, 33)),
                 None if rs.rand() < 0.3 else float(rs.randint(0, 60)))
                for rid in rs.choice(1000, n, replace=False)]
        tr = [Request(rid=r, prompt=[0] * p, max_new=1, arrival=a, deadline=d)
              for r, a, p, d in rows]
        jr = [JRequest(rid=r, prompt=[0] * p, max_new=1, arrival=a, deadline=d)
              for r, a, p, d in rows]
        for policy in ADMISSION_POLICIES:
            assert select_next(tr, policy).rid == j_select_next(jr, policy).rid
            assert [admission_key(policy, r) for r in tr] == \
                [j_admission_key(policy, r) for r in jr]
    with pytest.raises(ValueError, match="unknown admission policy"):
        admission_key("lifo", tr[0])


@pytest.mark.parametrize("kw", [
    dict(rate=0.5, prompt_lens=(3, 20), max_new=(3, 8)),
    dict(rate=0.3, prompt_lens=(16, 32), max_new=(16, 32), start_rid=7),
    dict(rate=2.0, prompt_lens=(3, 8), max_new=(2, 4), long_prompt_lens=(30, 40),
         long_frac=0.3, ttft_slack=(8.0, 32.0), eos_id=3),
])
def test_poisson_requests_match_reference(kw):
    got = poisson_requests(3, 16, vocab=64, **kw)
    want = j_poisson_requests(3, 16, vocab=64, **kw)
    for a, b in zip(got, want):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        np.testing.assert_array_equal(da.pop("prompt"), db.pop("prompt"))
        assert da == db


def test_fold_in_wraps_empty_slot_id_like_reference():
    """An empty slot's id -1 folds in as 0xFFFFFFFF (as a Python int and
    inside a per-row tensor), as in the reference."""
    with _legacy():
        k = jax.random.PRNGKey(5)
        want = np.asarray(jax.random.fold_in(k, jnp.int32(-1)))
        want_rows = np.asarray(jax.vmap(lambda r: jax.random.fold_in(k, r))(
            jnp.asarray([3, -1, 0], jnp.int32)))
    np.testing.assert_array_equal(trng.fold_in(_tk(k), -1).numpy(), want.astype(np.int64))
    rows = trng.fold_in(_tk(k), torch.tensor([3, -1, 0], dtype=torch.int32))
    np.testing.assert_array_equal(rows.numpy(), want_rows.astype(np.int64))


# ---------------------------------------------------------------- prefill
def _prompt(plen, vocab=64):
    return np.asarray([(7 * i) % vocab for i in range(plen)], np.int32)


def test_prefill_chunk_matches_reference(digital):
    jcfg, tcfg, jparams, tparams = digital
    plen, c, slot = 37, 16, 1
    padded = np.zeros((1, 48), np.int32)
    padded[0, :plen] = _prompt(plen)
    jc = j_init_cache(jcfg, 3, 64)
    tc = init_cache(tcfg, 3, 64, device="cpu")
    for start in (0, 16, 32):
        final = start == 32
        toks = padded[:, start:start + c]
        kw = dict(true_len=plen if final else None, park_pos=64 if start == 0 else None)
        jlast, jc = j_prefill_chunk(
            jparams, jc, jnp.asarray(toks), jcfg, start=start, slot=jnp.int32(slot),
            true_len=None if not final else jnp.asarray([plen], jnp.int32),
            park_pos=kw["park_pos"])
        tlast, tc = prefill_chunk(tparams, tc, torch.from_numpy(toks), tcfg,
                                  start=start, slot=slot, **kw)
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        for name in ("k", "v"):
            np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                       rtol=RTOL, atol=ATOL)
        assert (tlast is None) == (jlast is None)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), rtol=RTOL, atol=ATOL)
    assert int(tc["pos"][slot]) == plen - 1
    with pytest.raises(ValueError, match="align"):
        prefill_chunk(tparams, tc, torch.zeros((1, 8), dtype=torch.int32), tcfg,
                      start=0, slot=0)


def test_chunked_and_padded_prefill_match_whole(digital):
    """The port's own contracts: chunked prefill against whole-bucket
    prefill (cache over the real positions, restored pos, first token),
    right-padded against unpadded prefill (logits, cache), and the chunk
    step built by `make_prefill_chunk_step`."""
    _, tcfg, _, tparams = digital
    plen = 37
    prompt = _prompt(plen)
    padded = np.zeros((1, 64), np.int32)
    padded[0, :plen] = prompt
    wlast, wcache = prefill(tparams, {"tokens": torch.from_numpy(padded)}, tcfg,
                            max_len=64, true_len=torch.tensor([plen], dtype=torch.int32))
    cache = init_cache(tcfg, 2, 64, device="cpu")
    for start in (0, 16, 32):
        step = make_prefill_chunk_step(tcfg, start=start, final=start == 32, park_pos=64)
        last, cache = step(tparams, cache, torch.from_numpy(padded[:, start:start + 16]),
                           plen, 1)
        if start == 0:
            assert int(cache["pos"][1]) == 64      # parked: decode writes drop
    assert int(cache["pos"][1]) == plen - 1
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name][:, 1, :plen].numpy(),
                                   wcache[name][:, 0, :plen].numpy(),
                                   rtol=SELF_RTOL, atol=SELF_ATOL)
    np.testing.assert_allclose(last.numpy(), wlast.numpy(), rtol=SELF_RTOL, atol=SELF_ATOL)
    assert int(last.argmax()) == int(wlast.argmax())

    short = torch.from_numpy(np.asarray([[5, 9, 2, 40, 17]], np.int32))
    ulast, ucache = prefill(tparams, {"tokens": short}, tcfg, max_len=64)
    pad8 = torch.zeros((1, 8), dtype=torch.int32)
    pad8[:, :5] = short
    plast, pcache = prefill(tparams, {"tokens": pad8}, tcfg, max_len=64,
                            true_len=torch.tensor([5], dtype=torch.int32))
    np.testing.assert_allclose(plast.numpy(), ulast.numpy(), rtol=SELF_RTOL, atol=SELF_ATOL)
    assert pcache["pos"].tolist() == [4]
    np.testing.assert_allclose(pcache["k"][:, :, :5].numpy(), ucache["k"][:, :, :5].numpy(),
                               rtol=SELF_RTOL, atol=SELF_ATOL)


# ------------------------------------------------------------- scheduling
def _run_pair(jcfg, tcfg, jengine, tengine, reqs, warm_range, *, jkw=None, tkw=None,
              **kw):
    """The same stream through the JAX and the port scheduler."""
    with _legacy():
        js = _JRecording(jengine, key=jax.random.PRNGKey(5), **kw, **(jkw or {}))
        js.warmup(prompt_range=warm_range)
        jwarm = dict(js.trace_counts)
        want = js.run(_jreqs(reqs))
        jax.effects_barrier()
    ts = ContinuousScheduler(tengine, key=_tk(jax.random.PRNGKey(5)), device="cpu",
                             **kw, **(tkw or {}))
    ts.warmup(prompt_range=warm_range)
    twarm = dict(ts.trace_counts)
    got = ts.run(reqs)
    assert twarm == jwarm and ts.trace_counts == js.trace_counts == jwarm
    assert ts.host_syncs == ts.decode_steps == js.decode_steps
    assert ts.admit_syncs == js.admit_syncs
    assert ts.prefill_tokens == js.prefill_tokens
    _same_records(got, want)
    return js, ts, got, want


@pytest.mark.parametrize("temperature,chunked", [(0.0, False), (0.7, False), (0.7, True)],
                         ids=["greedy", "sampled", "sampled-chunked-edf"])
def test_digital_scheduler_matches_reference(digital, temperature, chunked):
    jcfg, tcfg, jparams, tparams = digital
    kw = dict(n_slots=3, max_len=64)
    if chunked:
        kw.update(prefill_chunk_tokens=16, admission_policy="edf",
                  prefill_tokens_per_step=16.0)
        reqs = poisson_requests(3, 10, rate=0.8, vocab=64, prompt_lens=(3, 40),
                                max_new=(3, 6), ttft_slack=(2.0, 12.0))
        warm = (3, 40)
    else:
        reqs = poisson_requests(0, 12, rate=0.5, vocab=64, prompt_lens=(3, 20),
                                max_new=(3, 8))
        warm = (3, 20)
    js, ts, got, want = _run_pair(
        jcfg, tcfg, JServeEngine(jcfg, jparams, temperature=temperature),
        ServeEngine(tcfg, tparams, temperature=temperature), reqs, warm, **kw)
    if chunked:
        assert max(r.n_chunks for r in got) >= 2
        assert ts.latency_stats()["deadline_requests"] == 10.0
    tol = 2 * DIGITAL_ATOL / (temperature or 1.0)
    _assert_tokens_follow({r.rid: r.tokens for r in got}, {r.rid: r.tokens for r in want},
                          js.margins, tol)
    stats, jstats = ts.latency_stats(), js.latency_stats()
    for k in ("completed", "decode_steps", "tokens_generated", "p50_latency_steps",
              "p99_latency_steps", "p50_ttft_steps", "p99_ttft_steps",
              "mean_queue_delay_steps"):
        assert stats[k] == jstats[k], k
    dig = ts.digest_stats()
    assert dig["serve.batch_occupancy"]["count"] == ts.decode_steps
    assert dig["serve.latency_steps"]["count"] == len(got)


def test_analog_scheduler_with_scrub_matches_reference(deployed):
    """Analog serving through the executor with a VERIFY_TRIGGERED scrub
    every 4 decode steps (two leaves, one hour per epoch), greedy."""
    jcfg, tcfg, jmodel = deployed
    jm = dataclasses.replace(jmodel, arrays=dict(jmodel.arrays))
    tm = _carry(jmodel)
    reqs = poisson_requests(2, 8, rate=0.6, vocab=64, prompt_lens=(3, 20),
                            max_new=(3, 9))
    with _legacy():
        jex = JCIMExecutor(jm, JCIMConfig(**NOISY), jax.random.PRNGKey(7))
        jsim = JLifetimeSimulator(jax.random.PRNGKey(3), jm,
                                  refresh_cfg=JRefreshConfig(
                                      policy=JRefreshPolicy.VERIFY_TRIGGERED),
                                  traffic_fn=jex.drain_reads)
    tex = CIMExecutor(tm, CIMConfig(**NOISY), _tk(jax.random.PRNGKey(7)))
    tsim = LifetimeSimulator(_tk(jax.random.PRNGKey(3)), tm,
                             refresh_cfg=RefreshConfig(
                                 policy=RefreshPolicy.VERIFY_TRIGGERED),
                             traffic_fn=tex.drain_reads)
    jep, tep = [], []

    def jmaint():
        with _legacy():
            jep.append(jsim.step_epoch(3600.0, max_leaves=2))

    js, ts, got, want = _run_pair(
        jcfg, tcfg, JServeEngine(jcfg, executor=jex), ServeEngine(tcfg, executor=tex),
        reqs, (3, 20), n_slots=2, max_len=48, maintenance_every=4,
        jkw=dict(maintenance_fn=jmaint),
        tkw=dict(maintenance_fn=lambda: tep.append(tsim.step_epoch(3600.0, max_leaves=2))))
    assert tex.access == jex.access and tex.tokens_served == jex.tokens_served
    assert len(tep) == len(jep) == ts.decode_steps // 4 > 0
    for a, b in zip(tep, jep):
        assert (a.columns_flagged, a.columns_reprogrammed) == \
            (b.columns_flagged, b.columns_reprogrammed)
        assert a.reads_per_column == b.reads_per_column > 0
    assert sum(e.columns_reprogrammed for e in tep) > 0
    _assert_tokens_follow({r.rid: r.tokens for r in got}, {r.rid: r.tokens for r in want},
                          js.margins, 2 * ANALOG_ATOL)
    # tokens_served = decode_steps x n_slots + prefill_tokens (warmup aside)
    assert ts.prefill_tokens > 0


def test_spans_carry_kernel_launches(deployed, monkeypatch):
    """Each admission, decode step and maintenance call is an `obs` span
    whose ``launches`` arg holds the kernels launched inside it, and each
    scrub re-program dispatch is a ``lifetime.reprogram`` span with its
    column count padded to a power of two (capped at the leaf).  The
    wrappers count only on the card, so here they are wrapped to count
    as the CUDA route does."""
    from repro_torch import kernels
    from repro_torch.kernels.acim_vmm import ops as vmm_ops
    from repro_torch.kernels.fwht import ops as fwht_ops
    from repro_torch.kernels.wv_step import ops as wv_ops

    def counting(mod, fn_name, counter):
        fn = getattr(mod, fn_name)

        def wrapped(*a, **kw):
            setattr(mod, counter, getattr(mod, counter) + 1)
            return fn(*a, **kw)
        monkeypatch.setattr(mod, fn_name, wrapped)

    counting(vmm_ops, "acim_vmm_tiled", "launches")
    counting(fwht_ops, "fwht", "launches")
    counting(wv_ops, "wv_cell_update", "launches")
    _, tcfg, jmodel = deployed
    tm = _carry(jmodel)
    ex = CIMExecutor(tm, CIMConfig(**NOISY), _tk(jax.random.PRNGKey(7)))
    sim = LifetimeSimulator(_tk(jax.random.PRNGKey(3)), tm,
                            refresh_cfg=RefreshConfig(policy=RefreshPolicy.VERIFY_TRIGGERED),
                            traffic_fn=ex.drain_reads)
    epochs = []
    sched = ContinuousScheduler(
        ServeEngine(tcfg, executor=ex), n_slots=2, max_len=48,
        key=_tk(jax.random.PRNGKey(11)), maintenance_every=4, device="cpu",
        maintenance_fn=lambda: epochs.append(sim.step_epoch(3600.0, max_leaves=2)))
    sched.warmup(prompt_range=(3, 20))
    before = kernels.launch_counts()
    obs.trace.reset()
    sched.run(poisson_requests(2, 8, rate=0.6, vocab=64, prompt_lens=(3, 20),
                               max_new=(3, 9)))
    spans = {}
    for e in obs.trace.events():
        if e["ph"] == "X":
            spans.setdefault(e["name"], []).append(e["args"])
    dispatches = spans["serve.admit"] + spans["serve.decode"]
    # One forward: seven analog leaves per layer and the untied lm_head.
    per_forward = {"acim_vmm_tiled": 7 * tcfg.n_layers + 1}
    assert len(spans["serve.decode"]) == sched.decode_steps
    assert all(a["launches"] == per_forward for a in dispatches)
    maint = [a["launches"] for a in spans["serve.maintenance"]]
    assert len(maint) == len(epochs) > 0 and all(m["fwht"] > 0 for m in maint)
    assert "acim_vmm_tiled" not in set().union(*maint)
    reprog = spans["lifetime.reprogram"]
    assert sum(a["columns"] for a in reprog) == sum(r.columns_reprogrammed for r in epochs) > 0
    for a in reprog:
        p = a["padded"]
        assert a["columns"] <= p and (p & (p - 1) == 0 or p == a["columns"])
    assert sum(m.get("wv_step", 0) for m in maint) > 0
    assert kernels.launches_since(before) == {
        k: sum(a["launches"].get(k, 0) for a in dispatches) + sum(m.get(k, 0) for m in maint)
        for k in ("fwht", "wv_step", "acim_vmm_tiled")}


def test_alone_vs_full_batch_bitwise(digital):
    """A request's sampled tokens are bit-identical served alone and in a
    full batch (and so in another slot), with no step rebuilt."""
    _, tcfg, _, tparams = digital
    sched = ContinuousScheduler(ServeEngine(tcfg, tparams, temperature=0.7), n_slots=3,
                                max_len=64, key=_tk(jax.random.PRNGKey(5)), device="cpu")
    sched.warmup(prompt_range=(3, 16))
    reqs = poisson_requests(1, 9, rate=2.0, vocab=64, prompt_lens=(3, 16),
                            max_new=(4, 8))
    busy = {r.rid: r.tokens for r in sched.run(reqs)}
    for probe in (reqs[4], reqs[7]):
        sched.reset(keep_traces=True)
        assert sched.run([probe])[0].tokens == busy[probe.rid]
    assert sched.trace_counts["decode"] == 1


def test_analog_decode_row_independent_of_neighbours(deployed):
    """With request ids folded into the read noise, a request's analog
    decode logits are bitwise the same alone, beside other requests and
    beside empty slots (id -1), in any slot."""
    _, tcfg, jmodel = deployed
    ex = CIMExecutor(_carry(jmodel), CIMConfig(**NOISY), _tk(jax.random.PRNGKey(7)))
    params = ex.tick(1)
    prompt = torch.tensor([[5, 9, 2, 40, 17]], dtype=torch.int32)
    rid = torch.tensor([37], dtype=torch.int32)
    last, cache1 = prefill(params, {"tokens": prompt}, tcfg, max_len=48)
    cur = torch.argmax(last, -1).to(torch.int32)[:, None]
    with token_stream_ids(rid):
        la, _ = decode_step(params, cache1, {"tokens": cur}, tcfg)
    for slot, others in ((0, [3, 11]), (2, [-1, -1]), (1, [-1, 29])):
        cache_b = write_cache_slot(init_cache(tcfg, 3, 48, device="cpu"), cache1, slot)
        rids = torch.tensor(others[:slot] + [37] + others[slot:], dtype=torch.int32)
        cur_b = torch.full((3, 1), 7, dtype=torch.int32)
        cur_b[slot] = cur[0]
        with token_stream_ids(rids):
            lb, _ = decode_step(params, cache_b, {"tokens": cur_b}, tcfg)
        assert torch.equal(la[0], lb[slot]), slot


def test_eos_evict_refill_and_accounting(digital):
    _, tcfg, _, tparams = digital
    sched = ContinuousScheduler(ServeEngine(tcfg, tparams), n_slots=2, max_len=64,
                                device="cpu")
    sched.warmup(prompt_range=(4, 8))
    recs = sched.run([Request(rid=i, prompt=[1 + i] * 5, max_new=4) for i in range(5)])
    assert len(recs) == 5 and sched.admits == 5 and sched.tokens_generated == 20
    assert len([r for r in recs if r.queue_delay_steps > 0]) == 4
    full = recs[0]
    sched.reset(keep_traces=True)
    eos = full.tokens[1]
    stopped = sched.run([Request(rid=0, prompt=[1] * 5, max_new=4, eos_id=eos)])[0]
    assert stopped.tokens == full.tokens[:full.tokens.index(eos) + 1]
    assert sched.active_slots() == 0
    assert obs.registry.value("serve.decode_tokens") > 0


def test_rejects_what_it_does_not_serve(digital):
    _, tcfg, _, tparams = digital
    eng = ServeEngine(tcfg, tparams)
    for bad, match in (({"block": "rwkv6"}, "attention"),
                       ({"pos_embedding": "sinusoidal"}, "sinusoidal")):
        _, cfg = _cfgs(**bad)
        with pytest.raises(ValueError, match=match):
            ContinuousScheduler(ServeEngine(cfg, tparams), device="cpu")
    with pytest.raises(TypeError, match="batch_mesh must be a DeviceMesh"):
        ContinuousScheduler(eng, batch_mesh=object(), device="cpu")
    for kw, match in ((dict(prefill_chunk_tokens=12), "power of two"),
                      (dict(prefill_chunk_tokens=8), "attn_chunk_q"),
                      (dict(prefill_chunk_tokens=64, max_len=64), "nothing"),
                      (dict(min_prefill_bucket=6), "power of two"),
                      (dict(admission_policy="lifo"), "unknown")):
        with pytest.raises(ValueError, match=match):
            ContinuousScheduler(eng, device="cpu", **kw)
    sched = ContinuousScheduler(eng, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="exceeds max_len"):
        sched.admit(Request(rid=0, prompt=[1] * 10, max_new=8))
