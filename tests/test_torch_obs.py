"""Telemetry in the port (`repro_torch.obs`) against the JAX package's
`repro.obs`: streaming digests, the digest registry, `rank_quantile`,
the counter registry, per-tile reductions, and a port trace read by the
JAX package's stdlib `obs.report`.

Inputs are made with numpy from a seed and fed to both sides.

Tolerances: digest counts, under/over counts, min and max exactly
(integer counts, the same bucket index arithmetic in float32); the
running total within rtol 1e-6 (float32 sums in another order);
quantiles and summaries exactly (they are functions of the counts),
but for the mean (the total over the count), within rtol 1e-6;
`tile_reduce` within rtol 1e-6 (float32 segment sums).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.obs import report as jreport
from repro_torch import obs


def _values(seed, n, lo=-2.0, hi=12.0):
    return np.random.RandomState(seed).uniform(lo, hi, n).astype(np.float32)


def _same_digest(got, want, rtol_total=1e-6):
    np.testing.assert_array_equal(np.asarray(got.counts), np.asarray(want.counts))
    for f in ("vmin", "vmax", "n_under", "n_over"):
        assert float(np.asarray(getattr(got, f))) == float(np.asarray(getattr(want, f))), f
    np.testing.assert_allclose(float(np.asarray(got.total)),
                               float(np.asarray(want.total)), rtol=rtol_total)


def _same_summary(got, want):
    """Equal summaries; the mean (total / count) within rtol 1e-6."""
    np.testing.assert_allclose(got.pop("mean"), want.pop("mean"), rtol=1e-6)
    assert got == want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rank_quantile_matches_reference(seed):
    x = _values(seed, 37 + seed)
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert obs.rank_quantile(x, q) == jobs.rank_quantile(x, q)
    with pytest.raises(ValueError):
        obs.rank_quantile([], 0.5)


@pytest.mark.parametrize("seed", [0, 1])
def test_device_digest_add_matches_reference(seed):
    """`add` over several batches (values under and over the range)."""
    want = jobs.StreamingDigest.zeros(0.0, 10.0, 20)
    got = obs.StreamingDigest.zeros(0.0, 10.0, 20, device="cpu")
    for i in range(4):
        x = _values(seed * 10 + i, 50)
        want = want.add(jnp.asarray(x))
        got = got.add(torch.from_numpy(x))
    host = obs.StreamingDigest.from_tree(got.lo, got.hi, obs.metrics.fetch(got.as_tree()))
    _same_digest(host, want)
    _same_summary(host.summary(), jobs.digest._host_copy(want).summary())


def test_device_digest_add_weighted_matches_reference():
    x = _values(3, 200, 0.0, 9.0)
    w = (np.random.RandomState(4).rand(200) < 0.7).astype(np.float32)
    want = jobs.StreamingDigest.zeros(0.0, 8.0, 64).add_weighted(jnp.asarray(x), jnp.asarray(w))
    got = obs.StreamingDigest.zeros(0.0, 8.0, 64, device="cpu").add_weighted(
        torch.from_numpy(x), torch.from_numpy(w))
    _same_digest(obs.StreamingDigest.from_tree(0.0, 8.0, obs.metrics.fetch(got.as_tree())),
                 want)


def test_host_digest_observe_merge_quantile_match_reference():
    a, b = _values(5, 100), _values(6, 80)
    want_a = jobs.StreamingDigest.host(0.0, 10.0, 32)
    got_a = obs.StreamingDigest.host(0.0, 10.0, 32)
    want_b = jobs.StreamingDigest.host(0.0, 10.0, 32)
    got_b = obs.StreamingDigest.host(0.0, 10.0, 32)
    want_a.observe(a)
    got_a.observe(a)
    want_b.observe(b)
    got_b.observe(b)
    want, got = want_a.merge(want_b), got_a.merge(got_b)
    _same_digest(got, want)
    for q in (0.5, 0.95, 0.99):
        assert got.quantile(q) == want.quantile(q)
    assert got.summary() == want.summary()
    assert obs.StreamingDigest.host(0.0, 1.0, 4).summary() == \
        jobs.StreamingDigest.host(0.0, 1.0, 4).summary()  # empty: null stats
    # The digest estimates rank_quantile within one bucket width.
    allv = np.concatenate([a, b])
    inside = allv[(allv >= 0.0) & (allv < 10.0)]
    d = obs.StreamingDigest.host(0.0, 10.0, 32)
    d.observe(inside)
    assert abs(d.quantile(0.5) - obs.rank_quantile(inside, 0.5)) <= d.width


def test_digest_registry_matches_reference():
    jreg, treg = jobs.digest.DigestRegistry(), obs.digest.DigestRegistry()
    for i, x in enumerate((_values(7, 30), _values(8, 12))):
        jreg.observe("serve.ttft_steps", x, lo=0.0, hi=64.0, n_buckets=16)
        treg.observe("serve.ttft_steps", x, lo=0.0, hi=64.0, n_buckets=16)
    x = _values(9, 40)
    jdev = jobs.StreamingDigest.zeros(0.0, 5.0, 6).add(jnp.asarray(x))
    tdev = obs.StreamingDigest.zeros(0.0, 5.0, 6, device="cpu").add(torch.from_numpy(x))
    th = obs.StreamingDigest.from_tree(0.0, 5.0, obs.metrics.fetch(tdev.as_tree()))
    jh = jobs.digest._host_copy(jdev)
    jreg.put("serve.batch_occupancy", jh)
    treg.put("serve.batch_occupancy", th)
    jreg.fold("lifetime.drift_lsb", jh)
    treg.fold("lifetime.drift_lsb", th)
    jreg.fold("lifetime.drift_lsb", jh)
    treg.fold("lifetime.drift_lsb", th)
    assert treg.names() == jreg.names()
    got, want = treg.snapshot(), jreg.snapshot()
    for name in want:
        _same_summary(got[name], want[name])
    assert treg.get("nope") is None and jreg.get("nope") is None
    treg.reset("serve.")
    jreg.reset("serve.")
    assert treg.names() == jreg.names() == ("lifetime.drift_lsb",)
    treg.reset()
    assert treg.names() == ()


def test_metric_registry_fold_snapshot():
    reg = obs.metrics.MetricRegistry()
    jreg = jobs.metrics.MetricRegistry()
    vals = {"decode_active_slots": np.float32(3.0), "decode_greedy_agree": 2}
    for r in (reg, jreg):
        r.fold(vals, prefix="serve.")
        r.fold(vals, prefix="serve.")
        r.inc("lifetime.scrub_epochs")
    assert reg.snapshot() == jreg.snapshot()


def test_tile_reduce_matches_reference():
    rs = np.random.RandomState(10)
    v = rs.rand(300).astype(np.float32)
    inv = rs.randint(0, 7, 300)
    want = np.asarray(jobs.health.tile_reduce(jnp.asarray(v), inv, 7))
    got = obs.health.tile_reduce(torch.from_numpy(v), inv, 7).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_health_registry_matches_reference():
    jh, th = jobs.health.HealthRegistry(), obs.health.HealthRegistry()
    for mode in ("sum", "max", "last"):
        for r in (jh, th):
            r.fold_tiles(f"m.{mode}", [3, 1, 3], [1.0, 2.0, 4.0], mode=mode)
            r.fold_tiles(f"m.{mode}", [1], [0.5], mode=mode)
    for r in (jh, th):
        r.set_gauge("lifetime.refresh_debt_epochs", 3)
    assert th.snapshot() == jh.snapshot()
    assert th.worst("m.sum", 1) == jh.worst("m.sum", 1)
    assert th.tiles("m.max") == jh.tiles("m.max")
    assert th.gauge("lifetime.refresh_debt_epochs") == 3.0
    with pytest.raises(ValueError):
        th.fold_tiles("m.bad", [0], [1.0], mode="avg")
    th.reset("m.")
    assert th.snapshot()["tiles"] == {}


def test_port_trace_reads_in_reference_report(tmp_path):
    """Spans, ledger charges, digests and counters of the port export to
    a trace that the JAX package's `obs.report` loads and summarizes."""
    obs.reset_all()
    with obs.span("serve.decode", cat="serve", step=0) as sp:
        sp["tokens"] = 4
    with obs.span("lifetime.scrub", cat="lifetime", epoch=0):
        obs.charge("lifetime.scrub", energy_pj=12.5, latency_ns=3.0, epoch=0)
    obs.trace.counter("serve.occupancy", active=3)
    obs.digests.observe("serve.ttft_steps", [1.0, 2.0, 5.0], lo=0.0, hi=16.0,
                        n_buckets=8)
    obs.digests.emit()
    path = obs.trace.export(tmp_path / "TRACE_port.json")
    doc = jreport.load(path)
    rows = {r["phase"]: r for r in jreport.summarize(doc)}
    assert rows["serve.decode"]["count"] == 1
    assert rows["lifetime.scrub"]["energy_pj"] == 12.5
    dig = {r["digest"]: r for r in jreport.digest_rows(doc)}
    assert dig["serve.ttft_steps"]["count"] == 3
    assert "serve.decode" in jreport.render(jreport.summarize(doc))
    events = json.loads(open(path).read())["traceEvents"]
    assert {e["ph"] for e in events} >= {"X", "i", "C"}
    assert obs.ledger.summary()["lifetime.scrub"]["n_charges"] == 1
    obs.reset_all()
    assert obs.trace.events() == [] and obs.ledger.summary() == {}
