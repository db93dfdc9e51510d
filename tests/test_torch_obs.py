"""Telemetry in the port (`repro_torch.obs`) against the JAX package's
`repro.obs`: streaming digests, the digest registry, `rank_quantile`,
the counter registry, per-tile reductions, a port trace read by the
JAX package's stdlib `obs.report`, the deploy's per-tile health,
digests, counters and ledger rows, the SLO rules and `fleet_status`,
and the port's own `obs.report` / `obs.dashboard`.

Inputs are made with numpy from a seed and fed to both sides.

Tolerances: digest counts, under/over counts, min and max exactly
(integer counts, the same bucket index arithmetic in float32); the
running total within rtol 1e-6 (float32 sums in another order);
quantiles and summaries exactly (they are functions of the counts),
but for the mean (the total over the count), within rtol 1e-6;
`tile_reduce` within rtol 1e-6 (float32 segment sums), and so its
fixed-order form (the card's, `tile_reduce_fixed`), which is also
bitwise equal to itself across calls;
`tile_deploy_stats` on carried stats: tile ids and integer-valued sums
exact, err2_sum within rtol 1e-6; a port deploy's counters and ledger
rows equal to its own report, its tile maps' sums within rtol 1e-6 of
it; against the JAX deploy of the same tiny model and key: the same
tile ids, each map's total within 0.1% (ROADMAP.md P2, as
`tests/test_torch_faults.py` holds gave-up totals); SLO results,
`resolve_metric`, `fleet_status` and `HealthRegistry.emit` equal; the
renderers' output byte for byte.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.obs import report as jreport
from repro_torch import obs


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads for the module, restored after it: the suite
    runs files side by side in worker processes, and this module's CPU
    deploys stall the others' with a thread per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


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


@pytest.mark.parametrize("layout", ["contiguous", "scattered"])
def test_tile_reduce_fixed_order_matches_reference_and_repeats(layout):
    """The card's fixed-order tile sums (no atomics: the same inputs give
    the same bits) against the reference's `segment_sum`, on the column
    -> tile index of a contiguous deploy (ascending runs, tiles of up to
    64 columns) and on a scattered one (fault-aware placement)."""
    rs = np.random.RandomState(11)
    v = (rs.rand(5000) * 100).astype(np.float32)
    if layout == "contiguous":
        inv = np.repeat(np.arange(79), 64)[:5000]
    else:
        inv = rs.randint(0, 79, 5000)
    width = int(np.bincount(inv).max())
    want = np.asarray(jobs.health.tile_reduce(jnp.asarray(v), inv, 79))
    idx = torch.from_numpy(inv.astype(np.int64))
    got = obs.health.tile_reduce_fixed(torch.from_numpy(v), idx, 79, width)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    again = obs.health.tile_reduce_fixed(torch.from_numpy(v), idx, 79, width)
    assert torch.equal(got, again)


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


# ----------------------------------------------------- deploy telemetry
class _Stats:
    """`WVStats`-shaped stand-in: the fields `tile_deploy_stats` reads."""

    def __init__(self, **fields):
        self.__dict__.update(fields)


_STAT_FIELDS = ("gave_up", "retry_pulses", "write_pulses", "reads", "rms_error_lsb")


def _carried_stats(seed, sizes):
    rs = np.random.RandomState(seed)
    out = []
    for c in sizes:
        out.append(dict(
            gave_up=rs.randint(0, 3, c).astype(np.float32),
            retry_pulses=rs.randint(0, 40, c).astype(np.float32),
            write_pulses=rs.randint(0, 300, c).astype(np.float32),
            reads=rs.randint(100, 900, c).astype(np.float32),
            rms_error_lsb=rs.rand(c).astype(np.float32),
        ))
    return out


@pytest.mark.parametrize("layout", ["contiguous", "placed"])
def test_tile_deploy_stats_matches_reference(layout):
    """Carried per-column stats and uids through both packages: tile ids
    and column counts exact, integer-valued sums exact, err2_sum within
    rtol 1e-6.  "contiguous": each leaf one run of uids (the port groups
    those without a host sort), leaves meeting inside a tile; "placed":
    one leaf on shuffled, non-contiguous uids (fault-aware placement)."""
    sizes = (37, 64, 5)
    stats = _carried_stats(11, sizes)
    names = [f"['layers']['w{i}']" for i in range(len(sizes))]
    base = np.cumsum((0,) + sizes)
    uids = [b + np.arange(c, dtype=np.int64) for b, c in zip(base, sizes)]
    if layout == "placed":
        uids[1] = np.random.RandomState(3).permutation(400)[:sizes[1]].astype(np.int64) + 200
    flags = {n: (np.random.RandomState(i).rand(c) < 0.3).astype(np.float32)
             for i, (n, c) in enumerate(zip(names, sizes))}
    jmap = {n: _Stats(**{f: jnp.asarray(s[f]) for f in _STAT_FIELDS}) for n, s in zip(names, stats)}
    tmap = {n: _Stats(**{f: torch.from_numpy(s[f]) for f in _STAT_FIELDS})
            for n, s in zip(names, stats)}
    umap = dict(zip(names, uids))
    jids, jtree = jobs.health.tile_deploy_stats(
        jmap, umap, 16, extra_columns={"remapped_columns": {n: jnp.asarray(v)
                                                            for n, v in flags.items()}})
    tids, ttree = obs.health.tile_deploy_stats(
        tmap, umap, 16, extra_columns={"remapped_columns": {n: torch.from_numpy(v)
                                                            for n, v in flags.items()}})
    np.testing.assert_array_equal(tids, jids)
    assert sorted(ttree) == sorted(jtree)
    np.testing.assert_array_equal(ttree["columns"], jtree["columns"])
    for m in ("gave_up_cells", "retry_pulses", "write_pulses", "verify_reads",
              "remapped_columns"):
        np.testing.assert_array_equal(ttree[m].numpy(), np.asarray(jtree[m]), err_msg=m)
    np.testing.assert_allclose(ttree["err2_sum"].numpy(), np.asarray(jtree["err2_sum"]),
                               rtol=1e-6)
    empty_ids, empty = obs.health.tile_deploy_stats({}, umap, 16)
    assert empty_ids.shape == (0,) and empty == {}


def _tiny_port_deploy(fault: bool):
    from repro_torch.core import FaultConfig, WVConfig, WVMethod, rng
    from repro_torch.core.programmer import deploy_arrays
    from repro_torch.core.remap import RemapConfig
    from repro_torch.models import ModelConfig, init_params

    cfg = ModelConfig(name="obs-test", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                      head_dim=16, d_ff=64, vocab_size=32, dtype=torch.float32,
                      attn_chunk_q=16, attn_chunk_kv=16, remat=False)
    params = init_params(0, cfg, device="cpu")
    wv = WVConfig(method=WVMethod.HARP, max_fine_iters=6, max_coarse_iters=4,
                  give_up_pulses=8 if fault else None)
    kw = {}
    if fault:
        kw = dict(fault_cfg=FaultConfig(p_stuck_hrs=0.02, p_stuck_lrs=0.01, p_weak=0.02,
                                        columns_per_tile=32, tiles_per_chip=8),
                  remap_cfg=RemapConfig(spare_frac=0.25, placement=True))
    return deploy_arrays(rng.PRNGKey(1, device="cpu"), params, wv, device="cpu", **kw)


@pytest.mark.parametrize("fault", [False, True], ids=["plain", "faulty-remap-placed"])
def test_port_deploy_folds_its_report(fault):
    """A port deploy's ``deploy.*`` counters, ledger rows, per-tile maps
    and digests agree with its own `DeployReport` (one host sync)."""
    from repro_torch.core import pipeline

    obs.reset_all()
    pipeline.reset_counters()
    with torch.random.fork_rng():
        model, rep = _tiny_port_deploy(fault)
    assert pipeline.host_sync_count() == 1
    counters = obs.registry.snapshot()
    for name, want in (("columns", rep.num_columns), ("verify_reads", rep.total_reads),
                       ("write_pulses", rep.total_write_pulses),
                       ("gave_up_cells", rep.total_gave_up_cells),
                       ("retry_pulses", rep.total_retry_pulses),
                       ("remapped_columns", rep.remapped_columns)):
        assert counters[f"deploy.{name}"] == float(want), name
    ledger = obs.ledger.summary()
    assert ledger["deploy"]["energy_pj"] == float(rep.total_energy_pj)
    assert ledger["deploy"]["latency_ns"] == float(rep.critical_latency_ns)
    assert ledger["deploy"]["reads"] == float(rep.total_reads)
    assert ("deploy.give_up" in ledger) == bool(rep.total_gave_up_cells or rep.remapped_columns)
    if fault:
        assert rep.total_gave_up_cells > 0 and rep.remapped_columns > 0
        assert ledger["deploy.give_up"]["n_charges"] == 1
    hr = obs.health_registry
    phys = sum(int(st.g.shape[0]) for st in model.arrays.values())
    assert sum(hr.tiles("deploy.columns").values()) == phys == rep.num_columns
    for metric, want in (("gave_up_cells", rep.total_gave_up_cells),
                         ("write_pulses", rep.total_write_pulses),
                         ("verify_reads", rep.total_reads)):
        np.testing.assert_allclose(sum(hr.tiles(f"deploy.{metric}").values()), want,
                                   rtol=1e-6)
    if fault:
        assert sum(hr.tiles("deploy.remapped_columns").values()) == rep.remapped_columns
        tiles = {int(u) // 32 for st in model.arrays.values() for u in st.uids}
        assert set(hr.tiles("deploy.columns")) == tiles
    for name in ("deploy.write_pulses_per_column", "deploy.iterations_per_column"):
        assert obs.digests.get(name).count == rep.num_columns
    spans = [e["name"] for e in obs.trace.events() if e["ph"] == "X"]
    assert "deploy" in spans and "deploy.program_columns" in spans
    assert obs.digests.get("pipeline.bucket_columns").count >= 1
    obs.reset_all()


# One bucket of 4096 columns for the tiny model's 2944: one compiled
# dispatch on the reference's side.
ONE_BUCKET = dict(min_bucket=4096, max_bucket=4096)


def test_deploy_health_matches_reference_deploy():
    """The JAX deploy and the port's of the same tiny model (carried
    params) and key: the same tile ids in every ``deploy.*`` map, each
    map's total within 0.1% (ROADMAP.md P2: a few cells take another
    trajectory), and equal column counts and digest counts."""
    from repro.core import WVConfig as JWVConfig, WVMethod as JWVMethod
    from repro.core.programmer import deploy_arrays as j_deploy_arrays
    from repro.models import init_params as j_init_params
    from repro_torch.convert import key_from_numpy, params_from_numpy
    from repro_torch.core import WVConfig, WVMethod
    from repro_torch.core.programmer import deploy_arrays

    from test_torch_cim import tiny_cfgs

    jcfg, _ = tiny_cfgs()
    jobs.reset_all()
    with jax.threefry_partitionable(False):
        params = j_init_params(jax.random.PRNGKey(0), jcfg)
        key = jax.random.PRNGKey(1)
        j_deploy_arrays(key, params, JWVConfig(method=JWVMethod.HARP, max_fine_iters=6,
                                               max_coarse_iters=4), **ONE_BUCKET)
    obs.reset_all()
    deploy_arrays(key_from_numpy(np.asarray(key), device="cpu"),
                  params_from_numpy(jax.tree.map(np.asarray, params), device="cpu"),
                  WVConfig(method=WVMethod.HARP, max_fine_iters=6, max_coarse_iters=4),
                  device="cpu", **ONE_BUCKET)
    want = jobs.health_registry.snapshot()["tiles"]
    got = obs.health_registry.snapshot()["tiles"]
    assert sorted(got) == sorted(want) and want
    for metric in want:
        assert sorted(got[metric]) == sorted(want[metric]), metric
        w, g = sum(want[metric].values()), sum(got[metric].values())
        assert abs(g - w) <= 1e-3 * max(abs(w), 1.0), (metric, g, w)
    assert got["deploy.columns"] == want["deploy.columns"]
    for name in ("deploy.write_pulses_per_column", "deploy.iterations_per_column"):
        assert obs.digests.get(name).count == jobs.digests.get(name).count
    for name in ("deploy.columns", "deploy.verify_reads"):
        assert obs.registry.value(name) == jobs.registry.value(name)
    jobs.reset_all()
    obs.reset_all()


# ------------------------------------------------------------------ SLOs
def _status():
    return {
        "digests": {"serve.latency_steps": {"p99": 40.5, "count": 12.0},
                    "serve.ttft_steps": {"p99": None}},
        "health": {"gauges": {"lifetime.refresh_debt_epochs": 3.0},
                   "tiles": {"deploy.gave_up_cells": {"0": 2.0}}},
        "counters": {"deploy.gave_up_cells": 17.0, "deploy": 1.0},
        "flat.key": 5,
    }


def test_slo_policy_and_fleet_status_match_reference():
    status = _status()
    for path in ("digests.serve.latency_steps.p99", "counters.deploy.gave_up_cells",
                 "counters.deploy", "health.gauges.lifetime.refresh_debt_epochs",
                 "health.tiles.deploy.gave_up_cells.0", "flat.key", "digests.nope.p99",
                 "digests.serve.ttft_steps.p99", "", "counters.deploy.gave_up_cells.x"):
        assert obs.health.resolve_metric(status, path) == \
            jobs.health.resolve_metric(status, path), path
    rules = (("p99_latency", "digests.serve.latency_steps.p99", 32.0),
             ("give_up", "counters.deploy.gave_up_cells", 100.0),
             ("ttft", "digests.serve.ttft_steps.p99", 1.0),
             ("missing", "digests.nope.p99", 0.0))
    policy = obs.SLOPolicy(tuple(obs.SLORule(*r) for r in rules))
    jpolicy = jobs.SLOPolicy(tuple(jobs.SLORule(*r) for r in rules))
    obs.reset_all()
    jobs.reset_all()
    got = policy.evaluate(status, replica=2)
    want = jpolicy.evaluate(status, replica=2)
    assert got == want and [r["breached"] for r in got] == [True, False, False, False]
    assert obs.registry.snapshot() == jobs.registry.snapshot()
    breach = [e for e in obs.trace.events() if e["cat"] == "slo"]
    jbreach = [e for e in jobs.trace.events() if e["cat"] == "slo"]
    assert [(e["name"], e["args"]) for e in breach] == [(e["name"], e["args"]) for e in jbreach]
    # fleet_status joins the same namespaces from the same host values.
    for o in (obs, jobs):
        o.digests.observe("serve.latency_steps", [3.0, 9.0, 30.0], lo=0.0, hi=64.0,
                          n_buckets=16)
        o.health_registry.fold_tiles("deploy.err2_sum", [4, 9], [0.5, 1.5])
        o.health_registry.set_gauge("cim.tokens_served", 96)
        o.registry.inc("deploy.columns", 4864)
    assert obs.fleet_status({"phase": "x"}) == jobs.fleet_status({"phase": "x"})
    obs.reset_all()
    jobs.reset_all()


def test_health_emit_matches_reference():
    obs.reset_all()
    jobs.reset_all()
    for o in (obs, jobs):
        o.health_registry.fold_tiles("deploy.err2_sum", [4, 9, 2], [0.5, 1.5, 0.25])
        o.health_registry.fold_tiles("lifetime.drift_rms_lsb", [], [])
        o.health_registry.set_gauge("cim.read_disturb_reads", 640)
        o.health_registry.emit()
    strip = lambda evs: [(e["name"], e["cat"], e["ph"], e["args"]) for e in evs]  # noqa: E731
    assert strip(obs.trace.events()) == strip(jobs.trace.events())
    obs.reset_all()
    jobs.reset_all()


def _port_trace(path):
    """A port trace with every event kind the report and dashboard read."""
    obs.reset_all()
    with obs.span("deploy", cat="deploy", method="harp") as sp:
        sp["columns"] = 4864
    obs.charge("deploy", energy_pj=3.1e7, latency_ns=142510.0, reads=3.4e6)
    for i in range(3):
        with obs.span("serve.decode", cat="serve", step=i):
            obs.charge("serve.analog", tokens=4, energy_pj=1.3e6, latency_ns=3280.0,
                       reads=280.0)
    obs.digests.observe("serve.latency_steps", [40.0, 60.0, 82.0], lo=0.0, hi=576.0,
                        n_buckets=128)
    obs.digests.ensure("serve.ttft_steps", 0.0, 64.0, 8)
    obs.health_registry.fold_tiles("deploy.err2_sum", [31, 8, 37], [6.66, 6.15, 6.12])
    obs.health_registry.set_gauge("cim.tokens_served", 952)
    obs.SLOPolicy((obs.SLORule("p99", "digests.serve.latency_steps.p99", 72.0),)).evaluate(
        obs.fleet_status())
    obs.health_registry.emit()
    obs.digests.emit()
    status = obs.fleet_status()
    obs.trace.export(path)
    obs.reset_all()
    return status


def test_report_and_dashboard_render_like_reference(tmp_path, capsys):
    """The port's `obs.report` and `obs.dashboard` render a port trace
    byte for byte as the reference's do (text and HTML)."""
    from repro.obs import dashboard as jdashboard
    from repro_torch.obs import dashboard, report

    trace_path = tmp_path / "TRACE_port.json"
    status = _port_trace(trace_path)
    fleet = tmp_path / "fleet_status.json"
    fleet.write_text(json.dumps(status))
    for port_main, ref_main, argv in (
            (report.main, jreport.main, [str(trace_path)]),
            (dashboard.main, jdashboard.main,
             [str(trace_path), "--fleet", str(fleet), "--format", "text"]),
            (dashboard.main, jdashboard.main,
             [str(trace_path), "--fleet", str(fleet), "--format", "html"])):
        assert port_main(argv) == 0
        got = capsys.readouterr().out
        assert ref_main(argv) == 0
        want = capsys.readouterr().out
        assert got == want and len(got) > 200
    out = capsys.readouterr()
    assert report.main([str(tmp_path / "missing.json")]) == 1
    assert dashboard.main([str(tmp_path / "missing.json")]) == 1
    assert "error" in capsys.readouterr().err and out.out == ""


def test_disabled_silences_spans_and_ledger_as_the_reference():
    """`obs.disabled()`: no span, instant, counter event or ledger charge
    is kept inside it, in either package; the counter registry still
    counts; `trace.is_enabled` says which, and the flag is restored."""
    got = {}
    for name, pkg in (("jax", jobs), ("port", obs)):
        pkg.reset_all()
        with pkg.trace.span("phase.a"):
            pass
        with pkg.disabled():
            assert not pkg.trace.is_enabled()
            with pkg.trace.span("phase.hidden") as args:
                args["x"] = 1
            pkg.trace.instant("hidden")
            pkg.ledger.charge("hidden", energy_pj=1.0)
            pkg.metrics.inc("still.counted")
        assert pkg.trace.is_enabled()
        got[name] = ([e["name"] for e in pkg.trace.events()], pkg.ledger.summary(),
                     pkg.metrics.value("still.counted"))
        pkg.reset_all()
    assert got["port"] == got["jax"] == (["phase.a"], {}, 1.0)
    assert obs.ledger.FIELDS == jobs.ledger.FIELDS


def test_ledger_total_matches_the_reference():
    """`EnergyLedger.total(field)`: each field summed over the phases, as
    the reference sums it, on the same charges."""
    got = {}
    for name, pkg in (("jax", jobs), ("port", obs)):
        pkg.reset_all()
        pkg.ledger.charge("deploy", energy_pj=2.5, latency_ns=10.0, reads=3.0)
        pkg.ledger.charge("serve.analog", energy_pj=0.25, tokens=4.0, reads=8.0)
        pkg.ledger.charge("deploy", energy_pj=1.0, latency_ns=5.0)
        led = pkg.ledger.ledger
        got[name] = [led.total()] + [led.total(f) for f in pkg.ledger.FIELDS]
        pkg.reset_all()
        assert led.total() == 0.0
    assert got["port"] == got["jax"]
    assert got["port"][0] == 3.75


def test_metric_accumulator_matches_the_reference():
    a = obs.MetricAccumulator.zeros(["tokens", "reads"], device="cpu")
    b = a.inc("tokens", 2.0).inc("reads", torch.tensor(3.5))
    ja = jobs.MetricAccumulator.zeros(["tokens", "reads"])
    jb = ja.inc("tokens", 2.0).inc("reads", jnp.asarray(3.5))
    assert a["tokens"].item() == 0.0            # inc returns a new accumulator
    assert b.names == jb.names == ("reads", "tokens")
    merged, jmerged = b.merge(b), jb.merge(jb)
    assert ({k: v.item() for k, v in merged.as_dict().items()}
            == {k: float(v) for k, v in jmerged.as_dict().items()})
    assert merged["reads"].dtype == torch.float32
    with pytest.raises(ValueError):
        b.merge(obs.MetricAccumulator.zeros(["tokens"], device="cpu"))
