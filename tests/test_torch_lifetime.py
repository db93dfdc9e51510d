"""The lifetime scrub in the port (`repro_torch.lifetime`: drift, refresh,
service) against the JAX package's `repro.lifetime`, on the same carried
deployment and the same aging state.

A tiny JAX HARP deployment (the CIM tests' config) is carried across with
its column uids; a JAX `CellState` is carried with
`convert.cell_state_from_numpy`, so both sides start from one state.  Every
JAX call runs inside a scoped ``jax.threefry_partitionable(False)`` block.

Tolerances:
* `init_cell_state`, `advance`: g, g_eq and the other float fields within
  atol 1e-5 (LSB; XLA's exp / pow differ from PyTorch's by ulps), nu and
  the endurance limit within rtol 1e-5, the boolean and counter fields
  exactly;
* `flag_columns` (all four methods) and `apply_refresh` (PERIODIC and
  VERIFY_TRIGGERED): flag masks and re-programmed counts exactly; the
  re-programmed g within atol 1e-5 for HARP, and for MRA on at least 90%
  of cells (ROADMAP.md C1: the reference's compiled MRA loop contracts a
  multiply-add, and an ulp there picks another pulse count); modeled
  energies and latencies within rtol 1e-4;
* `LifetimeSimulator.step_epoch`: flagged and re-programmed counts,
  stuck share and refresh debt exactly; drift RMS, energies and the
  per-tile drift map within rtol 1e-4; the drift digest's counts exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import WVConfig as JWVConfig, WVMethod as JWVMethod
from repro.core.programmer import deploy_arrays as j_deploy_arrays
from repro.lifetime import DriftConfig as JDriftConfig
from repro.lifetime import LifetimeSimulator as JLifetimeSimulator
from repro.lifetime import RefreshConfig as JRefreshConfig
from repro.lifetime import RefreshPolicy as JRefreshPolicy
from repro.lifetime import advance as j_advance
from repro.lifetime import apply_refresh as j_apply_refresh
from repro.lifetime import flag_columns as j_flag_columns
from repro.lifetime import init_cell_state as j_init_cell_state
from repro.models import init_params as j_init_params
from repro import obs as jobs
from repro_torch import obs
from repro_torch.convert import cell_state_from_numpy, key_from_numpy
from repro_torch.core import CircuitCost, WVConfig, WVMethod
from repro_torch.lifetime import (
    CellState,
    DriftConfig,
    LifetimeSimulator,
    RefreshConfig,
    RefreshPolicy,
    advance,
    apply_refresh,
    flag_columns,
    init_cell_state,
    wear_efficiency,
)
from repro_torch.lifetime.refresh import _pad_pow2

from test_torch_cim import carry_deployment, tiny_cfgs

ATOL, RTOL = 1e-5, 1e-5
COST_RTOL = 1e-4
LEAF = "['layers']['w_up']"
WV_KW = dict(max_fine_iters=12, max_coarse_iters=4)   # the tiny deployment's


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


@pytest.fixture(scope="module")
def jmodel():
    jcfg, _ = tiny_cfgs()
    with _legacy():
        params = j_init_params(jax.random.PRNGKey(0), jcfg)
        wv = JWVConfig(method=JWVMethod.HARP, **WV_KW)
        model, _ = j_deploy_arrays(jax.random.PRNGKey(1), params, wv)
    return model


def _fresh(jmodel):
    """A JAX deployment whose arrays dict the simulator may replace, and
    the port's carried copy of it (uids and WV configuration included)."""
    tm = carry_deployment(jmodel)
    tm.wv_cfg = WVConfig(method=WVMethod.HARP, **WV_KW)
    return dataclasses.replace(jmodel, arrays=dict(jmodel.arrays)), tm


def _np_state(st) -> dict:
    return {f: np.asarray(getattr(st, f)) for f in st._fields}


def _close_state(got: CellState, want, float_atol=ATOL):
    want = _np_state(want)
    for f in CellState._fields:
        a, b = getattr(got, f).numpy(), want[f]
        if f in ("stuck",):
            np.testing.assert_array_equal(a, b, err_msg=f)
        elif f in ("nu", "limit"):
            np.testing.assert_allclose(a, b, rtol=RTOL, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=float_atol, err_msg=f)


def _aged(jmodel, leaf=LEAF, hours=6.0):
    """A JAX aging state of one leaf after `hours` of drift, as numpy."""
    st = jmodel.arrays[leaf]
    with _legacy():
        s = j_init_cell_state(jax.random.PRNGKey(4), st.g, st.d2d,
                              jmodel.wv_cfg.device, JDriftConfig())
        s = j_advance(None, s, 3600.0 * hours, 1e4, jmodel.wv_cfg.device, JDriftConfig())
    return s


@pytest.mark.parametrize("leaf", [LEAF, "['layers']['wq']"])
def test_init_cell_state_matches_reference(jmodel, leaf):
    st = jmodel.arrays[leaf]
    tm = carry_deployment(jmodel)
    with _legacy():
        want = j_init_cell_state(jax.random.PRNGKey(7), st.g, st.d2d,
                                 jmodel.wv_cfg.device, JDriftConfig(),
                                 initial_cycles=2e6)
    got = init_cell_state(_tk(jax.random.PRNGKey(7)), tm.arrays[leaf].g,
                          tm.arrays[leaf].d2d, WVConfig().device, DriftConfig(),
                          initial_cycles=2e6)
    _close_state(got, want)
    assert 0 < int(got.stuck.sum()) < got.stuck.numel()  # 2e6 cycles: some stuck


def test_advance_matches_reference(jmodel):
    st = jmodel.arrays[LEAF]
    dcfg = DriftConfig(read_disturb_lsb=1e-5)
    jd = JDriftConfig(read_disturb_lsb=1e-5)
    with _legacy():
        s0 = j_init_cell_state(jax.random.PRNGKey(3), st.g, st.d2d,
                               jmodel.wv_cfg.device, jd, initial_cycles=1.5e6)
    got = cell_state_from_numpy(_np_state(s0), device="cpu")
    want = s0
    for dt, reads in ((60.0, 0.0), (3600.0, 2e4), (86400.0, 5e3)):
        want = j_advance(None, want, dt, reads, jmodel.wv_cfg.device, jd)
        got = advance(None, got, dt, reads, WVConfig().device, dcfg)
        _close_state(got, want)
    assert float((got.g - torch.from_numpy(np.array(s0.g))).abs().max()) > 0.1
    np.testing.assert_allclose(
        wear_efficiency(got.cycles, dcfg).numpy(),
        np.asarray(jnp.power(1.0 + want.cycles / jd.endurance_cycles,
                                   -jd.wear_exponent)), rtol=RTOL)


@pytest.mark.parametrize("method", list(JWVMethod), ids=lambda m: m.value)
def test_flag_columns_matches_reference(jmodel, method):
    aged = _aged(jmodel)
    targets = jmodel.arrays[LEAF].targets
    with _legacy():
        want, want_sweeps = j_flag_columns(jax.random.PRNGKey(9), aged.g, targets,
                                           JWVConfig(method=method))
    got, sweeps = flag_columns(_tk(jax.random.PRNGKey(9)),
                               torch.from_numpy(np.array(aged.g)),
                               torch.from_numpy(np.array(targets)),
                               WVConfig(method=WVMethod(method.value)))
    assert sweeps == want_sweeps
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < got.numel()  # the case is not trivial
    none, zero = flag_columns(_tk(jax.random.PRNGKey(9)), torch.zeros(4, 32),
                              torch.zeros(4, 32), WVConfig(),
                              RefreshConfig(verify_sweeps=0))
    assert zero == 0 and not bool(none.any())


def test_pad_pow2():
    idx = np.array([3, 9, 11])
    assert _pad_pow2(idx, 100).tolist() == [3, 9, 11, 3]
    assert _pad_pow2(idx, 3).tolist() == [3, 9, 11]
    assert _pad_pow2(np.arange(5), 6).tolist() == [0, 1, 2, 3, 4, 0]


@pytest.mark.parametrize("policy,method", [
    (JRefreshPolicy.PERIODIC, JWVMethod.HARP),
    (JRefreshPolicy.VERIFY_TRIGGERED, JWVMethod.HARP),
    (JRefreshPolicy.VERIFY_TRIGGERED, JWVMethod.MRA),
], ids=lambda v: v.value)
def test_apply_refresh_matches_reference(jmodel, policy, method):
    aged = _aged(jmodel)
    targets = jmodel.arrays[LEAF].targets
    jwv = JWVConfig(method=method, **WV_KW)
    wv = WVConfig(method=WVMethod(method.value), **WV_KW)
    from repro.core.cost import CircuitCost as JCircuitCost

    with _legacy():
        want, wout = j_apply_refresh(
            jax.random.PRNGKey(5), aged, targets, jwv, JCircuitCost(), JDriftConfig(),
            JRefreshConfig(policy=policy), epoch=0)
        want = jax.tree.map(np.asarray, want)
    got, out = apply_refresh(
        _tk(jax.random.PRNGKey(5)), cell_state_from_numpy(_np_state(aged), device="cpu"),
        torch.from_numpy(np.array(targets)), wv, CircuitCost(), DriftConfig(),
        RefreshConfig(policy=RefreshPolicy(policy.value)), epoch=0)
    assert out.n_reprogrammed == wout.n_reprogrammed > 0
    if wout.flagged is None:
        assert out.flagged is None
    else:
        np.testing.assert_array_equal(out.flagged, np.asarray(wout.flagged))
    for f in ("verify_latency_ns", "verify_energy_pj", "program_latency_ns",
              "program_energy_pj", "write_pulses", "gave_up_cells", "retry_pulses",
              "maintenance_energy_pj", "maintenance_latency_ns"):
        np.testing.assert_allclose(getattr(out, f), getattr(wout, f),
                                   rtol=COST_RTOL if method != JWVMethod.MRA else 0.05,
                                   err_msg=f)
    if method == JWVMethod.MRA:
        close = np.isclose(got.g.numpy(), want.g, rtol=0, atol=ATOL)
        assert close.mean() >= 0.9, close.mean()
        np.testing.assert_array_equal(got.age_s.numpy(), want.age_s)
    else:
        _close_state(got, want)
    # The no-op policies leave the state as it was.
    same, none = apply_refresh(_tk(jax.random.PRNGKey(5)), got, torch.from_numpy(
        np.array(targets)), wv, CircuitCost(), DriftConfig(),
        RefreshConfig(policy=RefreshPolicy.PERIODIC, period_epochs=2), epoch=0)
    assert same is got and none.n_reprogrammed == 0
    # An all-active mask is the unremapped array: the same outcome.
    _, every = apply_refresh(
        _tk(jax.random.PRNGKey(5)), cell_state_from_numpy(_np_state(aged), device="cpu"),
        torch.from_numpy(np.array(targets)), wv, CircuitCost(), DriftConfig(),
        RefreshConfig(policy=RefreshPolicy(policy.value)), epoch=0,
        active=torch.ones(targets.shape[0], dtype=torch.bool))
    assert every.n_reprogrammed == out.n_reprogrammed
    assert every.verify_energy_pj == out.verify_energy_pj


@pytest.mark.parametrize("policy", [JRefreshPolicy.VERIFY_TRIGGERED,
                                    JRefreshPolicy.PERIODIC], ids=lambda p: p.value)
def test_step_epoch_records_match_reference(jmodel, policy):
    """Three epochs of an hour each, a two-leaf rotating scrub window,
    read traffic from a `traffic_fn`: records, the drift digest and the
    per-tile drift map of both simulators."""
    jm, tm = _fresh(jmodel)
    traffic = {name: 40.0 * (i + 1) for i, name in enumerate(sorted(jm.arrays))}
    refreshed = {"jax": 0, "port": 0}
    with _legacy():
        jsim = JLifetimeSimulator(
            jax.random.PRNGKey(3), jm, refresh_cfg=JRefreshConfig(policy=policy),
            traffic_fn=lambda: dict(traffic),
            on_refresh=lambda p: refreshed.__setitem__("jax", refreshed["jax"] + 1))
        jobs.reset_all()
        want = [jsim.step_epoch(3600.0, reads_per_column=10.0, max_leaves=2)
                for _ in range(3)]
    want_dig = jobs.digests.get("lifetime.drift_lsb")
    want_tiles = jobs.health_registry.tiles("lifetime.drift_rms_lsb")
    want_debt = jobs.health_registry.gauge("lifetime.refresh_debt_epochs")
    obs.reset_all()
    sim = LifetimeSimulator(
        _tk(jax.random.PRNGKey(3)), tm, refresh_cfg=RefreshConfig(
            policy=RefreshPolicy(policy.value)),
        traffic_fn=lambda: dict(traffic),
        on_refresh=lambda p: refreshed.__setitem__("port", refreshed["port"] + 1))
    got = [sim.step_epoch(3600.0, reads_per_column=10.0, max_leaves=2)
           for _ in range(3)]
    assert sim._scrub_cursor == jsim._scrub_cursor
    assert refreshed["port"] == refreshed["jax"] > 0
    assert sum(r.columns_reprogrammed for r in got) > 0
    for g, w in zip(got, want):
        for f in ("epoch", "t_s", "reads_per_column", "columns_flagged",
                  "columns_reprogrammed", "stuck_frac", "refresh_debt_epochs"):
            assert getattr(g, f) == getattr(w, f), f
        for f in ("rms_drift_lsb", "verify_energy_pj", "program_energy_pj",
                  "maintenance_latency_ns", "write_pulses"):
            np.testing.assert_allclose(getattr(g, f), getattr(w, f), rtol=COST_RTOL,
                                       err_msg=f)
    dig = obs.digests.get("lifetime.drift_lsb")
    np.testing.assert_array_equal(dig.counts, want_dig.counts)
    tiles = obs.health_registry.tiles("lifetime.drift_rms_lsb")
    assert sorted(tiles) == sorted(want_tiles)
    np.testing.assert_allclose([tiles[t] for t in sorted(tiles)],
                               [want_tiles[t] for t in sorted(tiles)], rtol=COST_RTOL)
    assert obs.health_registry.gauge("lifetime.refresh_debt_epochs") == want_debt
    assert obs.registry.value("lifetime.health_syncs") == 3
    assert obs.registry.value("lifetime.scrub_epochs") == 3
    # The deployment holds the aged conductances.
    for name, st in sim.states.items():
        assert tm.arrays[name].g is st.g


def test_deployed_arrays_are_contiguous():
    """Every deployed leaf's g, targets and d2d is contiguous, including
    leaves whose packing is a single column group (the norm scales):
    the scrub hands them to the kernels, which take contiguous operands
    only (on the CPU the plain versions would not notice)."""
    from repro_torch.configs.qwen3_0_6b import SMOKE_CONFIG
    from repro_torch.core import rng
    from repro_torch.core.programmer import deploy_arrays
    from repro_torch.models import init_params

    params = init_params(0, SMOKE_CONFIG, device="cpu")
    model, _ = deploy_arrays(rng.PRNGKey(1, device="cpu"), params,
                             WVConfig(max_fine_iters=2, max_coarse_iters=2), device="cpu")
    for name, st in model.arrays.items():
        for f in ("g", "targets", "d2d"):
            assert getattr(st, f).is_contiguous(), (name, f)
        assert st.uids.dtype == np.int64 and len(st.uids) == st.g.shape[0]
    uids = np.concatenate([st.uids for st in model.arrays.values()])
    assert np.array_equal(np.sort(uids), np.arange(len(uids)))   # uid_base + arange
