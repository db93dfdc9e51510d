"""Faulty silicon in the port (fault maps, give-up, spare-column remap,
fault-aware placement, converter calibration) against the JAX package.

Every JAX call runs inside a scoped ``jax.threefry_partitionable(False)``
block, at the JAX tests' tiny sizes (`tests/test_fault_remap.py`: N = 16
cells, its `_FAULTY` population).

Tolerances:
* `sample_fault_map`: `stuck` / `stuck_g` exactly (a cell whose uniform
  lay on a threshold could classify otherwise, since the tile multiplier
  comes through `exp` of a normal draw within 3 ulp; none does here),
  `efficiency` and `tile_quality` within rtol 1e-6;
* `program_columns(fault=)` against the jitted reference entry
  `pipeline.get_program_fn(..., with_fault=True)`, fused and unfused: g
  within 1e-5 and gave-up / retry counts exactly for CW-SC, HD-PV and
  HARP; MRA on at least 90% of cells (ROADMAP.md C1); stuck cells
  pinned exactly;
* remap tables, candidates and placement uids: exactly;
* the spare-column deploy: uids, perm, active and remapped counts
  exactly; gave-up and retry totals within 0.1%; g within 1e-5 on 99% of
  the physical columns and `materialize()` on 99% of the weights within
  1e-6 of the leaf's scale (`test_torch_deploy.py`'s rules, over the
  whole deployment: an ulp of a normal draw can move one cell onto
  another trajectory, and through the Hadamard verify aggregate its
  whole column; in the placement case one column of 600 does); the
  zero-fault guard bitwise;
* the scrub on a carried remapped, faulty deployment: flag masks and
  re-programmed counts exactly, re-programmed g within 1e-5, records as
  in `test_torch_lifetime.py`;
* ideal-limit executor logits of a remapped deployment: rtol 1e-4;
* `calibrate_offsets`: residuals within 1e-5 LSB except where a SAR code
  flipped (a normal draw within 3 ulp on a code boundary), at most 1% of
  columns, each off by whole code widths / (N K).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cim import CIMConfig as JCIMConfig, CIMExecutor as JCIMExecutor
from repro.core import device as jdev, pipeline as jpipe, remap as jremap
from repro.core.cost import CircuitCost as JCircuitCost
from repro.core.programmer import deploy_arrays as j_deploy_arrays
from repro.core.types import FaultConfig as JFaultConfig
from repro.core.types import WVConfig as JWVConfig, WVMethod as JWVMethod
from repro.lifetime import LifetimeSimulator as JLifetimeSimulator
from repro.lifetime import RefreshConfig as JRefreshConfig
from repro.lifetime import RefreshPolicy as JRefreshPolicy
from repro.lifetime import advance as j_advance
from repro.lifetime import apply_refresh as j_apply_refresh
from repro.lifetime import init_cell_state as j_init_cell_state
from repro.lifetime import DriftConfig as JDriftConfig
from repro.models import forward as j_forward, init_params as j_init_params
from repro.readout import calibrate as jcal, for_wv_method as j_for_wv_method
from repro.core.types import NoiseConfig as JNoiseConfig
from repro import obs as jobs
from repro_torch import obs
from repro_torch.cim import CIMConfig, CIMExecutor
from repro_torch.convert import (
    cell_state_from_numpy,
    deployed_from_numpy,
    key_from_numpy,
    params_from_numpy,
)
from repro_torch.core import device as tdev, pipeline, remap
from repro_torch.core.cost import CircuitCost
from repro_torch.core.programmer import deploy_arrays
from repro_torch.core.types import FaultConfig, NoiseConfig, WVConfig, WVMethod
from repro_torch.lifetime import (
    DriftConfig,
    LifetimeSimulator,
    RefreshConfig,
    RefreshPolicy,
    apply_refresh,
)
from repro_torch.models import forward
from repro_torch.readout import calibrate_offsets, for_wv_method, sample_col_offsets

from test_torch_cim import tiny_cfgs

N = 16
ATOL = 1e-5
COST_RTOL = 1e-4
_FAULTY = dict(p_stuck_hrs=0.05, p_stuck_lrs=0.03, p_weak=0.05,
               sigma_tile_fault_dec=0.5, columns_per_tile=4, tiles_per_chip=2)
# Every correlated field and every fault kind at once.
_SPREAD = dict(_FAULTY, p_exhausted=0.02, sigma_tile_eff_frac=0.1,
               sigma_chip_eff_frac=0.05)
# Non-contiguous uids, across tiles and chips, up to the int32 range.
UIDS = np.array([3, 7, 8, 9, 100, 101, 102, 64, 12345, 1 << 20, (1 << 24) + 5,
                 (1 << 30) + 1, 21_000_000, 5, 6, 4], np.int64)


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


# --------------------------------------------------------------- configs
def test_remap_config_matches_reference():
    mine = [(f.name, f.default) for f in dataclasses.fields(remap.RemapConfig)]
    want = [(f.name, f.default) for f in dataclasses.fields(jremap.RemapConfig)]
    assert mine == want
    assert remap.n_spares(10, remap.RemapConfig()) == jremap.n_spares(
        10, jremap.RemapConfig()) == 3
    for c, frac in ((1, 0.25), (7, 0.5), (100, 0.0), (3, 2.0)):
        assert (remap.n_spares(c, remap.RemapConfig(spare_frac=frac))
                == jremap.n_spares(c, jremap.RemapConfig(spare_frac=frac)))


# ------------------------------------------------------------ fault maps
@pytest.mark.parametrize("fc", [_FAULTY, _SPREAD], ids=["faulty", "spread"])
def test_sample_fault_map_matches_reference(fc):
    dev = WVConfig(n_cells=N).device
    with _legacy():
        k = jax.random.PRNGKey(3)
        ju = jnp.asarray(UIDS, jnp.int32)
        want = jdev.sample_fault_map(k, ju, (len(UIDS), N), JFaultConfig(**fc),
                                     JWVConfig(n_cells=N).device)
        want_q = jdev.tile_quality(k, ju // fc["columns_per_tile"], JFaultConfig(**fc))
    tu = torch.from_numpy(UIDS)
    got = tdev.sample_fault_map(_tk(k), tu, (len(UIDS), N), FaultConfig(**fc), dev)
    got_q = tdev.tile_quality(_tk(k), tdev.tile_ids(tu, FaultConfig(**fc)),
                              FaultConfig(**fc))
    np.testing.assert_array_equal(got.stuck.numpy(), np.asarray(want.stuck))
    np.testing.assert_array_equal(got.stuck_g.numpy(), np.asarray(want.stuck_g))
    np.testing.assert_allclose(got.efficiency.numpy(), np.asarray(want.efficiency),
                               rtol=1e-6)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q), rtol=1e-6)
    # The case is not trivial: every kind of fault occurs.
    assert 0 < int(got.stuck.sum()) < got.stuck.numel()
    assert bool((got.stuck_g == dev.g_max_lsb).any())
    assert bool(((got.efficiency < 0.5) & ~got.stuck).any())
    if fc is _SPREAD:
        assert len(np.unique(got.efficiency.numpy())) > 3
        level = got.stuck_g.numpy()
        assert ((level > 0) & (level < dev.g_max_lsb)).any()   # exhausted cells


def test_fault_map_independent_of_bucketing():
    """A column's fault row depends only on (key, uid): a slice of the
    uids reproduces it bitwise, and so does sampling in chunks."""
    dev, fc = WVConfig(n_cells=N).device, FaultConfig(**_SPREAD)
    key = _tk(jax.random.PRNGKey(3))
    uids = torch.arange(40, dtype=torch.int64) * 7
    full = tdev.sample_fault_map(key, uids, (40, N), fc, dev)
    sub = tdev.sample_fault_map(key, uids[5:9], (4, N), fc, dev)
    chunked = pipeline.sample_fault_for(key, uids, (40, N), fc, dev)
    for a, b, c in zip(full, sub, chunked):
        torch.testing.assert_close(a[5:9], b, rtol=0, atol=0)
        torch.testing.assert_close(a, c, rtol=0, atol=0)
    inert = tdev.empty_fault_map((3, N), device="cpu")
    assert not bool(inert.stuck.any()) and bool((inert.efficiency == 1).all())


# -------------------------------------------------------- program_columns
@pytest.mark.parametrize("use_pallas", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("method", list(JWVMethod), ids=lambda m: m.value)
def test_program_columns_with_faults_matches_reference(method, use_pallas):
    """The port's one `wv_step` path against the reference's fused
    (Pallas op, CPU fallback) and unfused (`apply_pulses(fault=)`) paths,
    both through the jitted `get_program_fn(..., with_fault=True)`."""
    c = 64
    uids = np.arange(c, dtype=np.int64) * 3 + 5
    kw = dict(n_cells=N, max_fine_iters=20, max_coarse_iters=4, give_up_pulses=20)
    jcfg = JWVConfig(method=method, use_pallas=use_pallas, **kw)
    with _legacy():
        k = jax.random.PRNGKey(3)
        targets = jax.random.randint(jax.random.PRNGKey(0), (c, N), 0, 8
                                     ).astype(jnp.float32)
        ju = jnp.asarray(uids, jnp.int32)
        d2d = jpipe.sample_d2d_for(k, ju, (c, N), jcfg.device)
        fmap = jdev.sample_fault_map(k, ju, (c, N), JFaultConfig(**_FAULTY), jcfg.device)
        fn = jpipe.get_program_fn(jcfg, JCircuitCost(), with_fault=True)
        want_g, want = fn(k, targets, d2d, ju, fmap)
        want_g, want = np.asarray(want_g), jax.tree.map(np.asarray, want)
    cfg = WVConfig(method=WVMethod(method.value), **kw)
    tu = torch.from_numpy(uids)
    td2d = pipeline.sample_d2d_for(_tk(k), tu, (c, N), cfg.device)
    tfmap = pipeline.sample_fault_for(_tk(k), tu, (c, N), FaultConfig(**_FAULTY),
                                      cfg.device)
    before = pipeline.host_sync_count()
    g, st = pipeline.get_program_fn(cfg, CircuitCost(), with_fault=True)(
        _tk(k), torch.from_numpy(np.array(targets)), td2d, tu, tfmap)
    assert pipeline.host_sync_count() == before
    stuck = tfmap.stuck.numpy()
    np.testing.assert_array_equal(g.numpy()[stuck], tfmap.stuck_g.numpy()[stuck])
    assert float(st.gave_up.sum()) > 0 and float(st.retry_pulses.sum()) > 0
    if method == JWVMethod.MRA:
        close = np.isclose(g.numpy(), want_g, rtol=0, atol=ATOL)
        assert close.mean() >= 0.9, close.mean()
        return
    np.testing.assert_allclose(g.numpy(), want_g, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(st.gave_up.numpy(), want.gave_up)
    np.testing.assert_array_equal(st.retry_pulses.numpy(), want.retry_pulses)
    np.testing.assert_array_equal(st.iterations.numpy(), want.iterations)


@pytest.mark.parametrize("method", [WVMethod.HARP, WVMethod.HD_PV], ids=lambda m: m.value)
def test_inert_fault_map_bit_identical(method):
    """fault=None and an inert map, each with a generous give-up budget,
    program the same conductances bitwise; without a budget the give-up
    counters stay zero."""
    targets = torch.floor(torch.rand(24, N, generator=torch.Generator().manual_seed(1)) * 8)
    key = _tk(jax.random.PRNGKey(7))
    cfg = WVConfig(method=method, n_cells=N, max_fine_iters=20, max_coarse_iters=4)
    from repro_torch.core.wv import program_columns

    g0, s0 = program_columns(key, targets, cfg)
    g1, s1 = program_columns(key, targets, cfg.replace(give_up_pulses=500),
                             fault=tdev.empty_fault_map(targets.shape, device="cpu"))
    torch.testing.assert_close(g0, g1, rtol=0, atol=0)
    assert float(s0.gave_up.sum()) == 0 and float(s0.retry_pulses.sum()) == 0
    gu, rp = s1.gave_up.numpy(), s1.retry_pulses.numpy()
    assert (rp[gu > 0] > 0).all() and (rp[gu == 0] == 0).all()


# ----------------------------------------------------------------- remap
def _gave_up_vectors(seed: int, c: int, s: int):
    rs = np.random.RandomState(seed)
    prim = rs.randint(0, 4, c).astype(np.float32)   # small counts: many ties
    spare = rs.randint(0, 4, s).astype(np.float32)
    return prim, spare


@pytest.mark.parametrize("seed,c,s", [(0, 12, 3), (1, 40, 10), (2, 7, 7), (3, 33, 9),
                                      (4, 5, 1)])
@pytest.mark.parametrize("min_gave_up", [1, 2])
def test_remap_ops_match_reference(seed, c, s, min_gave_up):
    prim, spare = _gave_up_vectors(seed, c, s)
    cand_j = jremap.spare_candidates(jnp.asarray(prim), s)
    tbl_j = jremap.build_table(jnp.asarray(prim), cand_j, jnp.asarray(spare), min_gave_up)
    cand = remap.spare_candidates(torch.from_numpy(prim), s)
    tbl = remap.build_table(torch.from_numpy(prim), cand, torch.from_numpy(spare),
                            min_gave_up)
    np.testing.assert_array_equal(cand.numpy(), np.asarray(cand_j))
    np.testing.assert_array_equal(tbl.perm.numpy(), np.asarray(tbl_j.perm))
    np.testing.assert_array_equal(tbl.active.numpy(), np.asarray(tbl_j.active))
    x = np.random.RandomState(seed).randn(c + s, 3).astype(np.float32)
    np.testing.assert_array_equal(remap.apply_remap(torch.from_numpy(x), tbl).numpy(),
                                  np.asarray(jremap.apply_remap(jnp.asarray(x), tbl_j)))
    ident, ident_j = remap.identity_table(c, s, device="cpu"), jremap.identity_table(c, s)
    np.testing.assert_array_equal(ident.perm.numpy(), np.asarray(ident_j.perm))
    np.testing.assert_array_equal(ident.active.numpy(), np.asarray(ident_j.active))
    xt = torch.from_numpy(x)
    assert remap.apply_remap(xt, None) is xt


@pytest.mark.parametrize("seed", range(24))
def test_remap_table_is_permutation(seed):
    """For any give-up profile and spare quality, `perm` maps the C
    logical columns onto C distinct physical rows of the C + S array,
    `active` is exactly its image, and a column moves only onto a spare
    at least as good as its primary."""
    rs = np.random.RandomState(seed)
    c = int(rs.randint(4, 49))
    s = min(int(rs.randint(1, 13)), c)
    prim, spare = _gave_up_vectors(seed + 100, c, s)
    tbl = remap.build_table(torch.from_numpy(prim),
                            remap.spare_candidates(torch.from_numpy(prim), s),
                            torch.from_numpy(spare))
    perm, active = tbl.perm.numpy(), tbl.active.numpy()
    assert perm.shape == (c,) and active.shape == (c + s,)
    assert len(np.unique(perm)) == c and perm.min() >= 0 and perm.max() < c + s
    image = np.zeros(c + s, bool)
    image[perm] = True
    np.testing.assert_array_equal(image, active)
    moved = np.nonzero(perm >= c)[0]
    assert all(spare[perm[i] - c] <= prim[i] for i in moved)


@pytest.mark.parametrize("sens", [None, [1.0, 2.0, 0.5]])
def test_plan_placement_matches_reference(sens):
    fc = dict(p_stuck_hrs=0.01, sigma_tile_fault_dec=1.0, columns_per_tile=8,
              tiles_per_chip=4)
    with _legacy():
        k = jax.random.PRNGKey(11)
        want = jremap.plan_placement(k, [16, 8, 21], JFaultConfig(**fc), sens)
    got = remap.plan_placement(_tk(k), [16, 8, 21], FaultConfig(**fc), sens)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.dtype == np.int64
        np.testing.assert_array_equal(a, b)
    assert len(np.unique(np.concatenate(got))) == 45


# ---------------------------------------------------------------- deploy
def _small_params():
    """`tests/test_deploy_pipeline.py`'s small params tree."""
    ks = jax.random.split(jax.random.PRNGKey(0), 8)
    return {
        "blk0": {"w": jax.random.normal(ks[0], (40, 24)) * 0.05,
                 "scale": jnp.ones((24,))},
        "blk1": {"w": jax.random.normal(ks[1], (64, 16)) * 0.05,
                 "w2": jax.random.normal(ks[2], (33, 20)) * 0.05},
        "embed": jax.random.normal(ks[3], (64, 8)) * 0.05,
    }


_DEPLOY_FAULTS = dict(p_stuck_hrs=0.02, p_stuck_lrs=0.01, p_weak=0.01,
                      sigma_tile_fault_dec=0.5, columns_per_tile=8, tiles_per_chip=4)


@pytest.mark.parametrize("placement", [False, True], ids=["spares", "placement"])
def test_deploy_with_faults_and_remap_matches_reference(placement):
    wv_kw = dict(method=JWVMethod.HARP, max_fine_iters=14, give_up_pulses=24)
    with _legacy():
        params = _small_params()
        jdep, jrep = j_deploy_arrays(
            jax.random.PRNGKey(5), params, JWVConfig(**wv_kw), min_bucket=256,
            fault_cfg=JFaultConfig(**_DEPLOY_FAULTS),
            remap_cfg=jremap.RemapConfig(spare_frac=0.25, placement=placement))
        params = jax.tree.map(np.asarray, params)
    tparams = params_from_numpy(params, device="cpu")
    pipeline.reset_counters()
    dep, rep = deploy_arrays(
        _tk(jax.random.PRNGKey(5)), tparams,
        WVConfig(**{**wv_kw, "method": WVMethod.HARP}), min_bucket=256,
        fault_cfg=FaultConfig(**_DEPLOY_FAULTS),
        remap_cfg=remap.RemapConfig(spare_frac=0.25, placement=placement), device="cpu")
    assert pipeline.host_sync_count() == 1
    assert rep.remapped_columns == jrep.remapped_columns > 0
    assert jrep.total_gave_up_cells > 0
    for f in ("total_gave_up_cells", "total_retry_pulses"):
        assert abs(getattr(rep, f) / getattr(jrep, f) - 1) <= 1e-3, f
    assert rep.num_columns == jrep.num_columns
    assert sorted(dep.arrays) == sorted(jdep.arrays)
    col_ok, w_ok = [], []
    for name, jst in jdep.arrays.items():
        st = dep.arrays[name]
        np.testing.assert_array_equal(st.uids, np.asarray(jst.uids), err_msg=name)
        np.testing.assert_array_equal(st.remap.perm.numpy(), np.asarray(jst.remap.perm))
        np.testing.assert_array_equal(st.remap.active.numpy(), np.asarray(jst.remap.active))
        np.testing.assert_array_equal(st.targets.numpy(), np.asarray(jst.targets))
        for a, b in zip(st.fault, jst.fault):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
        stuck = st.fault.stuck.numpy()
        np.testing.assert_array_equal(st.g.numpy()[stuck], st.fault.stuck_g.numpy()[stuck])
        assert rep.leaves[name]["remapped_columns"] == jrep.leaves[name]["remapped_columns"]
        col_ok.append((np.abs(st.g.numpy() - np.asarray(jst.g)) <= ATOL).all(axis=1))
        want = np.asarray(jst.materialize())
        got = st.materialize().numpy()
        assert got.shape == want.shape == tuple(jst.shape)
        w_ok.append((np.abs(got - want) <= 1e-6 * float(np.max(np.abs(want))) + 1e-30
                     ).reshape(-1))
    assert np.concatenate(col_ok).mean() >= 0.99
    assert np.concatenate(w_ok).mean() >= 0.99
    dense = dep.materialize()
    assert dense["blk1"]["w2"].shape == (33, 20)
    with pytest.raises(ValueError, match="batched"):
        deploy_arrays(_tk(jax.random.PRNGKey(5)), tparams, WVConfig(), batched=False,
                      fault_cfg=FaultConfig(**_DEPLOY_FAULTS), device="cpu")


def test_zero_fault_deploy_bit_identical():
    """The whole fault / give-up machinery with every fault rate at zero
    programs the same weights as a plain deploy, bitwise, and gives up
    on nothing (the reference's own case, `test_fault_remap.py`)."""
    with _legacy():
        params = {"w": np.asarray(jax.random.normal(jax.random.PRNGKey(0), (24, 12)) * 0.2)}
    tparams = params_from_numpy(params, device="cpu")
    key = _tk(jax.random.PRNGKey(5))
    from repro_torch.core.types import default_config_for_array

    wv = default_config_for_array(N)
    plain, _ = deploy_arrays(key, tparams, wv, min_bucket=16, device="cpu")
    pipeline.reset_counters()
    guard, rep = deploy_arrays(key, tparams, wv.replace(give_up_pulses=500),
                               min_bucket=16, fault_cfg=FaultConfig(), device="cpu")
    assert pipeline.host_sync_count() == 1
    assert rep.total_gave_up_cells == 0.0 and rep.remapped_columns == 0
    for name, st in plain.arrays.items():
        torch.testing.assert_close(guard.arrays[name].materialize(), st.materialize(),
                                   rtol=0, atol=0)
        assert guard.arrays[name].fault is None and guard.arrays[name].remap is None


# ------------------------------------------------- scrub on faulty silicon
WV_KW = dict(max_fine_iters=12, max_coarse_iters=4, give_up_pulses=20)
LEAF = "['layers']['w_up']"


@pytest.fixture(scope="module")
def jfaulty():
    """A tiny JAX HARP deployment on faulty silicon with spares and
    placement (the CIM tests' model)."""
    jcfg, _ = tiny_cfgs()
    with _legacy():
        params = j_init_params(jax.random.PRNGKey(0), jcfg)
        model, rep = j_deploy_arrays(
            jax.random.PRNGKey(1), params, JWVConfig(method=JWVMethod.HARP, **WV_KW),
            fault_cfg=JFaultConfig(**_FAULTY),
            remap_cfg=jremap.RemapConfig(spare_frac=0.25, placement=True))
    assert rep.remapped_columns > 0
    return model


def _carry(jmodel):
    """The reference's faulty, remapped `DeployedModel` -> the port's."""
    arrays = {
        name: dict(g=np.asarray(st.g), targets=np.asarray(st.targets),
                   d2d=np.asarray(st.d2d), scale=np.asarray(st.scale),
                   layout=st.layout, shape=st.shape, dtype=st.dtype, uids=st.uids,
                   fault=jax.tree.map(np.asarray, st.fault),
                   remap=jax.tree.map(np.asarray, st.remap))
        for name, st in jmodel.arrays.items()
    }
    tree = jax.tree.map(np.asarray, jmodel.materialize())
    tm = deployed_from_numpy(tree, arrays, device="cpu")
    tm.wv_cfg = WVConfig(method=WVMethod.HARP, **WV_KW)
    return tm


def test_carried_faulty_deployment_materializes_like_reference(jfaulty):
    tm = _carry(jfaulty)
    for name, jst in jfaulty.arrays.items():
        st = tm.arrays[name]
        assert st.remap.perm.dtype == torch.int64 and st.fault.stuck.dtype == torch.bool
        np.testing.assert_array_equal(st.materialize().numpy(),
                                      np.asarray(jst.materialize()))


@pytest.mark.parametrize("policy", [JRefreshPolicy.VERIFY_TRIGGERED,
                                    JRefreshPolicy.PERIODIC], ids=lambda p: p.value)
def test_apply_refresh_active_and_fault_match_reference(jfaulty, policy):
    st = jfaulty.arrays[LEAF]
    active = np.asarray(st.remap.active)
    assert not active.all()
    jwv = JWVConfig(method=JWVMethod.HARP, **WV_KW)
    with _legacy():
        aged = j_init_cell_state(jax.random.PRNGKey(4), st.g, st.d2d, jwv.device,
                                 JDriftConfig())
        aged = j_advance(None, aged, 3600.0 * 6, 1e4, jwv.device, JDriftConfig())
        want, wout = j_apply_refresh(
            jax.random.PRNGKey(5), aged, st.targets, jwv, JCircuitCost(), JDriftConfig(),
            JRefreshConfig(policy=policy), epoch=0, active=st.remap.active,
            fault=st.fault)
        want = jax.tree.map(np.asarray, want)
    tm = _carry(jfaulty)
    tst = tm.arrays[LEAF]
    aged_t = cell_state_from_numpy({f: np.asarray(getattr(aged, f))
                                    for f in aged._fields}, device="cpu")
    got, out = apply_refresh(
        _tk(jax.random.PRNGKey(5)), aged_t, tst.targets, tm.wv_cfg, CircuitCost(),
        DriftConfig(), RefreshConfig(policy=RefreshPolicy(policy.value)), epoch=0,
        active=tst.remap.active, fault=tst.fault)
    assert out.n_reprogrammed == wout.n_reprogrammed > 0
    if wout.flagged is not None:
        np.testing.assert_array_equal(out.flagged, np.asarray(wout.flagged))
        assert not (out.flagged & ~active).any()
    for f in ("verify_latency_ns", "verify_energy_pj", "program_latency_ns",
              "program_energy_pj", "write_pulses", "gave_up_cells", "retry_pulses"):
        np.testing.assert_allclose(getattr(out, f), getattr(wout, f), rtol=COST_RTOL,
                                   err_msg=f)
    np.testing.assert_allclose(got.g.numpy(), want.g, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got.age_s.numpy(), want.age_s)
    # Inactive rows are untouched: neither re-programmed nor re-aged.
    np.testing.assert_array_equal(got.g.numpy()[~active], np.asarray(aged.g)[~active])
    assert (got.age_s.numpy()[~active] == 3600.0 * 6).all()
    # Stuck cells of the re-programmed rows sit at their pinned level.
    reprog = (out.flagged if out.flagged is not None else active)[:, None]
    stuck = tst.fault.stuck.numpy() & reprog
    assert stuck.any()
    np.testing.assert_array_equal(got.g.numpy()[stuck], tst.fault.stuck_g.numpy()[stuck])


def test_step_epoch_on_faulty_remapped_deployment_matches_reference(jfaulty, monkeypatch):
    """Three one-hour epochs with a two-leaf scrub window on the carried
    deployment: records, the drift digest and the per-tile map of both
    simulators, and no inactive row flagged or re-programmed."""
    jm = dataclasses.replace(jfaulty, arrays=dict(jfaulty.arrays))
    tm = _carry(jfaulty)
    with _legacy():
        jsim = JLifetimeSimulator(jax.random.PRNGKey(3), jm,
                                  refresh_cfg=JRefreshConfig(), columns_per_tile=4)
        jobs.reset_all()
        want = [jsim.step_epoch(3600.0, reads_per_column=10.0, max_leaves=2)
                for _ in range(3)]
    want_dig = jobs.digests.get("lifetime.drift_lsb")
    want_tiles = jobs.health_registry.tiles("lifetime.drift_rms_lsb")

    import repro_torch.lifetime.service as service

    seen = []

    def checked(*a, **kw):
        state, out = apply_refresh(*a, **kw)
        act = kw["active"]
        if out.flagged is not None and act is not None:
            seen.append(int((out.flagged & ~act.numpy()).sum()))
        return state, out

    monkeypatch.setattr(service, "apply_refresh", checked)
    obs.reset_all()
    sim = LifetimeSimulator(_tk(jax.random.PRNGKey(3)), tm, refresh_cfg=RefreshConfig(),
                            columns_per_tile=4)
    got = [sim.step_epoch(3600.0, reads_per_column=10.0, max_leaves=2)
           for _ in range(3)]
    assert seen and set(seen) == {0}
    assert sum(r.columns_reprogrammed for r in got) > 0
    for g, w in zip(got, want):
        for f in ("epoch", "columns_flagged", "columns_reprogrammed", "stuck_frac",
                  "refresh_debt_epochs"):
            assert getattr(g, f) == getattr(w, f), f
        for f in ("rms_drift_lsb", "verify_energy_pj", "program_energy_pj",
                  "maintenance_latency_ns", "write_pulses", "gave_up_cells",
                  "retry_pulses"):
            np.testing.assert_allclose(getattr(g, f), getattr(w, f), rtol=COST_RTOL,
                                       err_msg=f)
    np.testing.assert_array_equal(obs.digests.get("lifetime.drift_lsb").counts,
                                  want_dig.counts)
    tiles = obs.health_registry.tiles("lifetime.drift_rms_lsb")
    assert sorted(tiles) == sorted(want_tiles)
    np.testing.assert_allclose([tiles[t] for t in sorted(tiles)],
                               [want_tiles[t] for t in sorted(tiles)], rtol=COST_RTOL)
    for name, st in sim.states.items():
        inactive = ~tm.arrays[name].remap.active
        assert bool((st.age_s[inactive] == 3 * 3600.0).all()), name


def test_executor_ideal_logits_on_remapped_deployment(jfaulty):
    jcfg, tcfg = tiny_cfgs()
    toks = np.random.RandomState(20).randint(0, 32, (2, 6))
    ideal = dict(dac_bits=None, adc_bits=None, sigma_read_lsb=0.0)
    with _legacy():
        jex = JCIMExecutor(jfaulty, JCIMConfig(**ideal), jax.random.PRNGKey(19))
        want, _, _ = j_forward(jex.params(), {"tokens": jnp.asarray(toks)}, jcfg)
    tm = _carry(jfaulty)
    ex = CIMExecutor(tm, CIMConfig(**ideal), _tk(jax.random.PRNGKey(19)))
    got, _, _ = forward(ex.params(), {"tokens": torch.from_numpy(toks).to(torch.int32)},
                        tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    digital, _, _ = forward(tm.materialize(), {"tokens": torch.from_numpy(toks).to(
        torch.int32)}, tcfg)
    torch.testing.assert_close(got, digital, rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------ calibration
@pytest.mark.parametrize("method", [JWVMethod.HARP, JWVMethod.MRA], ids=lambda m: m.value)
def test_calibrate_offsets_matches_reference(method):
    """`benchmarks/readout_sweep.py`'s settings (sigma_offset 1.5 LSB,
    read noise 0.7 LSB, K = 8) at 1024 columns of 32 cells."""
    c = 1024
    jcfg = JWVConfig(method=method, noise=JNoiseConfig(sigma_read_lsb=0.7))
    jr = j_for_wv_method(jcfg).replace(sigma_col_offset_lsb=1.5)
    with _legacy():
        okey, ckey = jax.random.split(jax.random.PRNGKey(0))
        j_off = jcal.sample_col_offsets(okey, c, jr)
        j_res = np.asarray(jcal.calibrate_offsets(ckey, j_off, jr, k_reads=8))
        j_off = np.asarray(j_off)
    rcfg = for_wv_method(WVConfig(method=WVMethod(method.value),
                                  noise=NoiseConfig(sigma_read_lsb=0.7))
                         ).replace(sigma_col_offset_lsb=1.5)
    off = sample_col_offsets(_tk(okey), c, rcfg)
    np.testing.assert_allclose(off.numpy(), j_off, rtol=1e-6, atol=1e-6)
    res = calibrate_offsets(_tk(ckey), off, rcfg, k_reads=8).numpy()
    diff = np.abs(res - j_res)
    flips = diff > 1e-5
    assert flips.mean() <= 0.01, flips.sum()
    # The reference's criterion: calibration trims the offsets' spread.
    assert np.std(res) < 0.1 * np.std(off.numpy())
    assert abs(np.std(res) / np.std(j_res) - 1.0) < 0.05
