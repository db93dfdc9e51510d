"""Model deployment in the port: `deploy_arrays` on qwen3-0.6b's smoke
config, against the JAX reference and against itself.

The reference's `init_params` tree is carried across with
`params_from_numpy`, both sides deploy it by HARP from the same key, and
the port's tree, uids and streams must follow the reference's.

Tolerances:
* leaf names, shapes, dtypes and column counts: exactly;
* per-leaf `materialize()`: 99% of weights within 1e-6 relative to the
  leaf's scale, all within one quantization step (the WV loop agrees to
  the last bits, see `test_torch_wv.py`, but over ~10^4 columns a
  handful of cells take another trajectory on an ulp);
* `DeployReport` scalars: counts within 0.1%, float sums rtol 1e-3 (same
  reason);
* bucketed vs per-leaf deploy in the port alone: bitwise, with one host
  sync for the bucketed deploy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.qwen3_0_6b import SMOKE_CONFIG as J_SMOKE
from repro.core import WVConfig as JWV
from repro.core.programmer import deploy_arrays as j_deploy, deploy_matrix as j_deploy_matrix
from repro.models.transformer import init_params as j_init
from repro_torch.configs.qwen3_0_6b import CONFIG, SMOKE_CONFIG
from repro_torch.convert import key_from_numpy, params_from_numpy
from repro_torch.core import pipeline
from repro_torch.core.programmer import (
    deploy_arrays,
    deploy_matrix,
    flatten_with_names,
)
from repro_torch.core.types import WVConfig
from repro_torch.models import init_params


# One bucket shape (three 4096-column buckets, the last padded): the
# reference compiles its WV loop once per shape.
BUCKETS = dict(min_bucket=4096, max_bucket=4096)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads for the module, restored after it (the suite
    runs files side by side in worker processes, and a thread per core
    makes the port's many small CPU ops several times slower)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)



@pytest.fixture(scope="module")
def jax_params():
    with jax.threefry_partitionable(False):
        p = j_init(jax.random.PRNGKey(0), J_SMOKE)
    return jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def jax_deploy(jax_params):
    with jax.threefry_partitionable(False):
        params = jax.tree.map(jnp.asarray, jax_params)
        model, report = j_deploy(jax.random.PRNGKey(7), params, JWV(), **BUCKETS)
    leaves = {name: np.asarray(st.materialize()) for name, st in model.arrays.items()}
    cols = {name: int(st.g.shape[0]) for name, st in model.arrays.items()}
    return leaves, cols, report


@pytest.fixture(scope="module")
def port_deploy(jax_params):
    params = params_from_numpy(jax_params, device="cpu")
    key = key_from_numpy(np.array([0, 7], np.uint32), "cpu")
    before = pipeline.host_sync_count()
    model, report = deploy_arrays(key, params, WVConfig(), device="cpu", **BUCKETS)
    return model, report, pipeline.host_sync_count() - before


def test_param_tree_matches_reference(jax_params):
    mine = init_params(0, SMOKE_CONFIG, device="cpu")
    want = flatten_with_names(jax_params)
    got = flatten_with_names(mine)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(want, got):
        assert tuple(a.shape) == tuple(b.shape), name
        assert str(a.dtype) == str(b.dtype).replace("torch.", ""), name
    full = init_params(0, CONFIG.replace(n_layers=1, vocab_size=8), device="cpu")
    assert full["layers"]["wq"].shape == (1, 1024, 2048)
    assert full["layers"]["w_down"].dtype == torch.bfloat16


def test_smoke_deploy_matches_jax(jax_params, jax_deploy, port_deploy):
    leaves, cols, jrep = jax_deploy
    model, rep, syncs = port_deploy
    assert syncs == 1
    assert sorted(model.arrays) == sorted(leaves)
    for name, want in leaves.items():
        st = model.arrays[name]
        assert int(st.g.shape[0]) == cols[name], name
        got = st.materialize().numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, name
        step = float(np.max(np.abs(want))) / 63.0 + 1e-30
        close = np.abs(got - want) <= 1e-6 * step * 63.0 + 1e-30
        assert close.mean() >= 0.99, name
        assert np.max(np.abs(got - want)) <= step, name
    assert rep.num_columns == jrep.num_columns and rep.num_cells == jrep.num_cells
    for f in ("mean_iterations", "total_reads", "total_write_pulses"):
        assert abs(getattr(rep, f) / getattr(jrep, f) - 1) <= 1e-3, f
    for f in ("total_latency_ns", "critical_latency_ns", "total_energy_pj",
              "rms_cell_error_lsb"):
        np.testing.assert_allclose(getattr(rep, f), getattr(jrep, f), rtol=1e-3,
                                   err_msg=f)
    dense = model.materialize()
    assert sorted(dense) == sorted(jax_params)
    assert sorted(dense["layers"]) == sorted(jax_params["layers"])
    np.testing.assert_array_equal(dense["final_norm"].numpy(), jax_params["final_norm"])
    for name, leaf in leaves.items():
        key = name.split("'")[3]
        np.testing.assert_array_equal(dense["layers"][key].numpy(),
                                      model.arrays[name].materialize().numpy())


def test_bucketed_equals_per_leaf_bitwise(jax_params):
    params = params_from_numpy(jax_params, device="cpu")
    key = key_from_numpy(np.array([0, 3], np.uint32), "cpu")
    cfg = WVConfig(max_fine_iters=12)
    pipeline.reset_counters()
    bucketed, rep_b = deploy_arrays(key, params, cfg, min_bucket=256,
                                    max_bucket=1024, device="cpu")
    assert pipeline.host_sync_count() == 1
    # Several buckets, one padded: 9856 columns = 9 x 1024 + 512 + 256 + 256.
    assert pipeline.compile_count() == 3
    per_leaf, rep_l = deploy_arrays(key, params, cfg, batched=False, device="cpu")
    assert pipeline.host_sync_count() == 1  # the per-leaf path fetches no report
    for name, st in bucketed.arrays.items():
        torch.testing.assert_close(st.g, per_leaf.arrays[name].g, rtol=0, atol=0)
        torch.testing.assert_close(st.d2d, per_leaf.arrays[name].d2d, rtol=0, atol=0)
    assert rep_b.num_columns == rep_l.num_columns
    np.testing.assert_allclose(rep_b.mean_iterations, rep_l.mean_iterations, rtol=1e-6)
    np.testing.assert_allclose(rep_b.rms_cell_error_lsb, rep_l.rms_cell_error_lsb,
                               rtol=1e-6)


def test_bf16_leaf_matches_jax():
    w = (np.random.RandomState(4).randn(48, 40) * 0.05).astype(np.float32)
    with jax.threefry_partitionable(False):
        jw = jnp.asarray(w).astype(jnp.bfloat16)
        want, jst = j_deploy_matrix(jax.random.PRNGKey(2), jw, JWV())
        want = np.asarray(want)
        tw = params_from_numpy({"w": np.asarray(jw)}, device="cpu")["w"]
    assert tw.dtype == torch.bfloat16
    got, st = deploy_matrix(key_from_numpy(np.array([0, 2], np.uint32), "cpu"), tw,
                            WVConfig(), device="cpu")
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(st.iterations.numpy(), np.asarray(jst.iterations))
    params = {"layers": {"w": tw}, "norm": torch.zeros(40)}
    model, _ = deploy_arrays(key_from_numpy(np.array([0, 2], np.uint32), "cpu"),
                             params, WVConfig(), device="cpu")
    leaf = model.materialize()["layers"]["w"]
    assert leaf.dtype == torch.bfloat16 and leaf.shape == (48, 40)
    torch.testing.assert_close(leaf, got.to(torch.bfloat16), rtol=0, atol=0)
