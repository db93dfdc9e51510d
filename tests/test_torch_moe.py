"""The port's MoE family (`models/moe.py` and the MoE decoder) against the
JAX package: the block on its own, then olmoe-1b-7b's and
qwen3-moe-235b-a22b's smoke configs through `init_params`, `forward`,
`prefill` + `decode_step`, `loss_fn` and one train step, a HARP deploy
of olmoe's 4-D expert stacks, and serving.

Tolerances (besides those of `torch_families`, which every family check
uses):
* `moe_block`: outputs within 2e-5 of the largest, aux within rtol 2e-5,
  the drop count (kept (token, choice) pairs) equal, with capacity loose
  and with capacity binding;
* the expert deploy: leaf names, shapes, dtypes, column counts and uids
  exactly; 99% of each leaf's weights within 1e-6 of its scale, all
  within two quantization steps (ROADMAP.md P2: an ulp of a normal draw
  sends a cell another way, and the Hadamard aggregate moves its whole
  column with it; measured: 40 of w_down's 32768 weights, by up to 1.37
  steps); report counts within 0.1%, float sums rtol 1e-3 (as
  `test_torch_deploy.py`); `materialize()` of the 4-D leaves as the
  reference's;
* the served tree (ideal converters, float32): logits within 1e-4 of the
  digital forward of the materialized params and of the reference's
  served logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_families as fam
from repro.cim import CIMConfig as JCIMConfig
from repro.cim import CIMExecutor as JCIMExecutor
from repro.core import WVConfig as JWV
from repro.core.programmer import deploy_arrays as j_deploy
from repro.models.moe import _local_capacity as j_capacity
from repro.models.moe import moe_block as j_moe_block
from repro.models.transformer import forward as j_forward
from repro_torch.cim import CIMConfig, CIMExecutor
from repro_torch.convert import key_from_numpy, params_from_numpy
from repro_torch.core import pipeline
from repro_torch.core.programmer import deploy_arrays
from repro_torch.core.types import WVConfig
from repro_torch.models import forward
from repro_torch.models.moe import _local_capacity, moe_block, record_routing
from repro_torch.serving import ContinuousScheduler, Request, ServeEngine

ARCHS = ["olmoe-1b-7b", "qwen3-moe-235b-a22b"]
BUCKETS = dict(min_bucket=4096, max_bucket=4096)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads for the module, restored after it (the suite
    runs files side by side in worker processes)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def carried():
    return {arch: fam.carried(fam.smoke_pair(arch)[0]) for arch in ARCHS}


def _ref_kept(x, router, cfg) -> int:
    """The reference's kept (token, choice) pairs: its routing ops."""
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    _, sel = jax.lax.top_k(probs, cfg.moe_top_k)
    flat = jax.nn.one_hot(sel, cfg.moe_experts, dtype=jnp.int32).reshape(-1, cfg.moe_experts)
    rank = jnp.sum((jnp.cumsum(flat, axis=0) - flat) * flat, axis=-1)
    return int(jnp.sum(rank < j_capacity(x.shape[0], cfg)))


@pytest.mark.parametrize("t,factor", [(3, 1.25), (40, 1.25), (1000, 1.0), (7, 8.0)])
def test_local_capacity_matches(t, factor):
    jcfg, tcfg = fam.smoke_pair("olmoe-1b-7b")
    assert _local_capacity(t, tcfg.replace(capacity_factor=factor)) == \
        j_capacity(t, jcfg.replace(capacity_factor=factor))


@pytest.mark.parametrize("case", ["loose", "binding"])
def test_moe_block_matches_reference(case, carried):
    jcfg, tcfg = fam.smoke_pair("olmoe-1b-7b")
    factor = {"loose": 8.0, "binding": 0.5}[case]   # capacity 240 or 15; mean load 30
    jcfg, tcfg = (c.replace(capacity_factor=factor) for c in (jcfg, tcfg))
    layer = {k: v[1] for k, v in carried["olmoe-1b-7b"]["layers"]["moe"].items()}
    x = np.random.RandomState(3).randn(3, 40, jcfg.d_model).astype(np.float32)
    want, jaux = j_moe_block(jnp.asarray(x), jax.tree.map(jnp.asarray, layer), jcfg, None)
    with record_routing() as log:
        got, aux = moe_block(torch.from_numpy(x), params_from_numpy(layer, device="cpu"),
                             tcfg)
    assert fam.rel(got, want) <= fam.TOL
    np.testing.assert_allclose(float(aux), float(jaux), rtol=fam.TOL)
    (keep,) = log
    kept = int(keep.sum())
    assert kept == _ref_kept(x.reshape(-1, jcfg.d_model), layer["router"], jcfg)
    total = 3 * 40 * jcfg.moe_top_k
    assert (kept == total) == (case == "loose"), (kept, total)
    with pytest.raises(NotImplementedError, match="A5"):
        moe_block(torch.from_numpy(x), params_from_numpy(layer, device="cpu"), tcfg,
                  mesh=object())


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches(arch):
    fam.check_tree(*fam.smoke_pair(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches(arch, carried):
    jcfg, tcfg = fam.smoke_pair(arch)
    fam.check_forward(jcfg, tcfg, carried[arch], fam.make_batch(jcfg, 2, 20, seed=1))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_match(arch, carried):
    jcfg, tcfg = fam.smoke_pair(arch)
    fam.check_decode(jcfg, tcfg, carried[arch], fam.make_batch(jcfg, 2, 17, seed=2),
                     n_prompt=13, max_len=24)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches(arch, carried):
    jcfg, tcfg = fam.smoke_pair(arch)
    fam.check_loss(jcfg, tcfg, carried[arch],
                   fam.make_batch(jcfg, 2, 16, seed=4, labels=True))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches(arch):
    jcfg, tcfg = fam.smoke_pair(arch)
    fam.check_train_step(jcfg, tcfg, fam.make_batch(jcfg, 2, 16, seed=5, labels=True))


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches(arch, carried):
    jcfg, tcfg = fam.smoke_pair(arch)
    toks = fam.make_batch(jcfg, 2, 9, seed=6)["tokens"]
    fam.check_generate(jcfg, tcfg, carried[arch], toks, max_new=6)


@pytest.fixture(scope="module")
def expert_deploys(carried):
    """Layer 0 of olmoe's smoke params deployed by HARP from one key in
    both packages (4096-column buckets: the reference compiles once)."""
    params = dict(carried["olmoe-1b-7b"])
    params["layers"] = jax.tree.map(lambda a: a[:1], params["layers"])
    with fam.legacy():
        jmodel, jrep = j_deploy(jax.random.PRNGKey(7), jax.tree.map(jnp.asarray, params),
                                JWV(), **BUCKETS)
    before = pipeline.host_sync_count()
    tmodel, trep = deploy_arrays(key_from_numpy(np.array([0, 7], np.uint32), "cpu"),
                                 params_from_numpy(params, device="cpu"), WVConfig(),
                                 device="cpu", **BUCKETS)
    return jmodel, jrep, tmodel, trep, pipeline.host_sync_count() - before


def test_expert_deploy_matches_reference(expert_deploys):
    jmodel, jrep, tmodel, trep, syncs = expert_deploys
    assert syncs == 1
    assert sorted(tmodel.arrays) == sorted(jmodel.arrays)
    assert "['layers']['moe']['w_gate']" in tmodel.arrays
    for name, jst in jmodel.arrays.items():
        st = tmodel.arrays[name]
        assert tuple(st.shape) == tuple(jst.shape), name
        assert int(st.g.shape[0]) == int(jst.g.shape[0]), name
        np.testing.assert_array_equal(np.asarray(st.uids), np.asarray(jst.uids))
        want = np.asarray(jst.materialize())
        got = st.materialize().numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, name
        step = float(np.max(np.abs(want))) / 63.0 + 1e-30
        close = np.abs(got - want) <= 1e-6 * step * 63.0
        assert close.mean() >= 0.99, name
        assert np.max(np.abs(got - want)) <= 2 * step, name
    assert trep.num_columns == jrep.num_columns and trep.num_cells == jrep.num_cells
    for f in ("mean_iterations", "total_reads", "total_write_pulses"):
        assert abs(getattr(trep, f) / getattr(jrep, f) - 1) <= 1e-3, f
    for f in ("total_latency_ns", "total_energy_pj", "rms_cell_error_lsb"):
        np.testing.assert_allclose(getattr(trep, f), getattr(jrep, f), rtol=1e-3, err_msg=f)
    dense = tmodel.materialize()
    assert dense["layers"]["moe"]["w_gate"].shape == (1, 8, 64, 32)


def test_served_moe_tree_runs(expert_deploys):
    """The executor serves the attention projections in the arrays and
    the expert stacks digitally, as the reference's does."""
    jmodel, _, tmodel, _, _ = expert_deploys
    jcfg, tcfg = (c.replace(n_layers=1) for c in fam.smoke_pair("olmoe-1b-7b"))
    toks = fam.make_batch(jcfg, 2, 12, seed=8)["tokens"]
    ideal = dict(dac_bits=None, adc_bits=None, sigma_read_lsb=0.0)
    with fam.legacy():
        jex = JCIMExecutor(jmodel, JCIMConfig(**ideal), jax.random.PRNGKey(3))
        want, _, _ = fam.jitted(j_forward, jcfg)(jex.params(), {"tokens": jnp.asarray(toks)})
    ex = CIMExecutor(tmodel, CIMConfig(**ideal),
                     key_from_numpy(np.asarray(jax.random.PRNGKey(3)), "cpu"))
    assert len(ex._analog) == len(jex._analog) == 4       # wq, wk, wv, wo
    assert "['layers']['moe']['w_gate']" in ex._digital
    got, _, _ = forward(ex.params(), {"tokens": torch.from_numpy(toks)}, tcfg)
    dig, _, _ = forward(tmodel.materialize(), {"tokens": torch.from_numpy(toks)}, tcfg)
    np.testing.assert_allclose(got.numpy(), dig.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_scheduler_admits_moe_whole_prompts(carried):
    """MoE is admitted with whole-prompt admission; chunked prefill is
    refused (capacity couples the tokens of a sequence)."""
    _, tcfg = fam.smoke_pair("olmoe-1b-7b")
    eng = ServeEngine(tcfg, params_from_numpy(carried["olmoe-1b-7b"], device="cpu"))
    sched = ContinuousScheduler(eng, n_slots=2, max_len=32, device="cpu")
    recs = sched.run([Request(rid=i, prompt=[3 + i] * 6, max_new=4) for i in range(3)])
    assert len(recs) == 3 and all(len(r.tokens) == 4 for r in recs)
    with pytest.raises(ValueError, match="MoE"):
        ContinuousScheduler(eng, max_len=64, prefill_chunk_tokens=16, device="cpu")
