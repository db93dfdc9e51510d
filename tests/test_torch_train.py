"""The port's training stack against the JAX package: `rng.randint`, the
synthetic data, the loss, the LR schedule, AdamW, the train and eval
steps, checkpoints and the training-state carriers in `convert`.

Every JAX call runs inside a scoped ``jax.threefry_partitionable(False)``
block (the JAX package itself runs in the partitionable mode; the port
keeps the legacy layout, ROADMAP.md C1).  Nothing here changes
process-wide state beyond a fixture that runs the module on two torch
threads and restores the count: no global config, default dtype, seed,
working directory or environment (the one-rank process group of the
mesh check is torn down when it ends); checkpoints go under `tmp_path`.

Tolerances:
* `randint`, `SyntheticLM` batches: bitwise;
* `cross_entropy_loss`, `loss_fn` on carried float32 params (a
  multi-codebook head included): rtol 1e-5;
* gradients: each leaf within 1e-4 of its largest magnitude (float32
  sums in another order; measured ~1e-6);
* `cosine_schedule` over ``0 .. total + 5``: within 2e-7 of the peak
  (XLA's float32 cos and its fused multiply-adds move an ulp);
* `adamw_update` fed the reference's gradients: step equal, moments and
  params within rtol 1e-6 / atol 1e-9 (float32: an ulp of the update
  here and there; 1e-9 is an ulp of a step of lr ~5e-3 on a parameter
  near 0) or rtol 2^-7 (one bf16 rounding step; bf16 params and
  moments);
* 5 train steps (`grad_accum` 1 and 2): losses within 1e-5; params
  within 5e-4 wherever the reference's gradient exceeds 1e-4 of its
  leaf's largest in every step.  Adam's first steps are nearly
  ``sign(g)``: an element whose gradient is at the float32 noise of the
  two packages' sums could move ~2 lr (2e-2) the other way, so elements
  with a tiny gradient are not held (measured: none moved; max 7e-5);
* `make_eval_step`: rtol 1e-5;
* checkpoints, either package writing and the other restoring: bitwise,
  bf16 leaves and a whole `TrainState` included.
"""

import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_families as fam

from repro.checkpoint import restore_checkpoint as j_restore
from repro.checkpoint import save_checkpoint as j_save
from repro.configs.musicgen_medium import SMOKE_CONFIG as J_MUSICGEN
from repro.configs.qwen3_0_6b import SMOKE_CONFIG as J_SMOKE
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import ModelConfig as JModelConfig
from repro.models import init_params as j_init_params
from repro.models.layers import cross_entropy_loss as j_ce
from repro.models.transformer import loss_fn as j_loss_fn
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import cosine_schedule as j_cosine
from repro.training import TrainState as JTrainState
from repro.training import init_train_state as j_init_train_state
from repro.training import make_eval_step as j_make_eval_step
from repro.training import make_train_step as j_make_train_step
from repro_torch import pytree
from repro_torch.checkpoint import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.configs.musicgen_medium import SMOKE_CONFIG as MUSICGEN
from repro_torch.configs.qwen3_0_6b import SMOKE_CONFIG
from repro_torch.convert import (
    params_from_numpy,
    tensor_from_numpy,
    train_state_from_numpy,
    tree_to_numpy,
)
from repro_torch.core import rng as trng
from repro_torch.data import SyntheticLM
from repro_torch.distributed.sharding import gather_tree, shard_tree
from repro_torch.launch.shardings import shard_batch, state_sharding
from repro_torch.models import ModelConfig
from repro_torch.models.layers import cross_entropy_loss
from repro_torch.models.transformer import loss_fn
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, cosine_schedule
from repro_torch.optim.adamw import AdamWState
from repro_torch.training import (
    TrainState,
    init_train_state,
    make_eval_step,
    make_train_step,
)

# `benchmarks/fig10_robustness.py:_train_tiny_lm`'s model and data.
TINY = dict(name="bench-lm", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            head_dim=16, d_ff=128, vocab_size=64, attn_chunk_q=32,
            attn_chunk_kv=32, remat=False)
DATA = dict(vocab_size=64, seq_len=64, global_batch=16, seed=3)
LR_PEAK = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs files side by side in worker processes.  The port's
    CPU paths are many small elementwise ops; with an OpenMP thread per
    core in every worker, this module's deploys and another module's
    stall one another.  Two threads here, restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _legacy():
    return jax.threefry_partitionable(False)


def tiny_cfgs():
    return (JModelConfig(dtype=jnp.float32, **TINY),
            ModelConfig(dtype=torch.float32, **TINY))


def _np(tree) -> list[np.ndarray]:
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _bits(a) -> np.ndarray:
    """A float array's bit pattern (bf16 compared through its uint16 bits)."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.fixture(scope="module")
def tiny_state():
    """The reference's initial `TrainState` for the tiny LM (numpy leaves)
    and the port's copy of it."""
    jcfg, _ = tiny_cfgs()
    with _legacy():
        st = j_init_train_state(jax.random.PRNGKey(0), jcfg,
                                JAdamWConfig(lr_peak=LR_PEAK))
    np_st = jax.tree.map(np.asarray, st)
    return np_st, train_state_from_numpy(np_st, device="cpu")


def _batch(step: int, data=DATA):
    with _legacy():
        jb = JSyntheticLM(**data).global_batch_at(step)._asdict()
    return jb, SyntheticLM(**data, device="cpu").global_batch_at(step)._asdict()


# ---------------------------------------------------------------- randint
@pytest.mark.parametrize("seed,shape,lo,hi", [
    (0, (8,), 0, 151936),            # qwen3-0.6b's vocabulary
    (3, (16, 64), 0, 16),            # a power-of-two span
    (5, (7, 3), -5, 1000003),        # a prime span, negative minval
    (6, (1000,), 0, 65537),          # span > 2^16: the multiplier's square wraps
    (4, (100,), 0, 7),
    (1, (5,), 4, 4),                 # maxval == minval
    (2, (9,), 10, 3),                # maxval < minval
    (9, (33,), -2**31, 2**31 - 1),   # the whole int32 range
    (11, (2, 3, 4), 100, 101),       # span 1
])
def test_randint_bitwise(seed, shape, lo, hi):
    with _legacy():
        want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, lo, hi))
    got = trng.randint(trng.PRNGKey(seed, device="cpu"), shape, lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_randint_rejects_bounds_outside_int32():
    with pytest.raises(ValueError):
        trng.randint(trng.PRNGKey(0, device="cpu"), (3,), 0, 2**31)


# ---------------------------------------------------------------- data
@pytest.mark.parametrize("data", [DATA, dict(vocab_size=151936, seq_len=32,
                                             global_batch=4, seed=0)],
                         ids=["fig10", "qwen3-vocab"])
@pytest.mark.parametrize("step", [0, 1, 10_000])
def test_synthetic_batches_bitwise(data, step):
    jb, tb = _batch(step, data)
    for name in ("tokens", "targets", "mask"):
        want, got = np.asarray(jb[name]), tb[name].numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_host_batch_and_iterate_bitwise():
    data = dict(vocab_size=50, seq_len=17, global_batch=6, seed=5)
    with _legacy():
        want = JSyntheticLM(**data).host_batch_at(3, 1, 3)
        it = JSyntheticLM(**data).iterate(7)
        want_it = [next(it) for _ in range(2)]
    port = SyntheticLM(**data, device="cpu")
    for a, b in zip(want, port.host_batch_at(3, 1, 3)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    it = port.iterate(7)
    for w in want_it:
        for a, b in zip(w, next(it)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    with pytest.raises(ValueError):
        port.host_batch_at(0, 0, 4)


def test_succ_table_is_the_reference_table():
    for data in (DATA, dict(vocab_size=1000, seq_len=4, global_batch=2, seed=77)):
        np.testing.assert_array_equal(
            SyntheticLM(**data, device="cpu")._succ_table(),
            JSyntheticLM(**data)._succ_table())


# ---------------------------------------------------------------- loss
def test_cross_entropy_loss_matches():
    rs = np.random.RandomState(0)
    logits = (rs.randn(3, 11, 97) * 4).astype(np.float32)
    targets = rs.randint(0, 97, (3, 11)).astype(np.int32)
    mask = (rs.rand(3, 11) < 0.7).astype(np.float32)
    for m in (mask, np.zeros_like(mask)):  # all-masked: max(sum, 1) guards
        want = float(j_ce(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(m)))
        got = float(cross_entropy_loss(torch.from_numpy(logits),
                                       torch.from_numpy(targets), torch.from_numpy(m)))
        np.testing.assert_allclose(got, want, rtol=1e-5)
    # bf16 logits are taken in float32
    lb = torch.from_numpy(logits).to(torch.bfloat16)
    want = float(j_ce(jnp.asarray(lb.float().numpy()).astype(jnp.bfloat16),
                      jnp.asarray(targets), jnp.asarray(mask)))
    got = float(cross_entropy_loss(lb, torch.from_numpy(targets), torch.from_numpy(mask)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("which", ["tiny", "qwen3-smoke"])
def test_loss_fn_matches_on_carried_params(which, tiny_state):
    if which == "tiny":
        jcfg, tcfg = tiny_cfgs()
        np_params = tiny_state[0].params
        jb, tb = _batch(2)
    else:
        jcfg = J_SMOKE.replace(dtype=jnp.float32)
        tcfg = SMOKE_CONFIG.replace(dtype=torch.float32)
        with _legacy():
            np_params = jax.tree.map(
                lambda a: np.asarray(a, np.float32),
                j_init_params(jax.random.PRNGKey(1), J_SMOKE))
        data = dict(vocab_size=tcfg.vocab_size, seq_len=24, global_batch=3, seed=2)
        jb, tb = _batch(0, data)
    with _legacy():
        jl, jm = j_loss_fn(jax.tree.map(jnp.asarray, np_params), jb, jcfg)
    tl, tm = loss_fn(params_from_numpy(np_params, device="cpu"), tb, tcfg)
    for k in ("loss", "ce", "router_aux"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


def test_loss_fn_rejects_what_is_not_ported(tiny_state):
    """A mesh, refused before the training half of ROADMAP.md A5 was
    ported, now gives the unsharded loss: on a (1, 1) mesh (gloo, a
    world of one) with params and batch stored as DTensors, bitwise.
    Multi-codebook heads, refused before the model families were ported,
    give the reference's loss on carried params: MusicGen's smoke
    config, (B, S, C) targets."""
    _, tcfg = tiny_cfgs()
    _, tb = _batch(0)
    params = tiny_state[1].params
    want, wm = loss_fn(params, tb, tcfg)
    with fam.one_rank_mesh() as mesh:
        sp = shard_tree(params, state_sharding(mesh, params, tcfg))
        got, gm = loss_fn(sp, shard_batch(mesh, tb, tb["tokens"].shape[0]), tcfg, mesh)
    assert float(got) == float(want)
    assert {k: float(v) for k, v in gm.items()} == {k: float(v) for k, v in wm.items()}
    jcfg, mcfg = J_MUSICGEN, MUSICGEN
    with _legacy():
        np_params = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(2), jcfg))
    rs = np.random.RandomState(4)
    b, s, c = 2, 12, mcfg.n_codebooks
    batch = {"embeds": rs.randn(b, s, mcfg.d_model).astype(np.float32),
             "cond": rs.randn(b, mcfg.cross_kv_len, mcfg.cross_d_cond).astype(np.float32),
             "targets": rs.randint(0, mcfg.vocab_size, (b, s, c)).astype(np.int32),
             "mask": (rs.rand(b, s) < 0.8).astype(np.float32)}
    with _legacy():
        jl, jm = j_loss_fn(jax.tree.map(jnp.asarray, np_params),
                           {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    tl, tm = loss_fn(params_from_numpy(np_params, device="cpu"),
                     {k: torch.from_numpy(v) for k, v in batch.items()}, mcfg)
    for k in ("loss", "ce", "router_aux"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def test_grads_match_per_leaf(tiny_state):
    from repro_torch.training import _grads_of

    jcfg, tcfg = tiny_cfgs()
    np_st, t_st = tiny_state
    jb, tb = _batch(0)
    with _legacy():
        (jl, _), jg = jax.value_and_grad(
            lambda p: j_loss_fn(p, jb, jcfg), has_aux=True)(
                jax.tree.map(jnp.asarray, np_st.params))
    (tl, _), tg = _grads_of(t_st.params, tb, tcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    tflat = pytree.leaves_with_path(tg)
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == [k for k, _ in tflat]
    for (path, a), (_, b) in zip(jflat, tflat):
        a = np.asarray(a)
        err = np.abs(b.numpy() - a).max() / np.abs(a).max()
        assert err <= 1e-4, (jax.tree_util.keystr(path), err)


# ---------------------------------------------------------------- schedule
@pytest.mark.parametrize("peak,warmup,total", [(3e-4, 3, 30), (1e-2, 22, 220),
                                               (1e-3, 500, 10000), (1e-2, 0, 5)])
def test_cosine_schedule_matches(peak, warmup, total):
    steps = np.arange(total + 6)
    want = np.asarray(j_cosine(jnp.asarray(steps), peak, warmup, total))
    got = cosine_schedule(torch.from_numpy(steps), peak, warmup, total)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-7 * peak)
    # a Python int step gives the same value as the tensor's element
    assert float(cosine_schedule(int(steps[-1]), peak, warmup, total)) == float(got[-1])


# ---------------------------------------------------------------- AdamW
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_fed_reference_grads(dtype, tiny_state):
    jcfg, tcfg = tiny_cfgs()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    np_st = tiny_state[0]
    with _legacy():
        params = jax.tree.map(lambda a: jnp.asarray(a, jdt), np_st.params)
        jb, tb = _batch(0)
        jg = jax.grad(lambda p: j_loss_fn(p, jb, jcfg.replace(dtype=jdt))[0])(params)
        jopt = JAdamWConfig(lr_peak=LR_PEAK, state_dtype=jdt)
        jstate = j_adamw_init(params, jopt)
        # two steps from the same grads: the second has nonzero moments
        p1, s1, _ = j_adamw_update(jg, jstate, params, jopt, jnp.float32(3e-3))
        p2, s2, jmet = j_adamw_update(jg, s1, p1, jopt, jnp.float32(5e-3))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    tgrads = params_from_numpy(jax.tree.map(np.asarray, jg), device="cpu")
    topt = AdamWConfig(lr_peak=LR_PEAK, state_dtype=tdt)
    tstate = adamw_init(tparams, topt)
    assert tstate.step.dtype == torch.int32 and int(tstate.step) == 0
    q1, r1, _ = adamw_update(tgrads, tstate, tparams, topt, torch.tensor(3e-3))
    q2, r2, tmet = adamw_update(tgrads, r1, q1, topt, torch.tensor(5e-3))
    assert int(r2.step) == int(s2.step) == 2
    for k in ("grad_norm", "clip_scale"):  # float32 sums in another order
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5)
    rtol = 1e-6 if dtype == "float32" else 2.0 ** -7
    for name, want, got in (("params", p2, q2), ("m", s2.m, r2.m), ("v", s2.v, r2.v)):
        for a, b in zip(_np(want), pytree.leaves(got)):
            assert b.dtype == tdt, name
            np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32),
                                       rtol=rtol, atol=1e-9, err_msg=name)


# ---------------------------------------------------------------- train steps
@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_steps_match(grad_accum, tiny_state):
    jcfg, tcfg = tiny_cfgs()
    np_st, t_st = tiny_state
    with _legacy():
        opt = JAdamWConfig(lr_peak=LR_PEAK)
        step = jax.jit(j_make_train_step(jcfg, opt, total_steps=20,
                                         grad_accum=grad_accum))
        grad = jax.jit(jax.grad(lambda p, b: j_loss_fn(p, b, jcfg)[0]))
        st = jax.tree.map(jnp.asarray, np_st)
        st = JTrainState(st.params, st.opt)
        jl, held = [], None
        for i in range(5):
            b = JSyntheticLM(**DATA).global_batch_at(i)._asdict()
            g = grad(st.params, b)
            big = [np.abs(np.asarray(x)) > 1e-4 * np.abs(np.asarray(x)).max()
                   for x in jax.tree.leaves(g)]
            held = big if held is None else [h & n for h, n in zip(held, big)]
            st, m = step(st, b)
            jl.append(float(m["loss"]))
    tstep = make_train_step(tcfg, AdamWConfig(lr_peak=LR_PEAK), total_steps=20,
                            grad_accum=grad_accum)
    data = SyntheticLM(**DATA, device="cpu")
    t, tl = t_st, []
    for i in range(5):
        t, m = tstep(t, data.global_batch_at(i)._asdict())
        tl.append(float(m["loss"]))
        assert set(m) == {"loss", "ce", "router_aux", "grad_norm", "clip_scale", "lr"}
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5)
    assert int(t.opt.step) == 5
    for a, b, h in zip(_np(st.params), pytree.leaves(t.params), held):
        assert h.mean() > 0.9
        np.testing.assert_allclose(b.numpy()[h], a[h], rtol=0, atol=5e-4)
    # the functional step left the state it was given untouched
    for a, b in zip(pytree.leaves(np_st.params), pytree.leaves(t_st.params)):
        np.testing.assert_array_equal(b.numpy(), a)


def test_train_step_takes_a_schedule_and_refuses_a_mesh(tiny_state):
    """The schedule is called with the step from 1, single-device and on
    a (1, 1) mesh (a gloo world of one).  A mesh was refused before the
    training half of ROADMAP.md A5 was ported; the sharded step now
    refuses what it cannot shard: a state or a batch not stored as
    DTensors."""
    _, tcfg = tiny_cfgs()
    _, tb = _batch(0)
    seen = []
    schedule = lambda s: seen.append(int(s)) or torch.tensor(0.0)  # noqa: E731
    step = make_train_step(tcfg, AdamWConfig(), schedule=schedule)
    new, m = step(tiny_state[1], tb)
    assert seen == [1] and float(m["lr"]) == 0.0
    # lr 0: only the moments and the step move
    for a, b in zip(pytree.leaves(tiny_state[1].params), pytree.leaves(new.params)):
        assert torch.equal(a, b)
    rows = tb["tokens"].shape[0]
    with fam.one_rank_mesh() as mesh:
        mstep = make_train_step(tcfg, AdamWConfig(), mesh=mesh, schedule=schedule)
        sharded = shard_tree(tiny_state[1], state_sharding(mesh, tiny_state[1], tcfg))
        with pytest.raises(TypeError, match="state_sharding"):
            mstep(tiny_state[1], shard_batch(mesh, tb, rows))
        with pytest.raises(TypeError, match="shard_batch"):
            mstep(sharded, tb)
        new_m, m_m = mstep(sharded, shard_batch(mesh, tb, rows))
        assert seen == [1, 1] and float(m_m["lr"]) == 0.0
        # the moments as the plain step's (scatter-adds sum in thread order)
        for a, b in zip(pytree.leaves(new.opt), pytree.leaves(gather_tree(new_m.opt))):
            assert torch.allclose(b.float(), a.float(), rtol=0,
                                  atol=1e-5 * float(a.float().abs().max()))
    with pytest.raises(ValueError):
        make_train_step(tcfg, AdamWConfig(), grad_accum=3)(tiny_state[1], tb)


def test_eval_step_matches(tiny_state):
    jcfg, tcfg = tiny_cfgs()
    jb, tb = _batch(10_000)
    with _legacy():
        want = j_make_eval_step(jcfg)(jax.tree.map(jnp.asarray, tiny_state[0].params), jb)
    got = make_eval_step(tcfg)(tiny_state[1].params, tb)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-7)
        assert not got[k].requires_grad


def test_init_train_state_layout():
    _, tcfg = tiny_cfgs()
    st = init_train_state(0, tcfg, AdamWConfig(), device="cpu")
    assert isinstance(st, TrainState)
    keys = [k for k, _ in pytree.leaves_with_path(st)]
    assert keys[0].startswith(".params[") and ".opt.step" in keys
    for p, m in zip(pytree.leaves(st.params), pytree.leaves(st.opt.m)):
        assert m.shape == p.shape and m.dtype == torch.float32 and not m.any()


# ---------------------------------------------------------------- checkpoints
@pytest.fixture(scope="module")
def smoke_train_state():
    """A reference `TrainState` with bf16 params, float32 moments and an
    int32 step, one AdamW step in (nonzero moments)."""
    with _legacy():
        params = j_init_params(jax.random.PRNGKey(2), J_SMOKE)
        opt = JAdamWConfig()
        st = j_adamw_init(params, opt)
        g = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
        params, st, _ = j_adamw_update(g, st, params, opt, jnp.float32(1e-3))
    return JTrainState(params, st)


def _assert_trees_bitwise(jax_tree, torch_tree):
    jflat = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    tflat = pytree.leaves_with_path(torch_tree)
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == [k for k, _ in tflat]
    for (path, a), (_, b) in zip(jflat, tflat):
        a = np.asarray(a)
        assert str(b.dtype).removeprefix("torch.") == a.dtype.name, path
        assert tuple(b.shape) == a.shape, path
        bits = (b.view(torch.int16).numpy().view(np.uint16)
                if b.dtype == torch.bfloat16 else b.numpy())
        np.testing.assert_array_equal(bits, _bits(a), err_msg=jax.tree_util.keystr(path))


def test_jax_writes_port_restores_bitwise(tmp_path, smoke_train_state):
    j_save(str(tmp_path), 7, smoke_train_state)
    template = train_state_from_numpy(
        jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), smoke_train_state),
        device="cpu")
    assert latest_step(str(tmp_path)) == 7
    step, restored = restore_checkpoint(str(tmp_path), template=template, device="cpu")
    assert step == 7 and isinstance(restored, TrainState)
    _assert_trees_bitwise(smoke_train_state, restored)
    # without a template: the flat {keystr: tensor} view, in manifest dtypes
    _, flat = restore_checkpoint(str(tmp_path), 7, device="cpu")
    want = {jax.tree_util.keystr(p): a for p, a in
            jax.tree_util.tree_flatten_with_path(smoke_train_state)[0]}
    assert set(flat) == set(want)
    for k, t in flat.items():
        assert str(t.dtype).removeprefix("torch.") == np.asarray(want[k]).dtype.name
        assert tuple(t.shape) == np.shape(want[k]), k


def test_port_writes_jax_restores_bitwise(tmp_path, smoke_train_state):
    port_state = train_state_from_numpy(jax.tree.map(np.asarray, smoke_train_state),
                                        device="cpu")
    path = save_checkpoint(str(tmp_path), 12, port_state)
    assert pathlib.Path(path).name == "step_00000012"
    template = jax.tree.map(jnp.zeros_like, smoke_train_state)
    step, restored = j_restore(str(tmp_path), template=template)
    assert step == 12
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(smoke_train_state)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))
    # the two packages write the same manifest
    other = tmp_path / "jax"
    j_save(str(other), 12, smoke_train_state)
    import json
    mine = json.loads((tmp_path / "step_00000012" / "manifest.json").read_text())
    theirs = json.loads((other / "step_00000012" / "manifest.json").read_text())
    assert mine == theirs


def test_checkpoint_manager_keep_latest_and_async(tmp_path):
    d = str(tmp_path / "ckpt")
    mgr = CheckpointManager(d, keep=2)
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    tree = {"w": x, "b": torch.ones(3, dtype=torch.bfloat16)}
    mgr.save(1, tree)
    mgr.save(2, tree, blocking=False)
    # the save's consistency point is the call: a later in-place write to
    # the live tree does not reach step 3's files
    mgr.save(3, tree, blocking=False)
    x.add_(100.0)
    mgr.save(4, {"w": x, "b": tree["b"]}, blocking=False)
    mgr.wait()
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]
    os.makedirs(os.path.join(d, "step_00000009.tmp"))   # a crashed save
    os.makedirs(os.path.join(d, "step_00000008"))       # no manifest yet
    assert latest_step(d) == 4
    step, got = mgr.restore_latest(template={"w": torch.zeros(2, 3),
                                             "b": torch.zeros(3, dtype=torch.bfloat16)},
                                   device="cpu")
    assert step == 4 and torch.equal(got["w"], x) and got["b"].dtype == torch.bfloat16
    _, got3 = restore_checkpoint(d, 3, device="cpu")
    assert torch.equal(got3["['w']"], x - 100.0)
    assert latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "empty_dir_absent"), device="cpu")
    with pytest.raises(KeyError):
        restore_checkpoint(d, 4, template={"missing": torch.zeros(1)}, device="cpu")


def test_checkpoint_manager_reraises_a_failed_background_save(tmp_path):
    d = tmp_path / "ckpt"
    mgr = CheckpointManager(str(d), keep=1)
    d.rmdir()
    d.write_text("not a directory")
    mgr.save(1, {"w": torch.zeros(2)}, blocking=False)
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()  # the error is raised once


@pytest.mark.parametrize("a", [np.float32(1.5), np.asarray(7, np.int32),
                               np.zeros((0, 3), np.float32),
                               np.asarray(jnp.asarray(2.5, jnp.bfloat16)),
                               np.asarray(jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3).T)],
                         ids=["f32-0d", "int32-0d", "empty", "bf16-0d", "bf16-transposed"])
def test_tensor_from_numpy_keeps_shape_and_bits(a):
    """A 0-d leaf (`AdamWState.step`) stays 0-d; values and dtypes carry."""
    t = tensor_from_numpy(a, device="cpu")
    assert tuple(t.shape) == np.shape(a) and t.is_contiguous()
    back = tree_to_numpy(t)
    np.testing.assert_array_equal(back, np.asarray(a).astype(back.dtype))


def test_train_state_carriers_round_trip(tiny_state, smoke_train_state):
    """`train_state_from_numpy` then `tree_to_numpy` gives back the
    reference's arrays bitwise (bf16 as its exact float32 widening)."""
    back = tree_to_numpy(train_state_from_numpy(
        jax.tree.map(np.asarray, smoke_train_state), device="cpu"))
    assert isinstance(back, TrainState)
    for a, b in zip(jax.tree.leaves(smoke_train_state), pytree.leaves(back)):
        a = np.asarray(a)
        assert b.shape == a.shape
        if a.dtype.name == "bfloat16":
            assert b.dtype == np.float32
            np.testing.assert_array_equal(b, a.astype(np.float32))
        else:
            assert b.dtype == a.dtype
            np.testing.assert_array_equal(b, a)
    # and into the reference: a jitted reference step runs on it
    jcfg, _ = tiny_cfgs()
    np_st = tree_to_numpy(tiny_state[1])
    with _legacy():
        st = JTrainState(jax.tree.map(jnp.asarray, np_st.params),
                         jax.tree.map(jnp.asarray, type(tiny_state[0].opt)(*np_st.opt)))
        new, m = j_make_train_step(jcfg, JAdamWConfig(lr_peak=LR_PEAK))(
            st, _batch(0)[0])
    assert np.isfinite(float(m["loss"])) and int(new.opt.step) == 1


# ------------------------------------------------------- the one tree walker
def _walk_trees():
    """A parameter tree, and a tree of dicts, lists, tuples, named tuples,
    non-tensor leaves and an empty (None) subtree."""
    with _legacy():
        st = j_init_train_state(jax.random.PRNGKey(0), tiny_cfgs()[0], JAdamWConfig())
    params = train_state_from_numpy(jax.tree.map(np.asarray, st), device="cpu").params
    mixed = {"z": [torch.arange(3.0), (torch.ones(2, 2, dtype=torch.bfloat16), 7)],
             "a": AdamWState(torch.tensor(3, dtype=torch.int32), {"w": torch.zeros(4)},
                             None),
             "m": np.float32(2.5)}
    return {"params": params, "mixed": mixed}


@pytest.mark.parametrize("which", ["params", "mixed"])
def test_tree_walk_paths_are_the_reference_keystr(which):
    """`pytree.leaves_with_path`, which `programmer.flatten_with_names`
    and `obs.metrics.fetch` walk through, names and orders leaves as
    `jax.tree_util` does (named tuple fields as ``.name``, None empty)."""
    from repro_torch.core.programmer import flatten_with_names

    tree = _walk_trees()[which]
    jtree = pytree.tree_map(lambda x: np.asarray(x.float() if isinstance(x, torch.Tensor)
                                                 else x), tree)
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    got = pytree.leaves_with_path(tree)
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == [k for k, _ in got]
    assert [(k, id(v)) for k, v in flatten_with_names(tree)] == [(k, id(v)) for k, v in got]


@pytest.mark.parametrize("which", ["params", "mixed"])
def test_metrics_fetch_keeps_the_tree(which):
    """`obs.metrics.fetch` through the shared walker: every tensor comes
    back as float32 numpy with its values, other leaves as they were, the
    structure (named tuples, the caller's key order) kept."""
    from repro_torch.obs import metrics

    tree = _walk_trees()[which]
    got = metrics.fetch(tree)
    assert type(got) is type(tree) and list(got) == list(tree)
    flat_in, flat_out = pytree.leaves_with_path(tree), pytree.leaves_with_path(got)
    assert [k for k, _ in flat_in] == [k for k, _ in flat_out]
    for (k, a), (_, b) in zip(flat_in, flat_out):
        if isinstance(a, torch.Tensor):
            assert isinstance(b, np.ndarray) and b.dtype == np.float32, k
            np.testing.assert_array_equal(b, a.float().numpy(), err_msg=k)
        else:
            assert b is a, k
    if which == "mixed":
        assert isinstance(got["a"], AdamWState) and got["a"].v is None
        assert isinstance(got["z"][1], tuple) and got["z"][1][1] == 7
