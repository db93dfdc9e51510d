"""Shared checks of the port's model families against the JAX package.

Imported by `test_torch_moe.py`, `test_torch_rwkv.py`,
`test_torch_hymba.py` and `test_torch_cross.py` (not collected itself).
Each check carries the reference's params across with
`params_from_numpy`, feeds both packages the same numpy inputs (drawn
from a `RandomState` seed) and holds the port's outputs against the
reference's.  Every JAX random call runs inside a scoped
``jax.threefry_partitionable(False)`` block.

Tolerances (float32 configs):
* logits, aux losses and caches: ``max |port - ref| <= TOL * max |ref|``
  with TOL = 2e-5 (float32 sums taken in another order; XLA's exp,
  rsqrt, sin and cos an ulp off PyTorch's; the SSM prefix scan
  associates its products in another order; measured <= 4.6e-6);
* losses: rtol 1e-5;
* one train step: the step's metrics within rtol 1e-4 (the gradient
  norm sums float32 squares in another order; measured ~1e-6); the
  AdamW moments within 1e-4 of each leaf's largest; the new params
  within 1e-6 wherever the reference's gradient exceeds 1e-3 of its
  leaf's largest (Adam's first step is nearly ``lr * sign(g)``, so an
  element whose gradient sits at the float32 noise of the two sums may
  move the other way; elsewhere the steps agree to ~1e-9);
* greedy generation: tokens equal.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import init_params as j_init_params
from repro.models.config import ModelConfig as JModelConfig
from repro.models.decoding import decode_step as j_decode_step
from repro.models.decoding import prefill as j_prefill
from repro.models.transformer import forward as j_forward
from repro.models.transformer import loss_fn as j_loss_fn
from repro.optim import AdamWConfig as JAdamWConfig
from repro.serving import ServeEngine as JServeEngine
from repro.training import init_train_state as j_init_train_state
from repro.training import make_train_step as j_make_train_step
from repro_torch import configs, pytree
from repro_torch.convert import params_from_numpy, train_state_from_numpy
from repro_torch.models import ModelConfig, decode_step, forward, init_params, prefill
from repro_torch.models.transformer import loss_fn
from repro_torch.optim import AdamWConfig
from repro_torch.serving import ServeEngine
from repro_torch.training import make_train_step

TOL = 2e-5
LOSS_RTOL = 1e-5
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def legacy():
    return jax.threefry_partitionable(False)


@contextlib.contextmanager
def one_rank_mesh():
    """A (1, 1) ("data", "model") mesh over a gloo world of one in this
    process, torn down on exit (no process group is left behind)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_debug_mesh

    started = init_distributed("cpu")
    try:
        yield make_debug_mesh(1, 1, device="cpu")
    finally:
        if started:
            dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def jitted(fn, cfg, **static):
    """``jax.jit`` of ``fn(*args, cfg, **static)``, one per (fn, cfg,
    static): the reference's eager calls compile op by op, which takes
    longer than one compile of the whole function."""
    return jax.jit(lambda *args: fn(*args, cfg, **static))


def port_cfg(jcfg: JModelConfig) -> ModelConfig:
    """The port's `ModelConfig` with the reference's fields."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    for name in ("dtype", "opt_state_dtype"):
        kw[name] = _TORCH_DTYPES[np.dtype(kw[name]).name]
    return ModelConfig(**kw)


def smoke_pair(arch: str):
    return jconfigs.get_smoke_config(arch), configs.get_smoke_config(arch)


def rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


def carried(jcfg: JModelConfig, seed: int = 0, gate: float | None = None):
    """The reference's params as numpy (cross gates set to `gate`)."""
    with legacy():
        params = j_init_params(jax.random.PRNGKey(seed), jcfg)
    params = jax.tree.map(np.asarray, params)
    if gate is not None and "cross_layers" in params:
        params["cross_layers"]["gate"] = np.full_like(params["cross_layers"]["gate"], gate)
    return params


def make_batch(cfg, b: int, s: int, seed: int, labels: bool = False) -> dict:
    rs = np.random.RandomState(seed)
    batch = {}
    if cfg.frontend == "embed_stub":
        batch["embeds"] = rs.randn(b, s, cfg.d_model).astype(np.float32)
    else:
        batch["tokens"] = rs.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)
    if cfg.cross_kv_len:
        batch["cond"] = rs.randn(b, cfg.cross_kv_len, cfg.cross_d_cond).astype(np.float32)
    if labels:
        tshape = (b, s, cfg.n_codebooks) if cfg.n_codebooks > 1 else (b, s)
        batch["targets"] = rs.randint(0, cfg.vocab_size, tshape).astype(np.int32)
        batch["mask"] = (rs.rand(b, s) < 0.8).astype(np.float32)
    return batch


def to_jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _step(batch: dict, sl: slice) -> dict:
    return {k: (v[:, sl] if k in ("tokens", "embeds") else v) for k, v in batch.items()}


def check_tree(jcfg, tcfg) -> None:
    """`init_params`: the reference's key paths, shapes and dtypes."""
    want = jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0), jcfg))
    flat, _ = jax.tree_util.tree_flatten_with_path(want)
    got = pytree.leaves_with_path(init_params(0, tcfg, device="cpu"))
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in flat]
    for (path, w), (_, g) in zip(flat, got):
        assert tuple(g.shape) == tuple(w.shape), jax.tree_util.keystr(path)
        assert str(g.dtype).removeprefix("torch.") == np.dtype(w.dtype).name, \
            jax.tree_util.keystr(path)


def check_forward(jcfg, tcfg, params: dict, batch: dict) -> torch.Tensor:
    """`forward` logits and aux; returns the port's logits."""
    want, jaux, _ = jitted(j_forward, jcfg)(jax.tree.map(jnp.asarray, params), to_jax(batch))
    got, aux, _ = forward(params_from_numpy(params, device="cpu"), to_torch(batch), tcfg)
    assert tuple(got.shape) == tuple(want.shape)
    assert rel(got, want) <= TOL, rel(got, want)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL, atol=1e-7)
    return got


def check_decode(jcfg, tcfg, params: dict, batch: dict, n_prompt: int,
                 max_len: int | None) -> list[float]:
    """`prefill` of the first `n_prompt` positions, then one
    `decode_step` per remaining position: last logits, every step's
    logits and the final cache.  Returns each step's error."""
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_numpy(params, device="cpu")
    pre = _step(batch, slice(0, n_prompt))
    jlast, jcache = jitted(j_prefill, jcfg, max_len=max_len)(jp, to_jax(pre))
    tlast, tcache = prefill(tp, to_torch(pre), tcfg, max_len=max_len)
    assert rel(tlast, jlast) <= TOL
    errs = []
    s = next(v for k, v in batch.items() if k in ("tokens", "embeds")).shape[1]
    step = jitted(j_decode_step, jcfg)
    for t in range(n_prompt, s):
        one = _step(batch, slice(t, t + 1))
        want, jcache = step(jp, jcache, to_jax(one))
        got, tcache = decode_step(tp, tcache, to_torch(one), tcfg)
        assert tuple(got.shape) == tuple(want.shape)
        errs.append(rel(got, want))
        assert errs[-1] <= TOL, (t, errs[-1])
    assert sorted(tcache) == sorted(jcache)
    for name, leaf in jcache.items():
        got = tcache[name]
        assert tuple(got.shape) == tuple(leaf.shape), name
        assert str(got.dtype).removeprefix("torch.") == np.dtype(leaf.dtype).name, name
        if name == "pos":
            np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))
        else:
            assert rel(got, leaf) <= 5 * TOL, (name, rel(got, leaf))
    return errs


def check_loss(jcfg, tcfg, params: dict, batch: dict) -> None:
    jl, jm = jitted(j_loss_fn, jcfg)(jax.tree.map(jnp.asarray, params), to_jax(batch))
    tl, tm = loss_fn(params_from_numpy(params, device="cpu"), to_torch(batch), tcfg)
    for k in ("loss", "ce", "router_aux"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=k)


def check_train_step(jcfg, tcfg, batch: dict, lr: float = 1e-3) -> None:
    """One AdamW step from the reference's initial `TrainState`."""
    with legacy():
        opt = JAdamWConfig(lr_peak=lr)
        st = j_init_train_state(jax.random.PRNGKey(0), jcfg, opt)
        st2, jm = jax.jit(j_make_train_step(jcfg, opt, total_steps=10))(st, to_jax(batch))
    np_st = jax.tree.map(np.asarray, st)
    t_st = train_state_from_numpy(np_st, device="cpu")
    t2, tm = make_train_step(tcfg, AdamWConfig(lr_peak=lr), total_steps=10)(
        t_st, to_torch(batch))
    for k in ("loss", "ce", "router_aux", "grad_norm", "clip_scale", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    assert int(t2.opt.step) == int(st2.opt.step) == 1
    b1 = JAdamWConfig().betas[0]
    held_any = False
    for (path, m), g_m, g_v, g_p, w_v, w_p in zip(
            jax.tree_util.tree_flatten_with_path(st2.opt.m)[0],
            pytree.leaves(t2.opt.m), pytree.leaves(t2.opt.v), pytree.leaves(t2.params),
            jax.tree.leaves(st2.opt.v), jax.tree.leaves(st2.params)):
        name = jax.tree_util.keystr(path)
        m = np.asarray(m, np.float32)
        for got, want in ((g_m, m), (g_v, w_v)):
            want = np.asarray(want, np.float32)
            err = np.max(np.abs(got.float().numpy() - want))
            assert err <= 1e-4 * np.max(np.abs(want)) + 1e-30, name
        grad = np.abs(m / (1.0 - b1))
        held = grad > 1e-3 * grad.max()
        held_any |= bool(held.any())
        np.testing.assert_allclose(g_p.float().numpy()[held], np.asarray(w_p, np.float32)[held],
                                   rtol=0, atol=1e-6, err_msg=name)
    assert held_any


def check_generate(jcfg, tcfg, params: dict, tokens: np.ndarray, max_new: int) -> None:
    """Greedy `ServeEngine.generate` (prefill with ``max_len = None``,
    ROADMAP.md C4): tokens equal."""
    with legacy():
        want = JServeEngine(jcfg, jax.tree.map(jnp.asarray, params)).generate(
            jnp.asarray(tokens), max_new)
    got = ServeEngine(tcfg, params_from_numpy(params, device="cpu")).generate(
        torch.from_numpy(tokens), max_new)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
