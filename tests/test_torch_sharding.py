"""The port's training on a device mesh against the JAX package.

(a) Layout: the specs of `launch.shardings` (`param_rules`,
    `state_sharding`, `batch_sharding`, `cache_sharding`) on the
    reference's (2, 4) ("data", "model") and (2, 2, 2) ("pod", "data",
    "model") meshes, for every registry architecture's smoke train state,
    its train batch (256 rows, and 3, which no axis divides) and its
    decode cache (batch 8 and 3).  The JAX side runs in a subprocess with
    8 forced host devices, as the reference's own multi-device tests do,
    and prints its specs; the port's side takes an `AbstractMesh` of the
    same shape.  Equal specs, path for path.
(b) Arithmetic across ranks: one job of 8 gloo ranks on the CPU
    (`torch.multiprocessing`, spawn; `tests/torch_mesh_worker.py`),
    meeting through a `FileStore` under `tmp_path`, with a timeout on
    every process group and a deadline on the job:
    * `moe_block(mesh=)` on a (2, 4) mesh (rows over "data", experts EP
      over "model") equals the reference's `moe_block(mesh=None)` within
      rtol 2e-3 / atol 2e-3 (`test_sharding_multidevice.py`'s
      tolerance); its aux loss is the mean of the two row blocks' (rtol
      1e-5);
    * expert-parallel gradients of `loss_fn(mesh=)`, summed over the
      batch axis, equal single-rank autograd of the same objective
      within 1e-4 of each leaf's largest (float32; an expert stack's
      rank holds its own experts);
    * the sharded train step equals the reference's single-device
      `make_train_step` step (loss within 1e-4; params within rtol 2e-3
      / atol 2e-4, `test_sharding_multidevice.py`'s tolerances) and the
      port's own single-device step (the same, and the gradient norm
      within rtol 1e-5);
    * every rank's stored blocks have the shapes their specs say and are
      the blocks of the full tensors that JAX's layout puts there;
    * elastic restore onto a (4, 2) mesh holds within rtol 1e-6;
    * the collectives of that train step, counted by
      `launch.roofline.WorkCounter` (result bytes and calls per op type,
      bytes per mesh axis), equal on every rank the count of the same
      step run with meta tensors on an `AbstractMesh((2, 4))`, the
      dry run's way;
    * with ``grad_accum=2`` (the reference's microbatches) the same
      against both single-device steps; the sharded eval step's metrics
      within rtol 1e-5 of the plain one's;
    * every registry smoke config's `loss_fn(mesh=)` (float32, MoE
      capacity lifted) equals the unsharded CE of the batch and the mean
      of the row blocks' aux losses (the reference's value under
      `shard_map`) within rtol 1e-5, and `forward(mesh=)`'s DTensor
      logits gathered equal the unsharded logits within 1e-5 of the
      largest;
    * `compressed_psum` over "pod" on a (2, 2, 2) mesh: first-round error
      < 2e-2, bias after 100 rounds < 2e-3, and every all-reduce payload
      on the pod group int32 (a spy on `torch.distributed.all_reduce`).
(c) Deploy and serve on a mesh, in the same job, each held bitwise
    against the port's unsharded run (the reference's own mesh deploy
    crashes, ROADMAP.md C2; the unsharded port deploy is held against
    the JAX deploy in `tests/test_torch_deploy.py`):
    * `deploy_arrays(mesh=)` on an (8,) column mesh with faults and on
      the (2, 4) mesh: conductances, d2d, fault maps, every report field
      and the health tree, with one host fetch; the column axis split
      over "data" alone (`mesh_axes`), and a bucket no extent divides;
    * `launch/program.py` on the 8 ranks against its ``--baseline``;
    * `CIMExecutor(mesh=)` + `ServeEngine(mesh=)` with read noise on:
      tokens and prefill logits;
    * `ContinuousScheduler(batch_mesh=make_debug_mesh(4, 2))` on the
      reference's `_SHARD_SCRIPT` stream, digital and analog: tokens,
      one host sync per decode step, `trace_counts` flat after warmup;
      the digital tokens are also held against the reference's own
      (4, 2) mesh run of that stream (JAX in a subprocess with 8 forced
      devices, run before the job): equal up to the first token
      whose JAX-side top-2 margin is within `2 * atol / T`, as
      `tests/test_torch_scheduler.py` holds the unsharded scheduler;
    * every registry family's `forward(mesh=, collect_cache=True)`,
      prefill and two decode steps at 4 rows a rank; at one row a rank, the CPU BLAS rounds a one-row product
      unlike the same row of a larger one (a dense config's logits within
      1e-5 of the largest, argmax equal).
(d) A job whose rank dies fails within its deadline instead of hanging.
"""

import json
import os
import pickle
import re
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp_mp

import torch_mesh_worker as worker
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import ModelConfig as JModelConfig
from repro.models import init_params as j_init_params
from repro.models.moe import init_moe_params as j_init_moe_params
from repro.models.moe import moe_block as j_moe_block
from repro.optim import AdamWConfig as JAdamWConfig
from repro.training import init_train_state as j_init_train_state
from repro.training import make_train_step as j_make_train_step
from repro_torch import pytree
from repro_torch.configs import ARCHS, ShapeSpec, get_smoke_config, input_specs
from repro_torch.distributed.sharding import shard_tree
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.launch.shardings import (
    batch_sharding,
    cache_sharding,
    param_rules,
    shard_batch,
    state_sharding,
)
from repro_torch.models import ModelConfig
from repro_torch.models.decoding import init_cache
from repro_torch.optim import AdamWConfig
from repro_torch.training import init_train_state, make_train_step

from test_torch_scheduler import DIGITAL_ATOL, _assert_tokens_follow

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
JOB_DEADLINE_S = 400


def _legacy():
    return jax.threefry_partitionable(False)


# ------------------------------------------------------------------ (a)
SPEC_SCRIPT = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, jax
    from repro.configs import ARCHS, get_smoke_config
    from repro.configs.registry import ShapeSpec, input_specs
    from repro.launch.mesh import make_debug_mesh
    from repro.launch.shardings import (batch_sharding, cache_sharding, param_rules,
                                        state_sharding)
    from repro.models.decoding import init_cache
    from repro.optim import AdamWConfig
    from repro.training import init_train_state

    def spec(s):
        return [list(e) if isinstance(e, tuple) else e for e in s]

    def specs(tree):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        return {jax.tree_util.keystr(p): spec(s.spec) for p, s in flat}

    out = {}
    for name, mesh in (("2x4", make_debug_mesh(2, 4)),
                       ("2x2x2", make_debug_mesh(2, 2, pods=2))):
        for arch in ARCHS:
            cfg = get_smoke_config(arch)
            opt = AdamWConfig(state_dtype=cfg.opt_state_dtype)
            key = jax.random.PRNGKey(0)
            state = jax.eval_shape(lambda: init_train_state(key, cfg, opt))
            rules = param_rules(cfg)
            flat, _ = jax.tree_util.tree_flatten_with_path(state.params)
            paths = [jax.tree_util.keystr(p) for p, _ in flat]
            rec = {"rules": {p: spec(rules.spec(p)) for p in paths},
                   "state": specs(state_sharding(mesh, state, cfg))}
            for b in (256, 3):
                batch = input_specs(cfg, ShapeSpec("t", "train", 64, b))["batch"]
                rec[f"batch{b}"] = specs(batch_sharding(mesh, batch, b))
            for b in (8, 3):
                cache = jax.eval_shape(lambda: init_cache(cfg, b, 64))
                rec[f"cache{b}"] = specs(cache_sharding(mesh, cache, cfg, b))
            out[f"{name}/{arch}"] = rec
    print("SPECS " + json.dumps(out))
    """
)

MESHES = {"2x4": AbstractMesh((2, 4), ("data", "model")),
          "2x2x2": AbstractMesh((2, 2, 2), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def ref_specs():
    res = subprocess.run([sys.executable, "-c", SPEC_SCRIPT], capture_output=True,
                         text=True, cwd=ROOT, timeout=300,
                         env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    line = next(x for x in res.stdout.splitlines() if x.startswith("SPECS "))
    return json.loads(line[len("SPECS "):])


def _spec(s):
    return [list(e) if isinstance(e, tuple) else e for e in s]


def _specs(tree):
    return {path: _spec(s.spec) for path, s in pytree.leaves_with_path(tree)}


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_specs_match_reference(mesh_name, arch, ref_specs):
    mesh = MESHES[mesh_name]
    cfg = get_smoke_config(arch)
    state = init_train_state(0, cfg, AdamWConfig(state_dtype=cfg.opt_state_dtype),
                             device="cpu")
    rules = param_rules(cfg)
    got = {"rules": {p: _spec(rules.spec(p)) for p, _ in
                     pytree.leaves_with_path(state.params)},
           "state": _specs(state_sharding(mesh, state, cfg))}
    for b in (256, 3):
        batch = input_specs(cfg, ShapeSpec("t", "train", 64, b))["batch"]
        got[f"batch{b}"] = _specs(batch_sharding(mesh, batch, b))
    for b in (8, 3):
        cache = init_cache(cfg, b, 64, device="meta")
        got[f"cache{b}"] = _specs(cache_sharding(mesh, cache, cfg, b))
    want = ref_specs[f"{mesh_name}/{arch}"]
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k


# The reference's `_SHARD_SCRIPT` mesh run (`tests/test_serving_scheduler.py`)
# on the parameters the job's ranks get, recording the top-2 margin of every
# sampled row as `test_torch_scheduler._JRecording` does.
SHARD_SERVE_SCRIPT = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, pickle, jax, jax.numpy as jnp
    from repro.launch.mesh import make_debug_mesh
    from repro.models import ModelConfig
    from repro.serving import ContinuousScheduler, ServeEngine, poisson_requests

    class Recording(ContinuousScheduler):
        def __init__(self, *args, **kw):
            self.margins = {}
            super().__init__(*args, **kw)

        def _select_token(self, logits, key, rid, gen):
            tok = super()._select_token(logits, key, rid, gen)
            k = jax.random.fold_in(jax.random.fold_in(key, rid), gen)
            score = (logits.astype(jnp.float32) / self.temperature
                     + jax.random.gumbel(k, logits.shape))
            top2 = jax.lax.top_k(score, 2)[0]
            jax.debug.callback(self._record, rid, gen, top2[0] - top2[1])
            return tok

        def _record(self, rid, gen, margin):
            self.margins[f"{int(rid)},{int(gen)}"] = float(margin)

    with jax.threefry_partitionable(False):
        cfg = ModelConfig(**json.loads(sys.argv[2]), dtype=jnp.float32)
        with open(sys.argv[1], "rb") as f:
            params = jax.tree.map(jnp.asarray, pickle.load(f)["sched_params"])
        reqs = poisson_requests(3, 8, rate=0.8, vocab=cfg.vocab_size,
                                prompt_lens=(3, 24), max_new=(3, 6))
        s = Recording(ServeEngine(cfg, params, temperature=0.7), n_slots=4,
                      max_len=64, key=jax.random.PRNGKey(5), prefill_chunk_tokens=16,
                      batch_mesh=make_debug_mesh(4, 2))
        s.warmup(prompt_range=(3, 24))
        warm = dict(s.trace_counts)
        recs = s.run(reqs)
        jax.effects_barrier()
        assert s.trace_counts == warm and s.host_syncs == s.decode_steps
    print("SHARD-SERVE " + json.dumps(
        {"tokens": {r.rid: [int(t) for t in r.tokens] for r in recs},
         "margins": s.margins}))
    """
)


def _shard_serve(payload_path: str) -> dict:
    """The reference's tokens and margins, by request and (rid, index)."""
    res = subprocess.run([sys.executable, "-c", SHARD_SERVE_SCRIPT, payload_path,
                          json.dumps(worker.SCHED_CFG)], capture_output=True, text=True,
                         cwd=ROOT, timeout=300,
                         env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    line = next(x for x in res.stdout.splitlines() if x.startswith("SHARD-SERVE "))
    res = json.loads(line[len("SHARD-SERVE "):])
    return {"tokens": {int(r): t for r, t in res["tokens"].items()},
            "margins": {tuple(map(int, k.split(","))): v
                        for k, v in res["margins"].items()}}


# ------------------------------------------------------------------ (b)
def _spawn(fn, world: int, workdir: str, deadline_s: float, meanwhile=None):
    """Run `fn(rank, world, workdir)` on `world` spawned ranks; raise if a
    rank fails or the job outlives its deadline (every rank is then
    killed).  Returns `meanwhile()`, which runs here while the ranks do."""
    ctx = tmp_mp.start_processes(fn, args=(world, workdir), nprocs=world, join=False,
                                 start_method="spawn")
    end = time.monotonic() + deadline_s
    try:
        result = meanwhile() if meanwhile is not None else None
        while not ctx.join(timeout=1.0):
            if time.monotonic() > end:
                raise TimeoutError(f"the {world}-rank job outlived {deadline_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        for p in ctx.processes:
            p.join(10)
    return result


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The reference's values (single device), then the 8-rank job."""
    workdir = tmp_path_factory.mktemp("mesh_job")
    with _legacy():
        jcfg = JModelConfig(**worker.MOE_CFG, dtype=jnp.float32)
        p = jax.tree.map(lambda a: np.asarray(a[0]),
                         j_init_moe_params(jax.random.PRNGKey(0), jcfg, 1))
        x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (4, 8, 32)), np.float32)
        moe_out, _ = j_moe_block(jnp.asarray(x), jax.tree.map(jnp.asarray, p), jcfg, None)

        mcfg = JModelConfig(**worker.DENSE_CFG, dtype=jnp.float32)
        data = JSyntheticLM(vocab_size=64, seq_len=16, global_batch=worker.BATCH, seed=0)
        opt = JAdamWConfig(lr_peak=1e-3)
        batch = data.global_batch_at(0)._asdict()
        state0 = j_init_train_state(jax.random.PRNGKey(0), mcfg, opt)
        s_plain, m_plain = jax.jit(j_make_train_step(mcfg, opt, total_steps=10))(
            state0, batch)
        s_accum, m_accum = jax.jit(j_make_train_step(mcfg, opt, total_steps=10,
                                                     grad_accum=2))(state0, batch)
        sched_params = j_init_params(jax.random.PRNGKey(0),
                                     JModelConfig(**worker.SCHED_CFG, dtype=jnp.float32))
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    payload = {
        "sched_params": to_np(sched_params),
        "moe": {"p": p, "x": x},
        "train": {"state": {"params": to_np(state0.params), "m": to_np(state0.opt.m),
                            "v": to_np(state0.opt.v), "step": int(state0.opt.step)},
                  "batch": to_np(batch)},
        "compress": np.stack([np.linspace(-1, 1, 64),
                              np.linspace(0, 2, 64)]).astype(np.float32),
    }
    with open(workdir / "payload.pkl", "wb") as f:
        pickle.dump(payload, f)
    jax_sched = _shard_serve(str(workdir / "payload.pkl"))
    baseline = _spawn(worker.run, WORLD, str(workdir), JOB_DEADLINE_S, meanwhile=_baseline)
    outs = []
    for r in range(WORLD):
        with open(workdir / f"out_{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    ref = {"moe_out": np.asarray(moe_out), "loss": float(m_plain["loss"]),
           "params": jax.tree.map(np.asarray, s_plain.params),
           "accum_loss": float(m_accum["loss"]),
           "accum_params": jax.tree.map(np.asarray, s_accum.params),
           "program_baseline": baseline, "jax_sched": jax_sched}
    return outs, ref


def _baseline() -> str:
    """`launch/program.py --baseline`'s line, on one thread (run while the
    job runs)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return worker.program_line(["--arch", worker.PROGRAM_ARCH, "--device", "cpu",
                                    "--baseline"])
    finally:
        torch.set_num_threads(before)


def test_moe_block_mesh_matches_reference(job):
    outs, ref = job
    for r, o in enumerate(outs):
        m = o["moe"]
        np.testing.assert_allclose(m["out"], ref["moe_out"], rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(m["aux"], m["aux_blocks"], rtol=1e-5)
        assert m["local"] == (2, 8, 32), r                 # 4 rows over "data" = 2
        assert m["expert_local"] == {"router": (32, 8), "w_gate": (2, 16, 16),
                                     "w_up": (2, 16, 16), "w_down": (2, 16, 16)}, r


def test_expert_parallel_grads_match_unsharded(job):
    outs, _ = job
    for r, o in enumerate(outs):
        g = o["ep_grads"]
        np.testing.assert_allclose(g["loss"], g["ref_loss"], rtol=1e-5)
        bad = {p: e for p, e in g["rel_err"].items() if not e <= 1e-4}
        assert not bad, (r, bad)
        assert sorted(g["expert_shapes"]) == [
            "['layers']['moe']['w_down']", "['layers']['moe']['w_gate']",
            "['layers']['moe']['w_up']"]
        assert all(s[:2] == (2, 2) for s in g["expert_shapes"].values()), g


def test_sharded_train_step_matches_reference(job):
    outs, ref = job
    t = outs[0]["train"]
    assert abs(t["loss"] - ref["loss"]) < 1e-4
    for (path, a), b in zip(pytree.leaves_with_path(t["params"]),
                            pytree.leaves(ref["params"])):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-4, err_msg=path)
    # every rank returns the same loss and holds the same whole state
    for o in outs[1:]:
        assert o["train"]["loss"] == t["loss"]
        for a, b in zip(pytree.leaves(o["train"]["params"]), pytree.leaves(t["params"])):
            np.testing.assert_array_equal(a, b)


def test_dry_run_counts_the_collectives_the_ranks_make(job):
    """The train step on an `AbstractMesh((2, 4))` with meta tensors (as
    `launch.dryrun` runs a cell) counts the collectives, op for op and
    axis for axis, that the real step on 8 gloo ranks makes."""
    outs, _ = job
    cfg = ModelConfig(**worker.DENSE_CFG, dtype=torch.float32)
    opt = AdamWConfig(lr_peak=1e-3)
    mesh = AbstractMesh((2, 4), ("data", "model"))
    state = init_train_state(0, cfg, opt, device="meta")
    state = shard_tree(state, state_sharding(mesh, state, cfg))
    batch = {"tokens": torch.empty((worker.BATCH, 16), dtype=torch.int32, device="meta"),
             "targets": torch.empty((worker.BATCH, 16), dtype=torch.int32, device="meta"),
             "mask": torch.empty((worker.BATCH, 16), device="meta")}
    wc = dryrun.count(make_train_step(cfg, opt, mesh, total_steps=10),
                      (state, shard_batch(mesh, batch, worker.BATCH)))
    assert wc.collectives["all-gather"]["count"] > 0 and wc.collectives["all-reduce"]["count"] > 0
    for r, o in enumerate(outs):
        assert o["train"]["collectives"] == wc.collectives, r
        assert o["train"]["collective_axes"] == dict(wc.collective_axes), r


def test_sharded_train_step_matches_single_device_port(job):
    outs, _ = job
    t = outs[0]["train"]
    assert abs(t["loss"] - t["plain_loss"]) < 1e-4
    np.testing.assert_allclose(t["grad_norm"], t["plain_grad_norm"], rtol=1e-5)
    for (path, a), b in zip(pytree.leaves_with_path(t["params"]),
                            pytree.leaves(t["plain_params"])):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-4, err_msg=path)


def test_sharded_train_step_grad_accum_matches(job):
    """``grad_accum=2``: the reference's microbatches (slices of the
    whole batch, each laid out anew), against the reference's and the
    port's single-device steps; and the sharded eval step."""
    outs, ref = job
    t = outs[0]["train"]
    assert abs(t["accum_loss"] - ref["accum_loss"]) < 1e-4
    assert abs(t["accum_loss"] - t["accum_plain_loss"]) < 1e-4
    for (path, a), b, c in zip(pytree.leaves_with_path(t["accum_params"]),
                               pytree.leaves(ref["accum_params"]),
                               pytree.leaves(t["accum_plain_params"])):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-4, err_msg=path)
        np.testing.assert_allclose(a, c, rtol=2e-3, atol=2e-4, err_msg=path)
    for k, v in t["eval_plain"].items():
        np.testing.assert_allclose(t["eval"][k], v, rtol=1e-5, atol=1e-7, err_msg=k)


def test_state_stored_in_blocks(job):
    outs, _ = job
    specs = outs[0]["train"]["specs"]
    assert specs[".params['layers']['wq']"] == (None, "data", "model")
    assert specs[".opt.m['layers']['w_down']"] == (None, "model", "data")
    assert specs[".params['tok_embed']"] == ("model", "data")
    assert specs[".opt.step"] == ()
    for r, o in enumerate(outs):
        assert o["train"]["bad_blocks"] == [], r


def test_elastic_restore_onto_another_mesh(job):
    outs, _ = job
    for r, o in enumerate(outs):
        t = o["train"]
        assert t["restored_step"] == 1 and t["elastic_mesh"] == (4, 2)
        assert t["bad_elastic"] == [], r
        assert t["elastic_rel"] <= 1e-6, r


def test_sharded_remat_step_matches_plain(job):
    """olmoe's smoke config on the (2, 4) mesh, expert parallelism
    included: two sharded steps with layer remat leave every rank's
    blocks bitwise as without it, and the remat steps checkpointed one
    body per layer per step beyond the always-on attention chunks."""
    outs, _ = job
    for r, o in enumerate(outs):
        plain, rem = o["remat"][False], o["remat"][True]
        assert rem["state"] == plain["state"] and rem["loss"] == plain["loss"], r
        assert rem["checkpoints"] - plain["checkpoints"] == 2 * rem["layers"], r
        assert plain["checkpoints"] > 0, r
    assert len({o["remat"][True]["loss"] for o in outs}) == 1


@pytest.mark.parametrize("arch", list(ARCHS))
def test_loss_fn_mesh_matches_unsharded(arch, job):
    """Rank 0 holds the unsharded references; every rank returns the
    same loss, CE and aux."""
    outs, _ = job
    x = outs[0]["losses"][arch]
    np.testing.assert_allclose(x["ce"], x["ref_ce"], rtol=1e-5)
    np.testing.assert_allclose(x["aux"], x["ref_aux"], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(x["loss"], x["ref_loss"], rtol=1e-5)
    assert x["logits_shape"] and x["logits_rel"] <= 1e-5, x["logits_rel"]
    for r, o in enumerate(outs):
        assert {k: o["losses"][arch][k] for k in ("loss", "ce", "aux")} == {
            k: x[k] for k in ("loss", "ce", "aux")}, r


def test_compressed_psum_on_pod_mesh(job):
    outs, _ = job
    for r, o in enumerate(outs):
        c = o["compress"]
        assert c["err0"] < 2e-2, (r, c)
        assert c["bias"] < 2e-3, (r, c)
        assert c["dtypes"] == ["torch.int32"] and c["n_calls"] == 2 * 101, (r, c)


# ------------------------------------------------------------------ (c)
def _strip_path(line: str) -> str:
    return re.sub(r" \[[^]]*\]", "", line)


@pytest.mark.parametrize("case", ["cols_faults", "data_model"])
def test_mesh_deploy_matches_unsharded(case, job):
    outs = [o["serve"] for o in job[0]]
    ref, ref_syncs = outs[{"cols_faults": 0, "data_model": 5}[case]][f"ref_deploy_{case}"]
    assert ref_syncs == 1
    for r, o in enumerate(outs):
        assert o[f"deploy_{case}"] == (ref, 1), r


def test_mesh_axes_subset_and_whole_bucket_match(job):
    outs = [o["serve"] for o in job[0]]
    for r, o in enumerate(outs):
        assert o["packed_data_axis"] == outs[6]["ref_packed_data_axis"], r
        assert o["whole_bucket"] == outs[6]["ref_whole_bucket"], r


def test_program_launcher_matches_baseline(job):
    outs = [o["serve"] for o in job[0]]
    line, baseline = outs[0]["program"], job[1]["program_baseline"]
    assert "(smoke) with harp [bucketed pipeline (" in line and "1 host sync)]" in line
    assert "[per-leaf baseline]" in baseline
    assert _strip_path(line) == _strip_path(baseline)
    assert all(o["program"] == line for o in outs)


def test_mesh_analog_serve_matches_unsharded(job):
    outs = [o["serve"] for o in job[0]]
    for r, o in enumerate(outs):
        assert o["serve"] == outs[2]["ref_serve"], r
        local, whole = o["cim_local"]
        assert local[:-1] == whole[:-1] and local[-1] * 4 == whole[-1], r


@pytest.mark.parametrize("kind", ["digital", "analog"])
def test_batch_mesh_scheduler_matches_unsharded(kind, job):
    outs = [o["serve"] for o in job[0]]
    ref = outs[3][f"ref_sched_{kind}"]
    assert ref["flat"] and ref["syncs"][0] == ref["syncs"][1]
    for r, o in enumerate(outs):
        got = o[f"sched_{kind}"]
        assert got["tokens"] == ref["tokens"], r
        assert got["flat"] and got["syncs"] == ref["syncs"], (r, got["syncs"])
        assert got["rows"][1] == 1, got["rows"]      # 4 slots over "data" = 4


def test_batch_mesh_scheduler_follows_reference_mesh_run(job):
    """The port's digital `batch_mesh` tokens against the reference's
    `_SHARD_SCRIPT` run on its own (4, 2) mesh (temperature 0.7)."""
    outs, ref = job
    want = ref["jax_sched"]
    for r, o in enumerate(outs):
        _assert_tokens_follow(o["serve"]["sched_digital"]["tokens"], want["tokens"],
                              want["margins"], 2 * DIGITAL_ATOL / 0.7)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_family_mesh_decode_matches_unsharded(arch, job):
    outs = [o["serve"] for o in job[0]]
    for r, o in enumerate(outs):
        assert o["families"][arch] == outs[4]["ref_families"][arch], r


def test_one_row_per_rank_within_blas_rounding(job):
    outs = [o["serve"] for o in job[0]]
    rel, argmax_equal = outs[4]["one_row"]
    assert rel <= 1e-5 and argmax_equal, rel


# ------------------------------------------------------------------ (d)
def test_dead_rank_fails_the_job_within_its_deadline(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(Exception) as err:
        _spawn(worker.run_dies, 2, str(tmp_path), deadline_s=120)
    assert not isinstance(err.value, TimeoutError), err.value
    assert time.monotonic() - t0 < 120
