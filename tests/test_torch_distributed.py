"""The port's fault tolerance and gradient compression against the JAX
package: `FaultInjector`, `FaultTolerantRunner` and `StragglerMonitor` on
the reference's scenarios (`tests/test_substrates.py`), each run through
both packages' runners with the same failure plan; `compress_int8`,
`decompress_int8` and `_compress_leaf` on seeded inputs; the training
launcher (`python -m repro_torch.launch.train`) and
`examples/torch_train_lm.py` with a failure injected.

Tolerances:
* runners: the same metrics log (step and metrics of every completed
  step, replays included), restart count and final state, exactly;
* the straggler monitor: the same flags, escalations and callbacks;
* the compression functions: bitwise (codes, scales and residuals);
* the launcher: a run with a failure at step 3 ends on the params of
  an uninterrupted run, bitwise (the launcher runs its steps under
  deterministic algorithms).

Checkpoints go under `tmp_path`; the module runs on two torch threads
and restores the count.
"""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.distributed import FaultInjector as JInjector
from repro.distributed import FaultTolerantRunner as JRunner
from repro.distributed import StragglerMonitor as JMonitor
from repro.distributed.fault import SimulatedFailure as JFailure
from repro.optim import compress_int8 as j_compress
from repro.optim import decompress_int8 as j_decompress
from repro.optim.compression import _compress_leaf as j_compress_leaf
from repro_torch import obs
from repro_torch.checkpoint import CheckpointManager, restore_checkpoint
from repro_torch.distributed import FaultInjector, FaultTolerantRunner, StragglerMonitor
from repro_torch.distributed.fault import SimulatedFailure
from repro_torch.optim import compress_int8, decompress_int8
from repro_torch.optim.compression import _compress_leaf

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    obs.reset_all()
    yield
    obs.reset_all()


# ------------------------------------------------------------ the runners
def _both(make_step, plan: dict, runner_kw: dict, steps: int, tmp_path):
    """Run the reference's runner and the port's on the same plan;
    returns ((state, log, restarts) | the exception, for each)."""
    out = []
    for pkg in ("jax", "torch"):
        zeros = jnp.zeros(()) if pkg == "jax" else torch.zeros(())
        Manager, Runner = ((JManager, JRunner) if pkg == "jax"
                           else (CheckpointManager, FaultTolerantRunner))
        injector = plan["injector"](pkg)
        runner = Runner(make_step(pkg), lambda i: i, Manager(str(tmp_path / pkg), keep=3),
                        injector=injector, **runner_kw)
        try:
            state, log = runner.run({"x": zeros}, 0, steps)
            out.append((float(state["x"]), log, runner.restarts))
        except RuntimeError as e:
            out.append((str(e), runner.restarts))
    return out


def _adder(pkg):
    return lambda s, b: ({"x": s["x"] + b}, {"seen": b})


def _stock(*steps):
    return lambda pkg: (JInjector if pkg == "jax" else FaultInjector)(fail_at_steps=steps)


def test_runner_replays_to_target(tmp_path):
    """Failures at 6 and 11 with checkpoints every 4: both restore and
    replay to the same sum, with the same replayed log."""
    (js, jlog, jr), (ts, tlog, tr) = _both(
        _adder, {"injector": _stock(6, 11)}, dict(checkpoint_every=4), 15, tmp_path)
    assert ts == js == sum(range(15))
    assert tr == jr == 2
    assert tlog == jlog


def test_runner_restarts_from_initial_state(tmp_path):
    """A failure before the first checkpoint restarts from the true
    initial state, not from the advanced one."""
    (js, jlog, jr), (ts, tlog, tr) = _both(
        _adder, {"injector": _stock(3)}, dict(checkpoint_every=100), 10, tmp_path)
    assert ts == js == sum(range(10)) and tr == jr == 1
    assert tlog == jlog and [e["step"] for e in tlog[:4]] == [0, 1, 2, 0]


class _AlwaysFailJ(JInjector):
    def maybe_fail(self, step):
        if step == 3:
            raise JFailure("persistent")


class _AlwaysFailT(FaultInjector):
    def maybe_fail(self, step):
        if step == 3:
            raise SimulatedFailure("persistent")


def test_runner_gives_up_on_crash_loop(tmp_path):
    plan = {"injector": lambda pkg: _AlwaysFailJ() if pkg == "jax" else _AlwaysFailT()}
    j, t = _both(lambda pkg: lambda s, b: (s, {}), plan,
                 dict(checkpoint_every=100, max_retries_per_step=2), 10, tmp_path)
    assert "giving up" in t[0] and t == j


def test_runner_retry_exhaustion_with_real_injector(tmp_path):
    """A zero-retry budget turns the first injection into give-up, and
    the injection lands a `fault.injected` instant in the port's trace."""
    j, t = _both(lambda pkg: lambda s, b: (s, {}), {"injector": _stock(3)},
                 dict(checkpoint_every=100, max_retries_per_step=0), 10, tmp_path)
    assert t == j and t[1] == 1 and "giving up" in t[0]
    assert [e["args"]["step"] for e in obs.trace.events()
            if e.get("name") == "fault.injected"] == [3]


def test_injector_reset_rearms(tmp_path):
    for pkg, Inj, Man, Run, zeros in (
            ("jax", JInjector, JManager, JRunner, jnp.zeros(())),
            ("torch", FaultInjector, CheckpointManager, FaultTolerantRunner,
             torch.zeros(()))):
        inj = Inj(fail_at_steps=(3,))
        step = lambda s, b: ({"x": s["x"] + b}, {})  # noqa: E731
        runner = Run(step, lambda i: i, Man(str(tmp_path / pkg / "a"), keep=3),
                     checkpoint_every=4, injector=inj)
        state, _ = runner.run({"x": zeros}, 0, 10)
        assert runner.restarts == 1 and inj._fired == {3}
        assert float(state["x"]) == sum(range(10))
        inj.reset()
        assert inj._fired == set()
        runner2 = Run(step, lambda i: i, Man(str(tmp_path / pkg / "b"), keep=3),
                      checkpoint_every=100, injector=inj)
        state2, _ = runner2.run({"x": zeros}, 0, 10)
        assert runner2.restarts == 1 and float(state2["x"]) == sum(range(10)), pkg


def test_runner_final_save_is_blocking(tmp_path):
    """The run ends with a checkpoint of its last step on disk."""
    runner = FaultTolerantRunner(lambda s, b: ({"x": s["x"] + b}, {}), lambda i: i,
                                 CheckpointManager(str(tmp_path), keep=2),
                                 checkpoint_every=4)
    runner.run({"x": torch.zeros(())}, 0, 10)
    step, tree = restore_checkpoint(str(tmp_path), device="cpu")
    assert step == 10 and float(tree["['x']"]) == sum(range(10))


@pytest.mark.parametrize("durations, escalated", [
    ([0.1] * 10 + [0.35, 0.4, 0.1, 0.5], [11]),          # the reference's scenario
    ([0.2, 0.1, 0.9, 0.1, 0.1, 0.1, 0.5, 0.6, 0.7, 0.1, 0.3, 0.35, 0.4, 0.45], None),
], ids=["reference", "bursts"])
def test_straggler_monitor_matches_reference(durations, escalated):
    mons = []
    for Mon in (JMonitor, StragglerMonitor):
        mon = Mon(threshold=2.0, strikes_to_escalate=2, warmup_steps=3)
        events = []
        mon.on_straggler = lambda step, dur, events=events: events.append(step)
        flags = [mon.observe(i, d) for i, d in enumerate(durations)]
        mons.append((flags, mon.flagged_steps, mon.escalations, events, mon._ewma))
    assert mons[1] == mons[0]
    if escalated is not None:
        assert mons[1][2] == len(escalated) and mons[1][3] == escalated


def test_straggler_monitor_timed():
    mon = StragglerMonitor(warmup_steps=0)
    with mon.timed(0):
        pass
    assert mon._seen == 1


# ------------------------------------------------------------ compression
@pytest.mark.parametrize("shape", [(64,), (8, 33), (4, 3, 5)])
@pytest.mark.parametrize("seed", [0, 1])
def test_compression_bitwise(shape, seed):
    rs = np.random.RandomState(seed)
    x = (rs.randn(*shape) * rs.choice([1e-3, 1.0, 40.0])).astype(np.float32)
    e = (rs.randn(*shape) * 1e-2).astype(np.float32)
    jq, js = j_compress(jnp.asarray(x))
    tq, ts = compress_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        decompress_int8(tq, ts, shape).numpy(),
        np.asarray(j_decompress(jq, js, shape)))
    for jv, tv in zip(j_compress_leaf(jnp.asarray(x), jnp.asarray(e)),
                      _compress_leaf(torch.from_numpy(x), torch.from_numpy(e))):
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ------------------------------------------------------------ the launcher
def _launch(ckpt, *extra) -> subprocess.Popen:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "2",
           "TMPDIR": str(ckpt.parent)}
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke", "--device", "cpu",
         "--steps", "6", "--ckpt-dir", str(ckpt), *extra],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_launcher_restarts_and_ends_on_the_uninterrupted_params(tmp_path):
    runs = {"failed": _launch(tmp_path / "failed", "--inject-failure", "3"),
            "plain": _launch(tmp_path / "plain")}
    outs = {}
    for name, proc in runs.items():
        try:
            out, err = proc.communicate(timeout=240)
        finally:
            proc.kill()
        assert proc.returncode == 0, err[-4000:]
        outs[name] = out.strip().splitlines()[-1]
    assert outs["failed"].endswith("restarts=1"), outs
    assert outs["plain"].endswith("restarts=0"), outs
    assert "mesh={'data': 1, 'model': 1}" in outs["failed"]
    step_f, failed = restore_checkpoint(str(tmp_path / "failed"), device="cpu")
    step_p, plain = restore_checkpoint(str(tmp_path / "plain"), device="cpu")
    assert step_f == step_p == 6 and failed.keys() == plain.keys()
    assert any(k.startswith(".params") for k in failed)
    for k in failed:
        assert torch.equal(failed[k], plain[k]), k


def test_train_lm_example_restarts_on_cpu(tmp_path, capsys):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_train_lm", ROOT / "examples" / "torch_train_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    res = mod.main(["--preset", "tiny", "--device", "cpu", "--steps", "40",
                    "--ckpt-every", "10", "--inject-failure", "25",
                    "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "restarts=1" in out and res["runner"].restarts == 1
    assert [e["step"] for e in res["logs"]][20:26] == [20, 21, 22, 23, 24, 20]
    assert res["logs"][-1]["loss"] < res["logs"][0]["loss"]
    assert not torch.are_deterministic_algorithms_enabled()
