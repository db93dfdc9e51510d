"""A run of each cell on the CPU at a tiny size, driven through the
harness with the timed path broken underneath, must come out not
correct: a step that returns its state unchanged, half of the batch
left out, an answer altered where it is produced, and (serving) logits
moved where they are produced with every greedy token kept.  The sound run
comes out correct."""

from __future__ import annotations

import pytest
import torch

import run
import tiny


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(workload):
    # Long enough for a few requests to complete on a loaded CPU.
    seconds = 4.0 if "chat" in workload else 1.0
    return run.run_cell(workload, 2**31 + 12345, seconds, False, device="cpu",
                        cell=tiny.cell(workload))


def _deploy_state_unchanged(mp):
    from repro_torch.core import wv

    real = wv.wv_ops.wv_cell_update

    def stuck(agg, dev_mag, g, streak, frozen, *a):
        out = real(agg, dev_mag, g, streak, frozen, *a)
        return (g,) + tuple(out[1:])

    mp.setattr(wv.wv_ops, "wv_cell_update", stuck)


def _deploy_half_batch(mp):
    from repro_torch.core import pipeline

    real = pipeline.program_packed_columns

    def half(key, blocks, *a, **k):
        g, st, d2d, fb = real(key, [b[: (b.shape[0] + 1) // 2] for b in blocks], *a, **k)
        g = [torch.cat([x, torch.zeros((b.shape[0] - x.shape[0], b.shape[1]))])
             for x, b in zip(g, blocks)]
        st = [s.map(lambda v, n=b.shape[0]: torch.cat([v, v])[:n]) for s, b in zip(st, blocks)]
        d2d = [torch.cat([x, x])[: b.shape[0]] for x, b in zip(d2d, blocks)]
        return g, st, d2d, fb

    mp.setattr(pipeline, "program_packed_columns", half)


def _deploy_altered(mp):
    from repro_torch.core import programmer

    real = programmer.deploy_arrays

    def altered(*a, **k):
        dep, rep = real(*a, **k)
        name = sorted(dep.arrays)[0]
        dep.update_array(name, dep.arrays[name].g.clone().index_fill_(0, torch.tensor([0]), 3.5))
        return dep, rep

    mp.setattr(programmer, "deploy_arrays", altered)


def _serve_state_unchanged(mp):
    from repro_torch.serving import scheduler

    real = scheduler.decode_step
    mp.setattr(scheduler, "decode_step",
               lambda params, cache, batch, cfg, mesh=None: (
                   real(params, cache, batch, cfg, mesh)[0], cache))


def _serve_half_batch(mp):
    from repro_torch.serving import scheduler

    real = scheduler.decode_step
    calls = [0]

    def half(params, cache, batch, cfg, mesh=None):
        # Every other row left out, alternating by step, so every
        # request loses half of its steps.
        logits, new = real(params, cache, batch, cfg, mesh)
        calls[0] += 1
        rows = torch.arange(logits.shape[0])
        keep = (rows + calls[0]) % 2 == 0
        return torch.where(keep[:, None, None], logits, 0.0), new

    mp.setattr(scheduler, "decode_step", half)


def _serve_logits_moved(mp):
    from repro_torch.serving import scheduler

    real = scheduler.decode_step

    def moved(params, cache, batch, cfg, mesh=None):
        # Every decode logit moved, each row's best token unchanged.
        logits, new = real(params, cache, batch, cfg, mesh)
        return 2.0 * logits + 1.0, new

    mp.setattr(scheduler, "decode_step", moved)


def _serve_altered(mp):
    from repro_torch.serving.scheduler import ContinuousScheduler

    real = ContinuousScheduler._select_tokens

    def altered(self, logits, master, rids, gens):
        return (real(self, logits, master, rids, gens) + 1) % logits.shape[-1]

    mp.setattr(ContinuousScheduler, "_select_tokens", altered)


FAULTS = {
    "qwen3-0.6b.deploy-harp": [_deploy_state_unchanged, _deploy_half_batch, _deploy_altered],
    "qwen3-0.6b.chat64": [_serve_state_unchanged, _serve_half_batch, _serve_altered,
                          _serve_logits_moved],
}


@pytest.mark.parametrize("workload,fault", [(w, f) for w, fs in FAULTS.items() for f in fs],
                         ids=lambda x: getattr(x, "__name__", x))
def test_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch)
    out = _run(workload)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("workload", list(FAULTS))
def test_sound_run_is_correct(workload):
    out = _run(workload)
    assert out["correct"] is True, out["checks"]
    assert set(out["checks"]) == set(tiny.cell(workload)["limits"])
