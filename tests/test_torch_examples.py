"""The port's entry points (`examples/torch_*.py`) run on the CPU at
their smallest flags, in process through their `main(argv)`.

What each must give: the quickstart a row per WV method with finite
numbers and Hadamard-domain verification (HD-PV) below CW-SC's error,
as its closing line says; `torch_serve_lm.py` every request of its
stream served in the vocabulary (analog, continuous) and a full
fixed batch (digital), also for the MoE and hybrid archs, whose MoE
stream is admitted whole-prompt, while the RWKV6 and stub-frontend archs
are refused as `examples/serve_lm.py` refuses them; `torch_lifetime_serve.py` one aging epoch with
a finite eval loss (`--policy none`: the scrub's verify and re-program
are held in `tests/test_torch_lifetime.py`).  Parity of the paths
underneath is held in the other `tests/test_torch_*.py` files.
"""

import importlib.util
import math
import pathlib

import pytest
import torch

from repro_torch import obs

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads for the module, restored after it (the suite
    runs files side by side in worker processes)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    obs.reset_all()
    yield
    obs.reset_all()


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_runs_on_cpu(capsys):
    rows = _load("torch_quickstart").main(["--device", "cpu"])
    assert list(rows) == ["cw_sc", "mra", "hd_pv", "harp"]
    assert all(math.isfinite(v) for r in rows.values() for v in r.values())
    assert rows["hd_pv"]["rms"] < rows["cw_sc"]["rms"]
    assert "harp" in capsys.readouterr().out


def test_serve_lm_analog_continuous_runs_on_cpu(capsys):
    out = _load("torch_serve_lm").main(
        ["--device", "cpu", "--analog", "--continuous", "--requests", "2", "--max-new", "4"])
    recs = out["records"]
    assert len(recs) == 2
    assert all(2 <= r.n_generated <= 4 and all(0 <= t < 256 for t in r.tokens)
               for r in recs)
    printed = capsys.readouterr().out
    assert "served 2 requests" in printed and "analog cost model" in printed
    # The executor's telemetry rode the run: gauges and ledger rows.
    assert obs.health_registry.gauge("cim.tokens_served") > 0
    assert obs.ledger.summary()["serve.analog"]["tokens"] > 0


def test_serve_lm_fixed_batch_runs_on_cpu(capsys):
    out = _load("torch_serve_lm").main(
        ["--device", "cpu", "--arch", "llama3.2-1b", "--batch", "2", "--prompt-len", "8",
         "--max-new", "3"])
    assert out["tokens"].shape == (2, 3) and int(out["tokens"].max()) < 256
    assert "first sequence" in capsys.readouterr().out
    assert obs.digests.get("serve.generate_us_per_token").count == 1
    assert [e["name"] for e in obs.trace.events() if e["ph"] == "X"] == ["serve.generate"]


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen3-moe-235b-a22b", "hymba-1.5b"])
def test_serve_lm_token_families_run_on_cpu(arch, capsys):
    out = _load("torch_serve_lm").main(
        ["--device", "cpu", "--arch", arch, "--batch", "2", "--prompt-len", "8",
         "--max-new", "3"])
    assert out["tokens"].shape == (2, 3) and int(out["tokens"].max()) < 256
    assert f"arch={arch}" in capsys.readouterr().out


def test_serve_lm_continuous_moe_and_refusals(capsys):
    out = _load("torch_serve_lm").main(
        ["--device", "cpu", "--arch", "olmoe-1b-7b", "--continuous", "--requests", "2",
         "--max-new", "4"])
    assert len(out["records"]) == 2
    assert "served 2 requests" in capsys.readouterr().out
    for arch in ("rwkv6-1.6b", "musicgen-medium"):
        with pytest.raises(SystemExit, match="token-input arch"):
            _load("torch_serve_lm").main(["--device", "cpu", "--arch", arch])


def test_lifetime_serve_runs_on_cpu(capsys):
    recs = _load("torch_lifetime_serve").main(
        ["--device", "cpu", "--steps", "3", "--epochs", "1", "--policy", "none"])
    assert len(recs) == 1 and math.isfinite(recs[0].eval_metric)
    assert recs[0].columns_reprogrammed == 0
    assert "policy=none" in capsys.readouterr().out
