"""The control of each cell at a tiny size on the CPU: the plain
reference one precision step below (bfloat16 WV state for a deploy;
float8 activations and digital weights with bfloat16 column sums for
serving) put in the program's place, through the cell's own set-up,
window and check (`calibrate.readings`), as the limits were set from on
the card at the cells' sizes."""

from __future__ import annotations

import pytest
import torch

import calibrate
import tiny


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _readings(workload):
    seconds = 4.0 if "chat" in workload else 1.0
    return calibrate.readings(tiny.cell(workload), 2**31 + 54321, seconds, device="cpu",
                              control=True)


def test_deploy_control_is_not_correct():
    workload = "qwen3-0.6b.deploy-harp"
    out = _readings(workload)
    limits = tiny.cell(workload)["limits"]
    assert all(v <= limits[k] for k, v in out["numbers"].items()), out
    assert any(v > limits[k] for k, v in out["control"].items()), out


def test_serve_control_reads_apart_from_the_program():
    """A 128-token vocabulary has too few near-tied logits for the card's
    limits to apply, so the tiny size holds the separation those limits
    were set across: the control reads several times the sound run on
    every number."""
    out = _readings("qwen3-0.6b.chat64")
    limits = tiny.cell("qwen3-0.6b.chat64")["limits"]
    assert all(v <= limits[k] for k, v in out["numbers"].items()), out
    for k, v in out["control"].items():
        assert v > 5 * out["numbers"][k] + 1e-3, (k, out)
