"""The benchmark's plain reference against the port, at a tiny size on
the CPU: a HARP deploy cell for cell, and an analog prefill and decode
logit for logit.  One case repeats the deploy against the port's CUDA
kernels on the card."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from harness import weights
from reference import analog_lm, rng as ref_rng, wv as ref_wv
import tiny


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's kernels run only on the card")
    return "cuda"


def _deploy_case(workload: str, device: str):
    from repro_torch.core import WVConfig, WVMethod
    from repro_torch.core.programmer import deploy_arrays

    cfg = weights.model_config(tiny.cell(workload)["config"])
    params = weights.make_params(cfg, 11, device)
    key = ref_rng.fold_in(ref_rng.PRNGKey(5, device), 3)
    dep, rep = deploy_arrays(key, params, WVConfig(method=WVMethod.HARP),
                             batched=True, device=device)
    leaves = ref_wv.leaf_columns(params)
    targets = torch.cat([c for _, _, c, _, _ in leaves])
    g_all, it_all = ref_wv.program(key, targets, torch.arange(targets.shape[0], device=device))
    for name, leaf, cols, scale, base in leaves:
        g, it = g_all[base:base + cols.shape[0]], it_all[base:base + cols.shape[0]]
        assert torch.equal(g, dep.arrays[name].g), name
        assert float(torch.mean(it)) == pytest.approx(rep.leaves[name]["mean_iterations"],
                                                      abs=1e-6)
        assert torch.equal(ref_wv.dequantize_columns(g, leaf, scale),
                           dep.arrays[name].materialize()), name


def test_reference_deploy_matches_port_cpu():
    _deploy_case("qwen3-0.6b.deploy-harp", "cpu")


@pytest.mark.requires_cuda
def test_reference_deploy_matches_port_kernels(cuda_device):
    _deploy_case("qwen3-0.6b.deploy-harp", cuda_device)


def test_reference_decode_matches_port_cpu():
    """Prefill then two decode steps of one request through the port's
    executor, against the reference's forward over the same rows."""
    from repro_torch.cim import CIMConfig, CIMExecutor, token_stream_ids
    from repro_torch.core import WVConfig, WVMethod
    from repro_torch.core.programmer import deploy_arrays
    from repro_torch.models import decode_step, prefill

    from harness import driver_serve_closed as drv

    cell = tiny.cell("qwen3-0.6b.chat64")
    cfg = weights.model_config(cell["config"])
    params = weights.make_params(cfg, 13, "cpu")
    k_dep, k_noise = drv._keys(13, "cpu")
    dep, _ = deploy_arrays(k_dep, params, WVConfig(method=WVMethod.HARP), device="cpu")
    ex = CIMExecutor(dep, CIMConfig(dac_bits=6, adc_bits=10, sigma_read_lsb=0.2), k_noise)
    prompt = np.array([5, 17, 100, 3, 99, 42], np.int64)
    rid = 77
    params_p = ex.tick(len(prompt))
    access = [ex.access]
    last, cache = prefill(params_p, {"tokens": torch.as_tensor(prompt)[None]}, cfg,
                          max_len=12)
    got = [last[0]]
    served = [int(torch.argmax(last[0]))]
    for _ in range(2):
        params_d = ex.tick(1)
        access.append(ex.access)
        with token_stream_ids(torch.tensor([rid], dtype=torch.int32)):
            lg, cache = decode_step(params_d, cache, {"tokens": torch.tensor([[served[-1]]])}, cfg)
        got.append(lg[0, -1])
        served.append(int(torch.argmax(lg[0, -1])))
    st = dict(params=params, k_dep=k_dep, k_noise=k_noise, cfg=cfg, cell=cell)
    model, acfg = drv.reference_model(st)
    req = dict(prompt=prompt, served=served, access=access, rid=rid)
    ref = analog_lm.forward_rows(model, drv.sequences([req]), acfg)[0]
    rows = ref[len(prompt) - 1:]
    diff = torch.amax(torch.abs(torch.stack(got) - rows), dim=-1)
    assert float(torch.median(diff)) < 1e-4, diff
    assert float(torch.max(drv.gaps([ref], [req]))) < 1e-3
