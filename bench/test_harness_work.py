"""The benchmark's own work counts against each kernel's `work()` in
the port, at the shapes of the cells, and the sanity of the HARP
operation count and the model FLOPs."""

from __future__ import annotations

import pytest

from work import bound_s, kernels as kw, model_flops, wv_ops


@pytest.mark.parametrize("c", [1 << 18, 1 << 17, 256])
def test_fwht_and_wv_step_match_port(c):
    from repro_torch.kernels.fwht import ops as fwht_ops
    from repro_torch.kernels.wv_step import ops as wv_ops_port

    assert kw.fwht(c, 32) == fwht_ops.work(c, 32)
    assert kw.wv_step(c, 32) == wv_ops_port.work(c, 32, ternary=True)


@pytest.mark.parametrize("k,m", [(1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072),
                                 (3072, 1024)])
@pytest.mark.parametrize("tokens", [64, 16, 32])
def test_acim_vmm_matches_port(k, m, tokens):
    from repro_torch.kernels.acim_vmm import ops as vmm_ops

    b, r = 10 * tokens, 128
    t = -(-k // r)
    assert kw.acim_vmm(b, t, 2, r, m) == vmm_ops.work(b, t, 2, r, m, binary=True, noise=True)


@pytest.mark.parametrize("columns", [1_975_296, 393_216, 1_000, 255, 1 << 18])
def test_wv_buckets_match_port(columns):
    from repro_torch.core import pipeline

    assert kw.wv_buckets(columns, 256, 1 << 18) == pipeline.bucket_sizes(columns, 256, 1 << 18)


def test_wv_calls_spread_over_buckets():
    buckets = kw.wv_buckets(1_975_296, 256, 1 << 18)
    assert len(buckets) == 10
    w = kw.wv_calls(kw.fwht, 150 * len(buckets), buckets, 32)
    assert w["bytes"] == pytest.approx(150 * kw.fwht(1_975_296, 32)[0])
    assert w["ops"]["f32"] == pytest.approx(150 * kw.fwht(1_975_296, 32)[1]["f32"])
    assert kw.wv_calls(kw.wv_step, 50 * len(buckets) + 1, buckets, 32) is None
    assert kw.wv_calls(kw.wv_step, 0, buckets, 32) is None


def test_wv_ops_count():
    once, it = wv_ops.per_column_once(32), wv_ops.per_column_iteration(32)
    assert once > 0 and it > 0
    assert wv_ops.deploy_ops(10, 20.0) == pytest.approx(10 * (once + 20.0 * it))
    assert wv_ops.deploy_ops(10, 21.0) > wv_ops.deploy_ops(10, 20.0)


def test_model_flops_and_bound():
    c = dict(d_model=1024, n_heads=16, n_kv_heads=8, head_dim=128, d_ff=3072,
             vocab_size=151936, n_layers=1)
    assert model_flops.layer_params(c) == 15_728_640
    one = model_flops.token_flops(c, 0, head=False)
    assert one == 2 * 15_728_640 + 4 * 16 * 128
    assert model_flops.request_flops(c, 4, 1) == pytest.approx(
        sum(model_flops.token_flops(c, p, p == 3) for p in range(4)))
    assert bound_s(3.35e12, {}) == pytest.approx(1.0)
    assert bound_s(0.0, {"f32": 67e12, "bf16": 989e12}) == pytest.approx(2.0)
