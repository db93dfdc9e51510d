"""The window arithmetic on synthetic timestamps: a rate over completed
deploys, the p95 over requests, TPOT, the serve cell's end-to-end
metrics, and the trace reduction (busy time, idle gaps and their
names, kernel time by name)."""

from __future__ import annotations

import pytest

from harness import driver_deploy, driver_serve_closed, stats, trace


def test_deploy_kernel_work_counts_the_launched_calls():
    st = {"cell": {"traffic": {"min_bucket": 256, "max_bucket": 1024}}}
    rec = {"deploys": [dict(start=0.0, end=2.0, traced=True, columns=1536,
                            mean_iterations=20.0, launches={"fwht": 300, "wv_step": 100}),
                       dict(start=2.0, end=4.0, traced=False, columns=1536,
                            mean_iterations=20.0, launches={"fwht": 300, "wv_step": 100})]}
    ctx = driver_deploy.layer_context(st, rec, None)
    # Buckets of 1024 and 512 columns, 150 fwht and 50 wv_step calls each.
    assert ctx["kernel_work"]["fwht"]["bytes"] == pytest.approx(150 * 8.0 * 1536 * 32)
    assert ctx["kernel_work"]["wv_step"]["bytes"] == pytest.approx(50 * 42.0 * 1536 * 32)
    rec["deploys"][0]["launches"] = {}
    assert driver_deploy.layer_context(st, rec, None)["kernel_work"] == {}


def test_stats():
    assert stats.p95(range(1, 101)) == pytest.approx(95.05)
    assert stats.p95([]) is None
    reqs = [dict(sent=0.0, first=0.5, done=2.5, n=5),
            dict(sent=1.0, first=1.2, done=None, n=3),
            dict(sent=2.0, first=None, done=None, n=0)]
    assert stats.ttfts(reqs) == pytest.approx([0.5, 0.2])
    assert stats.tpots(reqs) == pytest.approx([0.5])


def test_deploy_rate_over_completed_deploys():
    rec = {"deploys": [dict(start=10.0, end=14.0, cells=100),
                       dict(start=14.0, end=18.5, cells=100)]}
    assert driver_deploy.end_to_end(rec)["deploy_cells_per_s"] == pytest.approx(200 / 8.5)


def test_serve_metrics():
    rec = dict(t0=0.0, t_end=10.0, start_n={7: 3},
               requests=[dict(rid=7, warm=True, sent=-5.0, first=-4.0, done=2.0, n=5),
                         dict(rid=0, sent=1.0, first=1.5, done=4.5, n=4),
                         dict(rid=1, sent=2.0, first=2.4, done=None, n=2)],
               completed=[])
    m = driver_serve_closed.end_to_end(rec)
    assert m["serve_tokens_per_s"] == pytest.approx((2 + 4 + 2) / 10.0)
    assert m["ttft_p95_ms"] == pytest.approx(1e3 * stats.p95([0.5, 0.4]))
    assert m["tpot_p95_ms"] == pytest.approx(1e3 * 1.0)


def _x(name, cat, ts, dur):
    return (cat, name, ts, dur)


def test_trace_reduce():
    ev = [_x(trace.WINDOW, "user_annotation", 1000.0, 100.0),
          _x("bench.deploy", "user_annotation", 1000.0, 100.0),
          _x("aten::item", "cpu_op", 1030.0, 55.0),
          _x("void (anonymous namespace)::fwht_f32_kernel(float const*, float*, long long, int)",
             "kernel", 1010.0, 20.0),
          _x("void (anonymous namespace)::fwht_f32_kernel(float const*, float*, long long, int)",
             "kernel", 1020.0, 15.0),
          _x("Memcpy DtoH", "gpu_memcpy", 1080.0, 10.0),
          _x("outside", "kernel", 500.0, 10.0)]
    s = trace.reduce(ev)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(35e-6)
    assert s["kernel_s"]["fwht_f32_kernel"] == pytest.approx(35e-6)
    assert s["kernel_s"]["gpu_memcpy"] == pytest.approx(10e-6)
    names = dict((n, v) for n, v in s["idle_gaps"])
    assert names["bench.deploy/aten::item"] == pytest.approx(45e-6)
    assert sum(v for _, v in s["idle_gaps"]) == pytest.approx(65e-6)
    assert names["bench.deploy"] == pytest.approx(10e-6)
    assert trace.reduce([]) == {}
    host_less = trace.reduce([e for e in ev if e[0] in ("kernel", "gpu_memcpy")
                              and e[1] != "outside"], host_window=150e-6)
    assert host_less["window_s"] == pytest.approx(150e-6)
    assert host_less["busy_s"] == pytest.approx(35e-6)
    assert [n for n, _ in host_less["idle_gaps"]] == ["idle host", "idle host"]
    assert sum(v for _, v in host_less["idle_gaps"]) == pytest.approx(115e-6)


class _Ev:
    def __init__(self, name, cuda, ua):
        self._n, self._c, self._u = name, cuda, ua

    def name(self):
        return self._n

    def device_type(self):
        import torch
        return torch.autograd.DeviceType.CUDA if self._c else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self._u


def test_event_category_without_activity_type():
    assert trace.category(_Ev("fwht_f32_kernel", True, False)) == "kernel"
    assert trace.category(_Ev("Memcpy DtoH (Device -> Pinned)", True, False)) == "gpu_memcpy"
    assert trace.category(_Ev("bench.window", True, True)) == "gpu_user_annotation"
    assert trace.category(_Ev("bench.window", False, True)) == "user_annotation"
    assert trace.category(_Ev("cudaLaunchKernel", False, False)) == "cpu_op"


_TRACE = dict(window_s=2.0, busy_s=1.5, kernel_s={"fwht_f32_kernel": 0.5, "wv_step_kernel": 0.25,
                                                   "acim_vmm_kernel": 0.2,
                                                   "epilogue_kernel": 0.05})
_DEPLOY = dict(kind="deploy", trace=_TRACE, window_s=4.0, wv_ops=2.68e12,
               deploys=[dict(syncs=1, mean_iterations=20.0, columns=100),
                        dict(syncs=1, mean_iterations=26.0, columns=300)],
               kernel_work={"fwht": {"bytes": 3.35e11, "ops": {}},
                            "wv_step": {"bytes": 0.0, "ops": {"f32": 6.7e12}}})
_SERVE = dict(kind="serve", trace=_TRACE, window_s=10.0, model_flops=9.89e13,
              occupancy=[64, 32], n_slots=64, admit_s=[1.0, 1.5], step_s=[0.1, 0.3, 0.2],
              kernel_work={"acim_vmm": {"bytes": 0.0, "ops": {"bf16": 9.89e13}}})


@pytest.mark.parametrize("name,ctx,value", [
    ("deploy.host_syncs", _DEPLOY, 1.0),
    ("wv.iterations_mean", _DEPLOY, 24.5),
    ("fwht_roofline", _DEPLOY, 20.0),
    ("wv_step_roofline", _DEPLOY, 40.0),
    ("mfu.deploy", _DEPLOY, 1.0),
    ("idle.deploy", _DEPLOY, 25.0),
    ("acim_vmm_roofline", _SERVE, 40.0),
    ("mfu.serve", _SERVE, 1.0),
    ("idle.serve", _SERVE, 25.0),
    ("serve.slot_occupancy", _SERVE, 75.0),
    ("serve.prefill_share", _SERVE, 25.0),
    ("serve.step_ms_p50", _SERVE, 200.0),
])
def test_reader(name, ctx, value):
    from harness import spec

    read = spec.reader(name)
    assert read(ctx) == pytest.approx(value)
    other = _SERVE if ctx is _DEPLOY else _DEPLOY
    assert read(dict(other, kernel_work={})) is None
    if "roofline" in name or "idle" in name:
        assert read(dict(ctx, trace=None)) is None


@pytest.mark.parametrize("workload", ["qwen3-0.6b.deploy-harp", "qwen3-0.6b.chat64"])
def test_cell_pieces_found_by_name(workload):
    from harness import spec

    cell = spec.cell(workload)
    assert spec.driver(cell["traffic"]["kind"])
    assert "setup_s" in {m["name"] for m in cell["end_to_end"]}
    assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
    for m in cell["per_layer"]:
        assert callable(spec.reader(m["name"])), m["name"]
    assert set(cell["limits"]) and all(v >= 0 for v in cell["limits"].values())
