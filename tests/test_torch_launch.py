"""The launch tools of the port on H100 terms: `launch.roofline` (the
terms' arithmetic and the `WorkCounter`), `launch.dryrun` (steps counted
on the meta device), `launch.program --dryrun` and `launch.report`.

* `RooflineTerms`' arithmetic on `tests/test_roofline_parser.py`'s
  case, rebuilt with the port's constants: exact to 1e-12 relative;
* the counts of the smoke train, prefill and decode steps run on the
  meta device and on real CPU tensors: FLOPs, bytes, every aten op's
  calls and the peak live bytes equal (the meta device has shapes only;
  what is counted must not depend on values);
* the counted matmul FLOPs equal 2 M N K summed over the step's
  products, worked out from the config (decode and prefill);
* `program.py --dryrun`: 3 `fwht` and 1 `wv_step` calls per fine
  iteration, `max_fine_iters` iterations, on each device's block;
* each kernel's `work()` gives the bounds of the kernel table in
  PERF.md (bytes at 3.35 TB/s or operations at the route's rate), to
  the four digits printed there;
* `report.fmt_row` and `HEADER` against `repro.launch.report`'s: the
  same columns, the same cells where no constant enters.

The collective bytes of a step on an `AbstractMesh` are held against the
real collectives of 8 gloo ranks in `tests/test_torch_sharding.py`.
"""

import json
import math

import pytest
import torch

from repro.launch import report as jreport
from repro_torch.configs import get_smoke_config
from repro_torch.configs.registry import ShapeSpec
from repro_torch.core import WVConfig, WVMethod
from repro_torch.kernels.acim_vmm import ops as vmm_ops
from repro_torch.kernels.fwht import ops as fwht_ops
from repro_torch.kernels.wv_step import ops as wv_ops
from repro_torch.launch import dryrun, program, report
from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import AbstractMesh

SPECS = {"train": ShapeSpec("train", "train", 32, 4),
         "prefill": ShapeSpec("prefill", "prefill", 32, 4),
         "decode": ShapeSpec("decode", "decode", 32, 4)}


def test_roofline_terms_and_bottleneck():
    t = rf.RooflineTerms(
        arch="a", shape="s", mesh="m", chips=256,
        flops={"bf16": 256 * rf.PEAK_FLOPS},   # exactly 1 s of compute
        hbm_bytes=256 * rf.HBM_BW * 0.5,      # 0.5 s of HBM
        collective_bytes=rf.ICI_BW * 0.25,    # 0.25 s on the NIC
        model_flops=128 * rf.PEAK_FLOPS,
    ).finalize()
    assert t.compute_s == pytest.approx(1.0, rel=1e-12)
    assert t.memory_s == pytest.approx(0.5, rel=1e-12)
    assert t.collective_s == pytest.approx(0.25, rel=1e-12)
    assert t.bottleneck == "compute"
    assert t.useful_ratio == pytest.approx(0.5, rel=1e-12)
    # float32 FLOPs at their own rate, and each axis at its link's rate
    t = rf.RooflineTerms(
        arch="a", shape="s", mesh="m", chips=2,
        flops={"f32": 2 * rf.PEAK_FLOPS_F32, "bf16": rf.PEAK_FLOPS},
        hbm_bytes=0.0, collective_bytes=rf.NVLINK_BW + rf.ICI_BW, model_flops=0.0,
        link_bw={"model": rf.NVLINK_BW, "data": rf.ICI_BW},
        collective_detail={"bytes_by_axis": {"model": rf.NVLINK_BW, "data": rf.ICI_BW}},
    ).finalize()
    assert t.compute_s == pytest.approx(1.5, rel=1e-12)
    assert t.collective_s == pytest.approx(2.0, rel=1e-12)


def test_link_rates_follow_the_node():
    pod = dryrun.MESHES["pod16x16"]
    assert rf.link_bw(pod, "model") == rf.link_bw(pod, "data") == rf.ICI_BW
    small = AbstractMesh((2, 4), ("data", "model"))
    assert rf.link_bw(small, "model") == rf.link_bw(small, "data") == rf.NVLINK_BW
    assert rf.link_bw(AbstractMesh((4, 4), ("data", "model")), "data") == rf.ICI_BW


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-1.6b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_meta_counts_equal_a_real_cpu_run(arch, kind):
    cfg = get_smoke_config(arch)
    counts = {}
    for device in ("meta", "cpu"):
        fn, args = dryrun.build_step(cfg, SPECS[kind], None, device,
                                     grad_accum=2 if kind == "train" else 1)
        wc = dryrun.count(fn, args)
        counts[device] = (dict(wc.flops), wc.bytes, dict(wc.ops), wc.peak_bytes)
    assert counts["meta"] == counts["cpu"]
    assert counts["meta"][1] > 0 and sum(counts["meta"][0].values()) > 0


def _projections(cfg) -> int:
    """Sum of d_in * d_out over one dense layer's weights."""
    d = cfg.d_model
    return d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d + 3 * d * cfg.d_ff


def test_decode_matmul_flops_are_2mnk():
    cfg = get_smoke_config("qwen3-0.6b")
    spec = SPECS["decode"]
    b, smax = spec.global_batch, spec.seq_len
    want = (2 * b * cfg.n_layers * _projections(cfg)
            + cfg.n_layers * 4 * b * cfg.n_heads * smax * cfg.head_dim   # q.k, p.v
            + 2 * b * cfg.d_model * cfg.vocab_size)                      # tied head
    wc = dryrun.count(*dryrun.build_step(cfg, spec))
    assert dict(wc.flops) == {"f32": want}


def test_prefill_matmul_flops_are_2mnk():
    cfg = get_smoke_config("qwen3-0.6b")
    spec = SPECS["prefill"]
    b, s = spec.global_batch, spec.seq_len
    cq, ck = cfg.attn_chunk_q, cfg.attn_chunk_kv
    # (query chunk, key chunk) pairs in the causal footprint
    pairs = sum((i * cq + cq - 1) // ck + 1 for i in range(s // cq))
    want = (2 * b * s * cfg.n_layers * _projections(cfg)
            + cfg.n_layers * pairs * 4 * b * cq * cfg.n_heads * ck * cfg.head_dim
            + 2 * b * s * cfg.d_model * cfg.vocab_size)
    wc = dryrun.count(*dryrun.build_step(cfg, spec))
    assert dict(wc.flops) == {"f32": want}


def test_program_dryrun_counts_the_kernels_per_fine_iteration(tmp_path):
    name = program.main(["--dryrun", "--columns", "512", "--out", str(tmp_path)])
    assert name == "program-wv-harp__cols512"
    with open(tmp_path / "pod16x16" / f"{name}.json") as f:
        row = json.load(f)
    iters = WVConfig(method=WVMethod.HARP).max_fine_iters
    calls = {k: v["calls"] for k, v in row["collective_detail"]["kernels"].items()}
    assert calls == {"fwht": 3 * iters, "wv_step": iters}
    assert row["chips"] == 256 and row["status"] == "ok"
    assert row["collective_bytes"] == 0.0       # columns are independent
    assert row["memory_analysis"]["argument_size_in_bytes"] == 2 * 32 * 4 + 2 * 4
    # the kernels' share of the count is their own formula's
    kern = row["collective_detail"]["kernels"]
    assert kern["fwht"]["bytes"] == 3 * iters * fwht_ops.work(2, 32)[0]
    assert kern["wv_step"]["bytes"] == iters * wv_ops.work(2, 32, True)[0]


# PERF.md's kernel table: (work, bound ms printed there, bound by).
BOUNDS = {
    "fwht C=2^18 N=32": (fwht_ops.work(1 << 18, 32), 0.0200, "bytes"),
    "fwht verify sweep C=1,572,864": (fwht_ops.work(1_572_864, 32), 0.1202, "bytes"),
    "fwht spare pass C=393,216": (fwht_ops.work(393_216, 32), 0.0300, "bytes"),
    "fwht fig10 C=8192": (fwht_ops.work(8192, 32), 0.0006, "bytes"),
    "wv_step C=2^18 ternary": (wv_ops.work(1 << 18, 32, True), 0.1052, "bytes"),
    "wv_step C=65,536 ternary": (wv_ops.work(65_536, 32, True), 0.0263, "bytes"),
    "wv_step fig10 C=8192": (wv_ops.work(8192, 32, True), 0.0033, "bytes"),
    "acim decode B=40": (vmm_ops.work(40, 8, 2, 128, 3072), 0.0176, "bytes"),
    "acim prefill B=1280": (vmm_ops.work(1280, 8, 2, 128, 3072), 0.0964, "bytes"),
    "acim admission B=160": (vmm_ops.work(160, 8, 2, 128, 3072), 0.0252, "bytes"),
    "acim one tile B=40": (vmm_ops.work(40, 1, 2, 128, 3072), 0.0023, "bytes"),
    "acim ideal raw B=2048": (vmm_ops.work(2048, 8, 2, 128, 3072, binary=False),
                              0.3846, "operations"),
    "acim llama w_down B=40": (vmm_ops.work(40, 64, 2, 128, 2048), 0.0931, "bytes"),
}


@pytest.mark.parametrize("case", sorted(BOUNDS))
def test_kernel_work_gives_the_tables_bounds(case):
    (nbytes, flops), want_ms, by = BOUNDS[case]
    s, got_by = rf.bound_s(nbytes, flops)
    assert round(s * 1e3, 4) == want_ms and got_by == by


def test_fwht_work_is_the_tables_bytes():
    assert fwht_ops.work(1 << 18, 32) == (67_108_864, {"f32": 41_943_040})


def test_kernel_meta_calls_add_their_work_and_launch_nothing():
    before = (fwht_ops.launches, wv_ops.launches, vmm_ops.launches)
    x = torch.empty((64, 32), device="meta")
    planes = [torch.empty((64, 32), device="meta") for _ in range(8)]
    planes[3] = planes[3].to(torch.int32)
    planes[4] = planes[4].to(torch.bool)
    p = wv_ops.WVCellParams(threshold=1.0, k_streak=2, can_freeze=True, ternary=True,
                            fine_step=0.25, max_pulses=16.0, g_max=7.0,
                            nonlinearity=0.35, reset_asymmetry=0.85,
                            nmap_sqrt_pulses=True)
    g = torch.empty((2, 1, 128, 48), device="meta")
    with rf.WorkCounter() as wc:
        y = fwht_ops.fwht(x)
        outs = wv_ops.wv_cell_update(*planes, p)
        acc = vmm_ops.acim_vmm_tiled(torch.empty((5, 256), device="meta"), g, g,
                                     bc=3, adc_bits=10, full_scale=1.0)
    assert (fwht_ops.launches, wv_ops.launches, vmm_ops.launches) == before
    assert y.shape == x.shape and y.device.type == "meta"
    assert [t.dtype for t in outs] == [torch.float32, torch.int32, torch.bool,
                                       torch.float32, torch.float32]
    assert acc.shape == (5, 48)
    assert {k: v["calls"] for k, v in wc.kernels.items()} == {
        "fwht": 1, "wv_step": 1, "acim_vmm_tiled": 1}
    assert wc.kernels["acim_vmm_tiled"]["bytes"] == vmm_ops.work(5, 2, 1, 128, 48,
                                                                 noise=False)[0]
    with pytest.raises(ValueError):
        fwht_ops.fwht(torch.empty((4, 48), device="meta"))


def test_report_has_the_references_columns(tmp_path):
    cfg = get_smoke_config("qwen3-0.6b")
    mesh = AbstractMesh((2, 4), ("data", "model"))
    spec = SPECS["train"]
    fn, args = dryrun.build_step(cfg, spec, mesh, grad_accum=2)
    wc = dryrun.count(fn, args)
    terms = dryrun.terms_of(wc, mesh, arch="qwen3-0.6b", shape="t", mesh_name="m",
                            model_flops=rf.model_flops(cfg, spec, 128),
                            arg_bytes=dryrun.device_bytes(args))
    dryrun.write_row(terms.to_json(), str(tmp_path))
    (row,) = report.load_rows(str(tmp_path), "m")
    assert row["collective_bytes"] > 0 and row["memory_analysis"]["fits"]
    cols = [c.strip() for c in report.HEADER.splitlines()[0].split("|")[1:-1]]
    jcols = [c.strip() for c in jreport.HEADER.splitlines()[0].split("|")[1:-1]]
    # The one renamed column: the port's compute term is counted, not read off HLO.
    assert cols == [("counted-comp [ms]" if c == "HLO-comp [ms]" else c) for c in jcols]
    mine = [c.strip() for c in report.fmt_row(row).split("|")[1:-1]]
    ref = [c.strip() for c in jreport.fmt_row(row).split("|")[1:-1]]
    assert len(mine) == len(ref) == len(cols)
    same = [0, 1, 2, 4, 5, 8, 9]       # no peak rate enters these cells
    assert [mine[i] for i in same] == [ref[i] for i in same]
    model_ms = row["model_flops"] / (row["chips"] * rf.PEAK_FLOPS) * 1e3
    assert math.isclose(float(mine[3]), model_ms, rel_tol=1e-3, abs_tol=1e-3)
