#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--layers 4]

Run from the repository root on a machine with an NVIDIA H100 and the
CUDA toolkit.  Phases, each of which fails the run:

1. device: needs `torch.cuda.is_available()`; prints the card's name and
   power limit as `nvidia-smi` reports them;
2. build: compiles `src/repro_torch/kernels/csrc/*.cu` into one library;
3. kernels: at the deploy's shapes (2^18 columns of 32 and of 64 cells)
   each CUDA kernel is held against its plain PyTorch version on the same
   inputs (`fwht` bitwise; `wv_step` discrete outputs exactly, g within
   1e-5) and timed (see `_time_ms`) beside its bound (bytes moved at
   3.35 TB/s), its plain version and, for `fwht`, one PyTorch call
   computing the same function (`x @ H`), which the port never calls;
4. quickstart: the four WV methods program 256 x 32 cells on the card
   and on the CPU from the same keys; mean rms error and mean iterations
   must agree within 1%;
5. deploy: qwen3-0.6b at full width (d_model 1024, q_dim 2048, d_ff 3072,
   `--layers` deep, random weights from `SEED`) is programmed by HARP
   through `deploy_arrays`; both kernels must have launched (exactly 3
   `fwht` and 1 `wv_step` per bucket and iteration), the deploy must make
   one host sync, and a materialized leaf must be finite with the right
   shape and dtype;
6. breakdown: the parts of one HARP bucket-iteration (keys, read noise,
   write noise, verify, kernels) timed on their own.

The line before the last is a JSON object with every kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
F32_FLOPS = 67e12                # H100 SXM float32 rate outside tensor cores
C_DEPLOY = 1 << 18               # the deploy's bucket size (columns)
SEED = 0                         # weights, kernel inputs
REPS = 20                        # calls per timing


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn) -> tuple[float, float]:
    """(device ms, stream ms) of one call of `fn`.

    device: `REPS` calls captured in one CUDA graph; CUDA events around
    a replay, divided by `REPS`, median of 5 replays.  The graph issues
    the kernels back to back, so no host time enters.
    stream: `REPS` eager calls with an event between consecutive calls,
    median; here the card waits whenever the host takes longer to issue
    a call's launches than the card takes to run them, so stream minus
    device is the host's share of an eager call.
    """
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    per_replay = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        per_replay.append(start.elapsed_time(end) / REPS)
    del graph

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(REPS + 1)]
    ev[0].record()
    for i in range(REPS):
        fn()
        ev[i + 1].record()
    torch.cuda.synchronize()
    stream = statistics.median(ev[i].elapsed_time(ev[i + 1]) for i in range(REPS))
    return statistics.median(per_replay), stream


def _bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_fwht(n: int, gen) -> dict:
    import torch

    from repro_torch.core.hadamard import hadamard_matrix
    from repro_torch.kernels.fwht import ops, ref

    x = torch.randn(C_DEPLOY, n, device="cuda", generator=gen)
    y = ops.fwht(x)
    want = ref.fwht(x)
    torch.cuda.synchronize()
    err = (y - want).abs().max().item()
    if not torch.equal(y, want):
        bad = (y != want).sum().item()
        raise AssertionError(f"fwht N={n}: {bad} values differ from the plain "
                             f"version, by up to {err}")
    h = hadamard_matrix(n, device="cuda")
    lib = torch.matmul(x, h)
    torch.cuda.synchronize()
    err_lib = (lib - want).abs().max().item()
    bound, by = _bound(8.0 * C_DEPLOY * n, C_DEPLOY * n * math.log2(n))
    ms, ms_s = _time_ms(lambda: ops.fwht(x))
    plain, plain_s = _time_ms(lambda: ref.fwht(x))
    lib_ms, lib_s = _time_ms(lambda: torch.matmul(x, h))
    return dict(
        ms=ms, plain_ms=plain, library_ms=lib_ms,
        stream_ms=ms_s, plain_stream_ms=plain_s, library_stream_ms=lib_s,
        bound_ms=bound, bound_by=by, max_abs_err=err, library_max_abs_err=err_lib,
    )


def phase_wv_step(n: int, ternary: bool, gen) -> dict:
    import torch

    from repro_torch.kernels.wv_step import ops, ref
    from repro_torch.kernels.wv_step.ref import WVCellParams

    c = C_DEPLOY
    dev = "cuda"
    r = lambda: torch.randn(c, n, device=dev, generator=gen)  # noqa: E731
    agg = r() * (8.0 if ternary else 1.0)
    dev_mag = r().abs() * 2.0
    g = torch.rand(c, n, device=dev, generator=gen) * 7.0
    streak = torch.randint(0, 3, (c, n), device=dev, generator=gen, dtype=torch.int32)
    frozen = torch.rand(c, n, device=dev, generator=gen) < 0.3
    frozen[: c // 8] = True
    c2c = 1.0 + 0.15 * r()
    nmap = 0.05 * r()
    d2d = 1.0 + 0.1 * r()
    args = (agg, dev_mag, g, streak, frozen, c2c, nmap, d2d)
    p = WVCellParams(
        threshold=4.0 * n / 32 if ternary else 0.5, k_streak=2, can_freeze=True,
        ternary=ternary, fine_step=0.25, max_pulses=16.0, g_max=7.0,
        nonlinearity=0.35, reset_asymmetry=0.85, nmap_sqrt_pulses=True,
    )
    got = ops.wv_cell_update(*args, p)
    want = ref.wv_cell_update(*args, p)
    torch.cuda.synchronize()
    names = ("g", "streak", "frozen", "n_p", "direction")
    for name, a, b in zip(names[1:], got[1:], want[1:]):
        if not torch.equal(a, b):
            raise AssertionError(
                f"wv_step N={n} ternary={ternary}: {name} differs in "
                f"{(a != b).sum().item()} cells")
    err = (got[0] - want[0]).abs().max().item()
    if not err <= 1e-5:
        raise AssertionError(f"wv_step N={n} ternary={ternary}: g off by {err}")
    read = (25 if ternary else 29) * c * n      # dev_mag unread when ternary
    bound, by = _bound(read + 17.0 * c * n, 30.0 * c * n)
    ms, ms_s = _time_ms(lambda: ops.wv_cell_update(*args, p))
    plain, plain_s = _time_ms(lambda: ref.wv_cell_update(*args, p))
    return dict(
        ms=ms, plain_ms=plain, library_ms=None,
        stream_ms=ms_s, plain_stream_ms=plain_s, library_stream_ms=None,
        bound_ms=bound, bound_by=by, max_abs_err=err,
    )


def phase_quickstart() -> dict:
    """The quickstart table on the card and on the CPU from the same keys."""
    import torch

    from repro_torch.core import WVConfig, WVMethod, program_columns, rng

    rows = {}
    for device in ("cuda", "cpu"):
        tkey, pkey = rng.split(rng.PRNGKey(0, device=device))
        targets = torch.floor(rng.uniform(tkey, (256, 32)) * 8.0)
        for method in WVMethod:
            g, st = program_columns(pkey, targets, WVConfig(method=method),
                                    device=device)
            rows[(method.value, device)] = dict(
                rms=float(st.rms_error_lsb.mean()),
                iters=float(st.iterations.mean()),
                lat_us=float(st.latency_ns.mean()) / 1e3,
                e_nj=float(st.energy_pj.mean()) / 1e3,
            )
    print(f"{'method':8s} {'device':6s} {'rms[LSB]':>9s} {'iters':>6s} "
          f"{'lat[us]':>8s} {'E[nJ]':>7s}")
    for (m, d), r in rows.items():
        print(f"{m:8s} {d:6s} {r['rms']:9.4f} {r['iters']:6.2f} "
              f"{r['lat_us']:8.2f} {r['e_nj']:7.3f}")
    for method in WVMethod:
        a, b = rows[(method.value, "cuda")], rows[(method.value, "cpu")]
        for k in ("rms", "iters"):
            if not abs(a[k] / b[k] - 1.0) <= 0.01:
                raise AssertionError(
                    f"quickstart {method.value}: {k} {a[k]} on the card vs "
                    f"{b[k]} on the CPU (more than 1% apart)")
    return rows


def phase_deploy(layers: int) -> dict:
    import torch

    from repro_torch.configs.qwen3_0_6b import CONFIG
    from repro_torch.core import WVConfig, WVMethod, pipeline, rng
    from repro_torch.core.programmer import deploy_arrays
    from repro_torch.kernels.fwht import ops as fwht_ops
    from repro_torch.kernels.wv_step import ops as wv_ops
    from repro_torch.models import init_params

    cfg = CONFIG.replace(n_layers=layers)
    params = init_params(SEED, cfg, device="cuda")
    wv_cfg = WVConfig(method=WVMethod.HARP)
    key = rng.PRNGKey(SEED + 1, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # Count only the main path's launches.
    fwht_ops.launches = 0
    wv_ops.launches = 0
    pipeline.reset_counters()
    t0 = time.perf_counter()
    model, report = deploy_arrays(key, params, wv_cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fwht": fwht_ops.launches, "wv_step": wv_ops.launches}
    syncs = pipeline.host_sync_count()
    buckets = len(pipeline.bucket_sizes(report.num_columns))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    print(f"deploy qwen3-0.6b layers={layers} d_model={cfg.d_model} "
          f"q_dim={cfg.q_dim} d_ff={cfg.d_ff} method=harp")
    print(f"  columns={report.num_columns} cells={report.num_cells} "
          f"buckets={buckets} leaves={len(model.arrays)}")
    print(f"  rms_cell_error_lsb={report.rms_cell_error_lsb:.6f} "
          f"mean_iterations={report.mean_iterations:.4f}")
    print(f"  simulated array latency (critical) = {report.critical_latency_ns / 1e3:.3f} us, "
          f"energy = {report.total_energy_pj / 1e6:.3f} uJ")
    print(f"  wall_s={wall:.3f} peak_device_mem_gib={peak_gib:.2f}")
    print(f"  launches fwht={launches['fwht']} wv_step={launches['wv_step']} "
          f"host_syncs={syncs}")

    per_bucket_iter = buckets * wv_cfg.max_fine_iters
    if launches["fwht"] != 3 * per_bucket_iter or launches["wv_step"] != per_bucket_iter:
        raise AssertionError(
            f"deploy launched fwht {launches['fwht']}x and wv_step "
            f"{launches['wv_step']}x; HARP needs 3 and 1 per bucket-iteration "
            f"({per_bucket_iter})")
    if syncs != 1:
        raise AssertionError(f"deploy made {syncs} host syncs, expected 1")
    if not 0.0 < report.rms_cell_error_lsb < 0.5:
        raise AssertionError(f"rms cell error {report.rms_cell_error_lsb} out of range")

    name = "['layers']['wq']"
    leaf = model.arrays[name].materialize()
    w0 = params["layers"]["wq"]
    if leaf.shape != w0.shape or leaf.dtype != w0.dtype:
        raise AssertionError(f"{name}: {leaf.dtype}{tuple(leaf.shape)} vs "
                             f"{w0.dtype}{tuple(w0.shape)}")
    if not bool(torch.isfinite(leaf).all()):
        raise AssertionError(f"{name}: non-finite programmed weights")
    a, b = leaf.float().flatten(), w0.float().flatten()
    corr = float(torch.corrcoef(torch.stack([a, b]))[0, 1])
    print(f"  {name} materialized {leaf.dtype} {tuple(leaf.shape)}, "
          f"correlation with the written weights {corr:.5f}")
    if not corr > 0.95:
        raise AssertionError(f"{name}: programmed weights correlate {corr} with the written")
    return dict(wall_s=wall, launches=launches, report=report)


def phase_breakdown() -> None:
    """Time the parts of one HARP bucket-iteration (2^18 x 32).

    Each part is timed on its own by `_time_ms` (device and stream ms);
    the whole iteration is timed the same way.
    """
    import torch

    from repro_torch.core import WVConfig, WVMethod, device as dev_mod, rng
    from repro_torch.core.wv import verify_aggregate
    from repro_torch.kernels.fwht import ops as fwht_ops
    from repro_torch.kernels.wv_step import ops as wv_ops
    from repro_torch.kernels.wv_step.ref import WVCellParams
    from repro_torch.readout import config as ro_config, noise as ro_noise

    c, n = C_DEPLOY, 32
    cfg = WVConfig(method=WVMethod.HARP)
    key = rng.PRNGKey(3, device="cuda")
    targets = torch.floor(rng.uniform(key, (c, n)) * 8.0)
    g = (targets + 0.3 * rng.normal(rng.fold_in(key, 1), (c, n))).clamp(0.0, 7.0)
    k_loop = rng.split(rng.fold_col_keys(key, torch.arange(c, device="cuda")), 3)[2]
    k_v, k_w = rng.split(rng.fold_in(k_loop, 0))
    streak = torch.zeros((c, n), dtype=torch.int32, device="cuda")
    frozen = torch.zeros((c, n), dtype=torch.bool, device="cuda")
    d2d = torch.ones((c, n), device="cuda")
    noise = ro_config.for_wv_method(cfg).noise
    p = WVCellParams(threshold=cfg.tau_w, k_streak=2, can_freeze=True, ternary=True,
                     fine_step=0.25, max_pulses=16.0, g_max=7.0, nonlinearity=0.35,
                     reset_asymmetry=0.85, nmap_sqrt_pulses=True)
    agg, mag, _, _ = verify_aggregate(k_v, g, targets, cfg)
    c2c, nmap = dev_mod.sample_write_noise(k_w, (c, n), cfg.device)

    def iteration():
        kv, kw = rng.split(rng.fold_in(k_loop, 0))
        a, m, _, _ = verify_aggregate(kv, g, targets, cfg)
        cc, nm = dev_mod.sample_write_noise(kw, (c, n), cfg.device)
        wv_ops.wv_cell_update(a, m, g, streak, frozen, cc, nm, d2d, p)

    parts = {
        "keys: fold_in + split (per-column keys)":
            lambda: rng.split(rng.fold_in(k_loop, 0)),
        "read noise: sample_read_fields (C,1,N)+(C,1,1)":
            lambda: ro_noise.sample_read_fields(k_v, (c,), 1, n, noise),
        "write noise: sample_write_noise 2 x (C,N)":
            lambda: dev_mod.sample_write_noise(k_w, (c, n), cfg.device),
        "one normal draw (C,N) per-column keys":
            lambda: rng.normal(k_w, (c, n)),
        "verify_aggregate (incl. read noise, 3 fwht)":
            lambda: verify_aggregate(k_v, g, targets, cfg),
        "fwht kernel x3":
            lambda: [fwht_ops.fwht(g) for _ in range(3)],
        "wv_step kernel":
            lambda: wv_ops.wv_cell_update(agg, mag, g, streak, frozen, c2c, nmap, d2d, p),
        "whole iteration (keys, verify, write noise, wv_step)": iteration,
    }
    print(f"breakdown of one HARP bucket-iteration ({c} x {n}):")
    print(f"  {'part':55s} {'device ms':>10s} {'stream ms':>10s}")
    for name, fn in parts.items():
        dev_ms, stream_ms = _time_ms(fn)
        print(f"  {name:55s} {dev_ms:10.4f} {stream_ms:10.4f}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=4,
                    help="qwen3-0.6b depth to deploy (28 = the whole model)")
    args = ap.parse_args()
    sys.stdout.reconfigure(line_buffering=True)
    t_start = time.perf_counter()

    def stamp(what: str) -> None:
        print(f"[{time.perf_counter() - t_start:8.2f} s] {what}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _nvidia_smi()
    print(f"device: {torch.cuda.get_device_name(0)} (torch {torch.__version__}, "
          f"CUDA {torch.version.cuda})")
    print(smi)

    t0 = time.perf_counter()
    so = build.build()
    build.load()
    print(f"build: {so.name} in {time.perf_counter() - t0:.2f} s")
    if build.last_build_log:
        print(build.last_build_log.strip())

    stamp("kernel phases")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    k = {}
    for n in (32, 64):
        k[("fwht", n)] = phase_fwht(n, gen)
        for ternary in (True, False):
            k[("wv_step", n, ternary)] = phase_wv_step(n, ternary, gen)
    print(f"kernels at C={C_DEPLOY} columns ({smi}); device ms (stream ms):")
    for key, r in k.items():
        lib = ("-" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ({r['library_stream_ms']:.4f})")
        print(f"  {str(key):26s} ms={r['ms']:.4f} ({r['stream_ms']:.4f}) "
              f"plain_ms={r['plain_ms']:.4f} ({r['plain_stream_ms']:.4f}) "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) library_ms={lib} "
              f"max_abs_err={r['max_abs_err']:.3g}")

    stamp("quickstart phase")
    phase_quickstart()
    stamp("deploy phase")
    dep = phase_deploy(args.layers)
    stamp("breakdown phase")
    phase_breakdown()
    stamp("done")

    main_fwht, main_wv = k[("fwht", 32)], k[("wv_step", 32, True)]
    line = {"kernels": [
        dict(name="fwht", route="cuda", source="src/repro_torch/kernels/csrc/fwht.cu",
             replaces="src/repro/kernels/fwht/fwht.py:62",
             launches=dep["launches"]["fwht"], max_abs_err=main_fwht["max_abs_err"],
             ms=main_fwht["ms"], plain_ms=main_fwht["plain_ms"],
             bound_ms=main_fwht["bound_ms"], bound_by=main_fwht["bound_by"],
             library_ms=main_fwht["library_ms"]),
        dict(name="wv_step", route="cuda", source="src/repro_torch/kernels/csrc/wv_step.cu",
             replaces="src/repro/kernels/wv_step/wv_step.py:99",
             launches=dep["launches"]["wv_step"], max_abs_err=main_wv["max_abs_err"],
             ms=main_wv["ms"], plain_ms=main_wv["plain_ms"],
             bound_ms=main_wv["bound_ms"], bound_by=main_wv["bound_by"],
             library_ms=None),
    ]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
