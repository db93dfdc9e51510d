#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--layers 2] [--train-layers 2] [--peak-of DIR]

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
   one host sync (counted, and the only one CUDA sync debugging sees),
   and a materialized leaf must be finite with the right shape and dtype;
6. breakdown: the parts of one HARP bucket-iteration (keys, read noise,
   write noise, verify, kernels) timed on their own;
7. acim_vmm: at the serving path's shapes (layer 0 of the deployed w_gate
   leaf: 8 tiles of 128 rows, 2 slices, 3072 outputs; decode B = 40 and
   prefill B = 1280 rows, and the one-tile form at B = 40), each with
   binary DAC planes (the kernel's bf16 x 3 tensor-core route) and with
   raw activations (the ideal driver's f32 route), the kernel is held
   against its plain version with the ADC off (rtol 1e-4, atol 1e-2) and
   on (every other element a sum of whole code flips, under 1%), and
   timed beside its bound (bytes, or operations at the route's rate),
   its plain version and one batched `torch.matmul` of the pre-ADC
   products (which omits the epilogue);
8. serving: phase 5's deployment is served through `CIMExecutor` and
   `ServeEngine` — first with ideal converters in float32 against the
   digital forward on the same arrays (logits, and greedy tokens over 8
   decode steps), then with `examples/serve_lm.py`'s defaults (batch 4,
   prompt 32, 32 new tokens, DAC 6 / ADC 10 bits, read noise 0.2 LSB) in
   bf16: exactly 7 `acim_vmm_tiled` launches per layer (7 analog
   leaves; 14 at the default 2 layers) per prefill and per decode step, tokens in the vocabulary,
   logits finite; then the parts of one decode step (noise draws, DAC
   streams, the kernel beside its byte bound, attention, the rest) timed
   on their own;
9. continuous serving: phase 5's deployment is served by the
   `ContinuousScheduler` with `examples/serve_lm.py --analog
   --continuous`'s defaults (4 slots, max_len 72, 16 Poisson requests at
   load 0.3, prompts of 16-32 and 16-32 new tokens, greedy), while a
   VERIFY_TRIGGERED `LifetimeSimulator` fed the executor's reads ages the
   arrays one hour and scrubs a two-leaf window every 8 decode steps;
   then 8 shorter requests with 16-token prefill chunks (and 16-token
   attention chunks, which the prefill chunks must align with) and EDF
   admission.  Each stream must complete every request with tokens in
   the vocabulary, build no step function after warmup, make one host
   sync per decode step (the dispatches run under CUDA sync debugging
   set to "error"), launch exactly 7 `acim_vmm_tiled` per layer per
   admission, chunk and decode step, and serve ``decode_steps * n_slots +
   prefill_tokens`` tokens; every scrub epoch must launch `fwht`, and
   the run must re-program a column (`wv_step` launches).  Times and
   launches per dispatch are read from the scheduler's `obs` spans.  Then
   `acim_vmm` at B = 160 and 320 (16- and 32-token admissions),
   `fwht` / `wv_step` at the run's smallest re-programmed subset, and
   `fwht` on the verify sweeps' own operands (conductances, targets and
   comparator signs of the largest leaf and of a norm-scale leaf) are
   held and timed as in phases 3 and 7, and the parts of a decode step
   and of a scrub epoch are timed;
10. faulty silicon: `benchmarks/fault_tolerance.py`'s highest fault rate
   (`FAULTS`: 2% of cells stuck or weak, a lognormal per-tile rate, 64
   columns per tile) with HARP and its 80-pulse give-up budget.  A
   zero-fault guard at 1 layer must program bitwise what a plain deploy
   programs.  Then phase 5's params and key deploy in two arms, "none"
   (faults and give-up) and "remap" (25% spare columns and fault-aware
   placement): each in one host sync (CUDA sync debugging sees only the
   report's fetch and the placement probe), with 3 `fwht` and 1
   `wv_step` launches per bucket-iteration over both passes' buckets;
   "none" must give up on cells, "remap" must remap columns and come
   closer to phase 5's clean weights, pin every stuck cell and keep its
   remap tables permutations.  `wv_step` is held on a faulty bucket's
   operands (weak cells, fault-scaled efficiency), `fwht` on the spare
   pass's targets, `acim_vmm_tiled` on a remapped leaf, the fault
   sampler and the spare ranking on the card against the CPU.  The
   remap arm is served (ideal converters against its digital forward;
   then prefill + 8 noisy decode steps of 7 launches per layer), scrubbed
   for two epochs (no inactive row flagged or re-programmed, `wv_step`
   on the re-program), and converter offsets are calibrated over the
   w_down leaf's columns (residual spread under 0.1 of the offsets');
11. train, write-and-verify, eval loss: qwen3-0.6b at full width,
   `--train-layers` deep, trains 30 steps (bf16 params, float32 AdamW
   moments, `AdamWConfig()`, `SyntheticLM(151936, seq 256, batch 8, seed
   0)`); every update must lower its own batch's loss (on fresh batches
   the loss stays near ln(vocab): the chain is not learned in 30 steps);
   step times (host median, device) and tokens/s
   are printed, and the tied head + CE timed on its own.  The same steps
   run again under deterministic algorithms with an async checkpoint at
   step 15, restored into fresh tensors and resumed: both bitwise.  The
   trained params are deployed by CW-SC and HARP at 0.7 LSB verify read
   noise (fig10's severe point): one host sync and exactly 1 `wv_step`
   (+ 3 `fwht` for HARP) per bucket-iteration each, HARP's rms cell error
   below CW-SC's; each deployment's eval loss is read digitally, through
   the arrays with ideal converters (within 1e-4 of the float32 digital
   loss) and at `serve_lm`'s analog defaults; `fwht`, `wv_step` and
   `acim_vmm_tiled` are held and timed on this path's operands;
12. fig10 on the card: `benchmarks/fig10_robustness.py`'s tiny LM trained
   220 steps and deployed by CW-SC, HD-PV and HARP at 0.1, 0.4 and 0.7
   LSB; at 0.7 HD-PV's and HARP's rms must be below CW-SC's and their
   dloss within CW-SC's + 0.01; `fwht` and `wv_step` are held and timed
   on the operands of each bucket the HARP deploy at 0.7 LSB runs;
13. registry models at full width, through the port's entry points:
   llama3.2-1b (`configs.get_config`, `REGISTRY_LAYERS` of 16 layers)
   deployed by HARP and served by `examples/torch_serve_lm.py --analog
   --continuous`'s own functions at its defaults; the deploy makes one
   host sync and folds per-tile health, digests, counters and ledger
   rows that must agree with its report; the stream is held as phase
   9's; `obs.fleet_status()` feeds an `SLOPolicy` (p99 latency, gave-up
   cells) whose every metric must resolve; the trace is rendered by the
   port's `obs.report` and `obs.dashboard`.  smollm-360m (d_model 960,
   kv_dim 320) is deployed and served with ideal converters against its
   digital forward.  `fwht`, `wv_step` and `acim_vmm_tiled` are held and
   timed on this phase's operands (llama's w_down and w_gate, smollm's
   partial-tile wq and 320-wide wk);
14. families: each non-dense registry model (`FAMILY_RUNS`: olmoe and
   qwen3-moe, rwkv6, hymba, the VLM, musicgen) at full width in bf16,
   depth cut, runs `prefill` over its prompt and 8 `decode_step`s for
   batch 2; the last step is held against `forward` over the whole
   sequence at that position (within `FAMILY_TOL` of the largest
   logit).  An MoE model's capacity couples the tokens of a call: at
   its registry capacity factor the forward's drop counts are printed
   and only rows that capacity routed alike in the prefill and the
   forward are held; then, on the same params and inputs, with the
   capacity lifted to every token, every row is held.  Then hymba-1.5b at 3 layers is deployed by HARP through
   `torch_serve_lm.py`'s `deploy_model` (one host sync, telemetry held
   as phase 13's), served at the script's fixed-batch analog defaults
   (batch 4, prompt 32, 32 new tokens, DAC 6 / ADC 10 bits, read noise
   0.2 LSB; 21 `acim_vmm_tiled` launches per access) and with ideal
   converters against its digital forward; `acim_vmm_tiled` is held and
   timed at decode on its w_down (K = 5504, 43 tiles), wk (M = 320) and
   w_gate (M = 5504), and `fwht` / `wv_step` on w_down's first fine
   iteration;
15. training on a device mesh: a world of one over NCCL and a (1, 1)
   ("data", "model") mesh.  smollm-360m's full train state (32 layers,
   d_model 960, vocab 49152) stored as `launch.shardings.state_sharding`
   says; one sharded train step equals the plain step from the same
   state bitwise (both under deterministic algorithms); olmoe-1b-7b's
   expert-parallel `moe_block(mesh=)` at full width (64 experts, top 8,
   batch 2 x 256) equals `moe_block(None)` bitwise; `compressed_psum`
   over a pod axis of 1 keeps each row within half a quantisation step
   and moves only int32 payloads; then `python -m
   repro_torch.launch.train` at its defaults (smollm-360m at full width
   and depth, seq 256, batch 8) runs `MESH_STEPS` steps with a failure
   injected at `MESH_FAIL_AT` and again without: the first restarts once
   and ends on the second's state, bitwise.  Step, block and compression
   host / stream ms, checkpoint save / wait / restore host ms and the
   phase's wall time are printed; the phase launches none of the port's
   kernels (the reference's training reaches no Pallas kernel);
16. deploy and serve on a device mesh, in phase 15's world of one on a
   (1, 1) ("data", "model") mesh: qwen3-0.6b at full width, 1 layer,
   deployed by HARP with `mesh=` and without (conductances, report and
   health tree bitwise equal, one host sync each, 3 `fwht` and 1
   `wv_step` per bucket-iteration on the mesh path); served through
   `CIMExecutor(mesh=)` + `ServeEngine(mesh=)` and the plain pair at
   `serve_lm`'s analog defaults for `MESH_SERVE_NEW` new tokens (tokens
   bitwise equal, 7 `acim_vmm_tiled` per access, a decode step's host ms
   each); `ContinuousScheduler(batch_mesh=)` against a plain scheduler
   over `MESH_REQUESTS` requests (the same tokens, phase 9's contracts);
   `repro_torch.launch.program`'s real mode; then `fwht`, `wv_step` and
   `acim_vmm_tiled` on this path's operands (`mesh_case` in the kernels
   line, beside each kernel's `launches_mesh`);
17. the launch tools against the card: `launch.dryrun` counts
   qwen3-0.6b's train_4k and decode_32k cells on the meta device on the
   production pod, `launch.program --dryrun` 2^18 columns, and
   `launch.report` renders them; then a HARP `program_columns` bucket
   (2^18 x 32) and a digital qwen3-0.6b decode step (`LAUNCH_DECODE`)
   are counted on the meta device and run on the card: each measured
   stream time must be at least 0.95 of its counted bound, and the
   bucket must launch the 3 `fwht` and 1 `wv_step` per fine iteration
   it counts (`launches_launch` in the kernels line);
18. rematerialisation: qwen3-0.6b at full width and depth (`get_config`:
   28 layers, `remat=True`, bf16 params, float32 AdamW moments) takes one
   warm-up and `REMAT_STEPS` train steps at batch 4 x seq 4096 on
   `SyntheticLM(151936, seq 4096, batch 4, seed 0)`: each loss finite,
   each step's host ms (ending in a sync), tokens/s and the peak of
   `torch.cuda.max_memory_allocated()`, which must stay under the card's
   80 GB.  Then at 2 layers, batch 1 x seq 4096, one gradient with
   `cfg.remat` False and one with True under deterministic algorithms
   (scoped to them): the loss and every gradient leaf bitwise equal, and
   both peaks printed.  A no-grad `forward` of that batch runs no
   checkpoint (`models.remat.checkpoints`) and gives the grad-enabled
   forward's logits bitwise.  The phase launches none of the port's
   kernels (`launches_remat` in the kernels line, all 0).
   ``python3 chip_smoke.py --peak-of DIR`` runs only the pair, with the
   port in ``DIR/src`` (a `git archive` of another commit), and prints
   its peaks.

The line before the last is a JSON object with every kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

C_DEPLOY = 1 << 18               # the deploy's bucket size (columns)
SEED = 0                         # weights, kernel inputs
REPS = 20                        # calls per timing
AGING_S = 3600.0                 # phase 9: device age added per scrub epoch
# Phase 10: `benchmarks/fault_tolerance.py`'s highest fault rate,
# `_fault_cfg(0.02)`, its give-up budget and its remap arm.
FAULTS = dict(p_stuck_hrs=0.01, p_stuck_lrs=0.005, p_weak=0.005,
              sigma_tile_fault_dec=0.5, columns_per_tile=64, tiles_per_chip=16)
GIVE_UP_PULSES = 80
TRAIN_STEPS = 30                 # phase 11: train steps at full width
CKPT_STEP = 15                   # phase 11: the checkpoint's step
EVAL_STEP = 10_000               # phases 11-12: the eval batch (fig10's step)
EVAL_SEQS = 2                    # phase 11: sequences per noisy in-array eval call
VERIFY_SIGMA = 0.7               # phases 11-12: fig10's severe verify read noise, LSB
FIG10_STEPS = 220                # phase 12: `fig10_robustness._train_tiny_lm`'s steps
REGISTRY_LAYERS = 1              # phase 13: depth of llama3.2-1b and smollm-360m
REGISTRY_REQUESTS = 16           # phase 13: `torch_serve_lm.py`'s default request count
# Phase 14: each family's registry model at full width, depth cut:
# (arch, layers, prompt tokens).  The VLM keeps two cross groups of 5
# layers: at 5 layers (cross_attn_every == n_layers) the reference's
# forward skips its cross block (ROADMAP.md C10).
FAMILY_RUNS = (("olmoe-1b-7b", 2, 256), ("qwen3-moe-235b-a22b", 1, 256),
               ("rwkv6-1.6b", 2, 256), ("hymba-1.5b", 3, 1100),
               ("llama-3.2-vision-11b", 10, 256), ("musicgen-medium", 2, 256))
FAMILY_BATCH = 2                 # phase 14: sequences per model
FAMILY_STEPS = 8                 # phase 14: decode steps after the prefill
FAMILY_TOL = 0.05                # phase 14: bf16 decode vs forward, of the largest logit
HYMBA_LAYERS = 3                 # phase 14: hymba-1.5b's depth for the deploy and serve
MESH_STEPS = 20                  # phase 15: the launcher's steps
MESH_FAIL_AT = 15                # phase 15: the launcher's injected failure
MESH_SERVE_NEW = 8               # phase 16: new tokens of each engine's generate
MESH_REQUESTS = 4                # phase 16: requests through the batch_mesh scheduler
LAUNCH_DECODE = (16, 4096)       # phase 17: the decode step's batch and cache length
REMAT_RUN = (4, 4096)            # phase 18: full-depth qwen3-0.6b's batch and seq
REMAT_STEPS = 3                  # phase 18: timed steps after one warm-up step
REMAT_PAIR = (2, 1, 4096)        # phase 18: layers, batch, seq of the remat on / off pair


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


def _bound(bytes_moved: float, flops: dict[str, float]) -> tuple[float, str]:
    """Least ms for the work (a kernel's `work()`, or bytes and FLOPs by
    dtype class): bytes at the card's memory rate or operations at each
    class's rate (`launch.roofline`'s H100 SXM constants), whichever is
    larger, and which of the two it is."""
    from repro_torch.launch import roofline

    s, by = roofline.bound_s(bytes_moved, flops)
    return s * 1e3, by


def phase_fwht(n: int, gen, c: int = C_DEPLOY, x=None) -> dict:
    """`fwht` against its plain version, bitwise, and timed: on a random
    (c, n) batch, or on the operand `x` when one is given."""
    import torch

    from repro_torch.core.hadamard import hadamard_matrix
    from repro_torch.kernels.fwht import ops, ref

    if x is None:
        x = torch.randn(c, n, device="cuda", generator=gen)
    c, n = x.numel() // x.shape[-1], x.shape[-1]
    y = ops.fwht(x)
    want = ref.fwht(x)
    torch.cuda.synchronize()
    err = (y - want).abs().max().item()
    if not torch.equal(y, want):
        bad = (y != want).sum().item()
        raise AssertionError(f"fwht C={c} N={n}: {bad} values differ from the "
                             f"plain version, by up to {err}")
    h = hadamard_matrix(n, device="cuda")
    lib = torch.matmul(x, h)
    torch.cuda.synchronize()
    err_lib = (lib - want).abs().max().item()
    bound, by = _bound(*ops.work(c, n))
    ms, ms_s = _time_ms(lambda: ops.fwht(x))
    plain, plain_s = _time_ms(lambda: ref.fwht(x))
    lib_ms, lib_s = _time_ms(lambda: torch.matmul(x, h))
    return dict(
        ms=ms, plain_ms=plain, library_ms=lib_ms,
        stream_ms=ms_s, plain_stream_ms=plain_s, library_stream_ms=lib_s,
        bound_ms=bound, bound_by=by, max_abs_err=err, library_max_abs_err=err_lib,
    )


def phase_wv_step(n: int, ternary: bool, gen, c: int = C_DEPLOY) -> dict:
    import torch

    from repro_torch.kernels.wv_step.ref import WVCellParams

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
    return _wv_case(args, p)


def _wv_case(args, p) -> dict:
    """Hold `wv_step` against its plain version on the operands `args`
    (discrete outputs exactly, g within 1e-5) and time both."""
    import torch

    from repro_torch.kernels.wv_step import ops, ref

    c, n = args[0].shape
    ternary = p.ternary
    got = ops.wv_cell_update(*args, p)
    want = ref.wv_cell_update(*args, p)
    torch.cuda.synchronize()
    names = ("g", "streak", "frozen", "n_p", "direction")
    for name, a, b in zip(names[1:], got[1:], want[1:]):
        if not torch.equal(a, b):
            raise AssertionError(
                f"wv_step C={c} N={n} ternary={ternary}: {name} differs in "
                f"{(a != b).sum().item()} cells")
    err = (got[0] - want[0]).abs().max().item()
    if not err <= 1e-5:
        raise AssertionError(f"wv_step C={c} N={n} ternary={ternary}: g off by {err}")
    bound, by = _bound(*ops.work(c, n, ternary))
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
    (model, report), dbg_syncs, dbg_where = _sync_counted(
        lambda: deploy_arrays(key, params, wv_cfg, device="cuda"))
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
          f"host_syncs={syncs} (sync debugging saw {dbg_syncs} at {dbg_where})")

    per_bucket_iter = buckets * wv_cfg.max_fine_iters
    if launches["fwht"] != 3 * per_bucket_iter or launches["wv_step"] != per_bucket_iter:
        raise AssertionError(
            f"deploy launched fwht {launches['fwht']}x and wv_step "
            f"{launches['wv_step']}x; HARP needs 3 and 1 per bucket-iteration "
            f"({per_bucket_iter})")
    if syncs != 1 or dbg_syncs != 1:
        raise AssertionError(f"deploy made {syncs} counted host syncs, {dbg_syncs} seen by "
                             f"sync debugging, expected 1 and 1")
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
    return dict(wall_s=wall, launches=launches, report=report, model=model,
                params=params, key=key)


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


def _check_vmm(got, want, *, w, n_tiles, s, bc, adc: bool, what: str) -> tuple[float, int]:
    """The acim_vmm tolerance (tests/acim_flips.py): rtol 1e-4, atol 1e-2;
    with the ADC on, an element outside it must differ by a sum of whole
    code flips, at most one per (tile, slice), each w * 2^(bc*l), and such
    elements stay under 1%.  Returns (max |got - want|, flipped elements)."""
    import numpy as np

    g = got.double().cpu().numpy()
    t = want.double().cpu().numpy()
    err = float(np.max(np.abs(g - t))) if g.size else 0.0
    off = ~np.isclose(g, t, rtol=1e-4, atol=1e-2)
    if not off.any():
        return err, 0
    if not adc:
        raise AssertionError(f"acim_vmm {what}: {off.sum()} values outside "
                             f"rtol 1e-4 / atol 1e-2, by up to {err}")
    if not off.mean() < 0.01:
        raise AssertionError(f"acim_vmm {what}: {off.sum()} of {off.size} values flipped")
    sums = {0}
    for _ in range(n_tiles):
        for l in range(s):
            sums = {a + d * (1 << (bc * l)) for a in sums for d in (-1, 0, 1)}
    sums = np.array(sorted(sums - {0}), np.float64)
    diff = (g - t)[off] / w
    near = np.min(np.abs(diff[:, None] - sums[None, :]), axis=1)
    if not np.all(near <= (1e-2 + 1e-4 * np.abs(t[off])) / w):
        raise AssertionError(f"acim_vmm {what}: differences of {diff[near > 1e-3]} "
                             "code widths are not sums of code flips")
    return err, int(off.sum())


def phase_acim_vmm(model, gen) -> dict:
    """The acim_vmm kernel at the serving path's shapes.

    Operands: layer 0 of qwen3-0.6b's w_gate leaf as deployed in phase 5
    (T = 8 tiles of R = 128 rows, S = 2 slices, M = 3072, bc = 3) and read
    noise 0.2 * N(0, 1) from the seeded generator.  Rows: decode (4
    tokens, B = 40), prefill (128 tokens, B = 1280), and the one-tile form
    at B = 40; each with x the DAC planes of random activations (P = 10
    {0, 1} planes per token: the bf16 x 3 tensor-core route, bounded by
    bytes against 3 bf16 products per MAC at the tensor-core rate) and
    with x raw N(0, 1) activations of the same shape (the ideal driver:
    the f32 route, bounded against the float32 rate).  Each is held
    against the plain version with the ADC off and on (10 bits) and timed
    at the serving configuration (ADC on, noise on).
    """
    from repro_torch.cim import CIMConfig, build_weight
    from repro_torch.core import rng

    cfg = CIMConfig(dac_bits=6, adc_bits=10, sigma_read_lsb=0.2)
    w = build_weight(model.arrays["['layers']['w_gate']"], cfg,
                     rng.PRNGKey(0, device="cuda")).layer(0)
    out = {case: _vmm_case(w, cfg, tokens, tiles, raw, gen, case)
           for case, tokens, tiles, raw in (
               ("decode", 4, w.n_tiles, False), ("prefill", 128, w.n_tiles, False),
               ("one tile", 4, 1, False), ("decode raw", 4, w.n_tiles, True),
               ("prefill raw", 128, w.n_tiles, True), ("one tile raw", 4, 1, True))}
    _print_vmm(w, cfg, out)
    return out


def _vmm_case(w, cfg, tokens: int, tiles: int, raw: bool, gen, case: str,
              rows: int | None = None) -> dict:
    """Hold one `acim_vmm` case against its plain version (ADC off and
    on) and time it beside its bound, its plain version and the batched
    `torch.matmul` of its pre-ADC products; see `phase_acim_vmm`.  With
    `raw`, `rows` (default: the DAC planes of `tokens`) sets B."""
    import torch

    from repro_torch.cim.mvm import _dac_stream
    from repro_torch.kernels.acim_vmm import ops, ref

    gp, gn = w.g_pos, w.g_neg
    _, s, r, m = gp.shape
    fs = 2.0 * r * (w.levels - 1)
    width = fs / (1 << cfg.adc_bits)
    d = gp - gn
    xf = torch.randn(tokens, w.rows_in, device="cuda", generator=gen)
    planes, _ = _dac_stream(xf, cfg)
    # Zero rows pad a partial last tile, as `cim.mvm.cim_matmul` pads them.
    x = planes.reshape(-1, w.rows_in)
    x = torch.nn.functional.pad(x, (0, max(0, tiles * r - w.rows_in)))
    x = x[:, : tiles * r].contiguous()
    b = x.shape[0]
    if raw:
        b = rows or b
        x = torch.randn(b, tiles * r, device="cuda", generator=gen)
    nz = 0.2 * torch.randn(tiles, s, b, m, device="cuda", generator=gen)
    if tiles == 1:
        args = (x, gp[0], gn[0])
        kern = lambda a, n: ops.acim_vmm(*args, bc=w.bc, adc_bits=a,  # noqa: E731
                                         full_scale=fs, noise=n)
        plain = lambda a, n: ref.acim_vmm(*args, w.bc, a, fs,  # noqa: E731
                                          None if n is None else n[0])
        kern_nz = nz[0]
    else:
        args = (x, gp, gn)
        kern = lambda a, n: ops.acim_vmm_tiled(*args, bc=w.bc, adc_bits=a,  # noqa: E731
                                               full_scale=fs, noise=n)
        plain = lambda a, n: ref.acim_vmm_tiled(*args, w.bc, a, fs, n)  # noqa: E731
        kern_nz = nz
    err_off, _ = _check_vmm(kern(None, kern_nz), plain(None, nz), w=width,
                            n_tiles=tiles, s=s, bc=w.bc, adc=False,
                            what=f"{case} ADC off")
    err_on, flips = _check_vmm(kern(cfg.adc_bits, kern_nz), plain(cfg.adc_bits, nz),
                               w=width, n_tiles=tiles, s=s, bc=w.bc, adc=True,
                               what=f"{case} ADC on")
    xt = x.reshape(b, tiles, r).transpose(0, 1)[:, None].contiguous()  # (T, 1, B, R)
    dt = d[:tiles]                                            # (T, S, R, M)
    bound, by = _bound(*ops.work(b, tiles, s, r, m, binary=not raw))
    ms, ms_s = _time_ms(lambda: kern(cfg.adc_bits, kern_nz))
    plain_ms, plain_s = _time_ms(lambda: plain(cfg.adc_bits, nz))
    lib_ms, lib_s = _time_ms(lambda: torch.matmul(xt, dt))
    return dict(
        b=b, tiles=tiles, ms=ms, stream_ms=ms_s, plain_ms=plain_ms,
        plain_stream_ms=plain_s, library_ms=lib_ms, library_stream_ms=lib_s,
        bound_ms=bound, bound_by=by, max_abs_err=err_off,
        max_abs_err_adc=err_on, flips=flips, n=b * m,
        split=tiles > 1 and ops._plan(b, tiles, m, ops._sm_count(x.device)))


def _print_vmm(w, cfg, out: dict, what: str = "w_gate layer 0") -> None:
    _, s, r, m = w.g_pos.shape
    fs = 2.0 * r * (w.levels - 1)
    width = fs / (1 << cfg.adc_bits)
    print(f"acim_vmm at {what} (K={w.rows_in}, R={r}, S={s}, M={m}, bc={w.bc}, FS={fs}, "
          f"ADC {cfg.adc_bits} bits, code width {width}); device ms (stream ms);")
    print("  library = one batched torch.matmul x @ (g_pos - g_neg) over (T, S), "
          "TF32 off, omitting the difference, noise, ADC and recombination")
    for case, rr in out.items():
        print(f"  {case:12s} B={rr['b']:5d} T={rr['tiles']} split={rr['split']}: "
              f"ms={rr['ms']:.4f} ({rr['stream_ms']:.4f}) plain_ms={rr['plain_ms']:.4f} "
              f"({rr['plain_stream_ms']:.4f}) library_ms={rr['library_ms']:.4f} "
              f"({rr['library_stream_ms']:.4f}) bound_ms={rr['bound_ms']:.4f} "
              f"({rr['bound_by']}, {rr['bound_ms'] / rr['ms']:.1%} of it) "
              f"max_abs_err ADC off {rr['max_abs_err']:.3g}, ADC on "
              f"{rr['max_abs_err_adc']:.3g} with {rr['flips']} of {rr['n']} codes flipped")


def _ideal_check(model, cfg, tokens, what: str) -> None:
    """Ideal converters in float32 reproduce the digital forward of the
    same arrays' `materialize()` (the analog leaves in float32, the
    others as the executor serves them): prefill logits within atol 2e-3
    + rtol 1e-3 (float32 sums over up to 5504 rows in another
    association), and greedy tokens equal over 8 decode steps."""
    import torch

    from repro_torch.cim import CIMConfig, CIMExecutor
    from repro_torch.core import rng
    from repro_torch.core.programmer import fill_names
    from repro_torch.models import forward
    from repro_torch.serving import ServeEngine

    cfg32 = cfg.replace(dtype=torch.float32)
    ideal = CIMExecutor(model, CIMConfig(dac_bits=None, adc_bits=None,
                                         sigma_read_lsb=0.0),
                        rng.PRNGKey(SEED + 2, device="cuda"))
    # The analog leaves read back in float32; every other deployed leaf as
    # the executor serves it (materialized in its own dtype: bf16 for
    # hymba's SSM branch).
    digital = fill_names(model.names, {
        **model.digital, **ideal._digital,
        **{n: model.arrays[n].materialize(dtype=torch.float32) for n in ideal._analog}})
    la, _, _ = forward(ideal.params(), {"tokens": tokens}, cfg32)
    ld, _, _ = forward(digital, {"tokens": tokens}, cfg32)
    err = float((la - ld).abs().max())
    scale = float(ld.abs().max())
    print(f"{what} ideal check (f32, {ideal.summary()['analog_leaves']} analog leaves): "
          f"prefill logits max |analog - digital| = {err:.3g} (logits up to {scale:.3g})")
    if not torch.allclose(la, ld, rtol=1e-3, atol=2e-3):
        raise AssertionError(f"{what}: ideal analog logits differ from digital by {err}")
    ta = ServeEngine(cfg32, executor=ideal).generate(tokens, max_new=9)
    td = ServeEngine(cfg32, digital).generate(tokens, max_new=9)
    if not torch.equal(ta, td):
        raise AssertionError(f"{what}: ideal analog greedy tokens {ta.tolist()} != "
                             f"digital {td.tolist()}")
    print(f"  greedy tokens over 8 decode steps equal: {ta[0].tolist()} ...")


def phase_serve(model, layers: int, gen) -> dict:
    """Analog serving of the phase-5 deployment through `CIMExecutor` and
    `ServeEngine` at full width, `layers` deep.

    Ideal check: `CIMConfig(dac_bits=None, adc_bits=None,
    sigma_read_lsb=0)` with the model in float32 against the digital
    forward on the float32 read-back of the same arrays: prefill logits
    within atol 2e-3 + rtol 1e-3 (float32 sums over up to 3072 rows in
    another association), greedy tokens equal over 8 decode steps.
    Noisy serve: `examples/serve_lm.py`'s defaults (batch 4, prompt 32,
    32 new tokens, DAC 6 bits, ADC 10 bits, read noise 0.2 LSB) in bf16.
    """
    import torch

    from repro_torch.cim import CIMConfig, CIMExecutor, planes_per_token
    from repro_torch.configs.qwen3_0_6b import CONFIG
    from repro_torch.core import rng
    from repro_torch.kernels.acim_vmm import ops as vmm_ops
    from repro_torch.serving import ServeEngine

    cfg = CONFIG.replace(n_layers=layers)
    b, s, new = 4, 32, 32
    tokens = torch.randint(0, cfg.vocab_size, (b, s), device="cuda", generator=gen,
                           dtype=torch.int32)

    _ideal_check(model, cfg, tokens, "serve")

    # Noisy serving, the serve_lm defaults, bf16: the main path.
    cim = CIMConfig(dac_bits=6, adc_bits=10, sigma_read_lsb=0.2)
    ex = CIMExecutor(model, cim, rng.PRNGKey(SEED + 3, device="cuda"))
    engine = ServeEngine(cfg, executor=ex)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    vmm_ops.launches = 0
    vmm_ops.launches_single = 0
    t0 = time.perf_counter()
    out = engine.generate(tokens, max_new=new)
    torch.cuda.synchronize()
    gen_wall = time.perf_counter() - t0
    launches = {"acim_vmm_tiled": vmm_ops.launches, "acim_vmm": vmm_ops.launches_single}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    # 7 stacked projections on tiles (the tied head stays digital).
    if ex.summary()["analog_leaves"] != 7:
        raise AssertionError(f"{ex.summary()['analog_leaves']} analog leaves, expected 7")
    leaves = 7 * layers
    if launches["acim_vmm_tiled"] != leaves * new:
        raise AssertionError(f"generate launched acim_vmm_tiled {launches} times; "
                             f"{leaves} analog leaf-layers x {new} steps = {leaves * new}")
    if out.shape != (b, new) or out.dtype != torch.int32:
        raise AssertionError(f"generate returned {out.dtype}{tuple(out.shape)}")
    if not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError("generated tokens outside the vocabulary")

    # The same traffic again, a sync around each step, for step times.
    per_step = []
    before = vmm_ops.launches
    t0 = time.perf_counter()
    last, cache = engine._prefill(engine.access_params(b * s), {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    step_launches = [vmm_ops.launches - before]
    finite = bool(torch.isfinite(last).all())
    cur = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
    for _ in range(new - 1):
        before = vmm_ops.launches
        t0 = time.perf_counter()
        tok, logits, cache = engine._decode(engine.access_params(b), cache,
                                            {"tokens": cur})
        torch.cuda.synchronize()
        per_step.append((time.perf_counter() - t0) * 1e3)
        step_launches.append(vmm_ops.launches - before)
        finite &= bool(torch.isfinite(logits).all())
        cur = tok[:, None]
    if set(step_launches) != {leaves}:
        raise AssertionError(f"acim_vmm launches per step {step_launches}, "
                             f"expected {leaves} each")
    if not finite:
        raise AssertionError("non-finite logits in noisy serving")
    step_ms = statistics.median(per_step)
    lat_ns, en_pj = ex.token_cost()
    print(f"serve qwen3-0.6b layers={layers} analog (DAC {cim.dac_bits}, ADC "
          f"{cim.adc_bits} bits, read noise {cim.sigma_read_lsb} LSB, "
          f"{planes_per_token(cim)} planes per token), batch {b}, prompt {s}, "
          f"{new} new tokens, bf16")
    print(f"  generate wall {gen_wall * 1e3:.1f} ms ({b * new / gen_wall:.2f} tokens/s "
          f"incl. prefill); prefill {prefill_ms:.1f} ms; decode step median "
          f"{step_ms:.2f} ms (min {min(per_step):.2f}, max {max(per_step):.2f}) = "
          f"{b / step_ms * 1e3:.2f} tokens/s")
    print(f"  acim_vmm_tiled launches {launches['acim_vmm_tiled']} in generate, "
          f"{step_launches[0]} per prefill and {step_launches[1]} per decode step; "
          f"acim_vmm (one tile) {launches['acim_vmm']}; peak device memory "
          f"{peak_gib:.2f} GiB; logits finite")
    print(f"  simulated arrays (cost model output, not card time): "
          f"{lat_ns / 1e3:.4f} us and {en_pj / 1e6:.4f} uJ per token")
    print(f"  first sequence: {out[0].tolist()}")
    return dict(engine=engine, ex=ex, cfg=cfg, cim=cim, cache=cache, cur=cur,
                launches=launches, prefill_ms=prefill_ms, step_ms=step_ms,
                gen_wall_s=gen_wall, peak_gib=peak_gib)


def phase_serve_breakdown(serve: dict, gen) -> dict:
    """Time the parts of one noisy decode step (batch 4) on their own:
    the read-noise draws, the DAC streams and the acim_vmm kernel of all
    analog leaf-layers, the attention of all layers, and the whole step
    (rest = whole - parts).  Device and stream ms as `_time_ms` gives."""
    import torch

    from repro_torch.cim import planes_per_token
    from repro_torch.cim.mvm import _dac_stream
    from repro_torch.core import rng
    from repro_torch.kernels.acim_vmm import ops as vmm_ops
    from repro_torch.models.attention import decode_attention
    from repro_torch.readout import noise as ro_noise

    engine, cfg, cim = serve["engine"], serve["cfg"], serve["cim"]
    cache, cur = serve["cache"], serve["cur"]
    params = engine.params
    b = cur.shape[0]
    leaves = [params["layers"][n].layer(i) for i in range(cfg.n_layers)
              for n in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")]
    xs = [torch.randn(b, w.rows_in, device="cuda", generator=gen).to(cfg.dtype)
          for w in leaves]

    def noise_draws():
        out = []
        for w in leaves:
            key = rng.fold_in(rng.fold_in(w.key, w.uid), w.layer_id)
            out.append(ro_noise.sample_token_read_noise(
                key, b, w.n_slices, w.n_outputs, cim.sigma_read_lsb,
                tiles=w.n_tiles, planes=planes_per_token(cim)))
        return out

    def dac():
        return [_dac_stream(x.to(torch.float32), cim) for x in xs]

    noises = noise_draws()
    xps = []
    for w, (planes, _) in zip(leaves, dac()):
        pad = w.n_tiles * w.tile_rows - w.rows_in
        xps.append(torch.nn.functional.pad(planes, (0, pad)).reshape(
            -1, w.n_tiles * w.tile_rows))

    kernel_bytes = sum(vmm_ops.work(xp.shape[0], *w.g_pos.shape)[0]
                       for w, xp in zip(leaves, xps))
    kernel_bound_ms = _bound(kernel_bytes, {})[0]

    def kernels():
        return [vmm_ops.acim_vmm_tiled(
            xp, w.g_pos, w.g_neg, bc=w.bc, adc_bits=cim.adc_bits,
            full_scale=2.0 * w.tile_rows * (w.levels - 1), noise=nz)
            for w, xp, nz in zip(leaves, xps, noises)]

    q = torch.randn(b, 1, cfg.n_heads, cfg.head_dim, device="cuda",
                    generator=gen).to(cfg.dtype)
    pos = cache["pos"]

    def attention():
        return [decode_attention(q, cache["k"][i], cache["v"][i], pos)
                for i in range(cfg.n_layers)]

    def step():
        return engine._decode(params, cache, {"tokens": cur})

    parts = {
        f"read-noise draws ({len(leaves)} leaf-layers)": noise_draws,
        f"_dac_stream ({len(leaves)})": dac,
        f"acim_vmm kernel ({len(leaves)} launches)": kernels,
        f"decode attention ({cfg.n_layers} layers)": attention,
    }
    times = {name: _time_ms(fn) for name, fn in parts.items()}
    whole = _time_ms(step)
    rest = (whole[0] - sum(t[0] for t in times.values()),
            whole[1] - sum(t[1] for t in times.values()))
    print(f"breakdown of one analog decode step (batch {b}, {cfg.n_layers} layers):")
    print(f"  {'part':42s} {'device ms':>10s} {'stream ms':>10s} {'device share':>12s}")
    for name, (dv, st) in {**times, "rest (whole - parts)": rest}.items():
        print(f"  {name:42s} {dv:10.4f} {st:10.4f} {dv / whole[0]:12.1%}")
    print(f"  {'whole decode step (no executor tick)':42s} {whole[0]:10.4f} {whole[1]:10.4f}")
    kern_ms = times[f"acim_vmm kernel ({len(leaves)} launches)"][0]
    print(f"  acim_vmm kernel ({len(leaves)} launches): {kern_ms:.4f} device ms against a "
          f"byte bound of {kernel_bound_ms:.4f} ms ({kernel_bytes / 1e6:.1f} MB at "
          f"3.35 TB/s): {kernel_bound_ms / kern_ms:.1%} of it")
    return dict(kernel_ms=kern_ms, kernel_bound_ms=kernel_bound_ms, whole_ms=whole[0])

def _host_ms(fn, reps: int = 3) -> float:
    """Median host-clock ms of `fn()` followed by a device sync."""
    import torch

    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def _serve_stream(sched, ex, reqs, vocab: int, leaves: int, what: str) -> dict:
    """Serve `reqs` through `sched` with every kernel count set to 0 just
    before the run and read just after, and check phase 9's contracts:
    every request completes with tokens in the vocabulary, no step
    function is built after warmup, one host sync per decode step,
    exactly `leaves` acim_vmm_tiled launches per dispatch (each
    admission, prefill chunk and decode step), and the executor served
    ``decode_steps * n_slots + prefill_tokens`` tokens.  Times and
    launches per dispatch come from the scheduler's own spans: host-clock
    ms, and the kernels launched inside each (its ``launches`` arg); only
    the spans that start in this run are read."""
    import torch

    from repro_torch import obs
    from repro_torch.kernels.acim_vmm import ops as vmm_ops
    from repro_torch.kernels.fwht import ops as fwht_ops
    from repro_torch.kernels.wv_step import ops as wv_ops

    warm = dict(sched.trace_counts)
    tokens0 = ex.tokens_served
    torch.cuda.synchronize()
    t_start = obs.tracer.now_us()
    vmm_ops.launches = vmm_ops.launches_single = 0
    fwht_ops.launches = wv_ops.launches = 0
    recs = sched.run(reqs)
    torch.cuda.synchronize()
    launches = {"acim_vmm_tiled": vmm_ops.launches, "acim_vmm": vmm_ops.launches_single,
                "fwht": fwht_ops.launches, "wv_step": wv_ops.launches}
    spans = {}
    for e in obs.trace.events():
        if e["ph"] == "X" and e["ts"] >= t_start:
            spans.setdefault(e["name"], []).append(e)
    ms = {n: [e["dur"] / 1e3 for e in spans.get(n, [])]
          for n in ("serve.decode", "serve.admit", "serve.prefill_chunk", "serve.maintenance")}
    dispatches = [e for n in ("serve.admit", "serve.prefill_chunk", "serve.decode")
                  for e in spans.get(n, [])]
    per_dispatch = {e["args"]["launches"].get("acim_vmm_tiled", 0) for e in dispatches}

    if len(recs) != len(reqs):
        raise AssertionError(f"{what}: {len(recs)} of {len(reqs)} requests completed")
    want_new = {r.rid: r.max_new for r in reqs}
    for r in recs:
        if r.n_generated != want_new[r.rid] or not all(0 <= t < vocab for t in r.tokens):
            raise AssertionError(f"{what}: request {r.rid} served {r.tokens}")
    if sched.trace_counts != warm:
        raise AssertionError(f"{what}: step functions built after warmup: "
                             f"{warm} -> {sched.trace_counts}")
    if sched.host_syncs != sched.decode_steps:
        raise AssertionError(f"{what}: {sched.host_syncs} host syncs in "
                             f"{sched.decode_steps} decode steps")
    if len(ms["serve.decode"]) != sched.decode_steps:
        raise AssertionError(f"{what}: {len(ms['serve.decode'])} decode spans in "
                             f"{sched.decode_steps} decode steps")
    if per_dispatch != {leaves}:
        raise AssertionError(f"{what}: acim_vmm_tiled launches per dispatch "
                             f"{sorted(per_dispatch)}, expected {leaves} each")
    if launches["acim_vmm_tiled"] != leaves * len(dispatches):
        raise AssertionError(f"{what}: {launches['acim_vmm_tiled']} acim_vmm_tiled launches "
                             f"in {len(dispatches)} dispatches of {leaves}")
    served = ex.tokens_served - tokens0
    if served != sched.decode_steps * sched.n_slots + sched.prefill_tokens:
        raise AssertionError(f"{what}: executor served {served} tokens; "
                             f"{sched.decode_steps} steps x {sched.n_slots} slots + "
                             f"{sched.prefill_tokens} prefill tokens")
    return dict(recs=recs, launches=launches, dispatches=len(dispatches),
                stats=sched.latency_stats(), step_ms=ms["serve.decode"],
                admit_ms=ms["serve.admit"], chunk_ms=ms["serve.prefill_chunk"],
                epoch_ms=ms["serve.maintenance"],
                epoch_launches=[e["args"]["launches"] for e in spans.get("serve.maintenance", [])],
                reprogram=[e["args"] for e in spans.get("lifetime.reprogram", [])])


def _print_stream(what: str, sched, run: dict) -> None:
    st = run["stats"]
    med = lambda v: f"{statistics.median(v):.2f}" if v else "-"  # noqa: E731
    print(f"  {what}: {int(st['completed'])} requests, {sched.decode_steps} decode steps, "
          f"{sched.admits} admissions, {sched.prefill_tokens} prefill tokens, "
          f"{run['dispatches']} dispatches of {run['launches']['acim_vmm_tiled'] // max(run['dispatches'], 1)} "
          f"acim_vmm_tiled launches each; host syncs {sched.host_syncs}; "
          f"step functions {sched.trace_counts}")
    print(f"    decode step median {med(run['step_ms'])} ms (min {min(run['step_ms']):.2f}, "
          f"max {max(run['step_ms']):.2f}; host clock of the `serve.decode` spans); "
          f"{st['tokens_per_s']:.2f} tokens/s over the run's wall "
          f"{st['wall_s']:.2f} s ({st['decode_tokens_per_s']:.2f} counting decode only)")
    print(f"    latency p50 {st['p50_latency_steps']:.1f} / p99 {st['p99_latency_steps']:.1f} "
          f"steps; TTFT p50 {st['p50_ttft_steps']:.1f} / p99 {st['p99_ttft_steps']:.1f} "
          f"steps; mean queue delay {st['mean_queue_delay_steps']:.2f} steps"
          + (f"; deadline misses {int(st['deadline_misses'])} of "
             f"{int(st['deadline_requests'])}" if "deadline_requests" in st else ""))
    print(f"    admission ms median {med(run['admit_ms'])} ({len(run['admit_ms'])}, ending "
          f"in its token's sync); prefill chunk ms median {med(run['chunk_ms'])} "
          f"({len(run['chunk_ms'])}, only the final chunk ends in a sync); "
          f"launches {run['launches']}")


def phase_continuous(model, layers: int, gen) -> dict:
    """Phase 9: continuous batching with an interleaved lifetime scrub.

    `examples/serve_lm.py --analog --continuous`'s defaults through the
    port, on phase 5's deployment: greedy `ServeEngine` over a
    `CIMExecutor` (DAC 6, ADC 10 bits, read noise 0.2 LSB), a
    `ContinuousScheduler` of 4 slots and max_len 72 warmed for prompts of
    16-32 tokens, 16 Poisson requests (load 0.3, 16-32 new tokens), and a
    VERIFY_TRIGGERED `LifetimeSimulator` fed the executor's reads that
    ages the arrays `AGING_S` and scrubs a two-leaf window every 8 decode
    steps.  Then 8 shorter requests with chunked prefill (16-token
    chunks, so 16-token attention chunks), EDF admission and TTFT
    deadlines.  Then the kernels at this
    path's shapes, and the parts of a decode step and of a scrub epoch.
    """
    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.cim import CIMConfig, CIMExecutor, build_weight
    from repro_torch.configs.qwen3_0_6b import CONFIG
    from repro_torch.core import rng
    from repro_torch.lifetime import (
        DriftConfig,
        LifetimeSimulator,
        RefreshConfig,
        RefreshPolicy,
        advance,
        flag_columns,
    )
    from repro_torch.lifetime.refresh import _reprogram_subset, default_flag_params
    from repro_torch.readout import config as ro_config
    from repro_torch.readout import readout as ro
    from repro_torch.serving import ContinuousScheduler, ServeEngine, poisson_requests

    cfg = CONFIG.replace(n_layers=layers)
    leaves = 7 * layers
    cim = CIMConfig(dac_bits=6, adc_bits=10, sigma_read_lsb=0.2)
    ex = CIMExecutor(model, cim, rng.PRNGKey(7, device="cuda"))
    engine = ServeEngine(cfg, executor=ex)
    t0 = time.perf_counter()
    sim = LifetimeSimulator(rng.PRNGKey(SEED + 4, device="cuda"), model, DriftConfig(),
                            RefreshConfig(policy=RefreshPolicy.VERIFY_TRIGGERED),
                            traffic_fn=ex.drain_reads)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    epochs = []
    sched = ContinuousScheduler(engine, n_slots=4, max_len=72,
                                key=rng.PRNGKey(11, device="cuda"),
                                maintenance_fn=lambda: epochs.append(
                                    sim.step_epoch(AGING_S, max_leaves=2)),
                                maintenance_every=8, device="cuda")
    t0 = time.perf_counter()
    sched.warmup(prompt_range=(16, 32))
    warm_s = time.perf_counter() - t0
    reqs = poisson_requests(3, 16, rate=0.3, vocab=cfg.vocab_size, prompt_lens=(16, 32),
                            max_new=(16, 32))
    main = _serve_stream(sched, ex, reqs, cfg.vocab_size, leaves, "stream 1")
    # Each re-program dispatch's column count: the flagged subset padded
    # to a power of two, capped at the leaf (`lifetime.reprogram` spans).
    subsets = [a["padded"] for a in main["reprogram"]]
    ep_fwht = [e.get("fwht", 0) for e in main["epoch_launches"]]
    ep_wv = [e.get("wv_step", 0) for e in main["epoch_launches"]]
    n_rep = sum(r.columns_reprogrammed for r in epochs)
    if not epochs or len(epochs) != sched.decode_steps // 8 or len(ep_fwht) != len(epochs):
        raise AssertionError(f"{len(epochs)} scrub epochs ({len(ep_fwht)} spans) in "
                             f"{sched.decode_steps} steps")
    if not all(n > 0 for n in ep_fwht):
        raise AssertionError(f"scrub epochs without fwht: {ep_fwht}")
    if not (n_rep > 0 and main["launches"]["wv_step"] > 0):
        raise AssertionError(f"no column re-programmed over the run ({n_rep}; wv_step "
                             f"{main['launches']['wv_step']})")
    print(f"continuous serve qwen3-0.6b layers={layers} analog ({cim}), greedy, "
          f"4 slots, max_len 72 (warmup {warm_s:.2f} s; lifetime state {init_s:.2f} s)")
    _print_stream("stream 1 (16 requests, FIFO, whole-bucket admission, scrub every 8 steps)",
                  sched, main)
    ep_ms = main["epoch_ms"]
    print(f"    scrub: {len(epochs)} epochs of {AGING_S:.0f} s aging, 2 leaves each; "
          f"flagged {[r.columns_flagged for r in epochs]}, re-programmed "
          f"{[r.columns_reprogrammed for r in epochs]} columns; fwht launches "
          f"{ep_fwht}, wv_step {ep_wv}; epoch ms median {statistics.median(ep_ms):.1f} "
          f"(min {min(ep_ms):.1f}, max {max(ep_ms):.1f}; `serve.maintenance` spans); "
          f"drift rms {epochs[-1].rms_drift_lsb:.4f} LSB, "
          f"refresh debt {epochs[-1].refresh_debt_epochs:.0f} epochs")

    # 16-token chunks must align with the attention's chunk grid (512 in
    # qwen3-0.6b's config, in both packages): stream 2 serves the same
    # executor with 16-token attention chunks.
    engine2 = ServeEngine(cfg.replace(attn_chunk_q=16, attn_chunk_kv=16), executor=ex)
    sched2 = ContinuousScheduler(engine2, n_slots=4, max_len=72,
                                 key=rng.PRNGKey(11, device="cuda"),
                                 prefill_chunk_tokens=16, admission_policy="edf",
                                 device="cuda")
    sched2.warmup(prompt_range=(16, 32))
    reqs2 = poisson_requests(4, 8, rate=0.3, vocab=cfg.vocab_size, prompt_lens=(16, 32),
                             max_new=(8, 16), ttft_slack=(8.0, 32.0))
    chunked = _serve_stream(sched2, ex, reqs2, cfg.vocab_size, leaves, "stream 2")
    if max(r.n_chunks for r in chunked["recs"]) < 2:
        raise AssertionError("stream 2: no prompt was prefilled in chunks")
    _print_stream("stream 2 (8 requests, EDF, 16-token prefill chunks)", sched2, chunked)

    # The kernels at this path's shapes.
    w = build_weight(model.arrays["['layers']['w_gate']"], cim,
                     rng.PRNGKey(0, device="cuda")).layer(0)
    vmm = {f"admit {t}": _vmm_case(w, cim, t, w.n_tiles, False, gen, f"admit {t} tokens")
           for t in (16, 32)}
    _print_vmm(w, cim, vmm)
    sub = min(subsets)
    sub_k = {"fwht": [dict(phase_fwht(32, gen, c=sub), case=f"re-program subset C={sub}")],
             "wv_step": [dict(phase_wv_step(32, True, gen, c=sub),
                              case=f"re-program subset C={sub}")]}
    # `fwht` on the verify sweeps' own operands: each HARP sweep of a leaf
    # transforms its live conductances, its targets and the comparator's
    # signs.  The largest leaf and the smallest norm-scale leaf.
    names = sorted(sim.states)
    leaf_c = {n: sim.states[n].g.shape[0] for n in names}
    norms = [n for n in names if "norm" in n]
    if not norms:
        raise AssertionError(f"no norm-scale leaf among {names}")
    vcfg = model.wv_cfg.replace(
        decision_threshold_lsb=default_flag_params(model.wv_cfg.method)[2])
    rcfg = ro_config.for_wv_method(vcfg)
    for n in (max(names, key=leaf_c.get), min(norms, key=leaf_c.get)):
        g = sim.states[n].g
        t = model.arrays[n].targets.to(torch.float32)
        signs = ro.read_columns(rng.PRNGKey(SEED + 5, device="cuda"), g, rcfg,
                                targets=t).values
        for what, x in (("g", g), ("targets", t), ("signs", signs)):
            sub_k["fwht"].append(dict(phase_fwht(32, gen, x=x),
                                      case=f"verify {n} {what} C={leaf_c[n]}"))
    print(f"  the scrub re-programmed subsets of {sorted(subsets)} columns; the kernels "
          f"at the smallest and (fwht) on the verify sweeps' operands, N=32; "
          f"device ms (stream ms), bitwise equal to the plain version:")
    for name, rows in sub_k.items():
        for r in rows:
            lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            print(f"    {name:8s} {r['case']:52s} ms={r['ms']:.4f} ({r['stream_ms']:.4f}) "
                  f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
                  f"({r['bound_by']}) library_ms={lib} max_abs_err={r['max_abs_err']:.3g}")

    # Where a decode step's time goes.
    fn = sched._get_decode()
    params = ex.params()
    vecs = torch.stack([
        torch.randint(0, cfg.vocab_size, (4,), device="cuda", generator=gen, dtype=torch.int32),
        torch.arange(4, device="cuda", dtype=torch.int32),
        torch.full((4,), 3, device="cuda", dtype=torch.int32)])
    dig = sched._fresh_occupancy()
    dec_dev, dec_stream = _time_ms(lambda: fn(params, sched.cache, vecs, sched.key, dig))
    toks, m, dig2, _ = fn(params, sched.cache, vecs, sched.key, dig)
    tick_ms = _host_ms(lambda: ex.tick(4), reps=5)
    fetch_ms = _host_ms(lambda: obs.metrics.fetch(
        {"toks": toks, "m": m, "dig": dig2.as_tree()}), reps=5)
    whole = statistics.median(main["step_ms"])
    print(f"  breakdown of one scheduler decode step (4 slots, {layers} layers): "
          f"whole step {whole:.2f} host ms (median of {len(main['step_ms'])} in stream 1); "
          f"executor tick {tick_ms:.2f} host ms; decode step function {dec_dev:.4f} "
          f"device ms / {dec_stream:.4f} stream ms; the one fetch {fetch_ms:.3f} host ms")

    # Where a scrub epoch's time goes (the next window, on the live state).
    window = [names[(sim._scrub_cursor + j) % len(names)] for j in range(2)]
    wv_cfg, cost = model.wv_cfg, model.cost
    key = rng.PRNGKey(SEED + 6, device="cuda")
    masks = {}

    def verify():
        for n in window:
            masks[n] = flag_columns(key, sim.states[n].g, model.arrays[n].targets, wv_cfg,
                                    sim.refresh_cfg)[0]

    parts = {
        f"advance ({len(names)} leaves)": _host_ms(lambda: [
            advance(None, st, AGING_S, 0.0, wv_cfg.device, sim.drift_cfg)
            for st in sim.states.values()]),
        "verify sweeps (2 leaves, 4 HARP sweeps each)": _host_ms(verify),
    }
    masks = {n: obs.metrics.fetch(v) > 0.5 for n, v in masks.items()}
    parts[f"re-program ({sum(int(v.sum()) for v in masks.values())} flagged columns)"] = \
        _host_ms(lambda: [_reprogram_subset(key, sim.states[n], model.arrays[n].targets,
                                            masks[n], wv_cfg, cost, sim.drift_cfg)
                          for n in window], reps=1)
    parts[f"re-tiling ({len(ex._analog)} analog leaves)"] = _host_ms(
        lambda: [ex._tile(n, model.arrays[n]) for n in ex._analog])
    parts["health fetch (one sync)"] = _host_ms(sim._epoch_health)
    cols = {n: int(model.arrays[n].g.shape[0]) for n in window}
    print(f"  breakdown of one scrub epoch (host ms, each part ending in a sync; "
          f"window {cols}):")
    for name, v in parts.items():
        print(f"    {name:48s} {v:10.2f}")
    print(f"    {'whole epoch in the run (median)':48s} {statistics.median(ep_ms):10.2f}")
    return dict(launches=main["launches"], launches_stream2=chunked["launches"], vmm=vmm,
                sub=sub, sub_kernels=sub_k, epochs=len(epochs), reprogrammed=n_rep)


def _sync_counted(fn):
    """(fn(), the syncs it made, where): `fn` runs with CUDA sync
    debugging set to "warn", which warns on every synchronizing call;
    `where` names the innermost three Python frames of each."""
    import traceback
    import warnings

    import torch

    where = []

    def record(message, category, filename, lineno, file=None, line=None):
        # Setting the mode warns once that it is a prototype; skip that.
        if "synchronizing" in str(message) and "prototype" not in str(message):
            frames = [f for f in traceback.extract_stack()[:-1]
                      if Path(f.filename).name != "warnings.py"][-3:]
            where.append(" < ".join(f"{Path(f.filename).parent.name}/"
                                    f"{Path(f.filename).name}:{f.lineno}"
                                    for f in reversed(frames)))

    old = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(old)
    return out, len(where), where


def _threshold_ties(key, uids, shape, fc, dev):
    """Cells whose classifying uniform lies within 1e-6 (relative) of one
    of `sample_fault_map`'s thresholds, recomputed on the CPU: only there
    may the card classify a cell otherwise (the tile multiplier is an
    `exp` of a normal draw, whose last bits may differ)."""
    import torch

    from repro_torch.core import device as dev_mod, rng

    key, uids = key.cpu(), uids.cpu()
    fkey = rng.fold_in(key, dev_mod._FAULT_SALT)
    k_kind, _ = rng.split(rng.fold_col_keys(fkey, uids))
    u = rng.uniform(k_kind, shape)
    mult = dev_mod.tile_quality(key, dev_mod.tile_ids(uids, fc), fc)[:, None]
    near = torch.zeros(shape, dtype=torch.bool)
    p = torch.zeros_like(mult)
    for rate in (fc.p_stuck_hrs, fc.p_stuck_lrs, fc.p_weak, fc.p_exhausted):
        p = p + rate * mult
        near |= (u - p).abs() <= 1e-6 * p
    return near


def phase_fault_guard() -> dict:
    """Zero-fault guard, at 1 layer: the give-up budget and an all-zero
    `FaultConfig` program bitwise what a plain HARP deploy of the same
    params and key programs, in one host sync, with no remap.  HARP
    applies at most one fine pulse per iteration, so no cell can spend
    the 80-pulse budget within 50 iterations: any gave-up cell is one the
    reference counts as unconverged at the iteration cap."""
    import torch

    from repro_torch.configs.qwen3_0_6b import CONFIG
    from repro_torch.core import FaultConfig, WVConfig, WVMethod, pipeline, rng
    from repro_torch.core.programmer import deploy_arrays
    from repro_torch.models import init_params

    params = init_params(SEED, CONFIG.replace(n_layers=1), device="cuda")
    key = rng.PRNGKey(SEED + 1, device="cuda")
    wv = WVConfig(method=WVMethod.HARP)
    t0 = time.perf_counter()
    (plain, plain_rep), plain_syncs, plain_where = _sync_counted(
        lambda: deploy_arrays(key, params, wv, device="cuda"))
    pipeline.reset_counters()
    guard, rep = deploy_arrays(key, params, wv.replace(give_up_pulses=GIVE_UP_PULSES),
                               fault_cfg=FaultConfig(), device="cuda")
    syncs = pipeline.host_sync_count()
    print(f"  the plain deploy: sync debugging saw {plain_syncs} at {plain_where}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    differ = [n for n, st in plain.arrays.items()
              if not (torch.equal(guard.arrays[n].g, st.g)
                      and torch.equal(guard.arrays[n].materialize(), st.materialize()))]
    print(f"faults: zero-fault guard (1 layer, {rep.num_columns} columns): give_up_pulses="
          f"{GIVE_UP_PULSES} + FaultConfig() vs plain HARP: {len(plain.arrays) - len(differ)} "
          f"of {len(plain.arrays)} leaves bitwise equal; host syncs {syncs}; gave-up cells "
          f"{rep.total_gave_up_cells:.0f} (retry pulses {rep.total_retry_pulses:.0f}); "
          f"remapped {rep.remapped_columns}; rms {rep.rms_cell_error_lsb:.6f} vs "
          f"{plain_rep.rms_cell_error_lsb:.6f}; both deploys {wall:.2f} s")
    if differ:
        raise AssertionError(f"zero-fault guard differs from the plain deploy in {differ}")
    if syncs != 1 or rep.remapped_columns != 0:
        raise AssertionError(f"zero-fault guard: {syncs} host syncs, "
                             f"{rep.remapped_columns} remapped columns")
    if any(st.fault is not None or st.remap is not None for st in guard.arrays.values()):
        raise AssertionError("zero-fault guard carries a fault map or a remap table")
    if rep.total_retry_pulses > wv.max_fine_iters * rep.total_gave_up_cells:
        raise AssertionError("zero-fault guard: a cell spent more fine pulses than the "
                             "iteration cap allows")
    return dict(gave_up=rep.total_gave_up_cells, wall_s=wall)


def _fault_arm(key, params, wv, fc, remap_cfg, clean: dict, n_weights: int,
               what: str) -> dict:
    """One faulty deploy (phase 10's arm `what`), with every kernel count
    set to 0 just before and read just after, and its contracts: one
    host sync (the report's; CUDA sync debugging also sees the placement
    probe), exactly 3 `fwht` and 1 `wv_step` launches per bucket-iteration
    over the primary and spare passes' buckets."""
    import torch

    from repro_torch.core import pipeline
    from repro_torch.core.programmer import deploy_arrays
    from repro_torch.kernels.fwht import ops as fwht_ops
    from repro_torch.kernels.wv_step import ops as wv_ops

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fwht_ops.launches = wv_ops.launches = 0
    pipeline.reset_counters()
    t0 = time.perf_counter()
    (model, rep), dbg_syncs, dbg_where = _sync_counted(lambda: deploy_arrays(
        key, params, wv, fault_cfg=fc, remap_cfg=remap_cfg, device="cuda"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fwht": fwht_ops.launches, "wv_step": wv_ops.launches}
    syncs = pipeline.host_sync_count()
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    prim = sum(int(st.targets.shape[0]) if st.remap is None else int(st.remap.perm.shape[0])
               for st in model.arrays.values())
    spare = sum(int(st.targets.shape[0]) for st in model.arrays.values()) - prim
    buckets = len(pipeline.bucket_sizes(prim)) + (
        len(pipeline.bucket_sizes(spare)) if spare else 0)
    num = sum(float(((st.materialize(dtype=torch.float32) - clean[n]) ** 2).sum())
              for n, st in model.arrays.items())
    wmse = num / n_weights
    probe = int(remap_cfg is not None and remap_cfg.placement)
    print(f"  arm {what}: {prim} primary + {spare} spare columns in {buckets} buckets; "
          f"wall {wall:.2f} s; peak {peak_gib:.2f} GiB above the {base / 2**30:.2f} GiB "
          f"held; host syncs {syncs} (sync debugging saw {dbg_syncs} at {dbg_where}, "
          f"the placement probe {probe}); launches fwht={launches['fwht']} wv_step={launches['wv_step']}")
    print(f"    gave-up cells {rep.total_gave_up_cells:.0f}, retry pulses "
          f"{rep.total_retry_pulses:.0f}, remapped columns {rep.remapped_columns}, rms cell "
          f"error {rep.rms_cell_error_lsb:.6f} LSB, mean iterations "
          f"{rep.mean_iterations:.4f}, weight MSE vs the clean deploy {wmse:.6e}")
    per_bucket_iter = buckets * wv.max_fine_iters
    if launches["fwht"] != 3 * per_bucket_iter or launches["wv_step"] != per_bucket_iter:
        raise AssertionError(f"arm {what}: fwht {launches['fwht']}x, wv_step "
                             f"{launches['wv_step']}x; HARP needs 3 and 1 per "
                             f"bucket-iteration ({per_bucket_iter})")
    if syncs != 1 or dbg_syncs != 1 + probe:
        raise AssertionError(f"arm {what}: {syncs} counted host syncs, {dbg_syncs} seen by "
                             f"sync debugging (expected 1 and {1 + probe})")
    return dict(model=model, report=rep, launches=launches, wmse=wmse)


def _check_remapped(model) -> int:
    """Every stuck cell sits exactly at its `stuck_g`; each leaf's `perm`
    maps onto distinct physical rows and `active` is exactly its image.
    Returns the stuck cells checked."""
    import torch

    n_stuck = 0
    for name, st in model.arrays.items():
        f = st.fault
        if not bool(torch.equal(torch.where(f.stuck, st.g, 0.0),
                                torch.where(f.stuck, f.stuck_g, 0.0))):
            raise AssertionError(f"{name}: a stuck cell is off its pinned level")
        n_stuck += int(f.stuck.sum())
        c, rows = int(st.remap.perm.shape[0]), int(st.g.shape[0])
        perm = st.remap.perm
        image = torch.zeros(rows, dtype=torch.bool, device=perm.device).index_fill(0, perm, True)
        if not (int(torch.unique(perm).numel()) == c and int(perm.min()) >= 0
                and int(perm.max()) < rows and torch.equal(image, st.remap.active)):
            raise AssertionError(f"{name}: the remap table is not a permutation onto "
                                 f"its active rows")
    return n_stuck


def _first_fine_iteration(key, st, wv, c: int, fault=None):
    """`wv_step`'s operands in the first fine iteration of a deployed
    leaf's first `c` columns, as the deploy ran it: coarse SET (under
    `fault`, the leaf's fault map cut to `c` rows), verify, write noise.
    Returns (operands, WVCellParams)."""
    import torch

    from repro_torch.core import device as dev_mod, pipeline, rng
    from repro_torch.core.wv import _characterized_coarse_pulses, verify_aggregate
    from repro_torch.kernels.wv_step.ref import WVCellParams

    n, dev = wv.n_cells, wv.device
    uids = pipeline.uids_to_device(st.uids[:c], "cuda")
    targets, d2d = st.targets[:c], st.d2d[:c]
    _, k_coarse, k_loop = rng.split(rng.fold_col_keys(key, uids), 3)
    n_coarse = _characterized_coarse_pulses(targets, dev, wv.max_coarse_iters)
    g0 = dev_mod.apply_pulses(k_coarse, torch.zeros_like(targets),
                              torch.where(n_coarse > 0, 1.0, 0.0), n_coarse, d2d, dev,
                              step_lsb=dev.coarse_step_lsb, fault=fault)
    k_v, k_w = rng.split(rng.fold_in(k_loop, 0))
    agg, mag, _, thr = verify_aggregate(k_v, g0, targets, wv)
    c2c, nmap = dev_mod.sample_write_noise(k_w, (c, n), dev)
    eff = d2d if fault is None else d2d * fault.efficiency
    p = WVCellParams(threshold=thr, k_streak=wv.k_streak, can_freeze=False, ternary=True,
                     fine_step=dev.fine_step_lsb, max_pulses=float(wv.max_pulses_per_iter),
                     g_max=dev.g_max_lsb, nonlinearity=dev.nonlinearity,
                     reset_asymmetry=dev.reset_asymmetry, nmap_sqrt_pulses=True)
    args = (agg, mag.contiguous(), g0, torch.zeros((c, n), dtype=torch.int32, device="cuda"),
            torch.zeros((c, n), dtype=torch.bool, device="cuda"), c2c, nmap, eff)
    return args, p


def phase_faults(dep: dict, clean: dict, layers: int, gen) -> dict:
    """Phase 10: deploy, serve and scrub qwen3-0.6b on faulty silicon.

    `benchmarks/fault_tolerance.py`'s highest fault rate (`FAULTS`), HARP
    with its give-up budget, on phase 5's params and key, in two arms:
    "none" (faults and give-up) and "remap" (spares and fault-aware
    placement), each against phase 5's clean weights (`clean`, taken
    before phase 9's scrub moved them).  Then the kernels at this path's
    operands, the remapped deployment served (ideal converters against
    its digital forward, then `serve_lm`'s noisy defaults for 8 decode
    steps), two scrub epochs on it, and converter offset calibration at
    `benchmarks/readout_sweep.py`'s settings over the w_down leaf's
    column count.
    """
    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.cim import CIMConfig, CIMExecutor, build_weight
    from repro_torch.configs.qwen3_0_6b import CONFIG
    from repro_torch.core import FaultConfig, NoiseConfig, WVConfig, WVMethod
    from repro_torch.core import device as dev_mod, remap, rng
    from repro_torch.core.programmer import flatten_with_names
    from repro_torch.kernels.acim_vmm import ops as vmm_ops
    from repro_torch.kernels.fwht import ops as fwht_ops
    from repro_torch.kernels.wv_step import ops as wv_ops
    from repro_torch.lifetime import (
        DriftConfig,
        LifetimeSimulator,
        RefreshConfig,
        RefreshPolicy,
    )
    from repro_torch.readout import calibrate_offsets, for_wv_method, sample_col_offsets
    from repro_torch.serving import ServeEngine

    cfg = CONFIG.replace(n_layers=layers)
    params, key = dep["params"], dep["key"]
    fc = FaultConfig(**FAULTS)
    wv = WVConfig(method=WVMethod.HARP, give_up_pulses=GIVE_UP_PULSES)
    n_weights = sum(int(t.numel()) for _, t in flatten_with_names(params))
    print(f"faults: qwen3-0.6b layers={layers} on faulty silicon ({fc}), HARP with "
          f"give_up_pulses={GIVE_UP_PULSES}, on phase 5's params and key")
    none = _fault_arm(key, params, wv, fc, None, clean, n_weights, "none")
    if not none["report"].total_gave_up_cells > 0:
        raise AssertionError("arm none: the give-up path never fired")
    del none["model"]
    torch.cuda.empty_cache()
    rcfg = remap.RemapConfig(spare_frac=0.25, placement=True)
    arm = _fault_arm(key, params, wv, fc, rcfg, clean, n_weights, "remap")
    model, rep = arm["model"], arm["report"]
    if not rep.remapped_columns > 0:
        raise AssertionError("arm remap: the remap path never fired")
    if not arm["wmse"] < none["wmse"]:
        raise AssertionError(f"remap's weight MSE {arm['wmse']} is not below none's "
                             f"{none['wmse']}")
    n_stuck = _check_remapped(model)
    print(f"    {n_stuck} stuck cells all at their pinned level; every leaf's perm is a "
          f"permutation onto distinct rows and active is its image; weight MSE remap / "
          f"none = {arm['wmse'] / none['wmse']:.4f}")

    # ---- the kernels at this path's operands (the w_down leaf) ------------
    wd = "['layers']['w_down']"
    st = model.arrays[wd]
    n = wv.n_cells
    c_prim = int(st.remap.perm.shape[0])
    c = min(C_DEPLOY, c_prim)
    dev = wv.device
    fault = st.fault.map(lambda x: x[:c])
    wv_args, p = _first_fine_iteration(key, st, wv, c, fault)
    kcases = {"wv_step": [dict(_wv_case(wv_args, p),
                               case=f"faulty bucket, first fine iteration, C={c}")]}
    weak = int(((fault.efficiency < 0.1) & ~fault.stuck).sum())
    spares_t = st.targets[c_prim:]
    kcases["fwht"] = [dict(phase_fwht(n, gen, x=spares_t),
                           case=f"spare-pass targets of w_down, C={spares_t.shape[0]}")]
    cim = CIMConfig(dac_bits=6, adc_bits=10, sigma_read_lsb=0.2)
    w = build_weight(model.arrays["['layers']['w_gate']"], cim,
                     rng.PRNGKey(0, device="cuda")).layer(0)
    vmm_case = _vmm_case(w, cim, 4, w.n_tiles, False, gen, "remapped decode")
    _print_vmm(w, cim, {"remapped decode": vmm_case})

    # The fault sampler on the card against the CPU, at placed uids.
    sample_rows = []
    for what, lo, k_ in (("primary", 0, 1 << 16), ("spare", c_prim, 1 << 14)):
        k_ = min(k_, len(st.uids) - lo)
        shape = (k_, n)
        ut = torch.from_numpy(np.asarray(st.uids[lo: lo + k_], np.int64))
        card = dev_mod.sample_fault_map(key, ut.to("cuda"), shape, fc, dev)
        cpu = dev_mod.sample_fault_map(key.cpu(), ut, shape, fc, dev)
        # The deploy sampled these rows on the card too, in other chunks.
        if not all(torch.equal(a[lo: lo + k_], b) for a, b in zip(st.fault, card)):
            raise AssertionError(f"{what} fault rows differ from the deploy's")
        differ = ((card.stuck.cpu() != cpu.stuck) | (card.stuck_g.cpu() != cpu.stuck_g))
        ties = _threshold_ties(key, ut, shape, fc, dev)
        eff_err = float(((card.efficiency.cpu() - cpu.efficiency).abs()
                         / cpu.efficiency.abs().clamp_min(1e-30)).max())
        sample_rows.append((what, k_, int(differ.sum()), int(ties.sum()), eff_err))
        if bool((differ & ~ties).any()) or not eff_err <= 1e-6:
            raise AssertionError(f"sample_fault_map {what}: {int(differ.sum())} cells differ "
                                 f"from the CPU ({int(ties.sum())} on a threshold), "
                                 f"efficiency off by {eff_err:.3g} relative")
    cand_n = torch.from_numpy(np.random.RandomState(1).poisson(0.3, c_prim).astype(np.float32))
    s_n = remap.n_spares(c_prim, rcfg)
    cand_ok = torch.equal(remap.spare_candidates(cand_n.to("cuda"), s_n).cpu(),
                          remap.spare_candidates(cand_n, s_n))
    if not cand_ok:
        raise AssertionError("spare_candidates on the card differs from the CPU")
    print(f"  kernels at this path's operands: {weak} weak cells (efficiency < 0.1) in the "
          f"wv_step bucket; sample_fault_map card vs CPU: "
          + "; ".join(f"{w_} {k_} uids: {d_} cells differ, {t_} on a threshold, efficiency "
                      f"within {e_:.3g} relative" for w_, k_, d_, t_, e_ in sample_rows)
          + f"; spare_candidates over {c_prim} tied counts ({s_n} spares) equal to the CPU's")

    # ---- serve the remapped deployment --------------------------------------
    b, s_len, steps = 4, 32, 8
    tokens = torch.randint(0, cfg.vocab_size, (b, s_len), device="cuda", generator=gen,
                           dtype=torch.int32)
    _ideal_check(model, cfg, tokens, "faulty serve (remap arm)")
    ex = CIMExecutor(model, cim, rng.PRNGKey(SEED + 3, device="cuda"))
    engine = ServeEngine(cfg, executor=ex)
    leaves = 7 * layers
    torch.cuda.synchronize()
    vmm_ops.launches = vmm_ops.launches_single = 0
    t0 = time.perf_counter()
    before = vmm_ops.launches
    last, cache = engine._prefill(engine.access_params(b * s_len), {"tokens": tokens})
    per_step, finite = [vmm_ops.launches - before], bool(torch.isfinite(last).all())
    cur = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
    out = []
    for _ in range(steps):
        before = vmm_ops.launches
        tok, logits, cache = engine._decode(engine.access_params(b), cache, {"tokens": cur})
        per_step.append(vmm_ops.launches - before)
        finite &= bool(torch.isfinite(logits).all())
        cur = tok[:, None]
        out.append(tok)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_launches = vmm_ops.launches
    out = torch.stack(out, dim=1)
    print(f"  noisy serve of the remap arm ({cim}), batch {b}, prompt {s_len}, prefill + "
          f"{steps} decode steps in {serve_s * 1e3:.1f} ms: acim_vmm_tiled launches per "
          f"dispatch {per_step}; first sequence {out[0].tolist()}")
    if set(per_step) != {leaves} or not finite:
        raise AssertionError(f"faulty serve: launches per dispatch {per_step} (expected "
                             f"{leaves}), logits finite {finite}")
    if not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError("faulty serve: tokens outside the vocabulary")
    del engine, ex, cache, last, logits

    # ---- scrub the remapped deployment ----------------------------------------
    sim = LifetimeSimulator(rng.PRNGKey(SEED + 7, device="cuda"), model, DriftConfig(),
                            RefreshConfig(policy=RefreshPolicy.VERIFY_TRIGGERED),
                            columns_per_tile=fc.columns_per_tile)
    names = sorted(sim.states)
    # Start the two-leaf window at w_down, so that both epochs scrub the
    # big remapped leaves (sorted order begins with the norm scales).
    sim._scrub_cursor = names.index(wd)
    torch.cuda.synchronize()
    obs.trace.reset()
    fwht_ops.launches = wv_ops.launches = 0
    records, epoch_ms = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        records.append(sim.step_epoch(AGING_S, max_leaves=2))
        torch.cuda.synchronize()
        epoch_ms.append((time.perf_counter() - t0) * 1e3)
    scrub_launches = {"fwht": fwht_ops.launches, "wv_step": wv_ops.launches}
    spans = {}
    for e in obs.trace.events():
        if e["ph"] == "X":
            spans.setdefault(e["name"], []).append(e)
    scrub_ms = [e["dur"] / 1e3 for e in spans.get("lifetime.scrub", [])]
    rep_spans = spans.get("lifetime.reprogram", [])
    print(f"  scrub of the remap arm: 2 epochs of {AGING_S:.0f} s aging, 2-leaf window from "
          f"w_down; launches {scrub_launches}")
    for r, ms, sm in zip(records, epoch_ms, scrub_ms):
        print(f"    {dataclasses.asdict(r)}")
        print(f"    epoch {r.epoch}: {ms:.1f} host ms, of which the scrub span (advance, "
              f"verify, re-program) {sm:.1f}; the rest (health fetch) {ms - sm:.1f}")
    for e in rep_spans:
        print(f"    re-program {e['args']['columns']} columns (padded to "
              f"{e['args']['padded']}): {e['dur'] / 1e3:.1f} host ms")
    untouched = all(bool((sim.states[nm].age_s[~model.arrays[nm].remap.active]
                          == 2 * AGING_S).all()) for nm in names)
    if not untouched:
        raise AssertionError("the scrub flagged or re-programmed an inactive row")
    if not (scrub_launches["wv_step"] > 0 and scrub_launches["fwht"] > 0
            and sum(r.columns_reprogrammed for r in records) > 0):
        raise AssertionError(f"the scrub re-programmed nothing: {scrub_launches}")
    sub = min(e["args"]["padded"] for e in rep_spans)
    kcases["wv_step"].append(dict(
        _wv_case(tuple(a[:sub].contiguous() for a in wv_args), p),
        case=f"scrub subset C={sub}, faulty operands"))
    print("    every inactive row kept its age (never re-programmed); wv_step held at the "
          f"smallest re-program subset (C={sub}) on the faulty bucket's first rows")
    del sim, wv_args

    # ---- converter offset calibration -------------------------------------------
    rcal = for_wv_method(WVConfig(method=WVMethod.HARP,
                                  noise=NoiseConfig(sigma_read_lsb=0.7))
                         ).replace(sigma_col_offset_lsb=1.5)
    okey, ckey = rng.split(rng.PRNGKey(SEED + 9, device="cuda"))
    fwht_ops.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    off = sample_col_offsets(okey, c_prim, rcal)
    res = calibrate_offsets(ckey, off, rcal, k_reads=8)
    torch.cuda.synchronize()
    cal_ms = (time.perf_counter() - t0) * 1e3
    cal_fwht = fwht_ops.launches
    ratio = float(res.std() / off.std())
    # The reference draws the calibration reads from one key over the
    # whole batch, so a 4096-column call is its own stream: the card and
    # the CPU each make that call.
    o4 = sample_col_offsets(okey, 4096, rcal)
    r4 = calibrate_offsets(ckey, o4, rcal, k_reads=8).cpu()
    r4_cpu = calibrate_offsets(ckey.cpu(), sample_col_offsets(okey.cpu(), 4096, rcal),
                               rcal, k_reads=8)
    flips = int(((r4 - r4_cpu).abs() > 1e-5).sum())
    print(f"  calibration ({rcal.basis.value} reads, SAR, read noise 0.7 LSB, offsets 1.5 "
          f"LSB, K=8) over {c_prim} columns of {n}: {cal_ms:.1f} host ms, {cal_fwht} fwht "
          f"launches; residual std / offset std = {ratio:.4f}; card vs CPU at 4096 columns: "
          f"{flips} columns off by more than 1e-5 (SAR code flips), max "
          f"{float((r4 - r4_cpu).abs().max()):.3g}")
    if not ratio < 0.1 or cal_fwht == 0:
        raise AssertionError(f"calibration: residual std ratio {ratio}, {cal_fwht} fwht")
    if not flips <= 41:
        raise AssertionError(f"calibration: {flips} of 4096 columns differ from the CPU")
    return dict(kcases=kcases, vmm=vmm_case,
                launches={"fwht": arm["launches"]["fwht"] + scrub_launches["fwht"] + cal_fwht,
                          "wv_step": arm["launches"]["wv_step"] + scrub_launches["wv_step"],
                          "acim_vmm_tiled": serve_launches, "acim_vmm": 0})


def _trees_equal(a, b) -> bool:
    """Two trees of tensors equal leaf for leaf, bitwise, dtypes too."""
    import torch

    from repro_torch import pytree

    la, lb = pytree.leaves_with_path(a), pytree.leaves_with_path(b)
    return ([k for k, _ in la] == [k for k, _ in lb]
            and all(x.dtype == y.dtype and torch.equal(x, y)
                    for (_, x), (_, y) in zip(la, lb)))


def phase_train(layers: int) -> dict:
    """Phase 11, part 1: train qwen3-0.6b at full width, `layers` deep,
    for `TRAIN_STEPS` steps (bf16 params, float32 AdamW moments,
    `AdamWConfig()` defaults, the cosine schedule over `TRAIN_STEPS`) on
    `SyntheticLM(151936, seq 256, batch 8, seed 0)`; every update must
    lower the loss of the batch it was computed on (the loss on fresh
    batches and on the eval batch is printed: a 151936-token bigram chain
    is not learned in 30 steps, so it stays near ln(vocab)).  Step times: host
    clock around each step ending in a sync (median), and device ms of
    one step and of its tied head + CE (forward and backward) as
    `_time_ms` gives them.  Then the checkpoint round trip, under
    `torch.use_deterministic_algorithms(True, warn_only=True)` scoped to
    it: the same steps again from the same state, saved at `CKPT_STEP`
    by `CheckpointManager.save(blocking=False)`, restored into fresh
    tensors (bitwise equal to the state saved) and continued to
    `TRAIN_STEPS`: bitwise equal to the uninterrupted run."""
    import shutil
    import warnings

    import torch

    from repro_torch import pytree
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.qwen3_0_6b import CONFIG
    from repro_torch.data import SyntheticLM
    from repro_torch.models.layers import cross_entropy_loss
    from repro_torch.models.transformer import loss_fn
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import init_train_state, make_train_step

    cfg = CONFIG.replace(n_layers=layers)
    opt = AdamWConfig()
    data = SyntheticLM(cfg.vocab_size, 256, 8, seed=0, device="cuda")
    batches = [data.global_batch_at(i)._asdict() for i in range(TRAIN_STEPS)]
    tokens = batches[0]["tokens"].numel()
    state0 = init_train_state(SEED, cfg, opt, device="cuda")
    step = make_train_step(cfg, opt, total_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    ev = data.global_batch_at(EVAL_STEP)._asdict()
    with torch.no_grad():
        eval0 = loss_fn(state0.params, ev, cfg)[0]
    state, losses, after, host_ms = state0, [], [], []
    for b in batches:
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"])
        with torch.no_grad():  # the same batch after the step's update
            after.append(loss_fn(state.params, b, cfg)[0])
        torch.cuda.synchronize()  # before the next step's clock starts
    peak = torch.cuda.max_memory_allocated() / 2**30
    with torch.no_grad():
        eval1 = float(loss_fn(state.params, ev, cfg)[0])
    losses, after, eval0 = [float(x) for x in losses], [float(x) for x in after], float(eval0)
    drops = [a - b for a, b in zip(losses, after)]
    step_ms = statistics.median(host_ms)
    dev_ms, stream_ms = _time_ms(lambda: step(state, batches[0]))

    h = torch.randn(8, 256, cfg.d_model, device="cuda").to(cfg.dtype)
    emb, b0 = state.params["tok_embed"], batches[0]

    def head_ce():
        hh = h.detach().requires_grad_(True)
        ee = emb.detach().requires_grad_(True)
        with torch.enable_grad():
            logits = torch.matmul(hh.to(torch.float32), ee.to(torch.float32).t())
            loss = cross_entropy_loss(logits, b0["targets"], b0["mask"])
            return torch.autograd.grad(loss, (hh, ee))

    head_ms, _ = _time_ms(head_ce)
    head_bound, head_by = _bound(0.0, {"f32": 6.0 * tokens * cfg.d_model * cfg.vocab_size})
    last5 = statistics.mean(losses[-5:])
    print(f"train qwen3-0.6b layers={layers} d_model={cfg.d_model} q_dim={cfg.q_dim} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} tied head, bf16 params, float32 AdamW "
          f"moments, {TRAIN_STEPS} steps of {tokens} tokens (batch 8 x seq 256)")
    print("  loss curve: " + " ".join(f"{x:.4f}" for x in losses))
    print("  each step's batch after its update: " + " ".join(f"{x:.4f}" for x in after))
    print(f"  the update lowered its own batch's loss in {sum(d > 0 for d in drops)} of "
          f"{len(drops)} steps, by {min(drops):.4f}-{max(drops):.4f} (mean "
          f"{statistics.mean(drops):.4f}); fresh batches: step 0 {losses[0]:.4f}, mean of "
          f"the last 5 {last5:.4f}; eval batch {eval0:.4f} -> {eval1:.4f}")
    print(f"  step host ms median {step_ms:.2f} (min {min(host_ms):.2f}, max "
          f"{max(host_ms):.2f}; the first, with PyTorch's warm-up, {host_ms[0]:.2f}) = "
          f"{tokens / step_ms * 1e3:.0f} tokens/s; device ms {dev_ms:.2f} (stream "
          f"{stream_ms:.2f}); peak {peak:.2f} GiB with {held:.2f} GiB held before")
    print(f"  tied head + CE, forward and backward, float32 (TF32 off): {head_ms:.2f} "
          f"device ms = {head_ms / dev_ms:.1%} of the step; bound {head_bound:.2f} ms "
          f"({head_by}, 6 x tokens x d_model x vocab at the float32 rate)")
    # A 151936-token bigram chain cannot be learned from 61k tokens: the
    # loss on fresh batches stays within batch noise of ln(vocab) here
    # (PERF.md, Findings).  What must hold is that every update lowers the
    # loss of the batch it was computed on.
    if not all(d > 0 for d in drops):
        raise AssertionError(f"an update did not lower its own batch's loss: {drops}")

    # ---- the checkpoint round trip -----------------------------------------
    ckpt = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            mgr = CheckpointManager(str(ckpt), keep=2)
            s = state0
            for i, b in enumerate(batches):
                s, _ = step(s, b)
                if i + 1 == CKPT_STEP:
                    t0 = time.perf_counter()
                    mgr.save(CKPT_STEP, s, blocking=False)
                    save_ms = (time.perf_counter() - t0) * 1e3
                    at_ckpt = s
            full = s
            t0 = time.perf_counter()
            r_step, restored = mgr.restore_latest(
                template=pytree.tree_map(torch.empty_like, state0))
            torch.cuda.synchronize()
            restore_ms = (time.perf_counter() - t0) * 1e3
            restored_equal = r_step == CKPT_STEP and _trees_equal(restored, at_ckpt)
            s = restored
            for b in batches[CKPT_STEP:]:
                s, _ = step(s, b)
            resumed_equal = _trees_equal(s, full)
        finally:
            torch.use_deterministic_algorithms(False)
    shutil.rmtree(ckpt, ignore_errors=True)
    nondet = sorted({str(w.message)[:100] for w in caught})
    drift = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(pytree.leaves(full.params), pytree.leaves(state.params)))
    print(f"  checkpoint at step {CKPT_STEP} (CheckpointManager.save(blocking=False): "
          f"{save_ms:.1f} host ms on the caller's thread), restored into fresh tensors in "
          f"{restore_ms:.1f} ms: bitwise equal to the state saved {restored_equal}; resumed "
          f"to step {TRAIN_STEPS}: bitwise equal to the uninterrupted run {resumed_equal} "
          f"(both under deterministic algorithms; warnings {nondet}); the deterministic "
          f"run's params differ from the first run's by up to {drift:.3g}")
    if not (restored_equal and resumed_equal):
        raise AssertionError(f"checkpoint round trip: restored {restored_equal}, resumed "
                             f"{resumed_equal}")
    return dict(cfg=cfg, data=data, params=state.params, losses=losses, step_ms=step_ms,
                device_ms=dev_ms, tokens_per_s=tokens / step_ms * 1e3, peak_gib=peak,
                head_ms=head_ms)


def phase_loop(train: dict, gen) -> dict:
    """Phase 11, parts 2-3: the trained params are deployed by CW-SC and
    by HARP at fig10's severe verify-read noise (`VERIFY_SIGMA`,
    `default_config_for_array(32)`) and their eval loss read digitally
    (`materialize()`) and through the arrays (`CIMExecutor.params()`),
    with ideal converters (in float32, against the float32 read-back of
    the same arrays: within 1e-4, `benchmarks/cim_inference.py`'s
    contract) and at `serve_lm`'s analog defaults (bf16, `EVAL_SEQS`
    sequences per call).  Each deploy: one host sync (counted, and seen
    by CUDA sync debugging), exactly 1 `wv_step` per bucket-iteration and
    3 `fwht` for HARP (0 for CW-SC: its one-hot reads take no transform);
    HARP's rms cell error below CW-SC's.  Then the kernels on this path's
    operands: `fwht` and `wv_step` on the first fine iteration of a HARP
    deploy bucket of the trained w_down, `acim_vmm_tiled` on the trained
    w_gate at the eval calls' B."""
    import torch

    from repro_torch.cim import CIMConfig, CIMExecutor, build_weight
    from repro_torch.core import (
        NoiseConfig,
        WVMethod,
        default_config_for_array,
        pipeline,
        rng,
    )
    from repro_torch.core.programmer import deploy_arrays, fill_names
    from repro_torch.kernels.acim_vmm import ops as vmm_ops
    from repro_torch.kernels.fwht import ops as fwht_ops
    from repro_torch.kernels.wv_step import ops as wv_ops
    from repro_torch.models.transformer import loss_fn

    cfg, params = train["cfg"], train["params"]
    cfg32 = cfg.replace(dtype=torch.float32)
    ev = train["data"].global_batch_at(EVAL_STEP)._asdict()
    n_seq = ev["tokens"].shape[0]

    def eval_loss(p, c=cfg, seqs=n_seq) -> float:
        with torch.no_grad():
            parts = [float(loss_fn(p, {k: v[i:i + seqs] for k, v in ev.items()}, c)[0])
                     for i in range(0, n_seq, seqs)]
        return sum(parts) / len(parts)

    clean = eval_loss(params)
    ideal_cim = CIMConfig(dac_bits=None, adc_bits=None, sigma_read_lsb=0.0)
    serve_cim = CIMConfig(dac_bits=6, adc_bits=10, sigma_read_lsb=0.2)
    key = rng.PRNGKey(SEED + 11, device="cuda")
    leaves = 7 * cfg.n_layers
    print(f"loop: deploy the trained params at verify read noise {VERIFY_SIGMA} LSB "
          f"(default_config_for_array(32)); eval batch {n_seq} x {ev['tokens'].shape[1]} "
          f"(step {EVAL_STEP}); clean eval loss {clean:.6f}")
    # Count only this path's launches: the deploys and the eval losses.
    fwht_ops.launches = wv_ops.launches = 0
    vmm_ops.launches = vmm_ops.launches_single = 0
    rows = {}
    for method in (WVMethod.CW_SC, WVMethod.HARP):
        wv = default_config_for_array(32).replace(
            method=method, noise=NoiseConfig(sigma_read_lsb=VERIFY_SIGMA))
        f0, w0 = fwht_ops.launches, wv_ops.launches
        pipeline.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (model, rep), dbg, where = _sync_counted(
            lambda: deploy_arrays(key, params, wv, device="cuda"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        syncs = pipeline.host_sync_count()
        per = len(pipeline.bucket_sizes(rep.num_columns)) * wv.max_fine_iters
        fw, ws = fwht_ops.launches - f0, wv_ops.launches - w0
        want_fw = 3 * per if method == WVMethod.HARP else 0
        if syncs != 1 or dbg != 1 or fw != want_fw or ws != per:
            raise AssertionError(
                f"deploy {method.value}: {syncs} counted host syncs, {dbg} seen by sync "
                f"debugging at {where}; fwht {fw}x (want {want_fw}), wv_step {ws}x "
                f"(want {per})")
        v0 = vmm_ops.launches
        digital = eval_loss(model.materialize())
        dig32 = eval_loss(fill_names(model.names, {
            **model.digital,
            **{n: st.materialize(dtype=torch.float32) for n, st in model.arrays.items()}}),
            cfg32)
        ideal = eval_loss(CIMExecutor(model, ideal_cim, rng.PRNGKey(SEED + 12, device="cuda")
                                      ).params(), cfg32)
        t0 = time.perf_counter()
        noisy = eval_loss(CIMExecutor(model, serve_cim, rng.PRNGKey(SEED + 13, device="cuda")
                                      ).params(), cfg, EVAL_SEQS)
        torch.cuda.synchronize()
        noisy_s = time.perf_counter() - t0
        evals = 1 + n_seq // EVAL_SEQS
        if vmm_ops.launches - v0 != leaves * evals:
            raise AssertionError(f"{method.value}: acim_vmm_tiled launched "
                                 f"{vmm_ops.launches - v0}x in the eval, want {leaves * evals}")
        rows[method.value] = dict(rms=rep.rms_cell_error_lsb, iters=rep.mean_iterations,
                                  wall_s=wall, digital=digital, digital_f32=dig32,
                                  ideal=ideal, noisy=noisy)
        print(f"  {method.value:6s}: {rep.num_columns} columns, wall {wall:.2f} s, rms "
              f"{rep.rms_cell_error_lsb:.6f} LSB, mean iterations {rep.mean_iterations:.4f}, "
              f"host syncs {syncs}, launches fwht {fw} wv_step {ws}; eval loss digital "
              f"{digital:.6f} (dloss {digital - clean:+.6f}), in-array ideal {ideal:.6f} vs "
              f"digital f32 {dig32:.6f} (|diff| {abs(ideal - dig32):.3g}), in-array at "
              f"serve_lm's defaults {noisy:.6f} (dloss {noisy - clean:+.6f}; {noisy_s:.2f} s "
              f"for {n_seq // EVAL_SEQS} calls of B = {EVAL_SEQS * 256 * 10} rows)")
        if not abs(ideal - dig32) <= 1e-4:
            raise AssertionError(f"{method.value}: ideal in-array loss {ideal} vs digital "
                                 f"{dig32}")
        if not all(math.isfinite(x) for x in (digital, ideal, noisy)):
            raise AssertionError(f"{method.value}: a non-finite eval loss")
        if method == WVMethod.HARP:
            harp = model
        del model
        torch.cuda.empty_cache()
    launches = {"fwht": fwht_ops.launches, "wv_step": wv_ops.launches,
                "acim_vmm_tiled": vmm_ops.launches, "acim_vmm": vmm_ops.launches_single}
    if not rows["harp"]["rms"] < rows["cw_sc"]["rms"]:
        raise AssertionError(f"HARP's rms {rows['harp']['rms']} is not below CW-SC's "
                             f"{rows['cw_sc']['rms']}")

    # ---- the kernels at this path's operands -------------------------------
    wv = default_config_for_array(32).replace(
        method=WVMethod.HARP, noise=NoiseConfig(sigma_read_lsb=VERIFY_SIGMA))
    st = harp.arrays["['layers']['w_down']"]
    c = min(C_DEPLOY, int(st.targets.shape[0]))
    wv_args, p = _first_fine_iteration(key, st, wv, c)
    kcases = {
        "wv_step": [dict(_wv_case(wv_args, p),
                         case=f"trained w_down, first fine iteration, C={c}")],
        "fwht": [dict(phase_fwht(wv.n_cells, gen, x=wv_args[2]),
                      case=f"trained w_down, first verify's conductances, C={c}")],
    }
    w = build_weight(harp.arrays["['layers']['w_gate']"], serve_cim,
                     rng.PRNGKey(0, device="cuda")).layer(0)
    vmm = {"eval noisy": _vmm_case(w, serve_cim, EVAL_SEQS * 256, w.n_tiles, False, gen,
                                   "eval noisy"),
           "eval ideal raw": _vmm_case(w, serve_cim, 1, w.n_tiles, True, gen,
                                       "eval ideal raw", rows=n_seq * 256)}
    _print_vmm(w, serve_cim, vmm)
    for name, rr in kcases.items():
        r = rr[0]
        print(f"  {name} on {r['case']}: ms={r['ms']:.4f} ({r['stream_ms']:.4f}) plain_ms="
              f"{r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"max_abs_err={r['max_abs_err']:.3g}")
    return dict(rows=rows, clean=clean, launches=launches, kcases=kcases, vmm=vmm)


def phase_fig10(gen) -> dict:
    """Phase 12: `benchmarks/fig10_robustness.py` on the card.  Its tiny
    LM (2 layers, d_model 64, vocab 64, float32) trained for
    `FIG10_STEPS` steps at lr 1e-2 on `SyntheticLM(64, 64, 16, seed 3)`,
    deployed by CW-SC, HD-PV and HARP (`default_config_for_array(32)`,
    key 42) at read noise 0.1, 0.4 and 0.7 LSB; its trends must hold at
    0.7: HD-PV's and HARP's rms cell error below CW-SC's, their dloss
    within CW-SC's + 0.01.  Then the kernels on this path's operands:
    the HARP deploy at 0.7 LSB again, through `deploy_arrays`, and `fwht`
    and `wv_step` on the first fine iteration of each of its buckets (its
    leaves' columns packed in order, as `pipeline.program_packed_columns`
    packs them)."""
    import types

    import numpy as np
    import torch

    from repro_torch.core import (
        NoiseConfig,
        WVMethod,
        default_config_for_array,
        pipeline,
        rng,
    )
    from repro_torch.core.programmer import deploy_arrays, deploy_params
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.acim_vmm import ops as vmm_ops
    from repro_torch.kernels.fwht import ops as fwht_ops
    from repro_torch.kernels.wv_step import ops as wv_ops
    from repro_torch.models import ModelConfig
    from repro_torch.models.transformer import loss_fn
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import init_train_state, make_train_step

    cfg = ModelConfig(name="bench-lm", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      head_dim=16, d_ff=128, vocab_size=64, dtype=torch.float32,
                      attn_chunk_q=32, attn_chunk_kv=32, remat=False)
    data = SyntheticLM(vocab_size=64, seq_len=64, global_batch=16, seed=3, device="cuda")
    opt = AdamWConfig(lr_peak=1e-2)
    state = init_train_state(0, cfg, opt, device="cuda")
    step = make_train_step(cfg, opt, total_steps=FIG10_STEPS)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(FIG10_STEPS):
        state, m = step(state, data.global_batch_at(i)._asdict())
        losses.append(m["loss"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    ev = data.global_batch_at(EVAL_STEP)._asdict()

    def eval_loss(p) -> float:
        with torch.no_grad():
            return float(loss_fn(p, ev, cfg)[0])

    clean = eval_loss(state.params)
    print(f"fig10: tiny LM trained {FIG10_STEPS} steps in {train_s:.2f} s (data included); "
          f"loss {float(losses[0]):.4f} -> {float(losses[-1]):.4f}; clean eval loss "
          f"{clean:.4f}")
    fwht_ops.launches = wv_ops.launches = 0
    vmm_ops.launches = vmm_ops.launches_single = 0
    dloss, rms = {}, {}
    t0 = time.perf_counter()
    for sigma in (0.1, 0.4, VERIFY_SIGMA):
        for m in (WVMethod.CW_SC, WVMethod.HD_PV, WVMethod.HARP):
            wv = default_config_for_array(32).replace(
                method=m, noise=NoiseConfig(sigma_read_lsb=sigma))
            prog, rep = deploy_params(rng.PRNGKey(42, device="cuda"), state.params, wv,
                                      device="cuda")
            dloss[(sigma, m.value)] = eval_loss(prog) - clean
            rms[(sigma, m.value)] = rep.rms_cell_error_lsb
            print(f"  fig10.n32.sigma{sigma:g}.{m.value}: dloss={dloss[(sigma, m.value)]:+.4f} "
                  f"rms_cell={rep.rms_cell_error_lsb:.4f}")
    torch.cuda.synchronize()
    deploy_s = time.perf_counter() - t0
    launches = {"fwht": fwht_ops.launches, "wv_step": wv_ops.launches,
                "acim_vmm_tiled": vmm_ops.launches, "acim_vmm": vmm_ops.launches_single}
    print(f"  9 deploys in {deploy_s:.2f} s; launches {launches}")
    hi = VERIFY_SIGMA
    for m in ("hd_pv", "harp"):
        if not rms[(hi, m)] < rms[(hi, "cw_sc")]:
            raise AssertionError(f"fig10: {m} rms {rms[(hi, m)]} not below cw_sc's "
                                 f"{rms[(hi, 'cw_sc')]} at {hi} LSB")
        if not dloss[(hi, m)] < dloss[(hi, "cw_sc")] + 0.01:
            raise AssertionError(f"fig10: {m} dloss {dloss[(hi, m)]} not within cw_sc's "
                                 f"{dloss[(hi, 'cw_sc')]} + 0.01 at {hi} LSB")
    if not (launches["fwht"] > 0 and launches["wv_step"] > 0):
        raise AssertionError(f"fig10: the deploys launched {launches}")

    # ---- the kernels at this path's operands -------------------------------
    wv = default_config_for_array(32).replace(
        method=WVMethod.HARP, noise=NoiseConfig(sigma_read_lsb=hi))
    key = rng.PRNGKey(42, device="cuda")
    model, rep = deploy_arrays(key, state.params, wv, device="cuda")
    sts = list(model.arrays.values())
    uids = np.concatenate([st.uids for st in sts])
    targets, d2d = torch.cat([st.targets for st in sts]), torch.cat([st.d2d for st in sts])
    kcases = {"fwht": [], "wv_step": []}
    off = 0
    for size in pipeline.bucket_sizes(rep.num_columns):
        take = min(size, rep.num_columns - off)
        bucket = types.SimpleNamespace(uids=uids[off:off + take],
                                       targets=targets[off:off + take],
                                       d2d=d2d[off:off + take])
        wv_args, p = _first_fine_iteration(key, bucket, wv, take)
        what = f"fig10 HARP at {hi} LSB, bucket of C={size}"
        kcases["wv_step"].append(dict(_wv_case(wv_args, p),
                                      case=f"{what}, first fine iteration"))
        kcases["fwht"].append(dict(phase_fwht(wv.n_cells, gen, x=wv_args[2]),
                                   case=f"{what}, first verify's conductances"))
        off += take
    for name, rr in kcases.items():
        for r in rr:
            print(f"  {name} on {r['case']}: ms={r['ms']:.4f} ({r['stream_ms']:.4f}) "
                  f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
                  f"({r['bound_by']}) library_ms="
                  f"{'-' if r['library_ms'] is None else format(r['library_ms'], '.4f')} "
                  f"max_abs_err={r['max_abs_err']:.3g}")
    return dict(dloss=dloss, rms=rms, clean=clean, launches=launches, train_s=train_s,
                kcases=kcases)

def _example(name: str):
    """`examples/<name>.py` as a module (the examples are scripts, not a
    package), so a phase runs the code the script runs."""
    import importlib.util

    path = Path(__file__).resolve().parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(fn) -> list[str]:
    """The lines `fn()` prints (it must return 0)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn()
    if rc != 0:
        raise AssertionError(f"renderer exited {rc}: {buf.getvalue()[-2000:]}")
    return buf.getvalue().splitlines()


def _registry_deploy(serve_lm, params, what: str) -> dict:
    """Deploy `params` through `torch_serve_lm.deploy_model` (key 1, as
    the script's `run` makes it) with every
    kernel count and the telemetry set to 0 just before, and check the
    deploy's contracts: one host sync (counted, and seen by CUDA sync
    debugging), 3 `fwht` and 1 `wv_step` launches per bucket-iteration,
    and telemetry that agrees with the report: columns per tile summing
    to the report's columns, the ``deploy.*`` counters and the ``deploy``
    ledger row equal to its totals, the per-tile gave-up and write-pulse
    maps within 1e-6 of them (float32 tile sums), and both deploy digests
    counting every column."""
    import torch

    from repro_torch import obs
    from repro_torch.core import pipeline, rng
    from repro_torch.kernels.fwht import ops as fwht_ops
    from repro_torch.kernels.wv_step import ops as wv_ops

    key = rng.PRNGKey(1, device="cuda")
    obs.reset_all()
    torch.cuda.synchronize()
    fwht_ops.launches = wv_ops.launches = 0
    pipeline.reset_counters()
    t0 = time.perf_counter()
    (model, rep), dbg_syncs, where = _sync_counted(
        lambda: serve_lm.deploy_model(key, params, "cuda"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fwht": fwht_ops.launches, "wv_step": wv_ops.launches}
    syncs = pipeline.host_sync_count()
    buckets = len(pipeline.bucket_sizes(rep.num_columns))
    per_bucket_iter = buckets * model.wv_cfg.max_fine_iters
    hr = obs.health_registry
    n_tiles = len(hr.tiles("deploy.columns"))
    counters = obs.registry.snapshot()
    charged = obs.ledger.summary()["deploy"]
    print(f"  {what}: {rep.num_columns} columns in {buckets} buckets, {len(model.arrays)} "
          f"leaves; wall {wall:.2f} s; host syncs {syncs} (sync debugging saw {dbg_syncs} "
          f"at {where}); launches fwht={launches['fwht']} wv_step={launches['wv_step']}; "
          f"rms {rep.rms_cell_error_lsb:.6f} LSB, mean iterations {rep.mean_iterations:.4f}, "
          f"gave-up cells {rep.total_gave_up_cells:.0f}")
    print(f"    telemetry: {n_tiles} tiles folded into {len(hr.snapshot()['tiles'])} "
          f"deploy maps; worst tiles by err2_sum {hr.worst('deploy.err2_sum', 5)}; "
          f"by gave_up_cells {hr.worst('deploy.gave_up_cells', 3)}")
    if launches["fwht"] != 3 * per_bucket_iter or launches["wv_step"] != per_bucket_iter:
        raise AssertionError(f"{what}: fwht {launches['fwht']}x, wv_step {launches['wv_step']}x; "
                             f"HARP needs 3 and 1 per bucket-iteration ({per_bucket_iter})")
    if syncs != 1 or dbg_syncs != 1:
        raise AssertionError(f"{what}: {syncs} counted host syncs, {dbg_syncs} seen by sync "
                             f"debugging at {where} (expected 1 and 1)")
    if sum(hr.tiles("deploy.columns").values()) != rep.num_columns:
        raise AssertionError(f"{what}: the tile map holds "
                             f"{sum(hr.tiles('deploy.columns').values())} columns")
    for name, want in (("columns", rep.num_columns), ("gave_up_cells", rep.total_gave_up_cells),
                       ("write_pulses", rep.total_write_pulses),
                       ("verify_reads", rep.total_reads)):
        if counters[f"deploy.{name}"] != float(want):
            raise AssertionError(f"{what}: counter deploy.{name} {counters[f'deploy.{name}']} "
                                 f"!= the report's {want}")
    if charged["energy_pj"] != rep.total_energy_pj or charged["reads"] != rep.total_reads:
        raise AssertionError(f"{what}: ledger row {charged} vs the report's energy "
                             f"{rep.total_energy_pj} and reads {rep.total_reads}")
    for name, want in (("gave_up_cells", rep.total_gave_up_cells),
                       ("write_pulses", rep.total_write_pulses)):
        got = sum(hr.tiles(f"deploy.{name}").values())
        if not abs(got - want) <= 1e-6 * max(want, 1.0):
            raise AssertionError(f"{what}: deploy.{name} tiles sum to {got}, report {want}")
    for name in ("deploy.write_pulses_per_column", "deploy.iterations_per_column"):
        if obs.digests.get(name).count != rep.num_columns:
            raise AssertionError(f"{what}: digest {name} counts "
                                 f"{obs.digests.get(name).count} columns")
    return dict(model=model, report=rep, wall_s=wall, launches=launches, tiles=n_tiles)


def phase_registry(gen) -> dict:
    """Phase 13: registry models at full width, through the port's
    entry points.

    llama3.2-1b from `get_config` (d_model 2048, 32 / 8 heads of 64,
    d_ff 8192, tied 128256-token head), cut to `REGISTRY_LAYERS` of 16
    layers, with `torch_serve_lm.py --analog --continuous`'s defaults
    (4 slots, 16 Poisson requests at load 0.3, DAC 6 / ADC 10 bits, read
    noise 0.2 LSB): its params and HARP deploy as the script makes them
    (`_registry_deploy`: one sync, the launches, the telemetry against
    the report), its executor and scheduler from the script's functions,
    the stream held as phase 9 holds its streams (`_serve_stream`: one
    sync per decode step, 7 launches per dispatch, every request served)
    and reported by the script.  Then `obs.fleet_status()` and an
    `SLOPolicy` shaped like `benchmarks/fleet_health.py`'s (a p99-latency
    ceiling and a give-up ceiling) on paths this run fills, each of
    which must resolve; the health maps and digests are emitted, the
    trace exported and rendered by the port's `obs.report` and
    `obs.dashboard`.  Then smollm-360m (d_model 960: 7.5 tiles of 128
    rows; kv_dim 320) at 1 layer, deployed the same way and served with
    ideal converters against its digital forward (`_ideal_check`).
    Last, the kernels on this phase's operands: `fwht` and `wv_step` on
    llama's w_down first fine iteration, `acim_vmm_tiled` at decode
    (B = 40) on llama's w_down (T = 64) and w_gate (M = 8192) and on
    smollm's wq (K = 960, its last tile half padding) and wk (M = 320).
    """
    import json as _json

    import torch

    from repro_torch import obs
    from repro_torch.cim import CIMConfig, build_weight
    from repro_torch.configs import get_config
    from repro_torch.core import rng
    from repro_torch.models import init_params
    from repro_torch.obs import dashboard
    from repro_torch.obs import report as obs_report
    from repro_torch.serving import ServeEngine

    serve_lm = _example("torch_serve_lm")
    args = serve_lm.build_parser().parse_args(
        ["--arch", "llama3.2-1b", "--analog", "--continuous",
         "--requests", str(REGISTRY_REQUESTS)])
    cfg = get_config(args.arch).replace(n_layers=REGISTRY_LAYERS)
    print(f"registry: {cfg.name} at full width (d_model {cfg.d_model}, {cfg.n_heads} / "
          f"{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size} tied, rope_theta {cfg.rope_theta}), {cfg.n_layers} of 16 layers")
    params = init_params(0, cfg, device="cuda")     # as torch_serve_lm.run makes them
    dep = _registry_deploy(serve_lm, params, cfg.name)
    del params
    ex = serve_lm.make_executor(dep["model"], args, "cuda")
    engine = ServeEngine(cfg, executor=ex)
    t0 = time.perf_counter()
    sched, reqs = serve_lm.make_scheduler(engine, cfg, args, "cuda")
    warm_s = time.perf_counter() - t0
    leaves = 7 * cfg.n_layers
    run = _serve_stream(sched, ex, reqs, cfg.vocab_size, leaves, cfg.name)
    serve_lm.report_continuous(sched, run["recs"], ex)
    _print_stream(f"{cfg.name} stream ({len(reqs)} requests, torch_serve_lm.py's defaults; "
                  f"warmup {warm_s:.2f} s)", sched, run)

    # The fleet view and an SLO policy on this run's own metrics.
    status = obs.fleet_status()
    policy = obs.SLOPolicy(rules=(
        obs.SLORule("p99_latency", "digests.serve.latency_steps.p99", float(sched.max_len)),
        obs.SLORule("give_up_cells", "counters.deploy.gave_up_cells",
                    1e-4 * dep["report"].num_cells),
    ))
    verdicts = policy.evaluate(status, phase="registry")
    for v in verdicts:
        print(f"  SLO {v['name']}: {v['metric']} = {v['value']} against ceiling "
              f"{v['ceiling']:.6g}: {'BREACHED' if v['breached'] else 'met'}")
    missing = [v["metric"] for v in verdicts if v["value"] is None]
    if missing:
        raise AssertionError(f"SLO metrics that this run did not fill: {missing}")
    obs.health_registry.emit()
    obs.digests.emit()
    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_obs"
    out_dir.mkdir(parents=True, exist_ok=True)
    trace_path = Path(obs.trace.export(out_dir / "TRACE_registry.json"))
    fleet_path = out_dir / "fleet_status.json"
    fleet_path.write_text(_json.dumps(status))
    rep_lines = _printed(lambda: obs_report.main([str(trace_path)]))
    dash_lines = _printed(lambda: dashboard.main([str(trace_path), "--fleet", str(fleet_path),
                                                  "--format", "text"]))
    print(f"  obs.report of {trace_path.name} ({len(rep_lines)} lines; head):")
    for line in rep_lines[:30]:
        print(f"    {line}")
    print(f"  obs.dashboard --format text ({len(dash_lines)} lines; head):")
    for line in dash_lines[:40]:
        print(f"    {line}")
    for phase in ("deploy", "deploy.program_columns", "serve.decode", "serve.analog"):
        if not any(line.split()[:1] == [phase] for line in rep_lines):
            raise AssertionError(f"the report of this run's trace has no {phase} row")

    # The kernels on llama's operands.
    cim = CIMConfig(dac_bits=args.dac_bits, adc_bits=args.adc_bits,
                    sigma_read_lsb=args.read_noise)
    model = dep["model"]
    st = model.arrays["['layers']['w_down']"]
    c = min(C_DEPLOY, int(st.targets.shape[0]))
    wv_args, p = _first_fine_iteration(rng.PRNGKey(1, device="cuda"), st, model.wv_cfg, c)
    kcases = {
        "wv_step": [dict(_wv_case(wv_args, p),
                         case=f"{cfg.name} w_down, first fine iteration, C={c}")],
        "fwht": [dict(phase_fwht(model.wv_cfg.n_cells, gen, x=wv_args[2]),
                      case=f"{cfg.name} w_down, first verify's conductances, C={c}")],
    }
    vmm = {}
    for leaf in ("w_down", "w_gate"):
        w = build_weight(model.arrays[f"['layers']['{leaf}']"], cim,
                         rng.PRNGKey(0, device="cuda")).layer(0)
        case = f"{cfg.name} {leaf} decode"
        vmm[case] = _vmm_case(w, cim, args.n_slots, w.n_tiles, False, gen, case)
        _print_vmm(w, cim, {case: vmm[case]}, f"{cfg.name} {leaf} layer 0")
    launches = dict(dep["launches"], acim_vmm_tiled=run["launches"]["acim_vmm_tiled"],
                    acim_vmm=run["launches"]["acim_vmm"])
    wall_s = dep["wall_s"]
    del ex, engine, sched, model, dep, st, wv_args
    torch.cuda.empty_cache()

    # smollm-360m: widths that are not powers of two.
    scfg = get_config("smollm-360m").replace(n_layers=REGISTRY_LAYERS)
    print(f"registry: {scfg.name} at full width (d_model {scfg.d_model}, q_dim {scfg.q_dim}, "
          f"kv_dim {scfg.kv_dim}, d_ff {scfg.d_ff}, vocab {scfg.vocab_size} tied), "
          f"{scfg.n_layers} of 32 layers")
    sparams = init_params(0, scfg, device="cuda")
    sdep = _registry_deploy(serve_lm, sparams, scfg.name)
    tokens = torch.randint(0, scfg.vocab_size, (args.n_slots, args.prompt_len), device="cuda",
                           generator=gen, dtype=torch.int32)
    _ideal_check(sdep["model"], scfg, tokens, scfg.name)
    for leaf in ("wq", "wk"):
        w = build_weight(sdep["model"].arrays[f"['layers']['{leaf}']"], cim,
                         rng.PRNGKey(0, device="cuda")).layer(0)
        case = f"{scfg.name} {leaf} decode"
        vmm[case] = _vmm_case(w, cim, args.n_slots, w.n_tiles, False, gen, case)
        _print_vmm(w, cim, {case: vmm[case]}, f"{scfg.name} {leaf} layer 0")
    for name, rr in kcases.items():
        r = rr[0]
        print(f"  {name} on {r['case']}: ms={r['ms']:.4f} ({r['stream_ms']:.4f}) plain_ms="
              f"{r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"max_abs_err={r['max_abs_err']:.3g}")
    return dict(launches=launches, kcases=kcases, vmm=vmm, wall_s=wall_s,
                smollm_wall_s=sdep["wall_s"], verdicts=verdicts)


def _family_batch(cfg, seq: int, gen) -> dict:
    """Random inputs of `cfg`'s frontend: tokens, or frame embeddings for
    the stub frontend, and the conditioning where it has one."""
    import torch

    b = FAMILY_BATCH
    batch = {}
    if cfg.frontend == "embed_stub":
        batch["embeds"] = torch.randn(b, seq, cfg.d_model, device="cuda",
                                      generator=gen).to(cfg.dtype)
    else:
        batch["tokens"] = torch.randint(0, cfg.vocab_size, (b, seq), device="cuda",
                                        generator=gen, dtype=torch.int32)
    if cfg.cross_kv_len:
        batch["cond"] = torch.randn(b, cfg.cross_kv_len, cfg.cross_d_cond, device="cuda",
                                    generator=gen).to(cfg.dtype)
    return batch


def _routed_alike(pre_log, fwd_log, prompt: int) -> tuple[list[int], list[bool]]:
    """From the keep masks (`moe.record_routing`, one (B * S, k) mask per
    MoE layer, tokens row-major) of a prefill over `prompt` positions and
    of the forward over the whole sequence: each row's dropped (token,
    choice) pairs in the forward, and whether the row was routed alike in
    both (the same pairs dropped over the prompt, none over the decode
    positions, which a decode step's capacity never drops)."""
    import torch

    b = FAMILY_BATCH
    dropped = [0] * b
    alike = [True] * b
    for pre, fwd in zip(pre_log, fwd_log):
        pre, fwd = pre.reshape(b, prompt, -1), fwd.reshape(b, -1, pre.shape[-1])
        for r in range(b):
            dropped[r] += int((~fwd[r]).sum())
            alike[r] &= torch.equal(pre[r], fwd[r, :prompt]) and bool(fwd[r, prompt:].all())
    return dropped, alike


def _decode_vs_forward(params, cfg, batch: dict, prompt: int) -> dict:
    """`prefill` over `prompt` positions, `FAMILY_STEPS` decode steps,
    then `forward` over the whole sequence; the last step against the
    forward at its position, over the rows that capacity routed alike
    (every row where the model has no MoE)."""
    import torch

    from repro_torch.models import decode_step, forward, moe, prefill

    seq = prompt + FAMILY_STEPS

    def upto(a: int, b: int) -> dict:
        return {k: (v[:, a:b] if k in ("tokens", "embeds") else v) for k, v in batch.items()}

    with torch.no_grad():
        with moe.record_routing() as pre_log:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, cache = prefill(params, upto(0, prompt), cfg, max_len=seq)
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
        host_ms = []
        for t in range(prompt, seq):
            t0 = time.perf_counter()
            logits, cache = decode_step(params, cache, upto(t, t + 1), cfg)
            host_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        with moe.record_routing() as fwd_log:
            full, aux, _ = forward(params, batch, cfg)
        torch.cuda.synchronize()
    dropped, alike = _routed_alike(pre_log, fwd_log, prompt)
    rows = [b for b in range(FAMILY_BATCH) if alike[b]]
    got, want = logits[:, 0].float(), full[:, seq - 1].float()
    err = scale = None
    if rows:
        scale = float(want[rows].abs().max())
        err = float((got[rows] - want[rows]).abs().max()) / scale
    finite = bool(torch.isfinite(full).all()) and bool(torch.isfinite(logits).all())
    head = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    if not finite or tuple(full.shape) != (FAMILY_BATCH, seq, *head, cfg.vocab_size) \
            or int(cache["pos"][0]) != seq - 1:
        raise AssertionError(f"{cfg.name}: logits finite={finite}, shape "
                             f"{tuple(full.shape)}, pos {int(cache['pos'][0])}")
    return dict(err=err, scale=scale, rows=rows, dropped=dropped, aux=float(aux),
                prefill_ms=prefill_ms, step_host_ms=statistics.median(host_ms),
                step_host_min_ms=min(host_ms))


def _family_case(arch: str, layers: int, prompt: int, gen) -> dict:
    """One registry model at full width, `layers` deep (`_decode_vs_forward`).

    An MoE model runs twice on the same params and inputs: at its
    registry capacity factor, where the forward's drop counts are
    printed and only rows routed alike are held, and with the capacity
    lifted to every token (``capacity_factor = experts / top_k``), where
    nothing drops and every row is held."""
    import torch

    from repro_torch import pytree
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = get_config(arch).replace(n_layers=layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(SEED, cfg, device="cuda")
    n_params = sum(t.numel() for t in pytree.leaves(params))
    batch = _family_batch(cfg, prompt + FAMILY_STEPS, gen)
    variants = [("", cfg)]
    if cfg.is_moe:
        variants.append(("capacity lifted, ",
                         cfg.replace(capacity_factor=cfg.moe_experts / cfg.moe_top_k)))
    out = {}
    for label, vcfg in variants:
        out[label] = r = _decode_vs_forward(params, vcfg, batch, prompt)
        cap = f"capacity factor {vcfg.capacity_factor:g}: " if cfg.is_moe else ""
        print(f"  {arch} ({label}{cap}{layers} of {get_config(arch).n_layers} layers, "
              f"d_model {cfg.d_model}, {n_params / 1e9:.3f} B params {cfg.dtype}, prompt "
              f"{prompt}): prefill {r['prefill_ms']:.1f} ms; decode step host ms median "
              f"{r['step_host_ms']:.2f} (min {r['step_host_min_ms']:.2f})")
        held = ("no row routed alike" if r["err"] is None else
                f"max |diff| {r['err']:.4g} of the largest logit {r['scale']:.4g}")
        print(f"    last decode step vs forward at position {prompt + FAMILY_STEPS - 1}, "
              f"rows {r['rows']}: {held}; aux {r['aux']:.4g}"
              + (f"; the forward dropped {r['dropped']} (token, choice) pairs per row"
                 if cfg.is_moe else ""))
        must_hold = label or not cfg.is_moe
        if must_hold and len(r["rows"]) != FAMILY_BATCH:
            raise AssertionError(f"{arch}: rows {r['rows']} routed alike, expected all")
        if r["err"] is not None and not r["err"] <= FAMILY_TOL:
            raise AssertionError(f"{arch}: decode differs from forward by {r['err']:.4g} of "
                                 f"the largest logit (tolerance {FAMILY_TOL})")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"    peak {peak_gib:.2f} GiB")
    del params, batch
    torch.cuda.empty_cache()
    return dict(arch=arch, layers=layers, prompt=prompt, peak_gib=peak_gib,
                runs={label.rstrip(", ") or "registry": r for label, r in out.items()})


def phase_families(gen) -> dict:
    """Phase 14: the other model families at full width.

    (a) Each of `FAMILY_RUNS` from `get_config(arch).replace(n_layers=...)`
    in its bf16, params from `SEED` on the card: `_family_case`.
    (b) hymba-1.5b at `HYMBA_LAYERS` layers (about 129 M weights): its
    params made and deployed as `torch_serve_lm.py --arch hymba-1.5b
    --analog` makes them (`_registry_deploy`: one host sync, 3 `fwht`
    and 1 `wv_step` per bucket-iteration, telemetry against the report),
    served by `ServeEngine.generate` at the script's fixed-batch defaults
    through its `make_executor` (7 analog leaves x 3 layers = 21
    `acim_vmm_tiled` launches per access, tokens in the vocabulary,
    finite logits), and with ideal converters against the digital
    forward of its materialized arrays (`_ideal_check`).  Then the
    kernels on this deploy's own operands: `acim_vmm_tiled` at decode
    (B = 40) on w_down (K = 5504: 43 tiles of 128 rows), wk (M = 320)
    and w_gate (M = 5504); `fwht` and `wv_step` on w_down's first fine
    iteration.
    """
    import torch

    from repro_torch.cim import build_weight
    from repro_torch.configs import get_config
    from repro_torch.core import rng
    from repro_torch.kernels.acim_vmm import ops as vmm_ops
    from repro_torch.models import init_params
    from repro_torch.serving import ServeEngine

    print(f"families: batch {FAMILY_BATCH}, prefill then {FAMILY_STEPS} decode steps, the "
          f"last held against the forward (tolerance {FAMILY_TOL} of the largest logit)")
    runs = [_family_case(arch, layers, prompt, gen) for arch, layers, prompt in FAMILY_RUNS]

    serve_lm = _example("torch_serve_lm")
    args = serve_lm.build_parser().parse_args(["--arch", "hymba-1.5b", "--analog"])
    cfg = get_config(args.arch).replace(n_layers=HYMBA_LAYERS)
    print(f"families: {cfg.name} at full width (d_model {cfg.d_model}, {cfg.n_heads} / "
          f"{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, ssm_state "
          f"{cfg.ssm_state}, window {cfg.sliding_window}), {cfg.n_layers} of 32 layers")
    params = init_params(0, cfg, device="cuda")     # as torch_serve_lm.run makes them
    dep = _registry_deploy(serve_lm, params, cfg.name)
    del params
    model = dep["model"]
    ex = serve_lm.make_executor(model, args, "cuda")
    engine = ServeEngine(cfg, executor=ex)
    prompts = rng.randint(rng.PRNGKey(2, device="cuda"), (args.batch, args.prompt_len),
                          0, cfg.vocab_size)
    leaves = ex.summary()["analog_leaves"]
    if leaves != 7:
        raise AssertionError(f"{cfg.name}: {leaves} analog leaves, expected 7")
    torch.cuda.synchronize()
    vmm_ops.launches = vmm_ops.launches_single = 0
    t0 = time.perf_counter()
    out = engine.generate(prompts, max_new=args.max_new)
    torch.cuda.synchronize()
    gen_wall = time.perf_counter() - t0
    launches = dict(dep["launches"], acim_vmm_tiled=vmm_ops.launches,
                    acim_vmm=vmm_ops.launches_single)
    want = leaves * cfg.n_layers * args.max_new
    if launches["acim_vmm_tiled"] != want:
        raise AssertionError(f"{cfg.name}: generate launched acim_vmm_tiled "
                             f"{launches['acim_vmm_tiled']} times, expected {want}")
    if out.shape != (args.batch, args.max_new) or not bool(
            ((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError(f"{cfg.name}: generated {tuple(out.shape)} outside the vocabulary")
    print(f"  served (DAC {args.dac_bits}, ADC {args.adc_bits} bits, read noise "
          f"{args.read_noise} LSB), batch {args.batch}, prompt {args.prompt_len}, "
          f"{args.max_new} new tokens: generate wall {gen_wall:.2f} s "
          f"({args.batch * args.max_new / gen_wall:.2f} tokens/s incl. prefill); "
          f"acim_vmm_tiled launches {launches['acim_vmm_tiled']} "
          f"({leaves * cfg.n_layers} per access); first sequence {out[0].tolist()}")
    _ideal_check(model, cfg, prompts, cfg.name)

    # The kernels on this deploy's operands.
    cim = ex.cfg
    vmm = {}
    for leaf in ("w_down", "wk", "w_gate"):
        w = build_weight(model.arrays[f"['layers']['{leaf}']"], cim,
                         rng.PRNGKey(0, device="cuda")).layer(0)
        case = f"{cfg.name} {leaf} decode"
        vmm[case] = _vmm_case(w, cim, args.batch, w.n_tiles, False, gen, case)
        _print_vmm(w, cim, {case: vmm[case]}, f"{cfg.name} {leaf} layer 0")
    st = model.arrays["['layers']['w_down']"]
    c = min(C_DEPLOY, int(st.targets.shape[0]))
    wv_args, p = _first_fine_iteration(rng.PRNGKey(1, device="cuda"), st, model.wv_cfg, c)
    kcases = {
        "wv_step": [dict(_wv_case(wv_args, p),
                         case=f"{cfg.name} w_down, first fine iteration, C={c}")],
        "fwht": [dict(phase_fwht(model.wv_cfg.n_cells, gen, x=wv_args[2]),
                      case=f"{cfg.name} w_down, first verify's conductances, C={c}")],
    }
    for name, rr in kcases.items():
        r = rr[0]
        print(f"  {name} on {r['case']}: ms={r['ms']:.4f} ({r['stream_ms']:.4f}) plain_ms="
              f"{r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"max_abs_err={r['max_abs_err']:.3g}")
    del ex, engine, model, dep, st, wv_args
    torch.cuda.empty_cache()
    return dict(runs=runs, launches=launches, kcases=kcases, vmm=vmm, gen_wall_s=gen_wall)


def _stream_ms(fn, reps: int = 3) -> tuple[float, float]:
    """(host ms, stream ms) of `fn()`, medians over `reps` calls: the host
    clock around the call and a device sync, and CUDA events recorded
    around the call on the current stream (the device's time for the
    call's work, gaps the host leaves between its launches included)."""
    import torch

    host, stream = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        stream.append(start.elapsed_time(end))
    return statistics.median(host), statistics.median(stream)


def phase_mesh(smi: str) -> dict:
    """Phase 15: training on a device mesh.  A world of one over NCCL and
    a (1, 1) ("data", "model") mesh: smollm-360m's full train state
    (`get_config`: 32 layers, d_model 960, vocab 49152; bf16 params,
    float32 AdamW moments) stored as `state_sharding` says, one sharded
    step against the plain step from the same state (bitwise, both under
    deterministic algorithms), and their host and stream ms; olmoe-1b-7b's
    `moe_block(mesh=)` at full width (one layer, 64 experts, top 8) on
    batch 2 x 256 against `moe_block(None)` (bitwise, deterministic);
    `compressed_psum` of smollm's params as a gradient tree over a pod
    axis of 1 (each row's error within half its scale, the residual
    exact, every payload int32); then `repro_torch.launch.train` at its
    defaults (smollm-360m at full width and depth, seq 256, batch 8) for
    `MESH_STEPS` steps with a failure at `MESH_FAIL_AT`, and again
    without one: the first must restart once and end on the second's
    state, bitwise.  Checkpoint save, wait and restore host ms and the
    phase's wall time are printed.  The training path launches none of
    the port's kernels (the reference's training reaches no Pallas
    kernel), which is checked."""
    import shutil
    import warnings

    import torch
    import torch.distributed as dist

    from repro_torch import kernels, pytree
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed.sharding import P, NamedSharding, gather_tree, shard_tree
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import init_distributed, make_debug_mesh
    from repro_torch.launch.shardings import shard_batch, state_sharding
    from repro_torch.models.moe import init_moe_params, moe_block
    from repro_torch.optim import AdamWConfig, compressed_psum, init_compression_state
    from repro_torch.training import init_train_state, make_train_step

    t_phase = time.perf_counter()
    launches0 = kernels.launch_counts()
    started = init_distributed("cuda")
    try:
        mesh = make_debug_mesh(1, 1, device="cuda")
        cfg = get_config("smollm-360m")
        opt = AdamWConfig(lr_peak=1e-3, state_dtype=cfg.opt_state_dtype)
        state = init_train_state(SEED, cfg, opt, device="cuda")
        sh = state_sharding(mesh, state, cfg)
        sharded = shard_tree(state, sh)
        n_bytes = sum(x.numel() * x.element_size() for x in pytree.leaves(state))
        specs = sorted({str(tuple(s.spec)) for s in pytree.leaves(sh)})
        data = SyntheticLM(cfg.vocab_size, 256, 8, seed=0, device="cuda")
        batch = data.global_batch_at(0)._asdict()
        sbatch = shard_batch(mesh, batch, 8)
        plain = make_train_step(cfg, opt, total_steps=MESH_STEPS)
        on_mesh = make_train_step(cfg, opt, mesh, total_steps=MESH_STEPS)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                s_plain, m_plain = plain(state, batch)
                s_mesh, m_mesh = on_mesh(sharded, sbatch)
                step_equal = _trees_equal(s_plain, gather_tree(s_mesh))
                loss_equal = float(m_plain["loss"]) == float(m_mesh["loss"])
                del s_plain, s_mesh
                plain_ms = _stream_ms(lambda: plain(state, batch))
                mesh_ms = _stream_ms(lambda: on_mesh(sharded, sbatch))

                moe_cfg = get_config("olmoe-1b-7b")
                g = torch.Generator(device="cuda").manual_seed(SEED)
                layer = {k: v[0] for k, v in init_moe_params(g, moe_cfg, 1, "cuda").items()}
                x = (torch.randn(2, 256, moe_cfg.d_model, device="cuda", generator=g)
                     .to(moe_cfg.dtype))
                specs_moe = {"router": P(), "w_gate": P("model", "data", None),
                             "w_up": P("model", "data", None),
                             "w_down": P("model", None, "data")}
                layer_sh = {k: NamedSharding(mesh, specs_moe[k]).shard(v)
                            for k, v in layer.items()}
                x_sh = NamedSharding(mesh, P("data", None, None)).shard(x)
                want, want_aux = moe_block(x, layer, moe_cfg)
                got, got_aux = moe_block(x_sh, layer_sh, moe_cfg, mesh)
                moe_equal = (torch.equal(got.to_local(), want)
                             and float(got_aux) == float(want_aux))
                moe_err = float((got.to_local().float() - want.float()).abs().max())
                moe_plain_ms = _stream_ms(lambda: moe_block(x, layer, moe_cfg))
                moe_mesh_ms = _stream_ms(lambda: moe_block(x_sh, layer_sh, moe_cfg, mesh))
            finally:
                torch.use_deterministic_algorithms(False)
        del layer, layer_sh, x, x_sh, want, got

        pod_mesh = make_debug_mesh(1, 1, pods=1, device="cuda")
        grads = pytree.tree_map(lambda t: t.to(torch.float32), state.params)
        seen, real = [], dist.all_reduce

        def spy(tensor, *a, **kw):
            seen.append(tensor.dtype)
            return real(tensor, *a, **kw)

        dist.all_reduce = spy
        try:
            synced, cstate = compressed_psum(grads, init_compression_state(grads), pod_mesh)
            comp_ms = _stream_ms(lambda: compressed_psum(
                grads, init_compression_state(grads), pod_mesh))
        finally:
            dist.all_reduce = real
        # Each value within half its row's step (plus the rounding of
        # code x scale, an ulp of the value), and the residual g - synced.
        within, residual = True, True
        for g_, s_, e_ in zip(pytree.leaves(grads), pytree.leaves(synced),
                              pytree.leaves(cstate.error)):
            rows = g_.reshape(g_.shape[0], -1) if g_.ndim > 1 else g_.reshape(1, -1)
            half = (rows.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12) / 2
            err = (s_ - g_).reshape(rows.shape).abs()
            within &= bool((err <= half + rows.abs() * 2.0**-23).all())
            residual &= torch.equal(e_, g_ - s_)
        comp_ok = within and residual
        comp_int = bool(seen) and all(d == torch.int32 for d in seen)
        del grads, synced, cstate, state, sharded
        torch.cuda.empty_cache()

        print(f"mesh (1, 1) over NCCL: smollm-360m train state {n_bytes / 2**30:.2f} GiB "
              f"in {len(pytree.leaves(sh))} DTensor leaves, specs {specs}")
        print(f"  one train step, batch 8 x seq 256, from the same state: sharded == plain "
              f"bitwise {step_equal} (loss {float(m_mesh['loss']):.6f}, equal "
              f"{loss_equal}); "
              f"host ms {mesh_ms[0]:.2f} (plain {plain_ms[0]:.2f}), stream ms "
              f"{mesh_ms[1]:.2f} (plain {plain_ms[1]:.2f})")
        print(f"  olmoe-1b-7b moe_block(mesh=) at full width (64 experts, top 8, "
              f"batch 2 x 256, "
              f"{moe_cfg.dtype}): == moe_block(None) bitwise {moe_equal} (max abs err "
              f"{moe_err:.3g}); host ms {moe_mesh_ms[0]:.2f} (plain "
              f"{moe_plain_ms[0]:.2f}), "
              f"stream ms {moe_mesh_ms[1]:.2f} (plain {moe_plain_ms[1]:.2f})")
        print(f"  compressed_psum over a pod of 1, smollm's params as float32 grads: "
              f"within "
              f"half a step of each row's scale {within}, residual exact {residual}; "
              f"payload dtypes {sorted({str(d) for d in seen})}; host ms {comp_ms[0]:.2f}, "
              f"stream ms {comp_ms[1]:.2f}")
        if not (step_equal and loss_equal and moe_equal and comp_ok and comp_int):
            raise AssertionError(f"mesh phase: step {step_equal}/{loss_equal}, moe "
                                 f"{moe_equal}, compressed_psum {within}/{residual}/"
                                 f"{comp_int}")

        # ---- the launcher, with a failure and without ---------------------
        timed: dict[str, list[float]] = {"save": [], "wait": [], "restore_latest": []}
        originals = {n: getattr(CheckpointManager, n) for n in timed}

        def clocked(name):
            def call(self, *a, **kw):
                t0 = time.perf_counter()
                try:
                    return originals[name](self, *a, **kw)
                finally:
                    timed[name].append((time.perf_counter() - t0) * 1e3)
            return call

        root = Path(__file__).resolve().parent / "build"
        runs = {}
        for name, extra in (("failed", ["--inject-failure", str(MESH_FAIL_AT)]),
                            ("plain", [])):
            ckpt = root / f"chip_smoke_launch_{name}"
            shutil.rmtree(ckpt, ignore_errors=True)
            for n in timed:
                setattr(CheckpointManager, n, clocked(n))
            res: dict = {}
            try:
                t0 = time.perf_counter()
                lines = _printed(lambda: res.update(launch_train.main(
                    ["--steps", str(MESH_STEPS), "--ckpt-dir", str(ckpt), *extra])) or 0)
                wall = time.perf_counter() - t0
            finally:
                for n, f in originals.items():
                    setattr(CheckpointManager, n, f)
            runs[name] = dict(lines=lines, wall=wall, state=res["state"],
                              restarts=res["runner"].restarts,
                              steps=[e["step"] for e in res["logs"]],
                              timed={k: list(v) for k, v in timed.items()})
            for v in timed.values():
                v.clear()
            shutil.rmtree(ckpt, ignore_errors=True)
        fin_equal = _trees_equal(gather_tree(runs["failed"]["state"]),
                                 gather_tree(runs["plain"]["state"]))
        print(f"  repro_torch.launch.train at its defaults, {MESH_STEPS} steps:")
        for name, r in runs.items():
            t = r["timed"]
            print(f"    {name}: {r['lines'][-1]!r} in {r['wall']:.1f} s; steps run "
                  f"{len(r['steps'])}; checkpoint host ms: save (caller's thread) "
                  f"{[round(x, 1) for x in t['save']]}, wait "
                  f"{[round(x, 1) for x in t['wait']]}, restore "
                  f"{[round(x, 1) for x in t['restore_latest']]}")
        print(f"  the run with a failure at step {MESH_FAIL_AT} ends on the uninterrupted "
              f"run's state, bitwise: {fin_equal}")
        for r in runs.values():
            del r["state"]
        failed = runs["failed"]
        if not (fin_equal and failed["restarts"] == 1
                and failed["lines"][-1].endswith("restarts=1")
                and runs["plain"]["restarts"] == 0):
            raise AssertionError(f"launcher: final states equal {fin_equal}, restarts "
                                 f"{failed['restarts']} / {runs['plain']['restarts']}")
    finally:
        if started:
            dist.destroy_process_group()
    launched = kernels.launches_since(launches0)
    wall = time.perf_counter() - t_phase
    print(f"  phase wall time {wall:.1f} s ({smi}); the port's kernels launched in this "
          f"phase: {launched or 'none'}")
    if launched:
        raise AssertionError(f"the training path launched kernels: {launched}")
    return dict(runs=runs, wall=wall)


def _host_equal(a, b) -> bool:
    """Two host trees (dicts, lists, numpy arrays, scalars) equal bitwise."""
    import numpy as np

    if isinstance(a, dict):
        return (isinstance(b, dict) and sorted(a) == sorted(b)
                and all(_host_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_host_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    return a == b


def phase_mesh_serve(smi: str, gen) -> dict:
    """Phase 16: deploy and serve on a device mesh, a (1, 1) ("data",
    "model") mesh over the world of one that phase 15 runs in.
    qwen3-0.6b at full width, 1 layer, is deployed by HARP with `mesh=`
    and without, deterministic algorithms off: conductances and report
    (every field and the health tree, whose per-tile sums run in a fixed
    order) bitwise equal, one host sync each, 3 `fwht` and 1 `wv_step`
    launches per bucket-iteration on the mesh path, and each of the mesh
    deploy's buckets sliced to its rank's block and its packed g and
    stats gathered over the mesh (one `all_gather_axes` per bucket).  The deployment is
    served through `CIMExecutor(mesh=)` + `ServeEngine(mesh=)` and
    through the plain pair at `serve_lm`'s analog defaults (batch 4,
    prompt 32, DAC 6 / ADC 10 bits, read noise 0.2 LSB) for
    `MESH_SERVE_NEW` new tokens: tokens bitwise equal, 7 `acim_vmm_tiled`
    launches per access, and one decode step's host ms of each.  Then
    `ContinuousScheduler(batch_mesh=)` and a plain one serve
    `MESH_REQUESTS` requests on 4 slots through the analog executors:
    the same tokens, phase 9's contracts (one sync per decode step under
    CUDA sync debugging, 7 launches per dispatch).  Then
    `repro_torch.launch.program`'s real mode, and `fwht`, `wv_step` and
    `acim_vmm_tiled` on the mesh path's own operands (w_down's first fine
    iteration; the mesh executor's local w_gate tiles at decode)."""
    import torch

    from repro_torch.cim import CIMConfig, CIMExecutor
    from repro_torch.configs.qwen3_0_6b import CONFIG
    from repro_torch.core import WVConfig, WVMethod, pipeline, rng
    from repro_torch.core.programmer import deploy_arrays
    from repro_torch.distributed.sharding import local
    from repro_torch.kernels.acim_vmm import ops as vmm_ops
    from repro_torch.kernels.fwht import ops as fwht_ops
    from repro_torch.kernels.wv_step import ops as wv_ops
    from repro_torch.launch import program
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import init_params
    from repro_torch.serving import ContinuousScheduler, ServeEngine, poisson_requests

    t_phase = time.perf_counter()
    mesh = make_debug_mesh(1, 1, device="cuda")
    cfg = CONFIG.replace(n_layers=1)
    params = init_params(SEED, cfg, device="cuda")
    wv = WVConfig(method=WVMethod.HARP)
    key = rng.PRNGKey(SEED + 1, device="cuda")
    deploys = {}
    real_gather, gathers = pipeline.all_gather_axes, []

    def counted_gather(*args, **kw):
        gathers.append(1)
        return real_gather(*args, **kw)

    for name, m in (("plain", None), ("mesh", mesh)):
        torch.cuda.synchronize()
        fwht_ops.launches = wv_ops.launches = 0
        gathers.clear()
        pipeline.all_gather_axes = counted_gather
        pipeline.reset_counters()
        t0 = time.perf_counter()
        # Without deterministic algorithms: the health tree's per-tile
        # sums run in a fixed order on the card (`obs.health.
        # tile_reduce_fixed`), so two deploys agree bitwise as they are.
        try:
            (model, report), dbg, where = _sync_counted(
                lambda: deploy_arrays(key, params, wv, device="cuda", mesh=m))
        finally:
            pipeline.all_gather_axes = real_gather
        torch.cuda.synchronize()
        deploys[name] = dict(model=model, report=report, wall=time.perf_counter() - t0,
                             syncs=(pipeline.host_sync_count(), dbg, where),
                             launches={"fwht": fwht_ops.launches,
                                       "wv_step": wv_ops.launches},
                             gathers=len(gathers))
    plain, dm = deploys["plain"], deploys["mesh"]
    model = dm["model"]
    g_equal = all(torch.equal(st.g, model.arrays[n].g)
                  for n, st in plain["model"].arrays.items())
    fields_p, fields_m = dataclasses.asdict(plain["report"]), dataclasses.asdict(dm["report"])
    extra_p, extra_m = plain["report"].extra or {}, dm["report"].extra or {}
    differ = ([k for k in fields_p if fields_p[k] != fields_m[k]]
              + [f"extra.{k}" for k in sorted(set(extra_p) | set(extra_m))
                 if not _host_equal(extra_p.get(k), extra_m.get(k))])
    report_equal = not differ
    n_buckets = len(pipeline.bucket_sizes(dm["report"].num_columns))
    per = n_buckets * wv.max_fine_iters
    print(f"mesh (1, 1) over NCCL: qwen3-0.6b layers=1 deploy by HARP, "
          f"{dm['report'].num_columns} columns; wall s mesh {dm['wall']:.2f} (plain "
          f"{plain['wall']:.2f}); g bitwise {g_equal}, report and health tree bitwise "
          f"{report_equal} {differ or ''}; host syncs mesh {dm['syncs'][:2]} plain {plain['syncs'][:2]} "
          f"(counted, seen by sync debugging); mesh launches {dm['launches']} "
          f"({per} bucket-iterations); packed gathers mesh {dm['gathers']} plain "
          f"{plain['gathers']} ({n_buckets} buckets)")
    if not (g_equal and report_equal):
        raise AssertionError(f"mesh deploy: g equal {g_equal}, report equal {report_equal}")
    for name, d in deploys.items():
        if d["syncs"][:2] != (1, 1):
            raise AssertionError(f"{name} deploy: host syncs {d['syncs']}")
    if (dm["gathers"], plain["gathers"]) != (n_buckets, 0):
        raise AssertionError(f"packed gathers mesh {dm['gathers']} plain "
                             f"{plain['gathers']}; the mesh deploy gathers each of its "
                             f"{n_buckets} buckets once")
    if dm["launches"] != {"fwht": 3 * per, "wv_step": per}:
        raise AssertionError(f"mesh deploy launched {dm['launches']}; HARP needs 3 fwht "
                             f"and 1 wv_step per bucket-iteration ({per})")

    # ---- serve: the engine on the mesh against the plain engine -----------
    cim = CIMConfig(dac_bits=6, adc_bits=10, sigma_read_lsb=0.2)
    b, s = 4, 32
    tokens = torch.randint(0, cfg.vocab_size, (b, s), device="cuda", generator=gen,
                           dtype=torch.int32)
    engines = {m_name: ServeEngine(cfg, None, m, executor=CIMExecutor(
        model, cim, rng.PRNGKey(SEED + 3, device="cuda"), mesh=m))
        for m_name, m in (("plain", None), ("mesh", mesh))}
    outs, gen_launches, step_ms = {}, {}, {}
    for name, eng in engines.items():
        torch.cuda.synchronize()
        vmm_ops.launches = vmm_ops.launches_single = 0
        outs[name] = eng.generate(tokens, max_new=MESH_SERVE_NEW)
        torch.cuda.synchronize()
        gen_launches[name] = {"acim_vmm_tiled": vmm_ops.launches,
                              "acim_vmm": vmm_ops.launches_single}
        _, cache = eng._prefill(eng.access_params(b * s), eng._rows({"tokens": tokens}))
        cur = eng._rows({"tokens": tokens[:, -1:]})
        step_ms[name] = _host_ms(lambda: eng._decode(eng.access_params(b), cache, cur),
                                 reps=5)
    tok_equal = torch.equal(outs["plain"], outs["mesh"])
    want = 7 * cfg.n_layers * MESH_SERVE_NEW
    print(f"  served (DAC 6, ADC 10 bits, read noise 0.2 LSB), batch {b}, prompt {s}, "
          f"{MESH_SERVE_NEW} new tokens: tokens bitwise {tok_equal}; acim_vmm_tiled "
          f"launches mesh {gen_launches['mesh']['acim_vmm_tiled']} plain "
          f"{gen_launches['plain']['acim_vmm_tiled']} (want {want}); decode step host ms "
          f"mesh {step_ms['mesh']:.2f} (plain {step_ms['plain']:.2f})")
    if not tok_equal or any(v["acim_vmm_tiled"] != want for v in gen_launches.values()):
        raise AssertionError(f"mesh serve: tokens equal {tok_equal}, launches {gen_launches}")

    # ---- continuous batching with batch_mesh ------------------------------
    reqs = poisson_requests(SEED, MESH_REQUESTS, rate=0.5, vocab=cfg.vocab_size,
                            prompt_lens=(16, 32), max_new=(8, 16))
    runs = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        ex = CIMExecutor(model, cim, rng.PRNGKey(7, device="cuda"), mesh=m)
        sched = ContinuousScheduler(ServeEngine(cfg, None, m, executor=ex), n_slots=4,
                                    max_len=64, key=rng.PRNGKey(11, device="cuda"),
                                    batch_mesh=m, device="cuda")
        sched.warmup(prompt_range=(16, 32))
        runs[name] = _serve_stream(sched, ex, reqs, cfg.vocab_size, 7 * cfg.n_layers,
                                   f"batch_mesh {name}")
        _print_stream(f"scheduler, batch_mesh={'(1, 1)' if m else None}", sched, runs[name])
    sched_equal = ({r.rid: r.tokens for r in runs["plain"]["recs"]}
                   == {r.rid: r.tokens for r in runs["mesh"]["recs"]})
    print(f"  scheduler tokens bitwise equal to the plain run: {sched_equal}")
    if not sched_equal:
        raise AssertionError("batch_mesh scheduler: tokens differ from the plain run")

    # ---- the launcher's real mode (a world of one: no mesh) ---------------
    t0 = time.perf_counter()
    line = program.main(["--device", "cuda"])
    prog_wall = time.perf_counter() - t0
    print(f"  repro_torch.launch.program (printed above) in {prog_wall:.1f} s")
    if "[bucketed pipeline (" not in line or "1 host sync)]" not in line:
        raise AssertionError(f"launch.program: {line!r}")

    # ---- the kernels on this path's operands ------------------------------
    st = model.arrays["['layers']['w_down']"]
    c = min(C_DEPLOY, int(st.targets.shape[0]))
    wv_args, p = _first_fine_iteration(key, st, wv, c)
    kcases = {
        "wv_step": [dict(_wv_case(wv_args, p),
                         case=f"mesh deploy, w_down first fine iteration, C={c}")],
        "fwht": [dict(phase_fwht(wv.n_cells, gen, x=wv_args[2]),
                      case=f"mesh deploy, w_down first verify's conductances, C={c}")],
    }
    w = engines["mesh"].executor._analog["['layers']['w_gate']"].layer(0)
    w = dataclasses.replace(w, **{f: local(getattr(w, f))
                                  for f in ("g_pos", "g_neg", "scale", "key", "layer_id")})
    case = "mesh w_gate decode (the rank's local tiles)"
    vmm = {case: _vmm_case(w, cim, b, w.n_tiles, False, gen, case)}
    _print_vmm(w, cim, vmm, "mesh executor w_gate layer 0")
    for name, rr in kcases.items():
        r = rr[0]
        print(f"  {name} on {r['case']}: ms={r['ms']:.4f} ({r['stream_ms']:.4f}) plain_ms="
              f"{r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"max_abs_err={r['max_abs_err']:.3g}")
    launches = dict(dm["launches"])
    for name in ("acim_vmm_tiled", "acim_vmm"):
        launches[name] = gen_launches["mesh"][name] + runs["mesh"]["launches"][name]
    wall = time.perf_counter() - t_phase
    print(f"  kernel launches on the mesh paths (deploy; generate + scheduler): {launches}; "
          f"phase wall time {wall:.1f} s ({smi})")
    del engines, deploys, model, st, wv_args, w
    torch.cuda.empty_cache()
    return dict(launches=launches, kcases=kcases, vmm=vmm, wall=wall,
                deploy_wall=(dm["wall"], plain["wall"]), step_ms=step_ms)


def phase_launch(smi: str) -> dict:
    """Phase 17: the launch tools against the card.  `launch.dryrun`
    counts qwen3-0.6b's train_4k and decode_32k cells on the meta device
    on the production pod, and `launch.program --dryrun` programming
    `C_DEPLOY` columns; `launch.report` renders the three rows.  Then two
    steps the card runs whole are counted by the same `WorkCounter` at
    the same shapes on the meta device, and run on the card: one HARP
    `program_columns` bucket of `C_DEPLOY` x 32 cells with per-column
    keys (phase 6's case; its 3 `fwht` and 1 `wv_step` launches per fine
    iteration counted) and one digital qwen3-0.6b decode step (full
    depth, `LAUNCH_DECODE` batch and cache).  Each is timed eagerly
    (stream ms, CUDA events around the call, median of 3 after a warm
    call) beside its counted bound: bytes at 3.35 TB/s or FLOPs at each
    dtype class's rate.  A time below 0.95 of its bound fails the phase:
    the count would say the card beat its own roofline."""
    import torch

    from repro_torch.configs import get_config, input_specs
    from repro_torch.configs.registry import ShapeSpec, materialize_inputs
    from repro_torch.core import WVConfig, WVMethod, program_columns, rng
    from repro_torch.kernels.acim_vmm import ops as vmm_ops
    from repro_torch.kernels.fwht import ops as fwht_ops
    from repro_torch.kernels.wv_step import ops as wv_ops
    from repro_torch.launch import dryrun, program, report
    from repro_torch.models import init_params
    from repro_torch.serving import make_decode_step

    t_phase = time.perf_counter()
    out_dir = str(Path("build") / "chip_smoke_dryrun")
    pod = dryrun.MESHES["pod16x16"]
    rows = [dryrun.run_cell("qwen3-0.6b", shape, pod, "pod16x16", out_dir)
            for shape in ("train_4k", "decode_32k")]
    rows.append(program.run_dryrun("harp", C_DEPLOY, out_dir))
    print(report.HEADER)
    for r in rows:
        print(report.fmt_row(r))
    t_dry = time.perf_counter() - t_phase

    cases = {}
    # One bucket of the deploy, as phase 6 times its iterations.
    wv = WVConfig(method=WVMethod.HARP)

    def bucket_args(device):
        key = rng.PRNGKey(3, device=device)
        if device == "meta":
            targets = torch.empty((C_DEPLOY, 32), device="meta")
        else:
            targets = torch.floor(rng.uniform(key, (C_DEPLOY, 32)) * 8.0)
        return key, targets, torch.arange(C_DEPLOY, device=device)

    def bucket(key, targets, col_ids):
        return program_columns(key, targets, wv, col_ids=col_ids)

    # A digital decode step of the whole model at a batch and cache the
    # card holds.
    cfg = get_config("qwen3-0.6b")
    b, s = LAUNCH_DECODE
    spec = ShapeSpec("decode", "decode", s, b)
    step = make_decode_step(cfg)

    def decode_args(device):
        inputs = (input_specs(cfg, spec) if device == "meta"
                  else materialize_inputs(cfg, spec, device=device))
        return init_params(SEED, cfg, device=device), inputs["cache"], inputs["batch"]

    for name, fn, make in (("program_columns bucket C=2^18", bucket, bucket_args),
                           (f"qwen3-0.6b decode step B={b} S={s}", step, decode_args)):
        wc = dryrun.count(fn, make("meta"))
        bound_ms, by = _bound(wc.bytes, wc.flops)
        args = make("cuda")
        torch.cuda.synchronize()
        fwht_ops.launches = wv_ops.launches = 0
        vmm_ops.launches = vmm_ops.launches_single = 0
        with torch.no_grad():
            fn(*args)
            _, ms = _stream_ms(lambda: fn(*args))
        launched = {"fwht": fwht_ops.launches, "wv_step": wv_ops.launches,
                    "acim_vmm_tiled": vmm_ops.launches, "acim_vmm": vmm_ops.launches_single}
        calls = {k: v["calls"] for k, v in wc.kernels.items()}
        cases[name] = dict(bytes=wc.bytes, flops=dict(wc.flops), bound_ms=bound_ms,
                           bound_by=by, stream_ms=ms, kernel_calls=calls,
                           launches=launched, peak_bytes=wc.peak_bytes)
        flops = ", ".join(f"{c} {f:.4e}" for c, f in wc.flops.items()) or "none"
        print(f"  {name}: counted {wc.bytes:.6e} bytes, FLOPs {flops}, kernels {calls}, "
              f"peak {wc.peak_bytes / 2**30:.2f} GiB; bound {bound_ms:.4f} ms ({by}); "
              f"measured {ms:.4f} stream ms = {bound_ms / ms:.1%} of it ({smi}); "
              f"launched {launched} in the 4 calls")
        del args
        torch.cuda.empty_cache()
    # Each case ran 4 times (a warm call and 3 timed): the bucket launches
    # exactly 4x HARP's kernels and no analog leaf, the digital decode
    # step launches no kernel of the port.
    bucket_case = cases["program_columns bucket C=2^18"]
    want = {"fwht": 3 * wv.max_fine_iters, "wv_step": wv.max_fine_iters}
    want_launched = dict({k: 4 * v for k, v in want.items()}, acim_vmm_tiled=0, acim_vmm=0)
    if bucket_case["kernel_calls"] != want or bucket_case["launches"] != want_launched:
        raise AssertionError(f"program_columns bucket: counted {bucket_case['kernel_calls']}, "
                             f"launched {bucket_case['launches']} in 4 calls; HARP runs "
                             f"{want} per call")
    for name, c in cases.items():
        if c is not bucket_case and (c["kernel_calls"] or any(c["launches"].values())):
            raise AssertionError(f"{name}: counted {c['kernel_calls']}, launched "
                                 f"{c['launches']}; a digital step runs no kernel of the port")
    for name, c in cases.items():
        if c["stream_ms"] < 0.95 * c["bound_ms"]:
            raise AssertionError(f"{name}: measured {c['stream_ms']:.4f} ms is below 0.95 of "
                                 f"its counted bound {c['bound_ms']:.4f} ms: the count is wrong")
    wall = time.perf_counter() - t_phase
    print(f"  phase wall time {wall:.1f} s (dry-run counts {t_dry:.1f} s)")
    launches = {k: sum(c["launches"][k] for c in cases.values()) for k in want_launched}
    return dict(rows=rows, cases=cases, launches=launches, wall=wall)


def _remat_pair(layers: int, b: int, s: int) -> dict:
    """Phase 18's pair: qwen3-0.6b at full width, `layers` deep, random
    params from `SEED`, one gradient (`training._grads_of`, the train
    step's) of the batch `SyntheticLM(151936, seq s, batch b, seed 0)`
    gives at step 0, with `cfg.remat` False and then True, under
    `torch.use_deterministic_algorithms(True, warn_only=True)` scoped to
    them.  For each: (loss, grads, peak GiB of `max_memory_allocated`);
    and the memory held before, the config, params, batch and warnings."""
    import warnings

    import torch

    from repro_torch.configs.qwen3_0_6b import CONFIG
    from repro_torch.data import SyntheticLM
    from repro_torch.models import init_params
    from repro_torch.training import _grads_of

    cfg = CONFIG.replace(n_layers=layers)
    params = init_params(SEED, cfg, device="cuda")
    batch = SyntheticLM(cfg.vocab_size, s, b, seed=0, device="cuda").global_batch_at(0)
    batch = batch._asdict()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2**30
    runs = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for on in (False, True):
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                (loss, _), grads = _grads_of(params, batch, cfg.replace(remat=on))
                torch.cuda.synchronize()
                runs[on] = (loss, grads, torch.cuda.max_memory_allocated() / 2**30)
        finally:
            torch.use_deterministic_algorithms(False)
    return dict(runs=runs, held=held, cfg=cfg, params=params, batch=batch,
                warnings=sorted({str(w.message)[:100] for w in caught}))


def phase_remat(smi: str) -> dict:
    """Phase 18: rematerialisation under autograd.  qwen3-0.6b at full
    width and depth (`get_config`, `remat=True`, bf16, `AdamWConfig()`)
    trains one warm-up and `REMAT_STEPS` steps at `REMAT_RUN` on
    `SyntheticLM(151936, seq 4096, batch 4, seed 0)`: every loss finite,
    the peak of `max_memory_allocated` under the card's 80 GB.  Then
    `_remat_pair` at `REMAT_PAIR`: `remat` False and True give the same
    loss and gradients, bitwise.  Then a no-grad `forward` of the pair's
    batch (the serving paths' mode) runs no checkpoint and equals the
    grad-enabled forward's logits bitwise.  The phase's kernel launches
    are zeroed before it and read after: training launches none."""
    import torch

    from repro_torch import kernels, pytree
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.acim_vmm import ops as vmm_ops
    from repro_torch.kernels.fwht import ops as fwht_ops
    from repro_torch.kernels.wv_step import ops as wv_ops
    from repro_torch.launch.roofline import HBM_BYTES
    from repro_torch.models import forward, remat
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import init_train_state, make_train_step

    t_phase = time.perf_counter()
    fwht_ops.launches = wv_ops.launches = 0
    vmm_ops.launches = vmm_ops.launches_single = 0
    cfg = get_config("qwen3-0.6b")
    opt = AdamWConfig()
    b, s = REMAT_RUN
    data = SyntheticLM(cfg.vocab_size, s, b, seed=0, device="cuda")
    state = init_train_state(SEED, cfg, opt, device="cuda")
    step = make_train_step(cfg, opt, total_steps=REMAT_STEPS + 1)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    losses, host_ms = [], []
    ck0 = remat.checkpoints
    for i in range(REMAT_STEPS + 1):
        batch = data.global_batch_at(i)._asdict()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    peak_bytes = torch.cuda.max_memory_allocated()
    per_step = (remat.checkpoints - ck0) // (REMAT_STEPS + 1)
    timed = host_ms[1:]
    tok_s = b * s / statistics.mean(timed) * 1e3
    print(f"remat: qwen3-0.6b layers={cfg.n_layers} remat={cfg.remat} "
          f"{str(cfg.dtype).removeprefix('torch.')} params, "
          f"float32 AdamW moments, batch {b} x seq {s} ({b * s} tokens a step), "
          f"attention chunks {cfg.attn_chunk_q} x {cfg.attn_chunk_kv}")
    print(f"  losses (warm-up, then {REMAT_STEPS} steps): "
          + " ".join(f"{x:.4f}" for x in losses))
    print(f"  step host ms: warm-up {host_ms[0]:.1f}, then "
          + " ".join(f"{x:.1f}" for x in timed)
          + f" = {tok_s:.0f} tokens/s; {per_step} checkpoints a step")
    print(f"  peak {peak_bytes / 2**30:.2f} GiB ({peak_bytes / 1e9:.2f} GB) with "
          f"{held:.2f} GiB of train state held before ({smi})")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"remat: a loss is not finite: {losses}")
    if peak_bytes >= HBM_BYTES:
        raise AssertionError(f"remat: the peak {peak_bytes / 1e9:.2f} GB reaches the "
                             f"card's {HBM_BYTES / 1e9:.0f} GB")
    del state, step, m
    torch.cuda.empty_cache()

    pair = _remat_pair(*REMAT_PAIR)
    (l0, g0, p0), (l1, g1, p1) = pair["runs"][False], pair["runs"][True]
    grads_equal = all(torch.equal(a, c) for a, c in
                      zip(pytree.leaves(g0), pytree.leaves(g1)))
    loss_equal = torch.equal(l0, l1)
    layers, pb, ps = REMAT_PAIR
    print(f"  {layers} layers, batch {pb} x seq {ps}, one gradient under deterministic "
          f"algorithms: remat False loss {float(l0):.6f} peak {p0:.2f} GiB, remat True "
          f"loss {float(l1):.6f} peak {p1:.2f} GiB ({pair['held']:.2f} GiB of params "
          f"held before); loss bitwise {loss_equal}, every gradient leaf bitwise "
          f"{grads_equal}; warnings {pair['warnings']}")
    if not (loss_equal and grads_equal):
        raise AssertionError(f"remat: loss equal {loss_equal}, grads equal {grads_equal}")
    del g0, g1
    pcfg = pair["cfg"].replace(remat=True)
    params, batch = pair["params"], pair["batch"]
    ck = remat.checkpoints
    with torch.no_grad():
        ng_logits = forward(params, batch, pcfg)[0]
    ng_ck = remat.checkpoints - ck
    leaves = [p.detach().requires_grad_(True) for p in pytree.leaves(params)]
    with torch.enable_grad():
        g_logits = forward(pytree.unflatten(params, leaves), batch, pcfg)[0].detach()
    g_ck = remat.checkpoints - ck - ng_ck
    logits_equal = torch.equal(ng_logits, g_logits)
    print(f"  no-grad forward: {ng_ck} checkpoints, logits bitwise the grad-enabled "
          f"forward's ({g_ck} checkpoints) {logits_equal}")
    if ng_ck or not g_ck or not logits_equal:
        raise AssertionError(f"remat: no-grad checkpoints {ng_ck}, grad-enabled "
                             f"{g_ck}, logits equal {logits_equal}")
    del ng_logits, g_logits, leaves, pair, params, batch
    torch.cuda.empty_cache()
    launches = kernels.launch_counts()
    wall = time.perf_counter() - t_phase
    print(f"  phase wall time {wall:.1f} s; the port's kernels launched: {launches}")
    if any(launches.values()):
        raise AssertionError(f"the training path launched kernels: {launches}")
    return dict(losses=losses, host_ms=host_ms, tokens_per_s=tok_s,
                peak_gib=peak_bytes / 2**30, pair_peaks=(p0, p1), launches=launches,
                wall=wall)


def peak_of(src: str) -> int:
    """``--peak-of DIR``: `_remat_pair` with the port in ``DIR/src`` (a
    checkout or `git archive` of any commit of the port); prints the two
    peaks as one JSON line."""
    sys.path.insert(0, str(Path(src).resolve() / "src"))
    import torch

    import repro_torch

    pair = _remat_pair(*REMAT_PAIR)
    print(_nvidia_smi())
    print(json.dumps({"port": str(Path(repro_torch.__file__).parent), "pair": REMAT_PAIR,
                      "held_gib": pair["held"],
                      "loss": {str(on): float(r[0]) for on, r in pair["runs"].items()},
                      "peak_gib": {str(on): r[2] for on, r in pair["runs"].items()},
                      "device": torch.cuda.get_device_name(0)}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=2,
                    help="qwen3-0.6b depth to deploy (28 = the whole model)")
    ap.add_argument("--train-layers", type=int, default=2,
                    help="qwen3-0.6b depth to train and deploy in phase 11")
    ap.add_argument("--peak-of", metavar="DIR", default=None,
                    help="only measure phase 18's remat pair with the port in DIR/src")
    args = ap.parse_args()
    sys.stdout.reconfigure(line_buffering=True)
    t_start = time.perf_counter()

    def stamp(what: str) -> None:
        print(f"[{time.perf_counter() - t_start:8.2f} s] {what}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.peak_of:
        return peak_of(args.peak_of)
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import build

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
    # Phase 10's reference: the clean deploy's weights, before phase 9's
    # scrub moves its conductances.
    clean = {n: st.materialize(dtype=torch.float32) for n, st in dep["model"].arrays.items()}
    stamp("breakdown phase")
    phase_breakdown()
    stamp("acim_vmm kernel phase")
    vmm = phase_acim_vmm(dep["model"], gen)
    stamp("serving phase")
    serve = phase_serve(dep["model"], args.layers, gen)
    stamp("serving breakdown phase")
    phase_serve_breakdown(serve, gen)
    stamp("continuous serving phase")
    cont = phase_continuous(dep["model"], args.layers, gen)
    serve_launches = serve["launches"]
    del serve
    torch.cuda.empty_cache()
    stamp("faulty silicon phase")
    phase_fault_guard()
    faults = phase_faults(dep, clean, args.layers, gen)
    deploy_launches = dep["launches"]
    del dep, clean
    torch.cuda.empty_cache()
    stamp("train phase")
    train = phase_train(args.train_layers)
    stamp("train -> write-and-verify -> eval loss phase")
    loop = phase_loop(train, gen)
    del train
    torch.cuda.empty_cache()
    stamp("fig10 phase")
    fig10 = phase_fig10(gen)
    torch.cuda.empty_cache()
    stamp("registry phase")
    reg = phase_registry(gen)
    torch.cuda.empty_cache()
    stamp("families phase")
    fams = phase_families(gen)
    torch.cuda.empty_cache()
    stamp("mesh training phase")
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed

    # Phases 15 and 16 share one world of one over NCCL.
    started = init_distributed("cuda")
    try:
        phase_mesh(smi)
        torch.cuda.empty_cache()
        stamp("mesh deploy and serve phase")
        mserve = phase_mesh_serve(smi, gen)
    finally:
        if started:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    stamp("launch tools phase")
    launch = phase_launch(smi)
    torch.cuda.empty_cache()
    stamp("remat phase")
    rem = phase_remat(smi)
    stamp("done")

    main_fwht, main_wv = k[("fwht", 32)], k[("wv_step", 32, True)]
    line = {"kernels": [
        dict(name="fwht", route="cuda", source="src/repro_torch/kernels/csrc/fwht.cu",
             replaces="src/repro/kernels/fwht/fwht.py:62",
             launches=deploy_launches["fwht"], max_abs_err=main_fwht["max_abs_err"],
             ms=main_fwht["ms"], plain_ms=main_fwht["plain_ms"],
             bound_ms=main_fwht["bound_ms"], bound_by=main_fwht["bound_by"],
             library_ms=main_fwht["library_ms"]),
        dict(name="wv_step", route="cuda", source="src/repro_torch/kernels/csrc/wv_step.cu",
             replaces="src/repro/kernels/wv_step/wv_step.py:99",
             launches=deploy_launches["wv_step"], max_abs_err=main_wv["max_abs_err"],
             ms=main_wv["ms"], plain_ms=main_wv["plain_ms"],
             bound_ms=main_wv["bound_ms"], bound_by=main_wv["bound_by"],
             library_ms=None),
    ]}
    for entry in line["kernels"]:
        entry["launches_continuous"] = cont["launches"][entry["name"]]
        # Phase 10: the remap arm's deploy, its scrub and the calibration.
        entry["launches_faults"] = faults["launches"][entry["name"]]
        entry["faults_case"] = [
            {k: r[k] for k in ("case", "ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "max_abs_err")}
            for r in faults["kcases"][entry["name"]]]
        # The same kernel at phase 9's scrub shapes.
        entry["scrub_case"] = [
            {k: r[k] for k in ("case", "ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "max_abs_err")}
            for r in cont["sub_kernels"][entry["name"]]]
        # Phase 11 (the trained model's deploys) and phase 12 (fig10's).
        entry["launches_train"] = loop["launches"][entry["name"]]
        entry["launches_fig10"] = fig10["launches"][entry["name"]]
        entry["train_case"] = [
            {k: r[k] for k in ("case", "ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "max_abs_err")}
            for r in loop["kcases"][entry["name"]]]
        entry["fig10_case"] = [
            {k: r[k] for k in ("case", "ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "max_abs_err")}
            for r in fig10["kcases"][entry["name"]]]
        # Phase 13: llama3.2-1b's deploy, and the kernel on its operands.
        entry["launches_registry"] = reg["launches"][entry["name"]]
        entry["registry_case"] = [
            {k: r[k] for k in ("case", "ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "max_abs_err")}
            for r in reg["kcases"][entry["name"]]]
        # Phase 14: hymba-1.5b's deploy, and the kernel on its operands.
        entry["launches_families"] = fams["launches"][entry["name"]]
        entry["families_case"] = [
            {k: r[k] for k in ("case", "ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "max_abs_err")}
            for r in fams["kcases"][entry["name"]]]
        # Phase 17: the program_columns bucket counted against the card.
        entry["launches_launch"] = launch["launches"][entry["name"]]
        # Phase 18: the full-depth remat train steps launch no kernel.
        entry["launches_remat"] = rem["launches"][entry["name"]]
        # Phase 16: the mesh deploy, and the kernel on its operands.
        entry["launches_mesh"] = mserve["launches"][entry["name"]]
        entry["mesh_case"] = [
            {k: r[k] for k in ("case", "ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "max_abs_err")}
            for r in mserve["kcases"][entry["name"]]]
    for name, case, src_line in (("acim_vmm_tiled", "decode", 166),
                                 ("acim_vmm", "one tile", 230)):
        r = vmm[case]
        tiled = case != "one tile"
        cases = {c: o for c, o in vmm.items() if c != case and (o["tiles"] == 1) != tiled}
        if tiled:
            cases.update(cont["vmm"])
            cases["remapped decode (phase 10)"] = faults["vmm"]
            cases.update({f"{c} (phase 11)": o for c, o in loop["vmm"].items()})
            cases.update({f"{c} (phase 13)": o for c, o in reg["vmm"].items()})
        line["kernels"].append(dict(
            name=name, route="cuda", source="src/repro_torch/kernels/csrc/acim_vmm.cu",
            replaces=f"src/repro/kernels/acim_vmm/acim_vmm.py:{src_line}",
            launches=serve_launches[name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            shape=f"B={r['b']} T={r['tiles']}", adc_flips=r["flips"],
            launches_continuous=cont["launches"][name],
            launches_faults=faults["launches"][name],
            launches_train=loop["launches"][name],
            launches_fig10=fig10["launches"][name],
            launches_registry=reg["launches"][name],
            launches_families=fams["launches"][name],
            launches_mesh=mserve["launches"][name],
            launches_launch=launch["launches"][name],
            launches_remat=rem["launches"][name],
            mesh_case=[dict(case=c, ms=o["ms"], plain_ms=o["plain_ms"],
                            bound_ms=o["bound_ms"], bound_by=o["bound_by"],
                            library_ms=o["library_ms"], max_abs_err=o["max_abs_err"],
                            shape=f"B={o['b']} T={o['tiles']}")
                       for c, o in mserve["vmm"].items() if tiled],
            families_case=[dict(case=c, ms=o["ms"], plain_ms=o["plain_ms"],
                                bound_ms=o["bound_ms"], bound_by=o["bound_by"],
                                library_ms=o["library_ms"], max_abs_err=o["max_abs_err"],
                                shape=f"B={o['b']} T={o['tiles']}")
                           for c, o in fams["vmm"].items() if tiled],
            # The same kernel's other rows of phases 7 and 9 (route "raw" = f32).
            other_cases={c: dict(ms=o["ms"], bound_ms=o["bound_ms"], bound_by=o["bound_by"],
                                 plain_ms=o["plain_ms"], library_ms=o["library_ms"],
                                 max_abs_err=o["max_abs_err"], shape=f"B={o['b']} T={o['tiles']}")
                         for c, o in cases.items()}))
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
