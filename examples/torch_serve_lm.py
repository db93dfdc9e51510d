"""Batched serving demo in the PyTorch port: prefill + decode with the
ServeEngine (`examples/serve_lm.py` in PyTorch).

    PYTHONPATH=src python examples/torch_serve_lm.py --arch qwen3-0.6b
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu --analog --continuous

Uses the smoke-size config of the chosen architecture, runs batched
greedy generation, and reports tokens/s.  Two RRAM modes:

  --rram    program the weights with HARP, read them back, serve the
            materialized digital weights (the paper's iso-footprint
            deployment, programming error frozen into dense matmuls);
  --analog  program with HARP and serve straight off the live
            `DeployedModel` arrays, no materialize(): every matmul is
            computed *in* the programmed conductance tiles through the
            bit-serial DAC -> analog VMM -> per-slice ADC path (the
            `acim_vmm` kernel on the card), with per-read noise, and the
            cost model's inference phase prices every token.

`--continuous` swaps the fixed-batch generate loop for the
continuous-batching scheduler: a Poisson stream of variable-length
requests is admitted into a fixed decode batch with no step function
built after warmup, and per-request latency is reported.

`--device` (default ``cuda``) picks where everything runs; on the CPU
the kernels run their plain PyTorch versions.  The body is split into
functions that take a `ModelConfig` and a device (`deploy_model`,
`make_executor`, `make_scheduler`, `report_continuous`, `run`), so a
caller can drive a full-size configuration through the same code.
"""

from __future__ import annotations

import argparse
import time

from repro_torch.configs import get_smoke_config
from repro_torch.core import WVConfig, WVMethod, rng
from repro_torch.core.programmer import deploy_arrays, deploy_params
from repro_torch.models import ModelConfig, init_params
from repro_torch.serving import ServeEngine


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--rram", action="store_true")
    ap.add_argument("--analog", action="store_true",
                    help="serve off the live arrays (compute-in-memory)")
    ap.add_argument("--dac-bits", type=int, default=6)
    ap.add_argument("--adc-bits", type=int, default=10)
    ap.add_argument("--read-noise", type=float, default=0.2,
                    help="per-read TIA/ADC noise std, cell-LSB")
    ap.add_argument("--continuous", action="store_true",
                    help="serve a Poisson request stream via the scheduler")
    ap.add_argument("--n-slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--load", type=float, default=0.3,
                    help="offered load, requests per decode step")
    ap.add_argument("--device", default="cuda")
    return ap


def deploy_model(key, params, device, *, materialize: bool = False):
    """Program `params` onto RRAM with HARP; returns (deployed model, or
    its materialized params with `materialize`, report)."""
    deploy = deploy_params if materialize else deploy_arrays
    out, report = deploy(key, params, WVConfig(method=WVMethod.HARP), device=device)
    print(f"  programmed {report.num_cells:,} cells, "
          f"rms={report.rms_cell_error_lsb:.3f} LSB")
    return out, report


def make_executor(deployed, args, device):
    """The analog executor at `args`' converters and read noise (key 7)."""
    from repro_torch.cim import CIMConfig, CIMExecutor

    executor = CIMExecutor(
        deployed,
        CIMConfig(dac_bits=args.dac_bits, adc_bits=args.adc_bits,
                  sigma_read_lsb=args.read_noise),
        rng.PRNGKey(7, device=device),
    )
    s = executor.summary()
    print(f"  analog serving: {s['analog_leaves']} leaves on tiles, "
          f"{s['digital_fallback_leaves']} digital fallback, "
          f"{s['planes_per_token']} read planes/token")
    return executor


def make_scheduler(engine: ServeEngine, cfg: ModelConfig, args, device):
    """The continuous scheduler (key 11), warmed for `args`' prompt
    range, and its Poisson request stream (seed 3)."""
    from repro_torch.serving import ContinuousScheduler, poisson_requests

    max_len = args.prompt_len + args.max_new + 8
    sched = ContinuousScheduler(engine, n_slots=args.n_slots, max_len=max_len,
                                key=rng.PRNGKey(11, device=device), device=device)
    lo, hi = max(args.prompt_len // 2, 2), args.prompt_len
    print(f"warming prefill buckets for prompts in [{lo}, {hi}] ...")
    sched.warmup(prompt_range=(lo, hi))
    reqs = poisson_requests(
        3, args.requests, rate=args.load, vocab=cfg.vocab_size,
        prompt_lens=(lo, hi), max_new=(args.max_new // 2, args.max_new),
    )
    return sched, reqs


def report_continuous(sched, recs, executor) -> dict:
    s = sched.latency_stats()
    print(f"served {len(recs)} requests in {sched.decode_steps} decode "
          f"steps ({s['tokens_per_s']:.1f} tok/s, "
          f"{s['tokens_per_step']:.2f} tok/step)")
    print(f"latency p50={s['p50_latency_steps']:.1f} "
          f"p99={s['p99_latency_steps']:.1f} steps; "
          f"ttft p50={s['p50_ttft_steps']:.1f} steps")
    print(f"step functions built: admit={sched.trace_counts['admit']} "
          f"decode={sched.trace_counts['decode']} (counts incl. warmup)")
    if executor is not None:
        lat_ns, e_pj = executor.token_cost()
        print(f"analog cost model: {lat_ns / 1e3:.2f} us/token, "
              f"{e_pj / 1e3:.1f} nJ/token")
    return s


def run(cfg: ModelConfig, args, device) -> dict:
    """The script's body on `cfg` and `device`; returns what it served."""
    if cfg.block == "rwkv6" or cfg.frontend == "embed_stub":
        raise SystemExit("pick a token-input arch for this demo (dense/moe/hybrid)")
    params = init_params(0, cfg, device=device)

    executor = None
    key = rng.PRNGKey(1, device=device)
    if args.analog:
        print("programming weights onto RRAM with HARP ...")
        deployed, _ = deploy_model(key, params, device)
        executor = make_executor(deployed, args, device)
        params = None
    elif args.rram:
        print("programming weights onto RRAM with HARP ...")
        params, _ = deploy_model(key, params, device, materialize=True)

    engine = ServeEngine(cfg, params, executor=executor)

    if args.continuous:
        sched, reqs = make_scheduler(engine, cfg, args, device)
        recs = sched.run(reqs)
        return dict(records=recs, stats=report_continuous(sched, recs, executor))

    prompts = rng.randint(rng.PRNGKey(2, device=device),
                          (args.batch, args.prompt_len), 0, cfg.vocab_size)
    t0 = time.time()
    out = engine.generate(prompts, max_new=args.max_new).cpu()
    dt = time.time() - t0
    total = args.batch * args.max_new
    print(f"arch={cfg.name} batch={args.batch} on {device}")
    print(f"generated {tuple(out.shape)} in {dt:.2f}s ({total / dt:.1f} tok/s)")
    if executor is not None:
        lat_ns, e_pj = executor.token_cost()
        s = executor.summary()
        print(
            f"analog cost model: {lat_ns / 1e3:.2f} us/token array latency, "
            f"{e_pj / 1e3:.1f} nJ/token "
            f"({s['total_energy_pj'] / 1e6:.2f} uJ for {s['tokens_served']} tokens)"
        )
    print("first sequence:", out[0][:16].tolist(), "...")
    return dict(tokens=out)


def main(argv: list[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)
    return run(get_smoke_config(args.arch), args, args.device)


if __name__ == "__main__":
    main()
