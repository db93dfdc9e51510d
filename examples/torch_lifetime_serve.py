"""Serve an RRAM-deployed LM across device aging with scrub refresh, in
the PyTorch port (`examples/lifetime_serve.py` in PyTorch).

End-to-end lifetime scenario: train a small LM, burn it onto simulated
RRAM with `deploy_arrays` (the persistent-state path: conductances stay
live), then serve traffic across wall-clock epochs while the devices
relax, drift and wear.  Each epoch the refresh policy decides what to
scrub (verify-triggered by default: one cheap Hadamard sweep per column,
re-program only flagged columns), the refreshed weights are
re-materialized and hot-swapped into the serving engine, and the
`LifetimeReport` time series records accuracy retained against
maintenance energy spent.

    PYTHONPATH=src python examples/torch_lifetime_serve.py --epochs 4
    PYTHONPATH=src python examples/torch_lifetime_serve.py --device cpu

`--device` (default ``cuda``) picks where everything runs; the body is
`run(cfg, args, device)`, which takes the model configuration.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core import NoiseConfig, WVConfig, WVMethod, rng
from repro_torch.core.programmer import deploy_arrays
from repro_torch.data import SyntheticLM
from repro_torch.lifetime import (
    DriftConfig,
    LifetimeSimulator,
    RefreshConfig,
    RefreshPolicy,
)
from repro_torch.models import ModelConfig
from repro_torch.models.transformer import loss_fn
from repro_torch.optim import AdamWConfig
from repro_torch.serving import ServeEngine
from repro_torch.training import init_train_state, make_train_step

# The demo's model (the reference script's).
DEMO_CONFIG = ModelConfig(
    name="lifetime-demo", n_layers=2, d_model=96, n_heads=4, n_kv_heads=2,
    head_dim=24, d_ff=192, vocab_size=64, dtype=torch.float32,
    attn_chunk_q=32, attn_chunk_kv=32, remat=False,
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--dt-hours", type=float, default=1.0)
    ap.add_argument("--noise", type=float, default=0.7, help="read noise, LSB")
    ap.add_argument("--method", default="harp", choices=[m.value for m in WVMethod])
    ap.add_argument(
        "--policy", default="verify_triggered",
        choices=[p.value for p in RefreshPolicy],
    )
    ap.add_argument("--device", default="cuda")
    return ap


def run(cfg: ModelConfig, args, device) -> list:
    """The script's body on `cfg` and `device`; returns the epoch records."""
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=64, global_batch=16,
                       seed=1, device=device)
    opt_cfg = AdamWConfig(lr_peak=1e-2)
    state = init_train_state(0, cfg, opt_cfg, device=device)
    step = make_train_step(cfg, opt_cfg, total_steps=args.steps)
    for i in range(args.steps):
        state, _ = step(state, data.global_batch_at(i)._asdict())
    eval_batch = data.global_batch_at(99_999)._asdict()

    def eval_fn(params) -> float:
        with torch.no_grad():
            return float(loss_fn(params, eval_batch, cfg)[0])

    clean = eval_fn(state.params)
    print(f"trained {args.steps} steps on {device}; clean eval loss = {clean:.4f}")

    wv = WVConfig(
        method=WVMethod(args.method),
        noise=NoiseConfig(sigma_read_lsb=args.noise),
    )
    deployed, report = deploy_arrays(rng.PRNGKey(7, device=device), state.params, wv,
                                     device=device)
    print(
        f"deployed {report.num_columns} columns "
        f"({report.num_cells} cells) with {args.method}; "
        f"rms err = {report.rms_cell_error_lsb:.3f} LSB\n"
    )

    engine = ServeEngine(cfg, deployed.materialize())
    sim = LifetimeSimulator(
        rng.PRNGKey(11, device=device),
        deployed,
        drift_cfg=DriftConfig(nu_drift=0.01, sigma_nu_frac=0.8),
        refresh_cfg=RefreshConfig(policy=RefreshPolicy(args.policy)),
        on_refresh=engine.swap_params,
    )

    prompt = data.global_batch_at(0).tokens[:4, :16]
    print(f"{'epoch':>5s} {'t[h]':>6s} {'loss':>8s} {'dloss':>8s} {'rms[LSB]':>9s} "
          f"{'flags':>6s} {'reprog':>6s} {'E_maint[nJ]':>12s}")
    records = []
    for _ in range(args.epochs):
        # Serving traffic: every decoded token is one ACiM read of every
        # column (that is the traffic the read-disturb model sees).
        toks = engine.generate(prompt, max_new=24, key=rng.PRNGKey(3, device=device))
        reads = int(toks.shape[0] * toks.shape[1]) * 100  # scale to epoch traffic
        rec = sim.step_epoch(
            dt_s=args.dt_hours * 3600.0,
            reads_per_column=float(reads),
            eval_fn=eval_fn,
        )
        records.append(rec)
        print(
            f"{rec.epoch:5d} {rec.t_s / 3600:6.1f} {rec.eval_metric:8.4f} "
            f"{rec.eval_metric - clean:+8.4f} {rec.rms_drift_lsb:9.3f} "
            f"{rec.columns_flagged:6d} {rec.columns_reprogrammed:6d} "
            f"{(rec.verify_energy_pj + rec.program_energy_pj) / 1e3:12.1f}"
        )

    total_e = sum(r.verify_energy_pj + r.program_energy_pj for r in records)
    print(
        f"\npolicy={args.policy}: final dloss "
        f"{records[-1].eval_metric - clean:+.4f}, total maintenance "
        f"energy {total_e / 1e3:.1f} nJ over {args.epochs} epochs"
    )
    print("Try --policy none (drift unchecked) and --policy periodic")
    print("(blind full re-program) to compare retention vs energy.")
    return records


def main(argv: list[str] | None = None) -> list:
    args = build_parser().parse_args(argv)
    return run(DEMO_CONFIG, args, args.device)


if __name__ == "__main__":
    main()
