"""End-to-end training driver in the PyTorch port: fault-tolerant LM
training on synthetic data (`examples/train_lm.py` in PyTorch).

The default is a CPU-friendly reduced config; `--arch smollm-360m --full`
selects a registry config at full size.  A ~100M-parameter run a few
hundred steps long:

    PYTHONPATH=src python examples/torch_train_lm.py --preset 100m --steps 300
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --inject-failure 30

Exercised: the deterministic data pipeline, AdamW + cosine schedule,
async checkpoints with keep-k rotation, fault injection + restore
(`--inject-failure`), the straggler monitor and resume (`--resume`).
The steps run under deterministic algorithms, so a restore replays
bitwise what an uninterrupted run computes.
"""

import argparse
import os
import tempfile
import time

import torch

from repro_torch import pytree
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import SyntheticLM
from repro_torch.distributed import FaultInjector, FaultTolerantRunner, StragglerMonitor
from repro_torch.models import ModelConfig
from repro_torch.optim import AdamWConfig
from repro_torch.training import init_train_state, make_train_step

PRESETS = {
    # ~1M params: smoke-speed
    "tiny": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
                 d_ff=256, vocab_size=512, seq=128, batch=8),
    # ~100M params: the "train a ~100M model for a few hundred steps" driver
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, head_dim=64,
                 d_ff=2048, vocab_size=32768, seq=512, batch=8),
}


def build_cfg(args) -> tuple[ModelConfig, int, int]:
    if args.arch:
        cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
        return cfg, args.seq or 256, args.batch or 8
    p = PRESETS[args.preset]
    cfg = ModelConfig(
        name=f"lm-{args.preset}", n_layers=p["n_layers"], d_model=p["d_model"],
        n_heads=p["n_heads"], n_kv_heads=p["n_kv_heads"], head_dim=p["head_dim"],
        d_ff=p["d_ff"], vocab_size=p["vocab_size"], dtype=torch.float32,
        attn_chunk_q=128, attn_chunk_kv=128, remat=False,
    )
    return cfg, args.seq or p["seq"], args.batch or p["batch"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    ap.add_argument("--arch", default=None, help="use a registry architecture")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "harp_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--inject-failure", type=int, nargs="*", default=())
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device (pass --device cpu)")

    cfg, seq, batch = build_cfg(args)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
                       device=args.device)
    opt_cfg = AdamWConfig(lr_peak=1e-3)
    state = init_train_state(0, cfg, opt_cfg, device=args.device)
    n_params = sum(x.numel() for x in pytree.leaves(state.params))
    print(f"model={cfg.name} params={n_params:,} seq={seq} batch={batch}")

    raw_step = make_train_step(cfg, opt_cfg, total_steps=args.steps)
    monitor = StragglerMonitor()
    t_last = [time.perf_counter()]

    def step_fn(state, batch):
        state, metrics = raw_step(state, batch)
        loss = float(metrics["loss"])
        now = time.perf_counter()
        monitor.observe(int(state.opt.step), now - t_last[0])
        t_last[0] = now
        return state, {"loss": loss}

    manager = CheckpointManager(args.ckpt_dir, keep=3)
    start = 0
    if args.resume:
        try:
            start, state = manager.restore_latest(template=state)
            print(f"resumed from step {start}")
        except FileNotFoundError:
            print("no checkpoint found; starting fresh")

    runner = FaultTolerantRunner(
        step_fn,
        lambda s: data.global_batch_at(s)._asdict(),
        manager,
        checkpoint_every=args.ckpt_every,
        injector=FaultInjector(fail_at_steps=tuple(args.inject_failure)),
    )
    mode = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        t0 = time.time()
        state, logs = runner.run(state, start, args.steps)
        dt = time.time() - t0
    finally:
        torch.use_deterministic_algorithms(mode[0], warn_only=mode[1])
    first, last = logs[0]["loss"], logs[-1]["loss"]
    print(
        f"steps={len(logs)} loss {first:.4f} -> {last:.4f} "
        f"({dt:.1f}s, {dt / max(len(logs), 1) * 1e3:.0f} ms/step, "
        f"restarts={runner.restarts}, straggler_flags={len(monitor.flagged_steps)})"
    )
    if not last < first:
        raise RuntimeError("training did not reduce the loss")
    return dict(state=state, logs=logs, runner=runner, monitor=monitor)


if __name__ == "__main__":
    main()
