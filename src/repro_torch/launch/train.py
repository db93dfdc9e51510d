"""Training launcher: mesh + sharded state + fault tolerance.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --smoke --steps 20 --device cpu

Under `torchrun` it joins the job's process group; alone it runs a world
of one in this process (NCCL on the card, gloo on the CPU).  The mesh is
the production mesh when asked (the job must have its 256 ranks),
``(data 2, model 2)`` at a world of 4 or more, else ``(1, 1)``.  The
state is stored as `launch.shardings.state_sharding` says, the batch as
`batch_sharding`, and `FaultTolerantRunner` runs the sharded step with
async checkpoints every ``max(steps // 2, 10)`` steps (two kept), a
`StragglerMonitor` and the failures `--inject-failure` plants.  The
steps run under deterministic algorithms (warn-only), so that a replay
from a checkpoint reproduces the uninterrupted run bitwise: PyTorch's
scatter-adds (the embedding's backward among them) otherwise sum in
thread order, on the CPU as on the card.  The last line is the
reference's summary, ``restarts=N`` included.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import SyntheticLM
from repro_torch.distributed import FaultInjector, FaultTolerantRunner, StragglerMonitor
from repro_torch.distributed.sharding import local, shard_tree
from repro_torch.launch.mesh import init_distributed, make_debug_mesh, make_production_mesh
from repro_torch.launch.shardings import shard_batch, state_sharding
from repro_torch.optim import AdamWConfig
from repro_torch.training import init_train_state, make_train_step

__all__ = ["main"]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "harp_torch_launch_train"))
    ap.add_argument("--inject-failure", type=int, nargs="*", default=())
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def main(argv: list[str] | None = None) -> dict:
    """Run the launcher; returns its mesh, final state, metrics log and
    runner (for callers that drive it in process)."""
    args = _parser().parse_args(argv)
    started = init_distributed(args.device)
    mode = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return _run(args)
    finally:
        torch.use_deterministic_algorithms(mode[0], warn_only=mode[1])
        if started:
            dist.destroy_process_group()


def _run(args) -> dict:
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    world = dist.get_world_size()
    if args.production_mesh:
        mesh = make_production_mesh(device=args.device)
    elif world >= 4:
        mesh = make_debug_mesh(2, 2, device=args.device)
    else:
        mesh = make_debug_mesh(1, 1, device=args.device)

    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, device=args.device)
    opt_cfg = AdamWConfig(lr_peak=1e-3, state_dtype=cfg.opt_state_dtype)
    state = init_train_state(0, cfg, opt_cfg, device=args.device)
    state = shard_tree(state, state_sharding(mesh, state, cfg))
    step = make_train_step(cfg, opt_cfg, mesh, total_steps=args.steps)

    monitor = StragglerMonitor()
    manager = CheckpointManager(args.ckpt_dir, keep=2)

    def step_fn(state, batch):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss = float(metrics["loss"])
        monitor.observe(int(local(state.opt.step)), time.perf_counter() - t0)
        return state, {"loss": loss}

    runner = FaultTolerantRunner(
        step_fn,
        lambda s: shard_batch(mesh, data.global_batch_at(s)._asdict(), args.batch),
        manager,
        checkpoint_every=max(args.steps // 2, 10),
        injector=FaultInjector(fail_at_steps=tuple(args.inject_failure)),
    )
    state, logs = runner.run(state, 0, args.steps)
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    print(f"{args.arch} mesh={sizes} loss {logs[0]['loss']:.4f} -> "
          f"{logs[-1]['loss']:.4f} restarts={runner.restarts}")
    return dict(mesh=mesh, state=state, logs=logs, runner=runner, monitor=monitor)


if __name__ == "__main__":
    main()
