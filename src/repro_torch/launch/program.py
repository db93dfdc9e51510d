"""Distributed RRAM programming launcher: the paper's technique at scale.

    PYTHONPATH=src python -m repro_torch.launch.program --arch qwen3-0.6b \
        --method harp --device cpu [--baseline]

Columns are independent, so the launcher splits the packed column axis
over every rank of the job: under `torchrun` with several ranks the
deploy runs on a 1-D ("cols",) mesh of all of them, with no traffic
between ranks inside the verify loop; alone it is a world of one and
needs no mesh.  It programs a smoke-config model end to end through
`core.programmer.deploy_params` (the bucketed pipeline; `--baseline`
takes the per-leaf path) and prints the reference's line.

The reference's ``--dryrun`` lowers and compiles `program_columns` for
a TPU v5e pod and emits a roofline row; its H100 counterpart is not
ported yet (ROADMAP.md A5 item 3), so ``--dryrun`` raises.
"""

from __future__ import annotations

import argparse
import time

import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.core import WVConfig, WVMethod, pipeline, rng
from repro_torch.core.programmer import deploy_params
from repro_torch.launch.mesh import DEFAULT_TIMEOUT, _mesh, init_distributed
from repro_torch.models import init_params

__all__ = ["run_real", "main"]


def run_real(method: str, arch: str, baseline: bool = False, device="cuda") -> str:
    """Program `arch`'s smoke config by `method`; returns the printed
    line.  The column axis is split over the job's ranks when it has
    several (a default process group of more than one rank)."""
    cfg = get_smoke_config(arch)
    params = init_params(0, cfg, device=device)
    mesh = None
    if not baseline and dist.is_initialized() and dist.get_world_size() > 1:
        mesh = _mesh((dist.get_world_size(),), ("cols",), device, DEFAULT_TIMEOUT)
    pipeline.reset_counters()
    t0 = time.perf_counter()
    _, report = deploy_params(
        rng.PRNGKey(1, device=device), params, WVConfig(method=WVMethod(method)),
        batched=not baseline, mesh=mesh, device=device)
    dt = time.perf_counter() - t0
    path = "per-leaf baseline" if baseline else (
        f"bucketed pipeline ({pipeline.compile_count()} compiles, "
        f"{pipeline.host_sync_count()} host sync)")
    line = (f"programmed {arch} (smoke) with {method} [{path}]: "
            f"{report.num_cells:,} cells, "
            f"{report.num_columns:,} columns, rms={report.rms_cell_error_lsb:.3f} LSB, "
            f"mean iters={report.mean_iterations:.1f}, "
            f"energy={report.total_energy_pj / 1e6:.2f} uJ, "
            f"{report.num_columns / dt:,.0f} columns/s")
    print(line)
    return line


def main(argv: list[str] | None = None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--method", default="harp", choices=[m.value for m in WVMethod])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--dryrun", action="store_true")
    ap.add_argument("--baseline", action="store_true",
                    help="per-leaf deployment path (vs bucketed pipeline)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.dryrun:
        raise NotImplementedError(
            "--dryrun: the TPU roofline tools' H100 counterparts are ROADMAP.md A5 "
            "item 3, not ported yet")
    started = False
    if dist.is_torchelastic_launched():
        started = init_distributed(args.device)
    try:
        return run_real(args.method, args.arch, baseline=args.baseline,
                        device=args.device)
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
