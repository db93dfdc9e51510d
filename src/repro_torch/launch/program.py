"""Distributed RRAM programming launcher: the paper's technique at scale.

    PYTHONPATH=src python -m repro_torch.launch.program --arch qwen3-0.6b \
        --method harp --device cpu [--baseline]
    PYTHONPATH=src python -m repro_torch.launch.program --dryrun \
        [--columns 4194304] [--method harp] [--out results/dryrun]

Columns are independent, so the launcher splits the packed column axis
over every rank of the job: under `torchrun` with several ranks the
deploy runs on a 1-D ("cols",) mesh of all of them, with no traffic
between ranks inside the verify loop; alone it is a world of one and
needs no mesh.  It programs a smoke-config model end to end through
`core.programmer.deploy_params` (the bucketed pipeline; `--baseline`
takes the per-leaf path) and prints the reference's line.

``--dryrun`` counts `core.wv.program_columns` for `--columns` columns
by `--method` on the meta device, with no card: the columns split over
the 256 devices of the production pod (`launch.dryrun.MESHES`), each
device's block counted as one card runs it (its `max_fine_iters` fine
iterations, each with its kernel calls: 3 `fwht` and 1 `wv_step` under
HARP), and writes the roofline row
``<out>/pod16x16/program-wv-<method>__cols<N>.json``.
"""

from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.core import WVConfig, WVMethod, pipeline, program_columns, rng
from repro_torch.core.programmer import deploy_params
from repro_torch.launch.mesh import DEFAULT_TIMEOUT, _mesh, init_distributed
from repro_torch.models import init_params

__all__ = ["run_dryrun", "run_real", "main"]


def run_dryrun(method: str, n_columns: int, out_dir: str) -> dict:
    """Count programming `n_columns` columns by `method` on the production
    pod (see the module docstring); returns the row it writes."""
    from repro_torch.launch import dryrun

    mesh_name = "pod16x16"
    mesh = dryrun.MESHES[mesh_name]
    chips = mesh.size()
    if n_columns % chips:
        raise ValueError(f"{n_columns} columns do not split over {chips} devices")
    cfg = WVConfig(method=WVMethod(method))
    targets = torch.empty((n_columns // chips, cfg.n_cells), device="meta")
    key = torch.empty((2,), dtype=torch.uint32, device="meta")
    wc = dryrun.count(lambda k, t: program_columns(k, t, cfg), (key, targets))
    terms = dryrun.terms_of(
        wc, mesh, arch=f"program-wv-{method}", shape=f"cols{n_columns}",
        mesh_name=mesh_name,
        model_flops=2.0 * n_columns * cfg.n_cells * cfg.max_fine_iters,
        arg_bytes=dryrun.device_bytes((key, targets)))
    row = terms.to_json()
    row["status"] = "ok"
    dryrun.write_row(row, out_dir)
    calls = {k: v["calls"] for k, v in wc.kernels.items()}
    print(f"[program-wv {method}] cols={n_columns} ({n_columns // chips} per device) "
          f"flops/job={sum(terms.flops.values()):.3e} bytes/job={terms.hbm_bytes:.3e} "
          f"kernel calls per device {calls} coll={terms.collective_bytes / 2**20:.1f}MiB "
          f"bottleneck={terms.bottleneck}")
    print("  memory:", terms.memory_analysis)
    return row


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
    ap.add_argument("--columns", type=int, default=1 << 22)
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)
    if args.dryrun:
        row = run_dryrun(args.method, args.columns, args.out)
        return f"{row['arch']}__{row['shape']}"
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
