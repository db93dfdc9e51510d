"""Production-mesh dry run: count every (arch x shape) cell's step on the
``meta`` device, show how it shards and whether it fits, and write its
roofline row.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \
        [--arch olmoe-1b-7b ...] [--shape train_4k ...] \
        [--multi-pod | --both] [--skip-existing] [--out results/dryrun]

The reference lowers and compiles each cell's step for 512 forced XLA
host devices.  Its H100 counterpart needs no card and allocates no data.
Per cell it

  1. builds the train, prefill or decode step of `configs.get_config`
     at the cell's `configs.SHAPES` entry, with its per-arch `GRAD_ACCUM`;
  2. makes the step's arguments on the meta device (`init_params` /
     `init_train_state(device="meta")`, `configs.input_specs`) and stores
     them as the port's mesh paths store them on the production mesh,
     given as a `launch.mesh.AbstractMesh` (16 x 16, or 2 x 16 x 16 with
     --multi-pod): this process plays rank 0, each rank's block is rank
     0's, and the collectives count their bytes (`launch.shardings`'
     specs; the decode cache by rows, see `_cache_rows_sharding`);
  3. runs the step under `launch.roofline.WorkCounter`: FLOPs by dtype
     class, bytes, collective bytes per op type and mesh axis, and the
     peak bytes its ops keep alive;
  4. reports memory fit in place of XLA's `memory_analysis`: the
     device's argument bytes (its blocks of the params, optimizer state,
     inputs and cache) and the trace's peak, against the card's 80 GB;
  5. writes the roofline row (H100 SXM constants) to
     <out>/<mesh>/<arch>__<shape>.json.

A path that reads a device value on the host raises on the meta device:
its cell fails with that error, and the run returns 1.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch import pytree
from repro_torch.configs import SHAPES, get_config, input_specs, runnable_cells
from repro_torch.configs.registry import ShapeSpec, materialize_inputs
from repro_torch.distributed.sharding import NamedSharding, P, local, shard_tree
from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.launch.shardings import batch_axes, shard_batch, state_sharding
from repro_torch.models import ModelConfig, init_params
from repro_torch.optim import AdamWConfig
from repro_torch.serving import make_decode_step, make_prefill_step
from repro_torch.training import init_train_state, make_train_step

__all__ = ["GRAD_ACCUM", "MESHES", "build_step", "build_lowerable", "run_cell",
           "main"]

# Per-arch gradient-accumulation factors for train_4k (the reference's):
# big-activation stacks split the 256-sequence global batch into
# microbatches so the per-device working set fits.
GRAD_ACCUM = {
    "qwen3-moe-235b-a22b": 8,
    "llama-3.2-vision-11b": 8,
    "hymba-1.5b": 4,
    "musicgen-medium": 2,
}

# The reference's production meshes.
MESHES = {
    "pod16x16": AbstractMesh((16, 16), ("data", "model")),
    "multipod2x16x16": AbstractMesh((2, 16, 16), ("pod", "data", "model")),
}


def _cache_rows_sharding(mesh, cache, global_batch: int):
    """The decode cache split by batch rows over the ("pod", "data")
    prefix that divides the batch, every other axis whole: the layout
    `models.decoding.decode_step` runs, each rank stepping its rows.  The
    reference's `cache_sharding` also splits the sequence (or the
    recurrent state's width) over "model", which the port's decode does
    not run: attention there reads the rank's whole cache."""
    ba = batch_axes(mesh, global_batch)
    out = []
    for name, leaf in pytree.leaves_with_path(cache):
        spec = [None] * leaf.ndim
        spec[0 if "pos" in name else 1] = ba
        out.append(NamedSharding(mesh, P(*spec)))
    return pytree.unflatten(cache, out)


def build_step(cfg: ModelConfig, spec: ShapeSpec, mesh=None, device="meta",
               grad_accum: int = 1):
    """(step, args): `spec`'s train, prefill or decode step of `cfg` and
    its arguments, on `device` (meta: shapes only; otherwise random
    values from seed 0).  With `mesh`, the arguments are stored on it and
    the step runs its mesh path."""
    if device == "meta":
        inputs = input_specs(cfg, spec)
    else:
        inputs = materialize_inputs(cfg, spec, device=device)
    batch = inputs["batch"]
    if mesh is not None:
        batch = shard_batch(mesh, batch, spec.global_batch)
    if spec.kind == "train":
        opt_cfg = AdamWConfig(state_dtype=cfg.opt_state_dtype)
        state = init_train_state(0, cfg, opt_cfg, device=device)
        if mesh is not None:
            state = shard_tree(state, state_sharding(mesh, state, cfg))
        return make_train_step(cfg, opt_cfg, mesh, grad_accum=grad_accum), (state, batch)
    params = init_params(0, cfg, device=device)
    if mesh is not None:
        params = shard_tree(params, state_sharding(mesh, params, cfg))
    if spec.kind == "prefill":
        return make_prefill_step(cfg, mesh, max_len=spec.seq_len), (params, batch)
    cache = inputs["cache"]
    if mesh is not None:
        cache = shard_tree(cache, _cache_rows_sharding(mesh, cache, spec.global_batch))
    return make_decode_step(cfg, mesh), (params, cache, batch)


def build_lowerable(arch: str, shape: str, mesh, grad_accum: int | None = None):
    """The reference's name: (step, meta arguments, cfg, spec) of a cell
    on `mesh`, ready to run under the counter."""
    cfg = get_config(arch)
    spec = SHAPES[shape]
    if grad_accum is None:
        grad_accum = GRAD_ACCUM.get(arch, 1) if spec.kind == "train" else 1
    fn, args = build_step(cfg, spec, mesh, "meta", grad_accum)
    return fn, args, cfg, spec


def device_bytes(tree) -> int:
    """Bytes this device holds of a tree: its block of each stored shard."""
    return sum(local(x).numel() * local(x).element_size() for x in pytree.leaves(tree))


def count(fn, args) -> rf.WorkCounter:
    """Run `fn(*args)` under a fresh counter; returns the counter."""
    with torch.no_grad(), rf.WorkCounter() as wc:
        fn(*args)
    return wc


def terms_of(wc: rf.WorkCounter, mesh, *, arch: str, shape: str, mesh_name: str,
             model_flops: float, arg_bytes: int) -> rf.RooflineTerms:
    """The roofline row of one device's counts on `mesh` (whole-job FLOPs
    and bytes: the device's times the chips)."""
    chips = mesh.size()
    mem = rf.summarize_memory_analysis({
        "argument_size_in_bytes": arg_bytes,
        "temp_size_in_bytes": wc.peak_bytes,
        "peak_memory_in_bytes": arg_bytes + wc.peak_bytes,
    })
    mem["fits"] = mem["peak_memory_in_bytes"] <= rf.HBM_BYTES
    detail = {
        "bytes_by_type": {k: v["bytes"] for k, v in wc.collectives.items()},
        "counts_by_type": {k: v["count"] for k, v in wc.collectives.items()},
        "bytes_by_axis": dict(wc.collective_axes),
        "total_bytes": wc.collective_bytes,
        "kernels": {k: dict(v) for k, v in wc.kernels.items()},
    }
    return rf.RooflineTerms(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops={c: f * chips for c, f in wc.flops.items()},
        hbm_bytes=wc.bytes * chips,
        collective_bytes=wc.collective_bytes,
        model_flops=model_flops,
        per_device_bytes=wc.bytes,
        link_bw={a: rf.link_bw(mesh, a) for a in mesh.mesh_dim_names},
        collective_detail=detail,
        memory_analysis=mem,
    ).finalize()


def write_row(row: dict, out_dir: str) -> str:
    os.makedirs(os.path.join(out_dir, row["mesh"]), exist_ok=True)
    path = os.path.join(out_dir, row["mesh"], f"{row['arch']}__{row['shape']}.json")
    with open(path, "w") as f:
        json.dump(row, f, indent=1)
    return path


def run_cell(arch: str, shape: str, mesh, mesh_name: str, out_dir: str) -> dict:
    t0 = time.time()
    fn, args, cfg, spec = build_lowerable(arch, shape, mesh)
    arg_bytes = device_bytes(args)
    wc = count(fn, args)
    del fn, args
    t_count = time.time() - t0
    tokens = spec.global_batch * (spec.seq_len if spec.kind != "decode" else 1)
    terms = terms_of(wc, mesh, arch=arch, shape=shape, mesh_name=mesh_name,
                     model_flops=rf.model_flops(cfg, spec, tokens), arg_bytes=arg_bytes)
    row = terms.to_json()
    row["count_seconds"] = t_count
    row["status"] = "ok"
    write_row(row, out_dir)
    mem = terms.memory_analysis
    flops = ", ".join(f"{c} {f:.3e}" for c, f in terms.flops.items())
    print(f"[{mesh_name}] {arch} x {shape}: counted in {t_count:.0f}s | "
          f"mem/device args={mem['argument_size_in_bytes'] / 2**30:.2f}GiB "
          f"peak temp={mem['temp_size_in_bytes'] / 2**30:.2f}GiB "
          f"fits={mem['fits']} | flops/job {flops} | bytes/job={terms.hbm_bytes:.3e} | "
          f"coll={terms.collective_bytes / 2**20:.1f}MiB | bottleneck={terms.bottleneck}",
          flush=True)
    return row


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", nargs="*", default=None)
    ap.add_argument("--shape", nargs="*", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)

    meshes = []
    if args.both or not args.multi_pod:
        meshes.append("pod16x16")
    if args.both or args.multi_pod:
        meshes.append("multipod2x16x16")

    cells = runnable_cells()
    if args.arch:
        cells = [(a, s) for a, s in cells if a in args.arch]
    if args.shape:
        cells = [(a, s) for a, s in cells if s in args.shape]

    failures = []
    for mesh_name in meshes:
        for arch, shape in cells:
            if args.skip_existing and os.path.exists(
                    os.path.join(args.out, mesh_name, f"{arch}__{shape}.json")):
                continue
            try:
                run_cell(arch, shape, MESHES[mesh_name], mesh_name, args.out)
            except Exception as e:  # noqa: BLE001 - report and continue
                failures.append((mesh_name, arch, shape, repr(e)))
                print(f"[{mesh_name}] {arch} x {shape}: FAILED {e!r}", flush=True)
                traceback.print_exc()
    print(f"\ndone: {len(cells) * len(meshes) - len(failures)} ok, "
          f"{len(failures)} failed")
    for f in failures:
        print("  FAIL:", f)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
