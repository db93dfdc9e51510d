"""Traffic of kind "deploy": a closed loop of whole HARP deploys of the
cell's model, back to back, each with a fresh key from the seed.

Set-up makes the weights and deploys the largest leaf once (the same
path at a full bucket and a remainder bucket), which builds the kernels
and fills the allocator.  The window starts no deploy that, at the mean
time of the earlier ones, would end past `--seconds`, and always runs
one.  Each deploy ends in the program's own host fetch of its report.

Correctness: for every deploy of the window, the reference programs a
sample of columns drawn from the seed (the first and last of each leaf
among them) and every column of the smallest leaves, from the same
weights and key, and the run compares the conductances cell by cell and
those leaves' reported mean iterations and rms cell error.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from reference import rng as ref_rng
from reference import wv as ref_wv
from work import kernels as kw
from work import wv_ops

from . import weights

N = ref_wv.HARP["n_cells"]
# |g - g_ref| above this counts a cell as different (LSB).
CELL_TOL = 1e-3


def deploy_key(seed: int, i: int, device) -> torch.Tensor:
    return ref_rng.fold_in(ref_rng.PRNGKey(seed, device), i)


def _columns(leaf: torch.Tensor) -> int:
    k = math.prod(leaf.shape[:-1])
    return -(-k // N) * leaf.shape[-1] * 2 * ref_wv.SLICES


def setup(cell: dict, seed: int, device) -> dict:
    from repro_torch.core import WVConfig, WVMethod
    from repro_torch.core.programmer import deploy_arrays

    traffic = cell["traffic"]
    cfg = weights.model_config(cell["config"])
    params = weights.make_params(cfg, seed, device)
    wv = WVConfig(method=WVMethod(traffic["method"]))
    leaves = ref_wv.eligible_leaves(params)
    sizes = [(name, _columns(t)) for name, t in leaves]
    big = max(leaves, key=lambda nt: nt[1].numel())
    deploy_arrays(deploy_key(seed, 1 << 30, device), {"warm": big[1]}, wv,
                  batched=True, min_bucket=traffic["min_bucket"],
                  max_bucket=traffic["max_bucket"], device=device)
    # The sample: uids drawn from the seed plus each leaf's first and
    # last column; and the smallest leaves, checked whole.
    total = sum(c for _, c in sizes)
    gen = np.random.default_rng(seed)
    pick = set(gen.choice(total, size=min(traffic["check_columns"], total),
                          replace=False).tolist())
    base = 0
    for name, c in sizes:
        pick |= {base, base + c - 1}
        base += c
    small = sorted(sizes, key=lambda nc: nc[1])[:traffic["check_whole_leaves"]]
    whole = [name for name, _ in small]
    return dict(cell=cell, cfg=cfg, params=params, wv=wv, sizes=sizes, seed=seed,
                device=device, sample=np.array(sorted(pick), np.int64), whole=whole)


def _sampled(deployed, sizes, sample) -> torch.Tensor:
    parts, base = [], 0
    for name, c in sizes:
        idx = sample[(sample >= base) & (sample < base + c)] - base
        if idx.size:
            g = deployed.arrays[name].g
            parts.append(g[torch.as_tensor(idx, device=g.device)])
        base += c
    return torch.cat(parts)


def window(st: dict, seconds: float, tracer) -> dict:
    from repro_torch import kernels
    from repro_torch.core import pipeline
    from repro_torch.core.programmer import deploy_arrays

    traffic = st["cell"]["traffic"]
    deploys = []
    t0 = time.perf_counter()
    i = 0
    while True:
        spent = [d["end"] - d["start"] for d in deploys]
        if deploys and time.perf_counter() - t0 + sum(spent) / len(spent) > seconds:
            break
        key = deploy_key(st["seed"], i, st["device"])
        if i == 0:
            tracer.start()
        syncs = pipeline.host_sync_count()
        launches = kernels.launch_counts()
        with tracer.span("bench.deploy"):
            t_s = time.perf_counter()
            dep, rep = deploy_arrays(key, st["params"], st["wv"], batched=True,
                                     min_bucket=traffic["min_bucket"],
                                     max_bucket=traffic["max_bucket"], device=st["device"])
            t_e = time.perf_counter()
        traced = tracer.active
        tracer.stop()
        deploys.append(dict(
            start=t_s, end=t_e, cells=rep.num_cells, columns=rep.num_columns,
            mean_iterations=rep.mean_iterations,
            syncs=pipeline.host_sync_count() - syncs, traced=traced,
            launches=kernels.launches_since(launches),
            leaves={n: dict(rep.leaves[n]) for n in st["whole"]},
            sample_g=_sampled(dep, st["sizes"], st["sample"]),
        ))
        del dep, rep
        i += 1
    return dict(deploys=deploys)


def end_to_end(rec: dict) -> dict:
    d = rec["deploys"]
    cells = sum(x["cells"] for x in d)
    return {"deploy_cells_per_s": cells / (d[-1]["end"] - d[0]["start"])}


def layer_context(st: dict, rec: dict, trace: dict | None) -> dict:
    """What the per-layer readers read: the deploys, the work of the
    kernel calls the traced deploy launched (each at its bucket's
    columns), and the window's WV operations (the sweeps each column
    needed)."""
    t = st["cell"]["traffic"]
    d = rec["deploys"]
    work = {}
    for x in d:
        if x["traced"]:
            buckets = kw.wv_buckets(x["columns"], t["min_bucket"], t["max_bucket"])
            for name, fn in (("fwht", kw.fwht), ("wv_step", kw.wv_step)):
                w = kw.wv_calls(fn, x["launches"].get(name, 0), buckets, N)
                if w:
                    work[name] = w
    ops = sum(wv_ops.deploy_ops(x["columns"], x["mean_iterations"], N) for x in d)
    return dict(kind="deploy", deploys=d, trace=trace, kernel_work=work,
                wv_ops=ops, window_s=d[-1]["end"] - d[0]["start"])


def release(st: dict, rec: dict) -> None:
    """Nothing to free: the window drops each deploy's state once it
    has taken the sampled answers the check reads."""


def reference_answers(st: dict, key, dtype=torch.float32) -> dict:
    """The reference's conductances of the sample and its statistics of
    the whole small leaves, for one deploy key."""
    if "ref_cols" not in st:
        st["ref_cols"] = ref_wv.leaf_columns(st["params"])
    cols = st["ref_cols"]
    targets = torch.cat([c for _, _, c, _, _ in cols])
    sample = torch.as_tensor(st["sample"], device=targets.device)
    parts = [sample]
    for name, _, c, _, base in cols:
        if name in st["whole"]:
            parts.append(base + torch.arange(c.shape[0], device=c.device))
    uids = torch.cat(parts)
    g_all, it_all = ref_wv.program(key, targets[uids], uids, dtype=dtype)
    g = g_all[:sample.shape[0]]
    leaves, off = {}, sample.shape[0]
    for name, _, c, _, base in cols:
        if name in st["whole"]:
            n = c.shape[0]
            gl, it = g_all[off:off + n], it_all[off:off + n]
            off += n
            rms = torch.sqrt(torch.mean((gl - c) ** 2, dim=-1))
            leaves[name] = dict(mean_iterations=float(torch.mean(it)),
                                rms_cell_error_lsb=float(torch.sqrt(torch.mean(rms ** 2))))
    return dict(g=g, leaves=leaves)


def compare(prog_g, prog_leaves, ref: dict) -> dict:
    """The numbers the check holds to its limits."""
    diff = torch.abs(prog_g.to(torch.float32) - ref["g"])
    it_gap = max(abs(prog_leaves[n]["mean_iterations"] - v["mean_iterations"])
                 for n, v in ref["leaves"].items())
    rms_gap = max(abs(prog_leaves[n]["rms_cell_error_lsb"] - v["rms_cell_error_lsb"])
                  / v["rms_cell_error_lsb"] for n, v in ref["leaves"].items())
    return dict(cell_mismatch_share=float(torch.mean((diff > CELL_TOL).to(torch.float32))),
                leaf_iterations_gap=it_gap, leaf_rms_rel_gap=rms_gap)


def check(st: dict, rec: dict, control: bool = False) -> dict:
    """Every deploy of the window against the reference: the worst of
    each number over the deploys.  With `control`, the numbers of the
    reference in bfloat16 put in the program's place."""
    worst: dict = {}
    for i, x in enumerate(rec["deploys"]):
        key = deploy_key(st["seed"], i, st["device"])
        ref = reference_answers(st, key)
        if control:
            low = reference_answers(st, key, dtype=torch.bfloat16)
            nums = compare(low["g"], low["leaves"], ref)
        else:
            nums = compare(x["sample_g"], x["leaves"], ref)
        for k, v in nums.items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


def attempted(rec: dict) -> int:
    return len(rec["deploys"])

