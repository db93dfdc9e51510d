"""Render the roofline table from the dry-run JSONs (`launch.dryrun`,
`launch.program --dryrun`).

    PYTHONPATH=src python -m repro_torch.launch.report [--dir results/dryrun] \
        [--mesh pod16x16]

The reference's columns, over the port's counts: FLOPs and bytes are
counted on the meta device and priced at H100 SXM datasheet rates
(`launch.roofline`); they are not measurements.  "args" and "temp" are
the device's argument bytes and the peak bytes its step's ops keep alive.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.roofline import PEAK_FLOPS

__all__ = ["load_rows", "fmt_row", "HEADER", "main"]


def load_rows(dir_: str, mesh: str) -> list[dict]:
    rows = []
    for path in sorted(glob.glob(os.path.join(dir_, mesh, "*.json"))):
        with open(path) as f:
            rows.append(json.load(f))
    return rows


def fmt_row(r: dict) -> str:
    """One table row.  The counted compute term is shown beside the
    MODEL_FLOPS one (6ND / 2ND at the bf16 rate); the bottleneck is the
    largest term, with the larger of the two compute terms, and
    roofline-frac = model-compute / (dominant term)."""
    ms = lambda s: f"{s * 1e3:9.3f}"  # noqa: E731
    model_comp = r["model_flops"] / (r["chips"] * PEAK_FLOPS)
    comp = max(r["compute_s"], model_comp)
    terms = {
        "compute": comp,
        "memory": r["memory_s"],
        "collective": r["collective_s"],
    }
    dom = max(terms, key=terms.get)
    frac = model_comp / max(max(terms.values()), 1e-30)
    mem = r.get("memory_analysis", {})
    temp_gib = mem.get("temp_size_in_bytes", 0) / 2**30
    arg_gib = mem.get("argument_size_in_bytes", 0) / 2**30
    return (
        f"| {r['arch']} | {r['shape']} | {ms(r['compute_s'])} | {ms(model_comp)} | "
        f"{ms(r['memory_s'])} | {ms(r['collective_s'])} | {dom} | "
        f"{frac:.2f} | {arg_gib:.2f} | {temp_gib:.2f} |"
    )


HEADER = (
    "| arch | shape | counted-comp [ms] | 6ND-comp [ms] | memory [ms] | "
    "collective [ms] | bottleneck | roofline-frac | args GiB/dev | temp GiB/dev |\n"
    "|---|---|---|---|---|---|---|---|---|---|"
)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default="results/dryrun")
    ap.add_argument("--mesh", default="pod16x16")
    args = ap.parse_args(argv)
    rows = load_rows(args.dir, args.mesh)
    print(HEADER)
    for r in rows:
        print(fmt_row(r))
    print(f"\n{len(rows)} cells; mesh={args.mesh}; "
          "terms per formulae in launch/roofline.py (H100 SXM constants)")


if __name__ == "__main__":
    main()
