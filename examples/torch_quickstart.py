"""Quickstart in the PyTorch port: program an RRAM array with all four
WV methods (`examples/quickstart.py` in PyTorch).

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Programs 256 columns of 32 cells (the paper's default array) from HRS to
random 3-bit targets under severe read noise (0.7 LSB) and prints the
Fig.-9-style comparison: mapping error, iterations, latency, energy.
`--device` (default ``cuda``) picks where the columns are programmed.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core import WVConfig, WVMethod, program_columns, rng


def table(device) -> dict[str, dict[str, float]]:
    """Per method: mean rms error (LSB), iterations, latency (us) and
    energy (nJ) per column, from the same keys as the reference."""
    tkey, pkey = rng.split(rng.PRNGKey(0, device=device))
    targets = rng.randint(tkey, (256, 32), 0, 8).to(torch.float32)
    rows = {}
    for method in WVMethod:
        _, stats = program_columns(pkey, targets, WVConfig(method=method), device=device)
        rows[method.value] = dict(
            rms=float(torch.mean(stats.rms_error_lsb)),
            iters=float(torch.mean(stats.iterations)),
            lat_us=float(torch.mean(stats.latency_ns)) / 1e3,
            e_nj=float(torch.mean(stats.energy_pj)) / 1e3,
        )
    return rows


def main(argv: list[str] | None = None) -> dict[str, dict[str, float]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = table(args.device)
    print(f"{'method':8s} {'rms[LSB]':>9s} {'iters':>6s} {'lat[us]':>8s} {'E[nJ]':>7s}")
    for method, r in rows.items():
        print(f"{method:8s} {r['rms']:9.3f} {r['iters']:6.1f} "
              f"{r['lat_us']:8.1f} {r['e_nj']:7.2f}")
    print("\nHadamard-domain verification (hd_pv/harp) should show the")
    print("lowest error/iterations (hd_pv) and the lowest energy (harp).")
    return rows


if __name__ == "__main__":
    main()
