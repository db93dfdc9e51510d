"""Operations HARP write-and-verify needs, per column, whatever
implements it (priced at the float32 rate, each integer operation
counted as one operation).

Counted per column of N cells (log2 N butterfly stages):
- a threefry2x32 block (two 32-bit words): 2 key adds, the third key
  word (2 xors), 20 rounds of add, rotate (shift, shift, or) and xor
  (100), 5 key injections of 3 adds (15): 119 operations;
- a standard normal from one word: to a float in [0, 1) (3), the affine
  map to (-1, 1) (3), erf^-1 on one branch (log1p, neg, mul, neg,
  compare, select, sub or sqrt + sub, 8 multiply-adds = 16, mul: 25),
  the sqrt(2) scale (1): 32 operations, and its sigma (mul, and add
  where it is 1 + sigma z);
- once a column: its key (fold_in: 1 block), the 3-way split (3), d2d
  (N normals), the open-loop coarse pulse count against the nominal
  curve's 11 points (5 operations each), the coarse write (split: 2
  blocks, 2N normals, 20 operations a cell), and the target's Hadamard
  code (N log2 N adds, 8 operations a value for the converter);
- each fine iteration the column ran: its keys (fold_in 1, split 2,
  the read key's split 2, the write key's split 2 blocks), N read-noise
  normals, the Hadamard encode and the decode (2 N log2 N adds), the
  noise add (N), the compare-only converter (4 a cell), 2N write-noise
  normals, and the ternary cell update (30 a cell).
The per-sweep common-mode draw is left out: its sigma is 0 here, so a
bit-exact implementation need not draw it.
"""

from __future__ import annotations

import math

BLOCK = 2 + 2 + 20 * 5 + 5 * 3
NORMAL = 3 + 3 + 25 + 1


def _normals(k: int, affine: int) -> float:
    return math.ceil(k / 2) * BLOCK + k * (NORMAL + affine)


def per_column_once(n: int) -> float:
    stages = math.log2(n)
    return (4 * BLOCK + _normals(n, 2) + n * 11 * 5
            + 2 * BLOCK + _normals(n, 2) + _normals(n, 1) + 20 * n
            + n * stages + 8 * n)


def per_column_iteration(n: int) -> float:
    stages = math.log2(n)
    return (7 * BLOCK + _normals(n, 1) + 2 * n * stages + n + 4 * n
            + _normals(n, 2) + _normals(n, 1) + 30 * n)


def deploy_ops(columns: int, mean_iterations: float, n: int = 32) -> float:
    """Operations of one deploy of `columns` columns whose fine loop ran
    `mean_iterations` sweeps a column on average."""
    return columns * (per_column_once(n) + mean_iterations * per_column_iteration(n))
