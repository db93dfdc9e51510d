"""Deterministic synthetic LM data (the reference's `data/synthetic.py`).

Sequences are walks of a fixed random bigram chain: each token has
`branching` successors from a table drawn by `np.random.RandomState(seed
^ 0x5EED)`, and a step's batch is a function of (seed, step) alone — its
first tokens and successor choices come from `rng.randint` on
``fold_in(PRNGKey(seed), step)``.  So the port's batches are bitwise the
reference's (under the legacy threefry layout), on any device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, NamedTuple

import numpy as np
import torch

from repro_torch.core import rng

__all__ = ["Batch", "SyntheticLM"]


class Batch(NamedTuple):
    tokens: torch.Tensor   # (B, S) int32 inputs
    targets: torch.Tensor  # (B, S) int32 next-token labels
    mask: torch.Tensor     # (B, S) float32 loss weights


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branching: int = 16  # successors per token: entropy ~= log2(branching) bits
    device: str = "cuda"

    def _succ_table(self) -> np.ndarray:
        """(vocab, branching) fixed successor table defining the bigram chain."""
        state = np.random.RandomState(self.seed ^ 0x5EED)
        return state.randint(
            0, self.vocab_size, size=(self.vocab_size, self.branching)
        ).astype(np.int32)

    def global_batch_at(self, step: int) -> Batch:
        """The full global batch for `step`, on `device`."""
        key = rng.fold_in(rng.PRNGKey(self.seed, device=self.device), step)
        k0, k1 = rng.split(key)
        first = rng.randint(k0, (self.global_batch,), 0, self.vocab_size)
        choices = rng.randint(k1, (self.global_batch, self.seq_len), 0,
                              self.branching).to(torch.int64)
        table = torch.from_numpy(
            self._succ_table().astype(np.int64).reshape(-1)).to(self.device)
        tok = first.to(torch.int64)
        seq = []
        for t in range(self.seq_len):  # the reference's lax.scan walk
            tok = table[tok * self.branching + choices[:, t]]
            seq.append(tok)
        seq = torch.stack(seq, dim=1).to(torch.int32)            # (B, S)
        tokens = torch.cat([first[:, None], seq[:, :-1]], dim=1)
        return Batch(tokens=tokens, targets=seq,
                     mask=torch.ones(seq.shape, dtype=torch.float32,
                                     device=seq.device))

    def host_batch_at(self, step: int, host_id: int, num_hosts: int) -> Batch:
        """This host's slice of the step's global batch."""
        if self.global_batch % num_hosts:
            raise ValueError(f"global batch {self.global_batch} does not split "
                             f"over {num_hosts} hosts")
        per = self.global_batch // num_hosts
        full = self.global_batch_at(step)
        sl = slice(host_id * per, (host_id + 1) * per)
        return Batch(full.tokens[sl], full.targets[sl], full.mask[sl])

    def iterate(self, start_step: int = 0) -> Iterator[Batch]:
        step = start_step
        while True:
            yield self.global_batch_at(step)
            step += 1
