"""Batched serving engine: prefill and decode steps and a generate loop.

`make_prefill_step` / `make_decode_step` build the step functions;
`ServeEngine` drives them for batched generation: greedy, or sampled by
`rng.categorical` when `temperature > 0` (the reference samples the raw
logits; the temperature only switches sampling on).  The steps are plain
calls, with no host sync, so `generate` syncs only to test `eos_id`.

With a `CIMExecutor` every prefill and decode access pulls fresh params
from it: deployed matmul leaves arrive as `CIMWeight` tiles computed in
the arrays by `models.layers.matmul`, read-noise keys advance per
access, and the executor accounts read traffic and token costs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from repro_torch import obs
from repro_torch.core import rng
from repro_torch.models import ModelConfig, decode_step, prefill, prefill_chunk

__all__ = ["make_prefill_step", "make_prefill_chunk_step", "make_decode_step",
           "ServeEngine"]


def make_prefill_step(cfg: ModelConfig, max_len: int | None = None):
    def prefill_step(params, batch: dict):
        return prefill(params, batch, cfg, max_len=max_len)

    return prefill_step


def make_prefill_chunk_step(cfg: ModelConfig, *, start: int, final: bool,
                            park_pos: int | None = None):
    """Step function for ONE chunk of a chunked prefill at offset `start`
    (one per (start, final) pair); the slot and the true length are
    arguments, so any request in any slot reuses it."""

    def chunk_step(params, cache, tokens, true_len: int, slot: int):
        return prefill_chunk(
            params, cache, tokens, cfg, start=start, slot=slot,
            true_len=true_len if final else None,
            park_pos=park_pos if start == 0 else None,
        )

    return chunk_step


def make_decode_step(cfg: ModelConfig, sample: bool = False):
    def step(params, cache, batch: dict, key=None):
        logits, cache = decode_step(params, cache, batch, cfg)
        last = logits[:, -1]
        if sample and key is not None:
            tok = rng.categorical(key, last.to(torch.float32), axis=-1)
        else:
            tok = torch.argmax(last, dim=-1)
        return tok.to(torch.int32), logits, cache

    return step


@dataclasses.dataclass
class ServeEngine:
    cfg: ModelConfig
    params: Any = None
    temperature: float = 0.0
    # Analog serving (`repro_torch.cim.CIMExecutor`): when set, every
    # access pulls the executor's params (see `access_params`).
    executor: Any = None

    def __post_init__(self):
        if self.executor is not None and self.params is None:
            self.params = self.executor.params()
        self._sample = self.temperature > 0
        self._prefill = make_prefill_step(self.cfg)
        self._decode = make_decode_step(self.cfg, sample=self._sample)

    def access_params(self, n_tokens: int) -> Any:
        """Params for one engine access of `n_tokens` batch tokens: an
        analog deployment ticks its executor here (read traffic and
        fresh noise sub-streams), and a hot swap lands on the next
        access."""
        if self.executor is not None:
            self.params = self.executor.tick(n_tokens)
        return self.params

    def swap_params(self, params: Any) -> None:
        """Hot-swap served weights (e.g. after an RRAM refresh); the next
        step serves them."""
        self.params = params

    def generate(self, tokens: torch.Tensor, max_new: int, key=None,
                 eos_id: int | None = None) -> torch.Tensor:
        """tokens: (B, S) prompt; returns (B, max_new) generated ids.

        The cache holds the prompt (the reference's fixed-batch engine
        prefills with ``max_len = S``).  The decode key is split every
        step as in the reference, but only when sampling reads it.  The
        call runs in a ``serve.generate`` span, and its host wall time
        per generated token goes to the ``serve.generate_us_per_token``
        digest.
        """
        b, s = tokens.shape
        if key is None:
            key = rng.PRNGKey(0, device=tokens.device)
        t0 = time.perf_counter()
        with obs.span("serve.generate", cat="serve", batch=b, prompt_len=s,
                      max_new=max_new) as sp:
            last, cache = self._prefill(self.access_params(b * s), {"tokens": tokens})
            cur = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
            outs = [cur]
            done = torch.zeros((b,), dtype=torch.bool, device=tokens.device)
            sub = None
            for _ in range(max_new - 1):
                if self._sample:
                    key, sub = rng.split(key)
                tok, _, cache = self._decode(
                    self.access_params(b), cache, {"tokens": cur}, sub)
                cur = tok[:, None]
                if eos_id is not None:
                    done = done | (tok == eos_id)
                    if bool(torch.all(done)):
                        outs.append(cur)
                        break
                outs.append(cur)
            out = torch.cat(outs, dim=1)
            sp["generated"] = int(out.shape[0] * out.shape[1])
        # Host wall clock per generated token (the reference's digest).
        obs.digests.observe(
            "serve.generate_us_per_token",
            (time.perf_counter() - t0) * 1e6 / max(int(out.shape[0] * out.shape[1]), 1),
            lo=0.0, hi=1e6, n_buckets=128)
        return out
