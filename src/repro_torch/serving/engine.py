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

With a `mesh` (a `DeviceMesh`) the steps run on it (`models.decoding`):
the engine lays each batch out over "data" as a decode cache is laid
out (`launch.shardings.decode_vec_sharding`), every rank steps its rows,
and each token comes from the gathered logits, so every rank takes the
same decisions and the tokens are those of the unsharded engine.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from repro_torch import obs
from repro_torch.core import rng
from repro_torch.distributed.sharding import gather
from repro_torch.models import ModelConfig, decode_step, prefill, prefill_chunk

__all__ = ["make_prefill_step", "make_prefill_chunk_step", "make_decode_step",
           "ServeEngine"]


def make_prefill_step(cfg: ModelConfig, mesh=None, max_len: int | None = None):
    def prefill_step(params, batch: dict):
        return prefill(params, batch, cfg, mesh, max_len=max_len)

    return prefill_step


def make_prefill_chunk_step(cfg: ModelConfig, mesh=None, *, start: int, final: bool,
                            park_pos: int | None = None):
    """Step function for ONE chunk of a chunked prefill at offset `start`
    (one per (start, final) pair); the slot and the true length are
    arguments, so any request in any slot reuses it."""

    def chunk_step(params, cache, tokens, true_len: int, slot: int):
        return prefill_chunk(
            params, cache, tokens, cfg, mesh, start=start, slot=slot,
            true_len=true_len if final else None,
            park_pos=park_pos if start == 0 else None,
        )

    return chunk_step


def make_decode_step(cfg: ModelConfig, mesh=None, sample: bool = False):
    """The step returns (tokens, logits, cache); on a mesh the tokens are
    taken from the logits gathered whole (every rank the same tokens)."""

    def step(params, cache, batch: dict, key=None):
        logits, cache = decode_step(params, cache, batch, cfg, mesh)
        last = gather(logits)[:, -1]
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
    # Device mesh the steps run on (see the module docstring).
    mesh: Any = None
    temperature: float = 0.0
    # Analog serving (`repro_torch.cim.CIMExecutor`): when set, every
    # access pulls the executor's params (see `access_params`).
    executor: Any = None

    def __post_init__(self):
        if self.executor is not None and self.params is None:
            self.params = self.executor.params()
        self._sample = self.temperature > 0
        self._prefill = make_prefill_step(self.cfg, self.mesh)
        self._decode = make_decode_step(self.cfg, self.mesh, sample=self._sample)

    def _rows(self, batch: dict) -> dict:
        """`batch` laid out over the mesh's "data" rows (as it is without
        a mesh)."""
        if self.mesh is None:
            return batch
        from repro_torch.distributed.sharding import NamedSharding, P
        from repro_torch.launch.shardings import decode_vec_sharding

        out = {}
        for k, v in batch.items():
            rows = decode_vec_sharding(self.mesh, v.shape[0]).spec
            out[k] = NamedSharding(self.mesh, P(*rows, *[None] * (v.ndim - 1))).shard(v)
        return out

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
            last, cache = self._prefill(self.access_params(b * s),
                                        self._rows({"tokens": tokens}))
            cur = torch.argmax(gather(last), dim=-1).to(torch.int32)[:, None]
            outs = [cur]
            done = torch.zeros((b,), dtype=torch.bool, device=tokens.device)
            sub = None
            for _ in range(max_new - 1):
                if self._sample:
                    key, sub = rng.split(key)
                tok, _, cache = self._decode(
                    self.access_params(b), cache, self._rows({"tokens": cur}), sub)
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
