"""Continuous-batching request scheduler for (analog) serving.

`ServeEngine.generate` runs one fixed batch to completion; under a real
arrival stream that leaves decode slots idle whenever sequences finish
at different times.  `ContinuousScheduler` keeps a fixed-shape decode
batch of `n_slots` busy against a request queue:

* **Admission**: arriving requests claim free slots; the prompt is
  right-padded to a power-of-two bucket and prefilled into the shared
  pre-allocated cache at the slot index (`models.decoding.prefill` with
  ``true_len`` + `write_cache_slot`).  One step function per bucket
  serves every admission, any slot, any neighbours.  The admission
  ORDER among ready requests is `admission_policy`: "fifo" (arrival),
  "spf" (shortest prompt first) or "edf" (earliest TTFT deadline first,
  `Request.deadline`); `select_next` is the pure order.
* **Chunked prefill**: with `prefill_chunk_tokens=C`, prompts whose
  bucket exceeds C prefill in C-token chunks interleaved between decode
  steps (`models.decoding.prefill_chunk`).  The first chunk parks the
  slot's cache position at `max_len` (interleaved decode writes for that
  row fall outside the cache and are dropped); the final chunk, the one
  holding the last real token, restores ``pos`` and samples the first
  token from the same per-request sub-stream as whole-prompt admission.
* **Clock accounting**: `prefill_tokens_per_step` prices prefill in
  proportion to the physical tokens driven; the constant
  `prefill_cost_steps` is the default.
* **Decode**: every step runs the whole batch through ONE step function
  of fixed shape; per-slot positions, stop bookkeeping and sampling
  keys keep batch composition out of the step's shapes.
  `trace_counts` counts the step functions built (one per admit bucket,
  one per chunk (start, final) pair, one decode); `warmup()` builds them
  all, and they stay flat after it.
* **Per-request RNG**: token i of request `rid` is sampled with
  ``fold_in(fold_in(master_key, rid), i)``, so a request's tokens are
  bit-identical whether it rides alone or in a full batch, in any slot.
* **One host sync per decode step**: the step's tokens, its device
  metrics (`decode_active_slots`, `decode_greedy_agree`) and the
  occupancy digest's counts reach the host in one copy (`host_syncs`).
  On the card the step's dispatch runs under
  `torch.cuda.set_sync_debug_mode("error")`, so a hidden sync anywhere
  on the path (the executor tick, the analog matmuls, the cache writes)
  raises instead of serializing the loop.
* **Analog path**: params are pulled through `ServeEngine.access_params`
  on every access, so a `CIMExecutor` ticks real read traffic per
  scheduled step (prefill ticks the padded bucket or chunk length,
  decode the whole batch).  An optional `maintenance_fn` (e.g. a
  `LifetimeSimulator` epoch with `traffic_fn=executor.drain_reads`)
  runs between decode steps without touching the batch state.
* **Telemetry**: each admission, prefill chunk, decode step and
  maintenance call is an `obs` span whose ``launches`` arg holds the
  kernels it launched (`kernels.launches_since`), host-side counts only.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import kernels, obs
from repro_torch.cim import token_stream_ids
from repro_torch.core import rng
from repro_torch.models import decode_step, init_cache, prefill, write_cache_slot

from .engine import make_prefill_chunk_step

__all__ = [
    "ADMISSION_POLICIES",
    "Request",
    "RequestRecord",
    "ContinuousScheduler",
    "admission_key",
    "select_next",
    "poisson_requests",
]


@dataclasses.dataclass
class Request:
    """One serving request: prompt tokens + generation budget."""

    rid: int                        # unique id (RNG sub-stream + records key)
    prompt: Any                     # 1-D int token ids
    max_new: int                    # generation budget (includes first token)
    arrival: float = 0.0            # arrival time, decode-step units
    eos_id: int | None = None       # per-request stop token
    deadline: float | None = None   # absolute TTFT deadline (step clock)


ADMISSION_POLICIES = ("fifo", "spf", "edf")


def admission_key(policy: str, req: Request):
    """Total order over ready requests for one admission decision:
    "fifo" by arrival, "spf" by prompt length, "edf" by deadline
    (deadline-less requests last).  Ties break on (arrival, rid), so
    every policy is a strict total order."""
    if policy == "fifo":
        return (req.arrival, req.rid)
    if policy == "spf":
        return (len(req.prompt), req.arrival, req.rid)
    if policy == "edf":
        d = req.deadline if req.deadline is not None else math.inf
        return (d, req.arrival, req.rid)
    raise ValueError(
        f"unknown admission policy {policy!r}; known: {ADMISSION_POLICIES}"
    )


def select_next(ready: list[Request], policy: str) -> Request:
    """The request `policy` admits next from the ready set (pure)."""
    return min(ready, key=lambda r: admission_key(policy, r))


@dataclasses.dataclass
class RequestRecord:
    """Lifecycle and latency accounting for one served request.

    All times are in decode-step units on the scheduler's clock.  A
    prefill occupies the engine for its `prefill_cost`, and a token
    emitted by a decode step completes at the END of that step.
    """

    rid: int
    arrival: float
    prompt_len: int
    bucket_len: int                 # padded prefill length (physical tokens)
    admit_step: float = 0.0         # admission (prefill dispatch) time
    first_token_step: float = 0.0   # first token completion time
    done_step: float = 0.0          # last token completion time
    deadline: float | None = None   # absolute TTFT deadline, if any
    n_chunks: int = 1               # prefill dispatches (1 = whole-bucket)
    tokens: list = dataclasses.field(default_factory=list)

    @property
    def n_generated(self) -> int:
        return len(self.tokens)

    @property
    def queue_delay_steps(self) -> float:
        return self.admit_step - self.arrival

    @property
    def ttft_steps(self) -> float:
        return self.first_token_step - self.arrival

    @property
    def latency_steps(self) -> float:
        return self.done_step - self.arrival

    @property
    def deadline_missed(self) -> bool:
        """True when the first token completed after the TTFT deadline."""
        return (
            self.deadline is not None and self.first_token_step > self.deadline
        )


@dataclasses.dataclass
class _ChunkedPrefill:
    """In-flight chunked prefill occupying a reserved slot."""

    req: Request
    padded: np.ndarray              # (1, padded_len) right-padded prompt
    bucket: int
    chunk: int                      # C, the per-dispatch token count
    next_start: int = 0

    @property
    def last_start(self) -> int:
        """Start of the chunk holding the last REAL token; trailing
        all-padding chunks are never dispatched."""
        return (len(self.req.prompt) - 1) // self.chunk * self.chunk


def _next_pow2(n: int) -> int:
    return 1 << max(int(n - 1).bit_length(), 0)


class ContinuousScheduler:
    """Slot-based continuous batching over a `ServeEngine`.

    Args:
      engine: `ServeEngine` (digital params or a `CIMExecutor`).  The
        scheduler builds its own step functions (per-slot sampling keys,
        slot admission) and routes every parameter access through
        `engine.access_params`, so hot swaps and executor ticks work.
      n_slots: fixed decode batch size.
      max_len: shared cache length; prompt_len + max_new must fit.
      min_prefill_bucket: smallest padded prompt length (buckets are
        powers of two in [min_prefill_bucket, max_len]).
      key: master sampling key; request sub-streams fold from it.
      maintenance_fn: called between decode steps every
        `maintenance_every` steps (lifetime scrub epochs).
      device_metrics: compute per-step metrics and the batch-occupancy
        digest on the device and fetch them on the SAME copy as the
        tokens.  Token values are identical either way.
      name: digest namespace prefix ("serve").
      device: where the cache, keys and steps live ("cuda" by default).
    """

    def __init__(
        self,
        engine,
        *,
        n_slots: int = 4,
        max_len: int = 128,
        min_prefill_bucket: int = 8,
        key: torch.Tensor | None = None,
        maintenance_fn: Callable[[], Any] | None = None,
        maintenance_every: int = 0,
        prefill_cost_steps: float = 1.0,
        prefill_tokens_per_step: float | None = None,
        prefill_chunk_tokens: int | None = None,
        admission_policy: str = "fifo",
        batch_mesh=None,
        device_metrics: bool = True,
        name: str = "serve",
        device="cuda",
    ):
        if batch_mesh is not None:
            raise NotImplementedError(
                "batch_mesh= (data-sharded decode) is the serving half of "
                "ROADMAP.md A5, not ported yet")
        self.engine = engine
        self.cfg = cfg = engine.cfg
        self.device = torch.device(device)
        self.temperature = float(engine.temperature)
        self.n_slots = n_slots
        self.max_len = max_len
        if min_prefill_bucket < 1 or min_prefill_bucket & (min_prefill_bucket - 1):
            raise ValueError(
                f"min_prefill_bucket must be a power of two: {min_prefill_bucket}"
            )
        self.min_bucket = min_prefill_bucket
        self.prefill_cost_steps = float(prefill_cost_steps)
        self.prefill_tokens_per_step = (
            float(prefill_tokens_per_step)
            if prefill_tokens_per_step is not None else None
        )
        if admission_policy not in ADMISSION_POLICIES:
            raise ValueError(
                f"unknown admission policy {admission_policy!r}; "
                f"known: {ADMISSION_POLICIES}"
            )
        self.admission_policy = admission_policy
        if prefill_chunk_tokens is not None:
            c = int(prefill_chunk_tokens)
            if c < 1 or c & (c - 1):
                raise ValueError(
                    f"prefill_chunk_tokens must be a power of two (so every "
                    f"larger power-of-two bucket divides into whole chunks): {c}"
                )
            for nm, cs in (("attn_chunk_q", cfg.attn_chunk_q),
                           ("attn_chunk_kv", cfg.attn_chunk_kv)):
                if c % cs:
                    raise ValueError(
                        f"prefill_chunk_tokens={c} must be a multiple of "
                        f"{nm}={cs}: chunk boundaries must align with the "
                        "attention's chunk grid"
                    )
            if c >= max_len:
                raise ValueError(
                    f"prefill_chunk_tokens={c} >= max_len={max_len}: nothing "
                    "would ever chunk"
                )
            if cfg.is_moe:
                raise ValueError(
                    "chunked prefill does not support MoE blocks (capacity "
                    "routing couples tokens across the sequence)"
                )
        self.prefill_chunk_tokens = (
            int(prefill_chunk_tokens) if prefill_chunk_tokens is not None
            else None
        )
        self.key = (rng.PRNGKey(0, device=self.device) if key is None
                    else key.to(self.device))
        self.maintenance_fn = maintenance_fn
        self.maintenance_every = maintenance_every
        self.device_metrics = bool(device_metrics)
        self.name = str(name)
        self._occ_digest = self._fresh_occupancy()

        cache = init_cache(cfg, n_slots, max_len, device=self.device)
        if set(cache) != {"k", "v", "pos"}:
            raise ValueError(
                "continuous batching needs a pure attention cache (k/v/pos); "
                f"got {sorted(cache)} for block={cfg.block}"
            )
        if cfg.pos_embedding == "sinusoidal":
            raise ValueError(
                "continuous batching needs per-slot positions; sinusoidal "
                "embeddings take a batch-wide offset"
            )
        if cfg.n_codebooks > 1:
            raise ValueError("multi-codebook heads are not admissible")
        self.cache = cache

        # Each count bumps once when its step function is built, so a
        # steady-state serve asserts them flat.
        self.trace_counts = {"admit": 0, "decode": 0, "chunk": 0}
        self._admit_fns: dict[int, Callable] = {}
        self._decode_fn: Callable | None = None
        # Chunk dispatches specialize on (start, is_final) only: the
        # count is bounded by 2 * max_len / C whatever the bucket mix.
        self._chunk_fns: dict[tuple[int, bool], Callable] = {}
        self._prefilling: dict[int, _ChunkedPrefill] = {}

        self._rid = np.full((n_slots,), -1, np.int32)
        self._gen = np.zeros((n_slots,), np.int32)
        self._cur = np.zeros((n_slots,), np.int32)
        self._slot_req: list[Request | None] = [None] * n_slots
        self.records: dict[int, RequestRecord] = {}
        self.completed: list[RequestRecord] = []
        self.now = 0.0
        self.decode_steps = 0
        self.host_syncs = 0
        self.admit_syncs = 0
        self.admits = 0
        self.tokens_generated = 0
        self.prefill_tokens = 0
        self.wall_s = 0.0
        self.decode_wall_s = 0.0

    # ------------------------------------------------------ device plumbing
    def _fresh_occupancy(self):
        if not self.device_metrics:
            return None
        return obs.StreamingDigest.zeros(0.0, self.n_slots + 1.0,
                                         self.n_slots + 1, device=self.device)

    @contextlib.contextmanager
    def _no_sync(self):
        """On the card, make any device->host sync inside the block raise
        (the counterpart of a device-to-host transfer guard)."""
        if self.device.type != "cuda":
            yield
            return
        old = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(old)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device without a sync: staged in pinned memory
        and copied asynchronously on the current stream."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t.clone()
        return t.pin_memory().to(self.device, non_blocking=True)

    # ------------------------------------------------------- step builders
    def _select_tokens(self, logits: torch.Tensor, master, rids, gens) -> torch.Tensor:
        """Sample (or argmax) each row's next token from its own
        sub-stream ``fold_in(fold_in(master, rid), gen)``; `rids` and
        `gens` are per-row tensors or ints (one row)."""
        if self.temperature > 0.0:
            keys = rng.fold_in(rng.fold_in(master, rids), gens)
            return rng.categorical(keys, logits.to(torch.float32) / self.temperature)
        return torch.argmax(logits, dim=-1)

    def _get_admit(self, bucket: int) -> Callable:
        fn = self._admit_fns.get(bucket)
        if fn is not None:
            return fn
        self.trace_counts["admit"] += 1
        cfg, max_len = self.cfg, self.max_len

        def admit(params, tokens, true_len, rid: int, master, cache, slot: int):
            last, single = prefill(params, {"tokens": tokens}, cfg,
                                   max_len=max_len, true_len=true_len)
            tok = self._select_tokens(last[0], master, rid, 0)
            return tok.to(torch.int32), write_cache_slot(cache, single, slot)

        self._admit_fns[bucket] = admit
        return admit

    def _get_decode(self) -> Callable:
        if self._decode_fn is not None:
            return self._decode_fn
        self.trace_counts["decode"] += 1
        cfg, device_metrics = self.cfg, self.device_metrics

        def decode(params, cache, vecs, master, dig):
            cur, rids, gens = vecs[0], vecs[1], vecs[2]
            # Analog leaves fold the REQUEST id into their per-row noise
            # sub-streams, so a request's logits do not depend on its
            # slot or its neighbours.  Digital params ignore the context.
            with token_stream_ids(rids):
                logits, cache = decode_step(params, cache, {"tokens": cur[:, None]}, cfg)
            last = logits[:, -1]
            toks = self._select_tokens(last, master, rids, gens).to(torch.int32)
            m = {}
            if device_metrics:
                active = rids >= 0
                n_active = torch.sum(active).to(torch.float32)
                greedy = torch.argmax(last, dim=-1).to(torch.int32)
                m = {
                    "decode_active_slots": n_active,
                    "decode_greedy_agree": torch.sum(
                        active & (toks == greedy)).to(torch.float32),
                }
                dig = dig.add(n_active)
            return toks, m, dig, cache

        self._decode_fn = decode
        return decode

    def _get_chunk(self, start: int, final: bool) -> Callable:
        fn = self._chunk_fns.get((start, final))
        if fn is not None:
            return fn
        self.trace_counts["chunk"] += 1
        step = make_prefill_chunk_step(self.cfg, start=start, final=final,
                                       park_pos=self.max_len)

        def chunk(params, cache, tokens, true_len: int, rid: int, master, slot: int):
            last, cache = step(params, cache, tokens, true_len, slot)
            if final:
                # Same sub-stream as whole-bucket admission.
                tok = self._select_tokens(last[0], master, rid, 0)
                return tok.to(torch.int32), cache
            return cache

        self._chunk_fns[(start, final)] = chunk
        return chunk

    # ------------------------------------------------------------ plumbing
    def bucket_len(self, prompt_len: int) -> int:
        b = max(_next_pow2(prompt_len), self.min_bucket)
        return min(b, self.max_len)

    def prefill_cost(self, n_tokens: int, bucket: int | None = None) -> float:
        """Step-clock charge for prefilling `n_tokens` physical tokens:
        proportional when `prefill_tokens_per_step` is set, else the
        constant `prefill_cost_steps` per whole bucket, pro-rated per
        chunk."""
        if self.prefill_tokens_per_step is not None:
            return n_tokens / self.prefill_tokens_per_step
        if bucket is None or n_tokens >= bucket:
            return self.prefill_cost_steps
        return self.prefill_cost_steps * n_tokens / bucket

    def _free_slot(self) -> int | None:
        free = [
            i for i in range(self.n_slots)
            if self._rid[i] < 0 and i not in self._prefilling
        ]
        return free[0] if free else None

    def active_slots(self) -> int:
        return int(np.sum(self._rid >= 0))

    def _digest_hi(self) -> float:
        """Shared bucket range for the step-clock digests; static per
        scheduler geometry, so replicas with one max_len merge."""
        return 8.0 * self.max_len

    def _finish(self, slot: int, t_done: float | None = None) -> None:
        rec = self.records[self._slot_req[slot].rid]
        rec.done_step = self.now if t_done is None else t_done
        self.completed.append(rec)
        obs.digests.observe(
            f"{self.name}.latency_steps", rec.latency_steps,
            lo=0.0, hi=self._digest_hi(), n_buckets=128,
        )
        self._rid[slot] = -1
        self._gen[slot] = 0
        self._cur[slot] = 0
        self._slot_req[slot] = None

    def _emit(self, slot: int, tok: int, t_done: float) -> bool:
        """Record one generated token (completing at `t_done`); returns
        True if the slot finished."""
        req = self._slot_req[slot]
        rec = self.records[req.rid]
        if not rec.tokens:
            rec.first_token_step = t_done
            obs.digests.observe(
                f"{self.name}.ttft_steps", rec.ttft_steps,
                lo=0.0, hi=self._digest_hi(), n_buckets=128,
            )
        rec.tokens.append(tok)
        self._gen[slot] += 1
        self._cur[slot] = tok
        self.tokens_generated += 1
        done = self._gen[slot] >= req.max_new or (
            req.eos_id is not None and tok == req.eos_id
        )
        if done:
            self._finish(slot, t_done)
        return done

    # ------------------------------------------------------------- serving
    def admit(self, req: Request, slot: int | None = None) -> int:
        """Prefill `req` into a free slot of the shared cache.

        Whole-bucket admission dispatches one prefill and emits the first
        token before returning.  Chunked admission reserves the slot and
        dispatches only the FIRST chunk; `run()` (or `prefill_tick()`)
        interleaves the rest between decode steps.
        """
        if slot is None:
            slot = self._free_slot()
        if slot is None:
            raise RuntimeError("no free slot")
        if self._rid[slot] >= 0 or slot in self._prefilling:
            raise RuntimeError(
                f"slot {slot} is occupied by request "
                f"{self._rid[slot] if self._rid[slot] >= 0 else self._prefilling[slot].req.rid}"
            )
        plen = len(req.prompt)
        if plen < 1:
            raise ValueError(f"request {req.rid}: empty prompt")
        if plen + req.max_new > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt {plen} + max_new {req.max_new} "
                f"exceeds max_len {self.max_len}"
            )
        bucket = self.bucket_len(plen)
        chunk = self.prefill_chunk_tokens
        chunked = chunk is not None and bucket > chunk
        padded_len = bucket if not chunked else (
            ((plen - 1) // chunk + 1) * chunk
        )
        padded = np.zeros((1, padded_len), np.int32)
        padded[0, :plen] = np.asarray(req.prompt, np.int32)
        self.records[req.rid] = RequestRecord(
            rid=req.rid, arrival=req.arrival, prompt_len=plen,
            bucket_len=bucket, admit_step=self.now, deadline=req.deadline,
            n_chunks=(plen - 1) // chunk + 1 if chunked else 1,
        )
        obs.digests.observe(
            f"{self.name}.queue_delay_steps", self.now - req.arrival,
            lo=0.0, hi=self._digest_hi(), n_buckets=128,
        )
        self.admits += 1
        obs.registry.inc("serve.admits")
        self._slot_req[slot] = req
        if chunked:
            self._prefilling[slot] = _ChunkedPrefill(
                req=req, padded=padded, bucket=bucket, chunk=chunk
            )
            self._dispatch_chunk(slot)
            return slot
        with obs.span(
            "serve.admit", cat="serve", rid=req.rid, bucket=bucket, slot=slot
        ) as sp:
            l0 = kernels.launch_counts()
            fn = self._get_admit(bucket)
            with self._no_sync():
                params = self.engine.access_params(bucket)  # physical prefill toks
                true_len = torch.full((1,), plen, dtype=torch.int32, device=self.device)
                tok, self.cache = fn(params, self._to_device(padded), true_len,
                                     req.rid, self.key, self.cache, slot)
            tok = int(tok.cpu())  # the one (small) admit sync
            sp["launches"] = kernels.launches_since(l0)
        self.admit_syncs += 1
        self.prefill_tokens += bucket
        obs.registry.inc("serve.prefill_tokens", bucket)
        self._rid[slot] = req.rid
        self._gen[slot] = 0
        # The prefill occupies the engine: advance the clock before the
        # first token completes.
        self.now += self.prefill_cost(bucket, bucket)
        self._emit(slot, tok, self.now)
        return slot

    def _dispatch_chunk(self, slot: int) -> None:
        """Run ONE chunk of the in-flight prefill reserved on `slot`."""
        st = self._prefilling[slot]
        start, chunk = st.next_start, st.chunk
        final = start == st.last_start
        req = st.req
        with obs.span(
            "serve.prefill_chunk", cat="serve", rid=req.rid, start=start,
            slot=slot, final=final,
        ) as sp:
            l0 = kernels.launch_counts()
            fn = self._get_chunk(start, final)
            with self._no_sync():
                tokens = self._to_device(st.padded[:, start:start + chunk])
                params = self.engine.access_params(chunk)  # physical chunk toks
                out = fn(params, self.cache, tokens, len(req.prompt), req.rid,
                         self.key, slot)
            if final:
                tok, self.cache = out
                tok = int(tok.cpu())  # the one (small) admit sync
                self.admit_syncs += 1
            else:
                self.cache = out
            sp["launches"] = kernels.launches_since(l0)
        self.prefill_tokens += chunk
        obs.registry.inc("serve.prefill_tokens", chunk)
        self.now += self.prefill_cost(chunk, st.bucket)
        st.next_start = start + chunk
        if final:
            del self._prefilling[slot]
            self._rid[slot] = req.rid
            self._gen[slot] = 0
            self._emit(slot, tok, self.now)

    def prefill_tick(self) -> bool:
        """Dispatch ONE pending prefill chunk (the oldest reservation);
        returns False when no chunked prefill is in flight."""
        if not self._prefilling:
            return False
        slot = next(iter(self._prefilling))
        self._dispatch_chunk(slot)
        return True

    def step(self) -> None:
        """One decode step of the whole batch + slot bookkeeping.

        Exactly one device->host copy: the tokens, the step metrics and
        the cumulative occupancy digest, packed into one buffer.  On the
        card the dispatch runs with sync debugging set to "error", so a
        hidden sync on the path raises.
        """
        t0 = time.perf_counter()
        with obs.span("serve.decode", cat="serve") as sp:
            l0 = kernels.launch_counts()
            fn = self._get_decode()
            with self._no_sync():
                params = self.engine.access_params(self.n_slots)
                vecs = self._to_device(np.stack([self._cur, self._rid, self._gen]))
                toks, m, dig, self.cache = fn(params, self.cache, vecs, self.key,
                                              self._occ_digest)
            # THE per-step host sync.
            h = obs.metrics.fetch({"toks": toks, "m": m,
                                   "dig": dig.as_tree() if dig is not None else {}})
            toks = h["toks"].astype(np.int64)
            self._occ_digest = dig
            self.host_syncs += 1
            self.decode_steps += 1
            obs.registry.inc("serve.decode_steps")
            obs.registry.fold(h["m"], prefix="serve.")
            if dig is not None:
                # Cumulative carry -> replace, never merge.
                obs.digests.put(f"{self.name}.batch_occupancy",
                                obs.StreamingDigest.from_tree(dig.lo, dig.hi, h["dig"]))
            obs.digests.observe(
                f"{self.name}.step_latency_us",
                (time.perf_counter() - t0) * 1e6,
                lo=0.0, hi=1e5, n_buckets=128,
            )
            emitted = 0
            for slot in np.flatnonzero(self._rid >= 0):
                # a decode-emitted token completes at the END of this step
                self._emit(int(slot), int(toks[slot]), self.now + 1.0)
                emitted += 1
            obs.registry.inc("serve.decode_tokens", emitted)
            sp["tokens"] = emitted
            sp["launches"] = kernels.launches_since(l0)
        # Decode-only wall clock: excludes admission prefill and
        # interleaved maintenance.
        self.decode_wall_s += time.perf_counter() - t0

    def warmup(
        self,
        prompt_lens: list[int] | None = None,
        prompt_range: tuple[int, int] | None = None,
    ) -> None:
        """Build every step function the serve loop will hit, then reset.

        Admits one throwaway request per distinct prefill bucket (and per
        distinct final-chunk offset when chunking) and runs decode steps;
        afterwards `trace_counts` stays flat for any traffic whose prompts
        map onto the warmed buckets.  `prompt_range=(lo, hi)` warms every
        bucket a prompt length in [lo, hi] can map to.
        """
        if prompt_range is not None:
            lo, hi = prompt_range
            plens = list(range(lo, hi + 1))
        else:
            plens = list(prompt_lens or [self.min_bucket])
        chunk = self.prefill_chunk_tokens
        buckets = sorted({
            self.bucket_len(p) for p in plens
            if chunk is None or self.bucket_len(p) <= chunk
        })
        if chunk is not None:
            # One dummy admission per distinct final-chunk offset covers
            # every reachable (start, is_final) pair.
            lasts = sorted({
                (p - 1) // chunk * chunk for p in plens
                if self.bucket_len(p) > chunk and p + 1 <= self.max_len
            })
            for j, last in enumerate(lasts):
                plen = max(
                    p for p in plens
                    if self.bucket_len(p) > chunk
                    and (p - 1) // chunk * chunk == last
                    and p + 1 <= self.max_len
                )
                slot = self._free_slot()
                if slot is None:
                    self._finish(0)
                    slot = 0
                self.admit(
                    Request(rid=(1 << 29) + j, prompt=[0] * plen, max_new=1,
                            arrival=self.now),
                    slot,
                )
                while slot in self._prefilling:
                    self.prefill_tick()
        for i, b in enumerate(buckets):
            slot = self._free_slot()
            if slot is None:  # more buckets than slots: recycle slot 0
                self._finish(0)
                slot = 0
            # A b-token prompt maps onto bucket b; a clamped top bucket
            # (b == max_len) warms with max_len - 1.  A bucket no
            # admissible request reaches is skipped.
            plen = min(b, self.max_len - 1)
            if self.bucket_len(plen) != b:
                continue
            self.admit(
                Request(rid=(1 << 30) + i, prompt=[0] * plen,
                        max_new=2 if plen + 2 <= self.max_len else 1,
                        arrival=self.now),
                slot,
            )
        if not self.active_slots():
            # every dummy finished at admission: keep one slot live so
            # the decode step is built too
            plen = max(1, min(self.min_bucket, self.max_len - 2))
            self.admit(
                Request(rid=(1 << 30) + len(buckets), prompt=[0] * plen,
                        max_new=2, arrival=self.now)
            )
        self.step()
        self.step()
        self.reset(keep_traces=True)

    def reset(self, keep_traces: bool = False) -> None:
        """Clear slot state, records and counters (step functions survive)."""
        self._rid[:] = -1
        self._gen[:] = 0
        self._cur[:] = 0
        self._slot_req = [None] * self.n_slots
        self._prefilling = {}
        self.records = {}
        self.completed = []
        self.now = 0.0
        self.decode_steps = 0
        self.host_syncs = 0
        self.admit_syncs = 0
        self.admits = 0
        self.tokens_generated = 0
        self.prefill_tokens = 0
        self.wall_s = 0.0
        self.decode_wall_s = 0.0
        self._occ_digest = self._fresh_occupancy()
        obs.digests.reset(f"{self.name}.")
        if not keep_traces:
            self.trace_counts = {"admit": 0, "decode": 0, "chunk": 0}

    def run(
        self, requests: list[Request], *, max_steps: int = 1_000_000
    ) -> list[RequestRecord]:
        """Serve an arrival stream to completion.

        The clock is the decode step: each step advances `now` by 1,
        prefills charge `prefill_cost`, and idle periods fast-forward to
        the next arrival.  Ready requests are admitted into free slots in
        `admission_policy` order; with chunked prefill, ONE pending chunk
        is dispatched per loop iteration before the decode step.
        Returns the completed `RequestRecord`s sorted by rid.
        """
        pending = collections.deque(
            sorted(requests, key=lambda r: (r.arrival, r.rid))
        )
        ready: list[Request] = []
        t0 = time.perf_counter()
        steps0 = self.decode_steps
        with obs.span(
            "serve.run", cat="serve", requests=len(requests),
            n_slots=self.n_slots, policy=self.admission_policy,
        ) as sp:
            while pending or ready or self.active_slots() or self._prefilling:
                while pending and pending[0].arrival <= self.now:
                    ready.append(pending.popleft())
                progressed = False
                while ready and self._free_slot() is not None:
                    req = select_next(ready, self.admission_policy)
                    ready.remove(req)
                    self.admit(req)
                    progressed = True
                    # admission advanced the clock: newly arrived
                    # requests join the ready set before the next pick
                    while pending and pending[0].arrival <= self.now:
                        ready.append(pending.popleft())
                if self.prefill_tick():
                    progressed = True
                if self.active_slots():
                    self.step()
                    self.now += 1.0
                    progressed = True
                    if (
                        self.maintenance_fn is not None
                        and self.maintenance_every > 0
                        and self.decode_steps % self.maintenance_every == 0
                    ):
                        with obs.span("serve.maintenance", cat="serve") as msp:
                            l0 = kernels.launch_counts()
                            self.maintenance_fn()
                            msp["launches"] = kernels.launches_since(l0)
                    if self.decode_steps - steps0 >= max_steps:
                        break
                if not progressed:
                    if not pending:  # every remaining request finished
                        break
                    self.now = max(self.now, pending[0].arrival)
            sp["decode_steps"] = self.decode_steps - steps0
            sp["completed"] = len(self.completed)
        self.wall_s += time.perf_counter() - t0
        return sorted(self.completed, key=lambda r: r.rid)

    # ----------------------------------------------------------- reporting
    def digest_stats(self) -> dict[str, dict]:
        """This scheduler's digest summaries (percentiles, no arrays)."""
        prefix = f"{self.name}."
        return {
            n: obs.digests.get(n).summary()
            for n in obs.digests.names() if n.startswith(prefix)
        }

    def latency_stats(self) -> dict[str, float]:
        """Aggregate latency/throughput stats over completed requests;
        percentiles by `obs.rank_quantile`, the definition the digests
        estimate."""
        lats = np.array([r.latency_steps for r in self.completed])
        ttfts = np.array([r.ttft_steps for r in self.completed])
        queue = np.array([r.queue_delay_steps for r in self.completed])
        steps = max(self.decode_steps, 1)
        out = {
            "completed": float(len(self.completed)),
            "decode_steps": float(self.decode_steps),
            "tokens_generated": float(self.tokens_generated),
            "tokens_per_step": self.tokens_generated / steps,
            "wall_s": self.wall_s,
            "tokens_per_s": (
                self.tokens_generated / self.wall_s if self.wall_s > 0 else 0.0
            ),
            "decode_wall_s": self.decode_wall_s,
            "decode_step_us": self.decode_wall_s / steps * 1e6,
            "decode_tokens_per_s": (
                self.tokens_generated / self.decode_wall_s
                if self.decode_wall_s > 0 else 0.0
            ),
        }
        if len(lats):
            out.update(
                p50_latency_steps=obs.rank_quantile(lats, 0.50),
                p99_latency_steps=obs.rank_quantile(lats, 0.99),
                p50_ttft_steps=obs.rank_quantile(ttfts, 0.50),
                p99_ttft_steps=obs.rank_quantile(ttfts, 0.99),
                mean_queue_delay_steps=float(queue.mean()),
            )
        with_deadline = [r for r in self.completed if r.deadline is not None]
        if with_deadline:
            missed = sum(r.deadline_missed for r in with_deadline)
            out["deadline_requests"] = float(len(with_deadline))
            out["deadline_misses"] = float(missed)
            out["deadline_miss_rate"] = missed / len(with_deadline)
        return out


def poisson_requests(
    seed: int,
    n: int,
    *,
    rate: float,
    vocab: int,
    prompt_lens: tuple[int, int] = (4, 24),
    max_new: tuple[int, int] = (4, 16),
    eos_id: int | None = None,
    start_rid: int = 0,
    long_prompt_lens: tuple[int, int] | None = None,
    long_frac: float = 0.0,
    ttft_slack: tuple[float, float] | None = None,
) -> list[Request]:
    """A Poisson arrival stream of variable-length requests.

    `rate` is the offered load in requests per decode step
    (inter-arrival times Exp(1/rate)); prompt lengths and budgets draw
    uniformly from their (lo, hi) ranges.  `long_prompt_lens` +
    `long_frac` mix in a fraction of long prompts; `ttft_slack=(lo, hi)`
    gives every request the deadline ``arrival + Uniform(lo, hi)``.
    """
    g = np.random.default_rng(seed)
    arrivals = np.cumsum(g.exponential(1.0 / rate, size=n))
    reqs = []
    for i in range(n):
        lens = prompt_lens
        if long_prompt_lens is not None and g.random() < long_frac:
            lens = long_prompt_lens
        plen = int(g.integers(lens[0], lens[1] + 1))
        deadline = None
        if ttft_slack is not None:
            deadline = float(
                arrivals[i] + g.uniform(ttft_slack[0], ttft_slack[1])
            )
        reqs.append(
            Request(
                rid=start_rid + i,
                prompt=g.integers(0, vocab, size=plen).astype(np.int32),
                max_new=int(g.integers(max_new[0], max_new[1] + 1)),
                arrival=float(arrivals[i]),
                eos_id=eos_id,
                deadline=deadline,
            )
        )
    return reqs
