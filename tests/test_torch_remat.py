"""Rematerialisation under autograd (`repro_torch.models.remat`): the
reference's `jax.checkpoint` places in the port's training path.

* For every model family's smoke config with ``remat=True`` (dense qwen3,
  olmoe's MoE, rwkv6, hymba, the VLM's grouped cross-attention, musicgen's
  per-layer cross-attention), the loss and every gradient leaf equal
  ``remat=False``'s bitwise (both under deterministic algorithms), and
  exactly the layer bodies the reference checkpoints were checkpointed;
* the same configs, ``remat=True`` on both sides, against the reference's
  `jax.value_and_grad(loss_fn)`: the loss within rtol 1e-5, each leaf
  within 1e-4 of its largest (`torch_families.check_grads`);
* what a grad-enabled `chunked_causal_attention`, `ssm_branch` and
  `time_mix` hold for backward, counted by distinct storage through
  `torch.autograd.graph.saved_tensors_hooks`, grows linearly in the
  sequence (at most 2.3x for twice the chunks): no probability tile, no
  SSM chunk's (B, c, d_inner, n) tensors, no per-chunk WKV state is held;
* under `moe.record_routing()` a forward + backward with layer remat logs
  one keep mask per MoE call (the recompute adds none);
* under `torch.no_grad()`, `forward`, `prefill` and `decode_step` run no
  checkpoint, and the no-grad logits equal the grad-enabled forward's
  bitwise.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import pytree
from repro_torch.convert import params_from_numpy
from repro_torch.models import decode_step, forward, prefill, remat
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import chunked_causal_attention
from repro_torch.models.moe import record_routing
from repro_torch.models.transformer import _hymba_runs
from repro_torch.training import _grads_of
from torch_families import carried, check_grads, make_batch, smoke_pair, to_torch

FAMILIES = ["qwen3-0.6b", "olmoe-1b-7b", "rwkv6-1.6b", "hymba-1.5b",
            "llama-3.2-vision-11b", "musicgen-medium"]
# Sequence lengths that run several chunks of each checkpointed loop:
# attention's 16-token chunks everywhere, two SSM chunks of 128 (hymba),
# two WKV groups of 16 chunks of 16 tokens (rwkv6).
SEQ = {"rwkv6-1.6b": 272, "hymba-1.5b": 136}
# Against the reference, hymba runs one SSM chunk: its 9 query chunks
# at 136 tokens cost the reference's compile ~12 s more; the chunk
# checkpoint is held bitwise at 136 tokens by the remat-vs-plain case.
REF_SEQ = {**SEQ, "hymba-1.5b": 40}


def _pair(arch: str, remat_on: bool = True):
    jcfg, tcfg = smoke_pair(arch)
    return (dataclasses.replace(jcfg, remat=remat_on),
            dataclasses.replace(tcfg, remat=remat_on))


def _case(arch: str, seq: dict = SEQ):
    jcfg, _ = _pair(arch)
    params = carried(jcfg, seed=0, gate=0.5)
    batch = make_batch(jcfg, 2, seq.get(arch, 40), seed=3, labels=True)
    return params, batch


def _layer_checkpoints(cfg) -> int:
    """Layer bodies the reference checkpoints under ``cfg.remat``."""
    if cfg.block == "hymba":
        return sum(end - start for start, end, _ in _hymba_runs(cfg) if end - start > 1)
    return cfg.n_layers


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads for the module, restored after it (the suite
    runs files side by side in worker processes)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def deterministic():
    """Deterministic algorithms for one test: the CPU's embedding backward
    (an accumulating `index_put_`) otherwise adds duplicate rows with
    atomics across threads, in no fixed order."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_grads_bitwise_equal_plain(arch, deterministic):
    params, batch = _case(arch)
    got = {}
    for on in (False, True):
        _, cfg = _pair(arch, on)
        n0 = remat.checkpoints
        (loss, _), grads = _grads_of(params_from_numpy(params, device="cpu"),
                                     to_torch(batch), cfg)
        got[on] = (loss, pytree.leaves_with_path(grads), remat.checkpoints - n0)
    assert torch.equal(got[True][0], got[False][0])
    for (path, a), (_, b) in zip(got[True][1], got[False][1]):
        assert torch.equal(a, b), path
    assert got[True][2] - got[False][2] == _layer_checkpoints(_pair(arch)[1])
    assert got[False][2] > 0          # attention, SSM and WKV chunks: always on


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_grads_match_reference(arch):
    jcfg, tcfg = _pair(arch)
    params, batch = _case(arch, REF_SEQ)
    check_grads(jcfg, tcfg, params, batch)


def _held(fn, *args) -> tuple[int, list[tuple[int, ...]]]:
    """What autograd saves for backward while `fn(*args)` runs (a
    checkpoint saves its arguments): the bytes of the distinct storages,
    and the shape of each saved tensor."""
    held, shapes = {}, []

    def pack(t):
        st = t.untyped_storage()
        held[st.data_ptr()] = st.nbytes()
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn(*args)
    return sum(held.values()), shapes


def _grown(make, sizes) -> float:
    small, large = (_held(*make(s))[0] for s in sizes)
    assert small > 0
    return large / small


def test_attention_holds_linear_bytes():
    gen = torch.Generator().manual_seed(0)

    def make(s):
        q, k, v = (torch.randn(1, s, h, 8, generator=gen, requires_grad=True)
                   for h in (4, 2, 2))
        return (lambda q, k, v: chunked_causal_attention(q, k, v, chunk_q=16,
                                                         chunk_kv=16), q, k, v)

    assert _grown(make, (64, 128)) <= 2.3
    # No (B, cq, KV, G, ck) score or probability tile is held.
    assert not [sh for sh in _held(*make(128))[1] if len(sh) == 5 and sh[-1] == 16]


def test_ssm_branch_holds_linear_bytes():
    _, cfg = _pair("hymba-1.5b")
    gen = torch.Generator().manual_seed(0)
    pl = {k: v[0].requires_grad_(True)
          for k, v in ssm_mod.init_ssm_params(gen, cfg, 1, "cpu").items()}

    def make(s):
        x = torch.randn(1, s, cfg.d_model, generator=gen, requires_grad=True)
        st = ssm_mod.init_ssm_state(cfg, 1, device="cpu")
        return ssm_mod.ssm_branch, x, pl, cfg, st

    assert _grown(make, (2 * ssm_mod.SSM_CHUNK, 4 * ssm_mod.SSM_CHUNK)) <= 2.3
    # No chunk's (B, c, d_inner, n) decay, drive, prefix or state tensor
    # is held: backward recomputes them.
    shapes = _held(*make(4 * ssm_mod.SSM_CHUNK))[1]
    assert not [sh for sh in shapes if sh[-2:] == (cfg.d_model, cfg.ssm_state)
                and len(sh) == 4]


def test_time_mix_holds_linear_bytes():
    _, cfg = _pair("rwkv6-1.6b")
    gen = torch.Generator().manual_seed(0)
    p = {k: v.requires_grad_(True)
         for k, v in rwkv_mod.init_rwkv_params(gen, cfg, 1, "cpu").items()}
    group = 16 * rwkv_mod.CHUNK

    def make(s):
        x = torch.randn(1, s, cfg.d_model, generator=gen, requires_grad=True)
        st = rwkv_mod.init_rwkv_state(cfg, 1, device="cpu")
        return rwkv_mod.time_mix, x, p, 0, cfg, st

    assert _grown(make, (2 * group, 4 * group)) <= 2.3
    # One (B, H, hd, hd) state per group of 16 chunks, its entry state:
    # none per chunk.
    hd = cfg.head_dim
    states = [sh for sh in _held(*make(4 * group))[1]
              if sh == (1, cfg.d_model // hd, hd, hd)]
    assert len(states) == 4


def test_routing_log_one_mask_per_moe_call():
    _, cfg = _pair("olmoe-1b-7b")
    params, batch = _case("olmoe-1b-7b")
    with record_routing() as log:
        _grads_of(params_from_numpy(params, device="cpu"), to_torch(batch), cfg)
    assert len(log) == cfg.n_layers
    t = batch["tokens"].size
    assert all(tuple(m.shape) == (t, cfg.moe_top_k) for m in log)


@pytest.mark.parametrize("arch", FAMILIES)
def test_no_grad_paths_run_no_checkpoint(arch):
    _, cfg = _pair(arch)
    params, batch = _case(arch)
    tp = params_from_numpy(params, device="cpu")
    inputs = {k: v for k, v in to_torch(batch).items() if k not in ("targets", "mask")}
    n0 = remat.checkpoints
    with torch.no_grad():
        logits, aux, _ = forward(tp, inputs, cfg)
        prompt = {k: (v[:, :-1] if k in ("tokens", "embeds") else v)
                  for k, v in inputs.items()}
        last, cache = prefill(tp, prompt, cfg, max_len=logits.shape[1])
        one = {k: (v[:, -1:] if k in ("tokens", "embeds") else v)
               for k, v in inputs.items()}
        step, _ = decode_step(tp, cache, one, cfg)
    assert remat.checkpoints == n0
    # The same forward under autograd checkpoints, and computes the same.
    leaves = [x.requires_grad_(True) for x in pytree.leaves(tp)]
    g_logits, g_aux, _ = forward(pytree.unflatten(tp, leaves), inputs, cfg)
    assert remat.checkpoints > n0
    assert torch.equal(g_logits.detach(), logits) and torch.equal(g_aux.detach(), aux)
    # Serving does not read `remat`: the plain config's outputs, bitwise.
    _, plain = _pair(arch, False)
    with torch.no_grad():
        p_last, p_cache = prefill(tp, prompt, plain, max_len=logits.shape[1])
        p_step, _ = decode_step(tp, p_cache, one, plain)
    assert torch.equal(p_last, last) and torch.equal(p_step, step)
    assert np.isfinite(step.numpy()).all()
