"""Architecture registry: 10 assigned archs x 4 input shapes.

`runnable_cells()` enumerates the reference's dry-run matrix: every
(arch x shape) pair, minus long_500k for pure full-attention archs; only
the SSM/hybrid archs (rwkv6, hymba) run the 524288-context decode cell.

The port builds and runs every arch: the four dense attention archs
(`DENSE_ARCHS`) and the MoE, RWKV6, hybrid, VLM and MusicGen families.
A decode spec's cache is the family's `init_cache`.

`input_specs` returns tensors on the ``meta`` device, PyTorch's
counterpart of the reference's `ShapeDtypeStruct`: shapes and dtypes
with no storage.  `materialize_inputs` fills the same structure with
real tensors drawn from the port's legacy threefry, in the reference's
order of key splits (the tree's leaves in sorted-key order).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any

import torch

from repro_torch import pytree
from repro_torch.core import rng
from repro_torch.models import ModelConfig, init_cache

__all__ = [
    "ARCHS", "SHAPES", "ShapeSpec", "LONG_CONTEXT_ARCHS", "DENSE_ARCHS",
    "get_config", "get_smoke_config", "runnable_cells", "input_specs",
    "materialize_inputs",
]

ARCHS: dict[str, str] = {
    "olmoe-1b-7b": "olmoe_1b_7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "smollm-360m": "smollm_360m",
    "qwen3-0.6b": "qwen3_0_6b",
    "llama3.2-1b": "llama3_2_1b",
    "llama-3.2-vision-11b": "llama3_2_vision_11b",
    "hymba-1.5b": "hymba_1_5b",
    "musicgen-medium": "musicgen_medium",
}

# The archs of the plain dense attention stack (no MoE, recurrence,
# cross-attention or multi-codebook head).
DENSE_ARCHS = ("qwen3-0.6b", "llama3.2-1b", "smollm-360m", "tinyllama-1.1b")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# long_500k runs only for sub-quadratic (SSM / hybrid) archs.
LONG_CONTEXT_ARCHS = {"rwkv6-1.6b", "hymba-1.5b"}


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; choose from {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE_CONFIG


def runnable_cells() -> list[tuple[str, str]]:
    cells = []
    for arch in ARCHS:
        for shape in SHAPES:
            if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
                continue  # full-attention arch: spec'd skip
            cells.append((arch, shape))
    return cells


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, spec: ShapeSpec) -> dict[str, Any]:
    """Meta-device stand-ins for the step's inputs.

    train  -> {"batch": {...}}
    prefill-> {"batch": {...}}
    decode -> {"batch": {...}, "cache": {...}}  (cache sized to seq_len)
    """
    b, s = spec.global_batch, spec.seq_len
    i32, f32, dt = torch.int32, torch.float32, cfg.dtype

    def data_batch(seq):
        batch: dict[str, Any] = {}
        if cfg.frontend == "embed_stub":
            batch["embeds"] = _meta((b, seq, cfg.d_model), dt)
        else:
            batch["tokens"] = _meta((b, seq), i32)
        if cfg.cross_kv_len > 0:
            batch["cond"] = _meta((b, cfg.cross_kv_len, cfg.cross_d_cond), dt)
        return batch

    if spec.kind == "train":
        batch = data_batch(s)
        tshape = (b, s, cfg.n_codebooks) if cfg.n_codebooks > 1 else (b, s)
        batch["targets"] = _meta(tshape, i32)
        batch["mask"] = _meta((b, s), f32)
        return {"batch": batch}
    if spec.kind == "prefill":
        return {"batch": data_batch(s)}
    # decode: one new token against a seq_len cache
    return {"batch": data_batch(1), "cache": init_cache(cfg, b, s, device="meta")}


def materialize_inputs(cfg: ModelConfig, spec: ShapeSpec, seed: int = 0,
                       device="cuda") -> dict[str, Any]:
    """Small real tensors with the same structure (smoke tests)."""
    specs = input_specs(cfg, spec)
    key = rng.PRNGKey(seed, device=device)
    values = []
    for meta in pytree.leaves(specs):
        key, sub = rng.split(key)
        if not meta.dtype.is_floating_point:
            v = rng.randint(sub, tuple(meta.shape), 0, max(cfg.vocab_size, 2))
        else:
            v = 0.01 * rng.normal(sub, tuple(meta.shape))
        values.append(v.to(meta.dtype))
    return pytree.unflatten(specs, values)
