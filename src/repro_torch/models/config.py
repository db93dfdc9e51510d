"""Unified model configuration (field for field the reference's ModelConfig)."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    block: str = "attn"              # "attn" | "rwkv6" | "hymba"

    # MoE (token-choice top-k; experts EP-sharded over "model")
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # attention details
    qk_norm: bool = False
    rope_theta: float = 10000.0
    pos_embedding: str = "rope"      # "rope" | "sinusoidal" | "none"
    sliding_window: int = 0          # 0 = full attention (hymba SWA uses >0)
    global_layer_every: int = 0      # hymba: every k-th layer is global attn

    # cross-attention conditioning (vlm image tower / musicgen text)
    cross_attn_every: int = 0        # insert a cross-attn block every k layers
    cross_kv_len: int = 0            # stub-frontend context length
    cross_d_cond: int = 0            # conditioning embedding width

    # SSM branch (hymba) / rwkv
    ssm_state: int = 0

    # embeddings / heads
    tie_embeddings: bool = True
    n_codebooks: int = 1             # musicgen: parallel output heads
    frontend: str = "none"           # "none" | "embed_stub" (precomputed frame
                                     # or patch embeddings from input_specs)

    # numerics / runtime
    dtype: Any = torch.bfloat16
    remat: bool = True
    attn_chunk_q: int = 512
    attn_chunk_kv: int = 1024
    norm_eps: float = 1e-5
    opt_state_dtype: Any = torch.float32

    # perf knobs of the reference, kept for field parity
    fuse_qkv: bool = False           # single fused QKV projection matmul
    # residual-stream sharding over the model axis (reference training)
    shard_residual: bool = True

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def is_moe(self) -> bool:
        return self.moe_experts > 0

    @property
    def num_cross_layers(self) -> int:
        if self.cross_attn_every <= 0:
            return 0
        return self.n_layers // self.cross_attn_every

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND roofline MODEL_FLOPS)."""
        d, hd = self.d_model, self.head_dim
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.qk_norm:
            attn += 2 * hd
        if self.is_moe:
            ffn = self.moe_experts * 3 * d * self.moe_d_ff + d * self.moe_experts
        else:
            ffn = 3 * d * self.d_ff
        if self.block == "rwkv6":
            # time-mix: r,k,v,g,o + decay/bonus + lerp params; channel-mix 2 mats
            attn = 5 * d * d + 2 * d + 6 * d + d * 64
            ffn = d * self.d_ff + self.d_ff * d
        if self.block == "hymba":
            # parallel SSM branch: in-proj (x,z), dt/B/C proj, out-proj
            n = self.ssm_state
            attn += 2 * d * d + d * (2 * n + d // hd) + d * d
        per_layer = attn + ffn + 2 * d
        total = self.n_layers * per_layer + self.vocab_size * d + d
        if not self.tie_embeddings:
            total += self.n_codebooks * d * self.vocab_size
        if self.cross_attn_every:
            cross = (
                d * self.q_dim
                + 2 * self.cross_d_cond * self.kv_dim
                + self.q_dim * d
                + 2 * d
            )
            total += self.num_cross_layers * cross
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        dense_ffn = self.moe_experts * 3 * d * self.moe_d_ff
        active_ffn = self.moe_top_k * 3 * d * self.moe_d_ff
        return int(self.param_count() - self.n_layers * (dense_ffn - active_ffn))

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
