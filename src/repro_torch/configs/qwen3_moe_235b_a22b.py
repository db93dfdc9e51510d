"""qwen3-moe-235b-a22b [moe] — 128 experts, top-8 [hf:Qwen/Qwen3-30B-A3B; hf].

94L d_model=4096 64H (GQA kv=4) per-expert d_ff=1536 vocab=151936, qk-norm.
Optimizer states ride in bf16 so params+grads+m+v fit the single-pod HBM
budget (DESIGN.md Sec. 4).
"""

import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    moe_experts=128,
    moe_top_k=8,
    moe_d_ff=1536,
    qk_norm=True,
    rope_theta=1000000.0,
    tie_embeddings=False,
    opt_state_dtype=torch.bfloat16,
    dtype=torch.bfloat16,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    moe_experts=8, moe_top_k=2, moe_d_ff=32, d_ff=32, vocab_size=256,
    attn_chunk_q=16, attn_chunk_kv=16, dtype=torch.float32,
    opt_state_dtype=torch.float32, remat=False,
)
