"""olmoe-1b-7b [moe] — 64 experts, top-8 [arXiv:2409.02060; hf].

16L d_model=2048 16H (MHA kv=16) per-expert d_ff=1024 vocab=50304.
"""

import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    moe_experts=64,
    moe_top_k=8,
    moe_d_ff=1024,
    rope_theta=10000.0,
    dtype=torch.bfloat16,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    moe_experts=8, moe_top_k=2, moe_d_ff=32, d_ff=32, vocab_size=256,
    attn_chunk_q=16, attn_chunk_kv=16, dtype=torch.float32, remat=False,
)
