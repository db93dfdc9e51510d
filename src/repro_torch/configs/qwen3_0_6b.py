"""qwen3-0.6b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf].

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936; head_dim=128
(q-projection widens to 2048, Qwen3 style).
"""

import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
    dtype=torch.bfloat16,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, attn_chunk_q=16, attn_chunk_kv=16,
    dtype=torch.float32, remat=False,
)
