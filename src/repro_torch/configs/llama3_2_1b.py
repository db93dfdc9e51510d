"""llama3.2-1b [dense] — small llama3 [hf:meta-llama/Llama-3.2-1B].

16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256.
"""

import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500000.0,
    dtype=torch.bfloat16,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=128, vocab_size=256, attn_chunk_q=16, attn_chunk_kv=16,
    dtype=torch.float32, remat=False,
)
