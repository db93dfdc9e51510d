"""smollm-360m [dense] — llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf].

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.  Neither d_model
(7.5 macro tiles of 128 rows) nor kv_dim 320 is a power of two.
"""

import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    rope_theta=10000.0,
    dtype=torch.bfloat16,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=60, n_heads=3, n_kv_heads=1, head_dim=20,
    d_ff=128, vocab_size=256, attn_chunk_q=16, attn_chunk_kv=16,
    dtype=torch.float32, remat=False,
)
