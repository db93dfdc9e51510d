"""hymba-1.5b [hybrid] — parallel attn+mamba heads [arXiv:2411.13676; hf].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Sliding-window attention (1024) everywhere except 3 global layers
(first / middle / last).  Runs long_500k: global layers keep full caches
(3 x 500k), SWA layers keep 1024-slot ring buffers, SSM state is O(1).
"""

import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    block="hymba",
    ssm_state=16,
    sliding_window=1024,
    global_layer_every=16,   # globals at 0, 16, 31 (first/middle/last)
    rope_theta=10000.0,
    dtype=torch.bfloat16,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, ssm_state=4, sliding_window=8,
    global_layer_every=2, attn_chunk_q=16, attn_chunk_kv=16,
    dtype=torch.float32, remat=False,
)
