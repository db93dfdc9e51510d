"""rwkv6-1.6b [ssm] — Finch, data-dependent decay [arXiv:2404.05892].

24L d_model=2048 (attention-free) d_ff=7168 vocab=65536; 32 wkv heads of 64.
Runs long_500k (O(1) recurrent state).
"""

import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    block="rwkv6",
    pos_embedding="none",
    dtype=torch.bfloat16,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256, dtype=torch.float32, remat=False,
)
