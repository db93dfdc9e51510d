"""llama-3.2-vision-11b [vlm] — cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision].

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256; a gated
cross-attention block every 5 decoder layers attends to image patch
embeddings.  The vision tower is a STUB per the task spec: input_specs()
supplies precomputed patch embeddings (B, 1601, d_cond).
"""

import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500000.0,
    cross_attn_every=5,
    cross_kv_len=1601,     # one 448x448 image -> 1601 patch embeddings
    cross_d_cond=4096,     # stub frontend projects to d_model width
    dtype=torch.bfloat16,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=4, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=128, vocab_size=256, cross_attn_every=2, cross_kv_len=17,
    cross_d_cond=64, attn_chunk_q=16, attn_chunk_kv=16,
    dtype=torch.float32, remat=False,
)
