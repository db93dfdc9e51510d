"""musicgen-medium [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284; hf].

48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048; 4 RVQ codebooks
decoded with the delay pattern -> 4 parallel output heads; sinusoidal
positions; text-conditioning cross-attention every layer.  The EnCodec
frontend is a STUB per the task spec: input_specs() supplies precomputed
frame embeddings (sum of codebook embeddings) and T5 text embeddings.
"""

import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    frontend="embed_stub",
    n_codebooks=4,
    pos_embedding="sinusoidal",
    cross_kv_len=64,       # T5 text-conditioning tokens
    cross_d_cond=1536,
    tie_embeddings=False,
    dtype=torch.bfloat16,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=64, cross_kv_len=9, cross_d_cond=64,
    attn_chunk_q=16, attn_chunk_kv=16, dtype=torch.float32, remat=False,
)
