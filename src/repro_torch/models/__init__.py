from .config import ModelConfig  # noqa: F401
from .transformer import forward, init_params, loss_fn  # noqa: F401
from .decoding import (  # noqa: F401
    decode_step,
    init_cache,
    prefill,
    prefill_chunk,
    write_cache_slot,
)
