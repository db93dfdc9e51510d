from .config import ModelConfig  # noqa: F401
from .transformer import forward, init_params  # noqa: F401
from .decoding import decode_step, init_cache, prefill, write_cache_slot  # noqa: F401
