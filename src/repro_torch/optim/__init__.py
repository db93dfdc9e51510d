from .adamw import AdamWConfig, AdamWState, adamw_init, adamw_update  # noqa: F401
from .schedule import cosine_schedule  # noqa: F401
from .compression import (  # noqa: F401
    CompressionState,
    compress_int8,
    compressed_psum,
    decompress_int8,
    init_compression_state,
)
