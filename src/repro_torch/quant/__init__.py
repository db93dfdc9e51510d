from .quantize import QuantConfig, quantize_weight, dequantize_weight  # noqa: F401
from .bitslice import (  # noqa: F401
    slice_magnitudes,
    unslice_magnitudes,
    signed_to_pair,
    pair_to_signed,
)
from .pack import pack_columns, unpack_columns, PackedLayout  # noqa: F401
