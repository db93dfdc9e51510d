# Batched serving of the port: prefill/decode steps and the generate
# loop, digital or through a CIM executor's analog tiles.
from .engine import ServeEngine, make_decode_step, make_prefill_step  # noqa: F401
