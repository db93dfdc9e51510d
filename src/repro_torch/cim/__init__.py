# Analog compute-in-memory serving: inference computed in the programmed
# arrays — macro tiling of live ArrayState conductances, the noisy
# bit-serial DAC -> VMM -> ADC forward, and the executor that hands it to
# the serving engine.
from .tile import CIMWeight, build_weight, slice_planes, tile_planes  # noqa: F401
from .mvm import (  # noqa: F401
    CIMConfig,
    cim_matmul,
    cim_vmm,
    current_token_ids,
    planes_per_token,
    token_stream_ids,
)
from .executor import CIMExecutor, analog_eligible  # noqa: F401
