# The paper's primary contribution in the port: Hadamard-domain
# write-and-verify for RRAM programming, in PyTorch.
from .types import (  # noqa: F401
    ADCConfig,
    DeviceConfig,
    FaultConfig,
    NoiseConfig,
    WVConfig,
    WVMethod,
    default_config_for_array,
)
from .cost import CircuitCost  # noqa: F401
from .wv import WVStats, program_columns, verify_aggregate, verify_sweep  # noqa: F401
from . import hadamard  # noqa: F401
from . import pipeline  # noqa: F401
from . import remap  # noqa: F401
