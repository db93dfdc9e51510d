# The analog readout subsystem of the port: ONE model of the read path
# (basis x converter x averaging x impairments) for WV verify, with
# per-column converter offset calibration.
# core.wv reads through this package: load core first, so that either
# package can be imported first.
import repro_torch.core  # noqa: F401
from .config import (  # noqa: F401
    Converter,
    ReadoutBasis,
    ReadoutConfig,
    for_wv_method,
)
from .converter import (  # noqa: F401
    code_width_lsb,
    compare_read,
    full_scale_lsb,
    sar_quantize,
    sar_read,
)
from .noise import (  # noqa: F401
    sample_read_fields,
    sample_token_read_noise,
)
from .readout import (  # noqa: F401
    ReadResult,
    decode_magnitude,
    decode_ternary,
    encode,
    read_columns,
    voted_signs,
)
from .cost import sweep_cost  # noqa: F401
from .calibrate import calibrate_offsets, sample_col_offsets  # noqa: F401
