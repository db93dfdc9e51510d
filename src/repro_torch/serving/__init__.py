# Serving in the port: prefill/decode steps and the fixed-batch generate
# loop (`engine`), and continuous batching over a request stream
# (`scheduler`), digital or through a CIM executor's analog tiles.
from .engine import (  # noqa: F401
    ServeEngine,
    make_decode_step,
    make_prefill_chunk_step,
    make_prefill_step,
)
from .scheduler import (  # noqa: F401
    ADMISSION_POLICIES,
    ContinuousScheduler,
    Request,
    RequestRecord,
    admission_key,
    poisson_requests,
    select_next,
)
