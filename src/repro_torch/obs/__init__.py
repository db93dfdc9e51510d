# Telemetry of the port: so far only the host-side counter registry and
# the counted device->host fetch (`obs.metrics`).
from . import metrics  # noqa: F401
from .metrics import registry  # noqa: F401
