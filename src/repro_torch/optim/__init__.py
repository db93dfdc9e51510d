from .adamw import AdamWConfig, AdamWState, adamw_init, adamw_update  # noqa: F401
from .schedule import cosine_schedule  # noqa: F401
