from . import ops, ref  # noqa: F401
from .ops import fwht  # noqa: F401
