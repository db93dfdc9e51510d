from . import ops, ref  # noqa: F401
from .ops import wv_cell_update  # noqa: F401
