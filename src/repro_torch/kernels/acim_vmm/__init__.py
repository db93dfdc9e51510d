from . import ops, ref  # noqa: F401
from .ops import acim_vmm, acim_vmm_tiled  # noqa: F401
