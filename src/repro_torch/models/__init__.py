from .config import ModelConfig  # noqa: F401
from .transformer import init_params  # noqa: F401
