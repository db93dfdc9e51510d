from .synthetic import Batch, SyntheticLM  # noqa: F401
