from .pipeline import DataConfig, Pipeline  # noqa: F401
