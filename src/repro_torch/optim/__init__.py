from . import adamw, grad_compress, schedule  # noqa: F401
