from . import ckpt  # noqa: F401
