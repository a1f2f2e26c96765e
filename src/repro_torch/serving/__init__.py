"""repro_torch.serving — the compiled token path and its serving engine."""
from .engine import EngineConfig, Request, ServeEngine, sample_token  # noqa: F401
