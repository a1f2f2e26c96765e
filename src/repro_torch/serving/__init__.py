"""repro_torch.serving — the compiled token path and its serving engine,
and the micro-batching server for compiled artifacts."""
from .compiled import CompiledModelServer, CompiledRequest, CompiledServerConfig  # noqa: F401
from .engine import EngineConfig, Request, ServeEngine, sample_token  # noqa: F401
