"""repro_torch.serving — the compiled token path and its serving engine,
the micro-batching server for compiled artifacts, and the sharded replica
router in front of N such servers."""
from .compiled import CompiledModelServer, CompiledRequest, CompiledServerConfig  # noqa: F401
from .engine import EngineConfig, Request, ServeEngine, sample_token  # noqa: F401
from .router import RoutedRequest, RouterConfig, ShardedRouter  # noqa: F401
