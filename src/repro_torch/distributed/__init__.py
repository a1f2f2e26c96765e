"""repro_torch.distributed — the fault-tolerance runtime (preemption-safe
checkpointing, the resilient restart loop, straggler detection) over the
port's checkpoints, and the logical-axis sharding rules (the identity on
one card)."""
from . import fault_tolerance, sharding  # noqa: F401
from .fault_tolerance import (  # noqa: F401
    CheckpointManager,
    CheckpointManagerConfig,
    StragglerMonitor,
    run_resilient,
)
from .sharding import shard, use_mesh  # noqa: F401
