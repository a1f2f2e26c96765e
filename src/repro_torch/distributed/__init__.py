"""repro_torch.distributed — the fault-tolerance runtime (preemption-safe
checkpointing, the resilient restart loop, straggler detection) over the
port's checkpoints.  ``repro``'s sharding module is not ported yet."""
from . import fault_tolerance  # noqa: F401
from .fault_tolerance import (  # noqa: F401
    CheckpointManager,
    CheckpointManagerConfig,
    StragglerMonitor,
    run_resilient,
)
