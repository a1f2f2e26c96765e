"""launches_per_decode_step: Device kernels in an engine cycle that admitted nothing: the decode
step's launches (``backend/plan.py`` ``ExecutionPlan.execute``), from the
profiler's trace, median over such cycles."""
from harness import readers


def read(ctx):
    return readers.kernels_per_quiet_cycle(ctx)
