"""repro_torch.backend — the typed lowering layer between optimized PQ-IR and
the kernels, on torch devices.

    PQ-IR ──► repro_torch.passes ──► repro_torch.core.compile (fusion)
                                              │ StepDrafts
                                              ▼
              repro_torch.backend.lowering ──► ExecutionPlan (slots, liveness)
                                              │
                                              ▼
              repro_torch.backend.registry ──► kernels
              ("ref": plain torch oracles; "cuda": hand-written CUDA kernels;
               "*": the generic torch op table)

The plan format, liveness planning, named-axis templates, per-bucket
specialization and the shared :class:`PlanCache` are those of ``repro``'s
backend; only the kernels and the tensors differ.  So are the measured
per-cell tile search (:mod:`.autotune`, ranked by the H100 cost model in
:mod:`.cost`) and the AOT plan artifacts (:mod:`.artifact`).
"""
from . import cost, fused, generic  # noqa: F401  (populate the registry on import)
from .autotune import (  # noqa: F401
    Autotuner,
    AutotuneCache,
    TuneJob,
    attention_candidates,
    measure_device_median,
    measure_median,
    seed_attention_candidates,
    seed_candidates,
    tile_candidates,
)
from .lowering import (  # noqa: F401
    StepDraft,
    build_plan,
    const_arg,
    none_arg,
    specialize_plan,
    tensor_arg,
)
from .plan import (  # noqa: F401
    Arg,
    ExecutionPlan,
    PlanCache,
    PlanStep,
    ValueInfo,
    batch_bucket,
    bindings_key,
    bucket_multiple,
    resolve_bucketing,
)
from .registry import UnknownKernelError, backends_for, kernel_ids, lookup, register  # noqa: F401

# last: artifact lazily imports repro_torch.core.compile, which imports this package
from .artifact import ARTIFACT_SCHEMA, load_artifact, save_artifact, sidecar_path  # noqa: F401,E402
