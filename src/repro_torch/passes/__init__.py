"""repro.passes — PQ-IR graph-optimization pass pipeline.

The paper's co-design contract hands the hardware compiler a standard-ops-only
pre-quantized graph; this package is the *optimization pipeline* that sits
between that artifact and backend codegen, in the spirit of QNN-style
compiler lowerings (Jain et al.) and the pass-structured onnx-mlir flow.

Optimization pipeline
=====================

::

    PQ-IR artifact (repro.core.pqir.Model)
        │
        ▼
    ┌──────────────────────────────────────────────────────────────┐
    │ PassManager (repro.passes.manager)                           │
    │   1. const_fold      evaluate all-initializer nodes          │
    │   2. identity_elim   same-dtype Cast, ×1, +0, no-op shapes   │
    │   3. sink_shapes     Reshape/Transpose/Flatten past          │
    │                      elementwise ops                         │
    │   4. mul_fold        §3.1 quant_scale·2⁻ⁿ pair → one Mul     │
    │   5. add_fold        integer bias Add pairs → one Add        │
    │   6. qdq_cancel      Dequantize→Quantize round trips         │
    │   7. dead_code       unused nodes + initializers             │
    │   (sweeps repeat until a fixpoint, bounded by max_iterations)│
    └──────────────────────────────────────────────────────────────┘
        │                         │
        │                         └── conformance hook (verify=True):
        │                             re-run repro.core.runtime on probe
        ▼                             inputs after every changing pass —
    optimized PQ-IR                   bit-exact on integer outputs, else
        │                             ConformanceError names the pass
        ▼
    repro.core.compile — declarative fusion patterns (qlinear / qconv /
    int8-LUT) expressed on repro.passes.rewrite, lowered through the typed
    repro.backend ExecutionPlan (buffer slots + kernel registry) onto the
    JAX/Pallas kernels

Layout
======

* :mod:`repro.passes.analysis`     — graph-wide dtype/shape inference and
  def-use maps (:class:`GraphAnalysis`), shared by passes and the compiler.
* :mod:`repro.passes.rewrite`      — the declarative pattern-rewrite engine:
  a fusion/canonicalization candidate is an :class:`~rewrite.OpSpec` chain
  (:class:`~rewrite.Pattern`) matched along single-consumer edges.
* :mod:`repro.passes.canonicalize` — semantics-preserving cleanups
  (const_fold, qdq_cancel, mul_fold, identity_elim, dead_code).
* :mod:`repro.passes.sink`         — Reshape/Transpose sinking.
* :mod:`repro.passes.manager`      — :class:`PassManager`, per-pass stats
  (:class:`PipelineReport`), the conformance hook, :func:`optimize`.

Every pass is individually toggleable (``PassManager(disable=("mul_fold",))``)
and every rewrite is chosen so the transformed float arithmetic is
IEEE-identical — the pipeline's output is interchangeable with its input for
any conforming runtime.
"""
from .analysis import GraphAnalysis, clone_graph, clone_model, infer_dtypes, infer_shapes  # noqa: F401
from .canonicalize import AddFold, ConstantFold, DeadCode, IdentityElim, MulFold, Pass, QdqCancel  # noqa: F401
from .manager import (  # noqa: F401
    ConformanceError,
    PassManager,
    PipelineReport,
    default_passes,
    make_probe_feeds,
    optimize,
)
from .rewrite import Match, OpSpec, Pattern, match_chain  # noqa: F401
from .sink import SinkShapes  # noqa: F401
