"""Backend kernel registry: kernel-id → per-backend implementations.

Kernel *selection* is data, not code: a :class:`~repro_torch.backend.plan.PlanStep`
declares a kernel id (``"qlinear_matmul"``, ``"op.Relu"``, …) and the plan
interpreter resolves the implementation for the plan's backend here.  Adding a
backend means registering implementations — no conditionals inside the
compiler or the executor.

An implementation has the uniform signature::

    impl(step: PlanStep, args: List[Optional[torch.Tensor]]) -> List[torch.Tensor]

where ``args`` are the step's operands in declared order (slot values and
baked constants already resolved; ``None`` for absent optional operands) and
``step.params`` / ``step.consts`` carry the compile-time-specialized state
(static attributes, chosen tile sizes, pre-padded parameter tensors).

Registration is keyed by ``(backend, kernel_id)``.  The pseudo-backend
``"*"`` is the shared fallback: :func:`lookup` first tries the exact backend,
then ``"*"`` — so the generic torch op table registers once for every
backend while the fused kernels provide ``ref`` / ``cuda`` specializations.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

#: (backend, kernel_id) → implementation.
_REGISTRY: Dict[Tuple[str, str], Callable] = {}

#: The shared-fallback pseudo-backend.
ANY_BACKEND = "*"


class UnknownKernelError(KeyError):
    """No implementation registered for (backend, kernel id)."""


def register(kernel_id: str, backend: str = ANY_BACKEND) -> Callable:
    """Decorator: register ``fn`` as the ``kernel_id`` implementation for
    ``backend`` (``"*"`` = shared across all backends)."""

    def deco(fn: Callable) -> Callable:
        _REGISTRY[(backend, kernel_id)] = fn
        return fn

    return deco


def lookup(backend: str, kernel_id: str) -> Callable:
    """Resolve the implementation for ``kernel_id`` on ``backend`` (falling
    back to the shared ``"*"`` registration)."""
    fn = _REGISTRY.get((backend, kernel_id)) or _REGISTRY.get((ANY_BACKEND, kernel_id))
    if fn is None:
        raise UnknownKernelError(
            f"no kernel {kernel_id!r} registered for backend {backend!r} "
            f"(known: {sorted(kernel_ids())})"
        )
    return fn


def kernel_ids() -> List[str]:
    """All registered kernel ids (across every backend)."""
    return sorted({kid for _, kid in _REGISTRY})


def backends_for(kernel_id: str) -> List[str]:
    """Backends providing ``kernel_id`` (``"*"`` = shared fallback)."""
    return sorted(b for b, kid in _REGISTRY if kid == kernel_id)
