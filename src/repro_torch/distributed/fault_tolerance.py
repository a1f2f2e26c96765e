"""Fault-tolerance runtime: preemption-safe checkpointing, elastic restart,
straggler detection.

Host-side machinery around the pure train step:

* ``CheckpointManager`` — periodic + on-signal (SIGTERM/SIGINT preemption
  notice) saves via :mod:`repro.checkpoint.ckpt`, keep-last-k GC.
* ``StragglerMonitor`` — per-step wall-time EWMA; steps slower than
  ``threshold ×`` the EWMA are logged and counted.  At fleet scale the same
  signal drives hot-spare substitution; here it feeds metrics + tests.
  Because the data pipeline is step-indexed and stateless, a replacement
  worker reproduces the same batch — re-issue is deterministic.
* ``run_resilient`` — restart loop: on crash, reload latest checkpoint and
  continue (optionally on a different mesh: elastic re-shard is a
  device_put at restore, see checkpoint/ckpt.py).
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Dict, List, Optional

from ..checkpoint import ckpt as ckptlib


@dataclasses.dataclass
class CheckpointManagerConfig:
    directory: str
    interval_steps: int = 100
    keep_last: int = 3


class CheckpointManager:
    def __init__(self, cfg: CheckpointManagerConfig, install_signal_handlers: bool = False) -> None:
        self.cfg = cfg
        self._preempted = False
        self._saved_steps: List[int] = []
        if install_signal_handlers:
            for sig in (signal.SIGTERM, signal.SIGINT):
                signal.signal(sig, self._on_signal)

    def _on_signal(self, signum, frame) -> None:
        # Preemption notice: request a save at the next step boundary.
        self._preempted = True

    @property
    def preempted(self) -> bool:
        return self._preempted

    def maybe_save(self, step: int, tree: Any, extra: Optional[dict] = None, *, force: bool = False) -> Optional[str]:
        due = force or self._preempted or (step > 0 and step % self.cfg.interval_steps == 0)
        if not due:
            return None
        path = ckptlib.save(self.cfg.directory, step, tree, extra)
        self._saved_steps.append(step)
        self._gc()
        return path

    def _gc(self) -> None:
        import os
        import shutil

        while len(self._saved_steps) > self.cfg.keep_last:
            old = self._saved_steps.pop(0)
            shutil.rmtree(os.path.join(self.cfg.directory, f"step_{old}"), ignore_errors=True)

    def restore(self, target_tree: Any, shardings: Any = None):
        return ckptlib.restore(self.cfg.directory, target_tree, shardings=shardings)

    def has_checkpoint(self) -> bool:
        return ckptlib.latest_step(self.cfg.directory) is not None


class StragglerMonitor:
    """EWMA-based step-time anomaly detector."""

    def __init__(self, threshold: float = 2.0, alpha: float = 0.1) -> None:
        self.threshold = threshold
        self.alpha = alpha
        self.ewma: Optional[float] = None
        self.slow_steps: List[int] = []
        self._t0: Optional[float] = None

    def start_step(self) -> None:
        self._t0 = time.monotonic()

    def end_step(self, step: int) -> Dict[str, float]:
        dt = time.monotonic() - self._t0
        is_slow = self.ewma is not None and dt > self.threshold * self.ewma
        if is_slow:
            self.slow_steps.append(step)
        # slow outliers do not poison the EWMA
        if self.ewma is None:
            self.ewma = dt
        elif not is_slow:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return {"step_time_s": dt, "step_time_ewma_s": self.ewma, "straggler": float(is_slow)}


def run_resilient(
    make_state: Callable[[], Any],
    step_fn: Callable[[Any, int], Any],
    *,
    manager: CheckpointManager,
    total_steps: int,
    max_restarts: int = 3,
    on_metrics: Optional[Callable[[int, Dict], None]] = None,
) -> Any:
    """Crash-tolerant training driver: resume-from-checkpoint restart loop.

    ``make_state()`` builds fresh (params, opt) state; ``step_fn(state, step)``
    returns the next state.  Any exception triggers restore-and-continue from
    the last checkpoint, up to ``max_restarts`` times.
    """
    restarts = 0
    state = make_state()
    start = 0
    if manager.has_checkpoint():
        state, start, _ = manager.restore(state)
        start += 1
    monitor = StragglerMonitor()
    step = start
    while step < total_steps:
        try:
            monitor.start_step()
            state = step_fn(state, step)
            metrics = monitor.end_step(step)
            if on_metrics:
                on_metrics(step, metrics)
            manager.maybe_save(step, state)
            if manager.preempted:
                manager.maybe_save(step, state, force=True)
                break
            step += 1
        except Exception:
            restarts += 1
            if restarts > max_restarts:
                raise
            if manager.has_checkpoint():
                state, saved_step, _ = manager.restore(make_state())
                step = saved_step + 1
            else:
                state = make_state()
                step = 0
    return state
