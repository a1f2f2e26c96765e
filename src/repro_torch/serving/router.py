"""Sharded replica router: N compiled-model servers behind one front door.

One process, one :class:`~repro_torch.serving.compiled.CompiledModelServer`,
one plan cache serves one replica.  At fleet scale the same AOT artifact
(:mod:`repro_torch.backend.artifact`) warm-starts *N* replicas, and the routing
decision becomes part of the co-design story:

* **Cell affinity** — the scenario-cell grid (batch bucket × seq bucket)
  that bounds specializations in one server also shards traffic across
  servers.  A request's per-request-knowable half of its cell (the sequence
  bucket; batch buckets only emerge at coalescing time) maps *stickily* to
  one replica, so each replica sees a narrow slice of the grid and its
  :class:`~repro_torch.backend.plan.PlanCache` and background autotuner stay hot
  — per-replica hit rates match or beat the single-server baseline instead
  of dividing by N.  New cells go to the replica owning the fewest cells
  (ties to the lowest index); unhealthy replicas are skipped.
* **Health + failure containment** — per-replica consecutive-failure
  counters (a replica is unhealthy at ``failure_threshold``) plus the
  distributed layer's :class:`~repro_torch.distributed.fault_tolerance.
  StragglerMonitor` for step-time anomaly detection (an EWMA-slow replica
  is surfaced in :meth:`ShardedRouter.health`, feeding the same eviction
  decision a fleet scheduler would make).
* **In-order re-queue** — a replica whose ``step()`` raises keeps its batch
  (its server re-queues at the head, original order); the router then
  migrates that replica's entire queue, order preserved, onto a healthy
  replica and re-points the failed replica's cells.  Requests keep their
  fleet-unique uids and their open ``serve.request`` spans — nothing is
  lost, nothing served twice (:meth:`ShardedRouter.summary` carries the uid
  accounting to prove it).
* **One obs plane** — all replicas publish into one shared
  :class:`~repro_torch.obs.metrics.MetricsRegistry` (counters and latency
  histograms aggregate fleet-wide; per-replica state is read live from each
  server), and every replica's spans carry a ``replica=`` attribute.

The port keeps ``repro``'s routing logic as it is.  One difference:
:meth:`ShardedRouter.from_artifact` takes ``device=`` (None means the CUDA
card, as at every entry point of the port), and each replica loads its own
copy of the plan's constants onto it.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..distributed.fault_tolerance import StragglerMonitor
from ..obs import trace as _trace
from ..obs.metrics import MetricsRegistry
from .compiled import CompiledModelServer, CompiledRequest, CompiledServerConfig

__all__ = ["RouterConfig", "RoutedRequest", "ShardedRouter"]

#: uid stride between replicas: replica i issues uids in
#: [i*stride, (i+1)*stride) — fleet-unique without a shared counter.
UID_STRIDE = 1_000_000_000


@dataclasses.dataclass
class RouterConfig:
    #: consecutive step failures after which a replica is marked unhealthy
    #: and its cells re-pointed (a success resets the count)
    failure_threshold: int = 3
    #: StragglerMonitor threshold: a step slower than this multiple of the
    #: replica's EWMA step time is recorded as a straggler step
    straggler_threshold: float = 2.0

    def __post_init__(self) -> None:
        if self.failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {self.failure_threshold}"
            )


@dataclasses.dataclass
class RoutedRequest:
    """A request as the router sees it: the replica-owned
    :class:`CompiledRequest` plus fleet-level routing state."""

    uid: int  # fleet-unique (replica uid spaces are strided)
    cell: Tuple  # the affinity key it was routed on
    replica: str  # current owner (updated if the batch migrates)
    inner: CompiledRequest
    rerouted: int = 0  # times this request migrated off a failed replica

    @property
    def done(self) -> bool:
        return self.inner.done

    @property
    def outputs(self):
        return self.inner.outputs

    @property
    def latency_s(self) -> Optional[float]:
        return self.inner.latency_s


@dataclasses.dataclass
class _Replica:
    name: str
    server: CompiledModelServer
    monitor: StragglerMonitor
    failures: int = 0  # consecutive step failures
    healthy: bool = True
    steps: int = 0


class ShardedRouter:
    """Cell-affinity front door over N warm-started server replicas."""

    def __init__(
        self,
        servers: List[CompiledModelServer],
        *,
        registry: Optional[MetricsRegistry] = None,
        cfg: Optional[RouterConfig] = None,
    ) -> None:
        if not servers:
            raise ValueError("a router needs at least one replica server")
        self.cfg = cfg if cfg is not None else RouterConfig()
        self.registry = registry if registry is not None else MetricsRegistry()
        self.replicas: List[_Replica] = []
        for i, srv in enumerate(servers):
            name = srv.name or f"r{i}"
            srv.name = name
            self.replicas.append(
                _Replica(
                    name=name,
                    server=srv,
                    monitor=StragglerMonitor(threshold=self.cfg.straggler_threshold),
                )
            )
        if len({r.name for r in self.replicas}) != len(self.replicas):
            raise ValueError("replica names must be unique")
        seq_axes = {r.server.seq_axis for r in self.replicas}
        if len(seq_axes) != 1:
            raise ValueError(
                "all replicas must serve the same artifact shape "
                f"(got mixed sequence axes {sorted(map(str, seq_axes))})"
            )
        self._seq_axis = seq_axes.pop()
        #: sticky cell → replica-index map (the affinity table)
        self._cell_owner: Dict[Tuple, int] = {}
        self._inflight: Dict[int, RoutedRequest] = {}
        self._done_uids: set = set()
        self.metrics = {
            "requests": 0,
            "completed": 0,
            "duplicates": 0,  # uid seen completed more than once (must stay 0)
            "rerouted": 0,  # requests migrated off a failed replica
            "failovers": 0,  # replica step failures handled
        }

    # -- construction ---------------------------------------------------------
    @classmethod
    def from_artifact(
        cls,
        path: str,
        replicas: int = 3,
        *,
        server_cfg: Optional[CompiledServerConfig] = None,
        registry: Optional[MetricsRegistry] = None,
        cfg: Optional[RouterConfig] = None,
        warm: bool = True,
        autotuner_factory: Optional[Callable[[], Any]] = None,
        device=None,
    ) -> "ShardedRouter":
        """N replicas warm-started from one AOT artifact: each gets its own
        :func:`~repro_torch.backend.artifact.load_artifact` on ``device``
        (None means the CUDA card; own plan cache, pre-seeded with the
        recorded hot cells; ``warm=True`` also runs each cell once, so the
        kernels are built and loaded), all sharing one metrics registry.
        ``autotuner_factory`` builds one background tuner per replica (a
        tuner holds per-cell session state, so replicas must not share
        one).

        Each replica holds its own copy of the plan's device tensors (the
        padded, packed weights, biases and scales; specializations share
        them): N replicas on one card hold N copies.  For ``chip_smoke.py``'s
        fleet FFN (2048 → 6144 w8 → 2048 w4, per-channel) that is
        18,972,672 bytes a replica."""
        from ..backend.artifact import load_artifact

        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        registry = registry if registry is not None else MetricsRegistry()
        servers = []
        for i in range(replicas):
            cm = load_artifact(
                path,
                device=device,
                warm=warm,
                autotuner=autotuner_factory() if autotuner_factory else None,
            )
            servers.append(
                CompiledModelServer(
                    cm,
                    server_cfg,
                    registry=registry,
                    name=f"r{i}",
                    uid_start=i * UID_STRIDE,
                )
            )
        return cls(servers, registry=registry, cfg=cfg)

    # -- routing --------------------------------------------------------------
    def _cell_of(self, x) -> Tuple:
        """The per-request-knowable half of the scenario cell: the sequence
        bucket for two-axis artifacts, or the empty cell (batch-only — the
        batch bucket only exists once a batch is coalesced).  ``x`` is one
        request's example — a dict of per-input examples or the bare-ndarray
        single-input sugar — and any seq-carrying input yields the extent
        (the server validates cross-input consistency at submit)."""
        srv = self.replicas[0].server
        if self._seq_axis is None:
            return ()
        in_name, pos = next(iter(srv._seq_pos.items()))
        ex = x[in_name] if isinstance(x, dict) else x
        extent = int(np.asarray(ex).shape[pos])
        return (self._seq_axis, srv.cm.bucket_for(self._seq_axis, extent))

    def _healthy(self) -> List[_Replica]:
        live = [r for r in self.replicas if r.healthy]
        if not live:
            raise RuntimeError(
                "no healthy replica left "
                f"(all {len(self.replicas)} exceeded the failure threshold)"
            )
        return live

    def _owner_of(self, cell: Tuple) -> _Replica:
        idx = self._cell_owner.get(cell)
        if idx is not None and self.replicas[idx].healthy:
            return self.replicas[idx]
        live = self._healthy()
        if len(live) == 1:
            chosen = live[0]
        else:
            # least-loaded by owned-cell count, ties to the lowest index —
            # deterministic, and it spreads distinct cells across replicas
            owned = {i: 0 for i, r in enumerate(self.replicas) if r.healthy}
            for o in self._cell_owner.values():
                if o in owned:
                    owned[o] += 1
            chosen_i = min(owned, key=lambda i: (owned[i], i))
            chosen = self.replicas[chosen_i]
        self._cell_owner[cell] = self.replicas.index(chosen)
        return chosen

    def submit(self, x) -> RoutedRequest:
        """Route one request (dict of per-input examples, or the bare-ndarray
        single-input sugar) to its cell's replica; returns the fleet-level
        request handle (``outputs`` fill on completion, like the server's)."""
        cell = self._cell_of(x)
        rep = self._owner_of(cell)
        inner = rep.server.submit(x)
        rr = RoutedRequest(uid=inner.uid, cell=cell, replica=rep.name, inner=inner)
        self._inflight[rr.uid] = rr
        self._count("requests")
        return rr

    def _count(self, key: str, n: int = 1) -> None:
        self.metrics[key] += n
        self.registry.counter(f"fleet.{key}").inc(n)

    # -- stepping + failover --------------------------------------------------
    def step(self) -> List[RoutedRequest]:
        """One fleet cycle: step every healthy replica that has queued work.
        A replica failure is contained here — its batch (already re-queued
        in order by the server) and the rest of its queue migrate to a
        healthy replica, and the request handles keep working."""
        completed: List[RoutedRequest] = []
        for rep in self.replicas:
            if not rep.healthy or not rep.server.queue:
                continue
            rep.monitor.start_step()
            try:
                done = rep.server.step()
            except Exception:
                self._on_failure(rep)
                continue
            rep.monitor.end_step(rep.steps)
            rep.steps += 1
            rep.failures = 0
            completed.extend(self._finish(done))
        return completed

    def _finish(self, done: List[CompiledRequest]) -> List[RoutedRequest]:
        out = []
        for req in done:
            rr = self._inflight.pop(req.uid, None)
            if rr is None:
                if req.uid in self._done_uids:
                    # a routed request served twice would resurface here with
                    # no inflight entry — surfaced, never silently dropped
                    self._count("duplicates")
                continue  # else: submitted directly to the server, not via us
            self._done_uids.add(rr.uid)
            self._count("completed")
            out.append(rr)
        return out

    def _on_failure(self, rep: _Replica) -> None:
        rep.failures += 1
        self._count("failovers")
        self.registry.counter(f"fleet.failures.{rep.name}").inc()
        if rep.failures >= self.cfg.failure_threshold:
            rep.healthy = False
        if _trace.enabled:
            _trace.event(
                "fleet.failover", replica=rep.name,
                failures=rep.failures, healthy=rep.healthy,
            )
        # the failed batch is back at the head of rep's queue in original
        # order; migrate the whole queue onto one healthy replica, preserving
        # order, and re-point the failed replica's cells
        targets = [r for r in self.replicas if r.healthy and r is not rep]
        if not targets:
            if not rep.healthy:
                raise RuntimeError(
                    f"replica {rep.name} failed with no healthy replica to "
                    "take its queue"
                )
            return  # still healthy below the threshold: it keeps its queue
        target = targets[0]
        moved = list(rep.server.queue)
        rep.server.queue.clear()
        target.server.queue.extend(moved)  # order preserved, appended in turn
        for req in moved:
            rr = self._inflight.get(req.uid)
            if rr is not None:
                rr.replica = target.name
                rr.rerouted += 1
                self._count("rerouted")
        if not rep.healthy:
            rep_i = self.replicas.index(rep)
            target_i = self.replicas.index(target)
            for cell, owner in list(self._cell_owner.items()):
                if owner == rep_i:
                    self._cell_owner[cell] = target_i

    def run_until_drained(self, max_cycles: int = 10_000) -> List[RoutedRequest]:
        done: List[RoutedRequest] = []
        for _ in range(max_cycles):
            if not any(r.server.queue for r in self.replicas):
                return done
            done.extend(self.step())
        raise RuntimeError("fleet serve loop did not drain")

    # -- reporting ------------------------------------------------------------
    def health(self) -> Dict[str, Dict[str, Any]]:
        """Live per-replica health: failure counters, straggler detection,
        queue depth."""
        return {
            r.name: {
                "healthy": r.healthy,
                "failures": r.failures,
                "steps": r.steps,
                "queue": len(r.server.queue),
                "straggler_steps": list(r.monitor.slow_steps),
                "step_time_ewma_s": r.monitor.ewma,
            }
            for r in self.replicas
        }

    def summary(self) -> Dict[str, Any]:
        """Fleet-wide aggregation: uid accounting (every submitted request is
        completed, pending, or still queued — never lost, never duplicated),
        per-replica summaries, the affinity table, and the shared registry's
        snapshot."""
        pending = len(self._inflight)
        per_replica = {r.name: r.server.summary() for r in self.replicas}
        hit_rates = {
            name: s["plan_cache_hit_rate"] for name, s in per_replica.items()
        }
        cells = {
            (f"{cell[0]}={cell[1]}" if cell else "*"): self.replicas[i].name
            for cell, i in sorted(self._cell_owner.items())
        }
        return {
            "replicas": per_replica,
            "health": self.health(),
            "requests": self.metrics["requests"],
            "completed": self.metrics["completed"],
            "pending": pending,
            "lost": self.metrics["requests"] - self.metrics["completed"] - pending,
            "duplicates": self.metrics["duplicates"],
            "rerouted": self.metrics["rerouted"],
            "failovers": self.metrics["failovers"],
            "plan_cache_hit_rates": hit_rates,
            "cell_owners": cells,
            "registry": self.registry.snapshot(),
        }
