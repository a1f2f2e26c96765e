"""Measured per-cell tile autotuning for the port's fused kernels.

The port of ``repro.backend.autotune``.  The kernels' tilings are planned by
fixed heuristics — the qmatmul row tile ``bm`` and its K splits
(:func:`repro_torch.kernels.qmatmul.choose_bm` / ``choose_splits``), the
qattention cluster size (:func:`repro_torch.kernels.qattention.
choose_cluster`) — and this module measures them against the alternatives
the kernels accept, per scenario cell:

* **Search space** — the CUDA kernels' lattice.  A qmatmul candidate is
  ``(bm, splits)``: ``bm`` in ``SUPPORTED_BM`` (16, and 64 once M has more
  than 16 rows), ``1 <= splits <= kp // BK``; ``BK``/``BN`` are compiled
  into the kernel, so they are not searched (:func:`tile_candidates`,
  validated by :func:`repro_torch.kernels.ops.with_tiles`).  An attention
  candidate is a cluster size ``C`` that
  :func:`repro_torch.kernels.qattention.check_cluster` accepts for the
  record's T and dh (:func:`attention_candidates`).
* **Cost-model seeding** — the heuristic tiling is always candidate #0;
  the rest of the qmatmul lattice is ranked by the analytic cost
  (:mod:`repro_torch.backend.cost`), the other cluster sizes follow in
  ascending order, and the list is cut to ``budget`` candidates.
* **Measurement** — each candidate runs the real planned kernel on the
  plan's CUDA device: :func:`repro_torch.kernels.ops.quantized_matmul_planned`
  with the step's consts (a folded LUT epilogue included), or
  :func:`repro_torch.kernels.qattention.qattention` with the step's LUT, on
  int8 activations made from ``seed`` (attention's q, k and v as the token
  path hands them over: per-head views of the qkv projection's rows, and
  at decode of the KV cache's, for :data:`VIEW_HEADS` heads; a causal mask
  at prefill).  It is timed with CUDA events, each
  timed launch after a :data:`FLUSH_BYTES` overwrite of device memory (a
  decode layer meets its weights cold on the served path, so a warm-L2
  ranking would favour the wrong tiles), as the median of ``repeat``
  launches after ``warmup``.  A plan on the CPU has no kernel to time: with
  no injected ``measure_fn`` its measurement raises ``ValueError``.
  Timings route through the obs plane: one ``backend.autotune`` span per
  tuned (cell × step) with ``autotune.candidate`` children, and the
  ``autotune.*`` registry counters.
* **Persistence** — winners land in an on-disk JSON :class:`AutotuneCache`
  (schema ``repro_torch-autotune-v1``) keyed by ``(step, backend, cell,
  shape)``, with the measured evidence and the card's name.  A second
  process on the same file specializes every known cell with **zero**
  measurements.
* **Integration** — :func:`repro_torch.backend.lowering.specialize_plan`
  takes ``tuner=``; each fused step's provenance tile record is tagged with
  its source (heuristic untagged, ``[tuned]`` / ``[cache]`` otherwise).
  :class:`repro_torch.serving.compiled.CompiledModelServer` drives the
  search between batches through :class:`TuneJob`.

Determinism for tests: inject ``measure_fn`` (e.g. the cost model) and the
whole search — winners, provenance tags, cache files — is reproducible.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.cache import PersistentJsonStore
from ..kernels import ops as kops
from ..kernels import qattention as _qatt
from ..kernels import qmatmul as _qmm
from ..obs import trace as _trace
from ..obs.metrics import MetricsRegistry, default_registry
from . import cost
from .generic import TORCH_DTYPES

#: A qmatmul tiling ``(bm, splits)``, or an attention one ``(cluster,)``.
Tiles = Tuple[int, ...]

#: measure_fn contract: (step, bound shape record, backend) -> seconds.
MeasureFn = Callable[[Any, Dict[str, Any], str], float]

CACHE_SCHEMA = "repro_torch-autotune-v1"

#: Device memory overwritten before each timed launch: more than the
#: H100's 50 MB L2, so the launch reads its operands from HBM.
FLUSH_BYTES = 64 << 20
#: Cycles the card spins before each timed launch (about half a
#: millisecond), so the host has queued the launch before the start event
#: fires and the time is the device's, not the wrapper's Python.
SPIN_CYCLES = 1_000_000
#: Heads in the rows that attention's q, k and v are timed as views of:
#: the token path's layout at Qwen3-1.7B widths, where each head's q (and
#: at prefill its k and v) is a slice of a qkv row of 3 · dh · heads bytes,
#: and at decode its k and v are slices of KV-cache rows of dh · heads.
VIEW_HEADS = 16


# ---------------------------------------------------------------------------
# stable timing helpers
# ---------------------------------------------------------------------------

def _median(samples: List[float]) -> float:
    samples = sorted(samples)
    mid = len(samples) // 2
    if len(samples) % 2:
        return samples[mid]
    return 0.5 * (samples[mid - 1] + samples[mid])


def measure_median(fn: Callable[[], Any], *, repeat: int = 5, warmup: int = 2) -> float:
    """Median-of-``repeat`` host wall time of ``fn()`` in seconds, after
    ``warmup`` discarded calls.  The median — not the mean — so one
    scheduler blip lands in one sample and cannot move the result."""
    if repeat < 1:
        raise ValueError(f"repeat must be >= 1, got {repeat}")
    for _ in range(warmup):
        fn()
    samples = []
    for _ in range(repeat):
        t0 = time.perf_counter()
        fn()
        samples.append(time.perf_counter() - t0)
    return _median(samples)


def measure_device_median(
    fn: Callable[[], Any], flush: torch.Tensor, *, repeat: int = 5, warmup: int = 2
) -> float:
    """Median device time (seconds) of ``fn()`` on the current CUDA stream
    over ``repeat`` launches after ``warmup``, each timed launch between two
    CUDA events, after ``flush`` was overwritten (cold L2) and the card
    spun :data:`SPIN_CYCLES` (the launch is queued before the start event)."""
    if repeat < 1:
        raise ValueError(f"repeat must be >= 1, got {repeat}")
    for _ in range(warmup):
        fn()
    samples = []
    for _ in range(repeat):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / 1e3)
    return _median(samples)


def _int8(rng: np.random.Generator, device: torch.device, shape) -> torch.Tensor:
    return torch.from_numpy(rng.integers(-127, 128, size=shape, dtype=np.int8)).to(device)


# ---------------------------------------------------------------------------
# search space
# ---------------------------------------------------------------------------

def is_attention_shape(shape: Dict[str, Any]) -> bool:
    """True for a fused-attention shape record (``{b, s, t, dh, cluster}``)
    as opposed to a qmatmul record (``{m, k, n, kp, np, ...}``)."""
    return "dh" in shape and "t" in shape and "m" not in shape


def attention_candidates(t: int, dh: int) -> List[int]:
    """The cluster sizes the kernel takes for a row of ``t`` keys at width
    ``dh``: those :func:`repro_torch.kernels.qattention.check_cluster`
    accepts (which holds the row within the cluster's shared memory)."""
    out = []
    for c in _qatt.CLUSTER_SIZES:
        try:
            out.append(_qatt.check_cluster(t, dh, c))
        except ValueError:
            continue
    return out


def seed_attention_candidates(shape: Dict[str, Any], *, budget: int) -> List[int]:
    """Measurement list for one bound attention record: the heuristic
    cluster size first, then the other legal sizes in ascending order, cut
    to ``budget`` (at most five sizes: the default budget times them all)."""
    heuristic = int(shape["cluster"])
    rest = [c for c in attention_candidates(int(shape["t"]), int(shape["dh"])) if c != heuristic]
    return [heuristic] + rest[: max(0, budget - 1)]


def tile_candidates(m: int, kp: int) -> List[Tiles]:
    """Every legal ``(bm, splits)`` of a bound qmatmul cell: ``bm`` in the
    kernel's ``SUPPORTED_BM`` — 64 only once M has more than 16 rows (a
    64-row block over at most 16 rows computes 4× the rows it needs) —
    and ``1 <= splits <= kp // BK`` (each split holds whole K stages)."""
    out: List[Tiles] = []
    for bm in _qmm.SUPPORTED_BM:
        if bm > _qmm.SUPPORTED_BM[0] and int(m) <= _qmm.SUPPORTED_BM[0]:
            continue
        out.extend((bm, splits) for splits in range(1, kp // _qmm.BK + 1))
    return out


def seed_candidates(shape: Dict[str, Any], *, budget: int) -> List[Tiles]:
    """The measurement list for one bound qmatmul record: the heuristic
    ``(bm, splits)`` first (always measured, so a search can only add
    information), then the rest of the lattice ranked by the analytic cost,
    cut to ``budget`` in all.  The record's ``bits`` (4 ⇒ packed weights)
    feeds the cost model, so int4 cells rank on their halved weight bytes."""
    m, k, n = int(shape["m"]), int(shape["k"]), int(shape["n"])
    kp, np_ = int(shape["kp"]), int(shape["np"])
    bits = int(shape.get("bits", 8))
    heuristic: Tiles = (int(shape["bm"]), int(shape["splits"]))
    rest = [c for c in tile_candidates(m, kp) if c != heuristic]
    rest.sort(key=lambda c: (cost.qmatmul_tile_cost(m, k, n, kp, np_, *c, weight_bits=bits), c))
    return [heuristic] + rest[: max(0, budget - 1)]


# ---------------------------------------------------------------------------
# persistent tile cache (the co-design artifact)
# ---------------------------------------------------------------------------

class AutotuneCache:
    """On-disk tuned-tile store: ``{"schema": "repro_torch-autotune-v1",
    "entries": {<key>: {...}}}`` via
    :class:`repro_torch.core.cache.PersistentJsonStore`.

    Keys are ``<step>|<backend>|<cell>|<shape key>`` — e.g. ::

        fc0_matmul|cuda|N=8|m=8,k=256,n=256,kp=256,np=256

    and each entry records the winning tiling (``bm``/``splits``, or
    ``cluster``) with its evidence: the ``heuristic`` tiling, ``best_us``,
    ``heuristic_us``, ``measured``, every candidate's µs and the ``device``
    that measured it (the card's name, or ``measure_fn`` for an injected
    oracle)."""

    def __init__(self, path: str) -> None:
        self.store = PersistentJsonStore(path, schema=CACHE_SCHEMA)

    @property
    def path(self) -> str:
        return self.store.path

    def get(self, key: str) -> Optional[Dict[str, Any]]:
        return self.store.get(key)

    def put(self, key: str, entry: Dict[str, Any]) -> None:
        self.store.put(key, entry)

    def __len__(self) -> int:
        return len(self.store)

    def __contains__(self, key: str) -> bool:
        return key in self.store


def cell_key(bindings: Dict[str, int]) -> str:
    """Deterministic cell rendering: sorted ``axis=bucket`` pairs."""
    return ",".join(f"{a}={v}" for a, v in sorted(bindings.items()))


def shape_key(shape: Dict[str, Any]) -> str:
    """Deterministic problem-shape rendering (tiles excluded: they are the
    search's output, not its identity).  The weight bitwidth is identity
    (an int4 cell runs the packed lane on half the weight bytes) and is
    appended only when sub-8."""
    if is_attention_shape(shape):
        return ",".join(f"{f}={int(shape[f])}" for f in ("b", "s", "t", "dh"))
    key = ",".join(f"{f}={int(shape[f])}" for f in ("m", "k", "n", "kp", "np"))
    if shape.get("bits", 8) != 8:
        key += f",bits={int(shape['bits'])}"
    return key


def _tiles_label(tiles: Tiles) -> str:
    if len(tiles) == 1:
        return f"cluster={tiles[0]}"
    return f"bm={tiles[0]},splits={tiles[1]}"


# ---------------------------------------------------------------------------
# the tuner
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Resolution:
    """What the tuner knows about one (step × cell): a tiling override
    (None ⇒ the heuristic stands) and where it came from."""

    tiles: Optional[Tiles]
    source: str  # "heuristic" | "tuned" | "cache"


class Autotuner:
    """Budgeted measured tile search, cached per (step, backend, cell, shape).

    One tuner is one *measurement session*: what it resolved is remembered
    in-process (re-specializing an evicted cell measures nothing), and with
    a ``cache`` path it persists to the on-disk :class:`AutotuneCache`, so
    the *next* session warm-starts with zero measurements.
    ``measurements`` counts every candidate actually timed.

    ``measure_fn`` injects the timing oracle (the CPU tests pass the
    analytic cost model); the default times the real planned kernel on the
    card (see the module docstring) and refuses a plan on the CPU.
    """

    def __init__(
        self,
        *,
        budget: int = 8,
        repeat: int = 5,
        warmup: int = 2,
        cache: Optional[Any] = None,  # AutotuneCache | path | None
        measure_fn: Optional[MeasureFn] = None,
        seed: int = 0,
        registry: Optional[MetricsRegistry] = None,
    ) -> None:
        if budget < 1:
            raise ValueError(f"budget must be >= 1, got {budget}")
        self.budget = budget
        self.repeat = repeat
        self.warmup = warmup
        if cache is None or isinstance(cache, AutotuneCache):
            self.cache = cache
        else:
            self.cache = AutotuneCache(str(cache))
        self.measure_fn = measure_fn
        self.seed = seed
        self.registry = registry if registry is not None else default_registry()
        self.measurements = 0  # candidates actually timed this session
        self.device_name: Optional[str] = None  # the card the last real measurement ran on
        self._session: Dict[str, _Resolution] = {}
        self._flush: Dict[torch.device, torch.Tensor] = {}
        # the synthetic activations, made once per (device, problem shape)
        self._inputs: Dict[Tuple[Any, ...], Tuple[torch.Tensor, ...]] = {}

    # -- identity ------------------------------------------------------------
    def key_for(self, step, shape: Dict[str, Any], backend: str, bindings: Dict[str, int]) -> str:
        return "|".join(
            [step.name or step.kernel, backend, cell_key(bindings), shape_key(shape)]
        )

    @staticmethod
    def tunable(shape: Dict[str, Any], backend: str) -> bool:
        """Only cells with a known flat M on the ``cuda`` backend are
        searchable: the ref oracle has no tiles, and an unknown M has no
        fixed cost."""
        return backend != "ref" and shape.get("m") is not None

    # -- resolution (what specialize_plan calls) ----------------------------
    def tune_step(
        self, step, shape: Dict[str, Any], *, backend: str, bindings: Dict[str, int]
    ) -> Tuple[Dict[str, Any], str]:
        """Resolve one bound step's tiling: session → disk cache → measured
        search (blocking).  Returns the (possibly re-tiled) shape record and
        its source tag."""
        attention = is_attention_shape(shape)
        if backend == "ref" or not (attention or self.tunable(shape, backend)):
            return shape, "heuristic"
        key = self.key_for(step, shape, backend, bindings)
        res = self._resolve_cached(key, attention)
        if res is None:
            cands = self._search_list(shape)
            if len(cands) <= 1:
                # the lattice collapsed to the heuristic: nothing to measure
                res = self._session[key] = _Resolution(None, "heuristic")
            else:
                with _trace.span(
                    "backend.autotune",
                    step=step.name or step.kernel,
                    cell=cell_key(bindings),
                    candidates=len(cands),
                ) as sp:
                    timings = {c: self.measure_candidate(step, shape, backend, c) for c in cands}
                    res = self.finish(key, shape, cands[0], timings)
                    sp.set(tiles=_tiles_label(res.tiles))
        return self._apply(shape, res), res.source

    def _resolve_cached(self, key: str, attention: bool = False) -> Optional[_Resolution]:
        res = self._session.get(key)
        if res is not None:
            return res
        if self.cache is not None:
            entry = self.cache.get(key)
            if entry is not None:
                self.registry.counter("autotune.cache_hits").inc()
                tiles = ((int(entry["cluster"]),) if attention
                         else (int(entry["bm"]), int(entry["splits"])))
                res = self._session[key] = _Resolution(tiles, "cache")
                return res
            self.registry.counter("autotune.cache_misses").inc()
        return None

    def _search_list(self, shape: Dict[str, Any]) -> List[Tiles]:
        if is_attention_shape(shape):
            return [(c,) for c in seed_attention_candidates(shape, budget=self.budget)]
        return seed_candidates(shape, budget=self.budget)

    # -- incremental primitives (TuneJob drives these) ----------------------
    def measure_candidate(
        self, step, shape: Dict[str, Any], backend: str, cand: Tiles
    ) -> float:
        """Time one candidate (seconds) through the obs plane."""
        cshape = self._apply(shape, _Resolution(cand, "tuned"))
        with _trace.span("autotune.candidate", tiles=_tiles_label(cand)) as sp:
            if self.measure_fn is not None:
                t = float(self.measure_fn(step, cshape, backend))
            else:
                t = self._measure_real(step, cshape)
            sp.set(us=round(t * 1e6, 3))
        self.measurements += 1
        self.registry.counter("autotune.measurements").inc()
        return t

    def finish(
        self, key: str, shape: Dict[str, Any], heuristic: Tiles, timings: Dict[Tiles, float]
    ) -> _Resolution:
        """Close one search: pick the winner (ties break toward the
        heuristic, then lexicographically — determinism over luck), record
        it in the session and the on-disk artifact."""
        best = min(timings, key=lambda c: (timings[c], c != heuristic, c))
        res = _Resolution(best, "tuned")
        self._session[key] = res
        self.registry.counter("autotune.cells").inc()
        if self.cache is not None:
            if len(best) == 1:
                entry: Dict[str, Any] = {"cluster": best[0]}
            else:
                entry = {"bm": best[0], "splits": best[1]}
            entry.update(
                heuristic=",".join(str(v) for v in heuristic),
                best_us=round(timings[best] * 1e6, 3),
                heuristic_us=round(timings[heuristic] * 1e6, 3),
                measured=len(timings),
                candidates_us={
                    ",".join(str(v) for v in c): round(t * 1e6, 3)
                    for c, t in sorted(timings.items())
                },
                device="measure_fn" if self.measure_fn is not None else self.device_name,
            )
            self.cache.put(key, entry)
        return res

    # -- mechanics -----------------------------------------------------------
    @staticmethod
    def _apply(shape: Dict[str, Any], res: _Resolution) -> Dict[str, Any]:
        if res.tiles is None:
            return shape
        if len(res.tiles) == 1:
            return kops.with_cluster(shape, res.tiles[0])
        bm, splits = res.tiles
        return kops.with_tiles(shape, bm=bm, splits=splits)

    def _cuda_device(self, tensor: torch.Tensor) -> torch.device:
        if tensor.device.type != "cuda":
            raise ValueError(
                f"autotune: the plan lives on {tensor.device}, where no kernel runs to be "
                "timed (a wrapper there runs its plain version); tune a plan on the CUDA "
                "card, or inject measure_fn"
            )
        return tensor.device

    def _time(self, fn: Callable[[], Any], device: torch.device) -> float:
        flush = self._flush.get(device)
        if flush is None:
            flush = self._flush[device] = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)
        self.device_name = torch.cuda.get_device_name(device)
        with torch.cuda.device(device):
            return measure_device_median(fn, flush, repeat=self.repeat, warmup=self.warmup)

    def _attention_inputs(self, device: torch.device, b: int, s: int, t: int, dh: int):
        """q, k, v and mask as the token path hands them over, head 0's
        slices: q of the qkv projection's rows (3 · VIEW_HEADS · dh wide);
        at prefill k and v of the same rows and one causal (S, T) mask
        broadcast over the batch, at decode k and v of the updated KV
        cache's rows (VIEW_HEADS · dh wide, one tensor each) and a mask
        row per sequence."""
        key = (device, "attention", b, s, t, dh)
        if key not in self._inputs:
            rng = np.random.default_rng(self.seed)
            width = VIEW_HEADS * dh
            q = _int8(rng, device, (b, s, 3 * width))[:, :, :dh]
            if s > 1:
                kv = _int8(rng, device, (b, t, 3 * width))
                k, v = kv[:, :, width:width + dh], kv[:, :, 2 * width:2 * width + dh]
                mask = torch.ones((1, s, t), dtype=torch.float32, device=device)
                mask = torch.tril(mask, diagonal=t - s).expand(b, s, t)
            else:
                k = _int8(rng, device, (b, t, width))[:, :, :dh]
                v = _int8(rng, device, (b, t, width))[:, :, :dh]
                mask = torch.ones((b, s, t), dtype=torch.float32, device=device)
            self._inputs[key] = (q, k, v, mask)
        return self._inputs[key]

    def _matmul_input(self, device: torch.device, m: int, k: int) -> torch.Tensor:
        key = (device, "qmatmul", m, k)
        if key not in self._inputs:
            self._inputs[key] = (_int8(np.random.default_rng(self.seed), device, (m, k)),)
        return self._inputs[key][0]

    def _measure_real(self, step, shape: Dict[str, Any]) -> float:
        p = step.params
        if is_attention_shape(shape):
            (lut,) = step.consts
            device = self._cuda_device(lut)
            q, k, v, mask = self._attention_inputs(
                device, *(int(shape[f]) for f in ("b", "s", "t", "dh")))

            def thunk():
                _qatt.qattention(
                    q, k, v, mask, lut, qk_scale=p["qk_scale"], big=p["big"],
                    lut_scale=p["lut_scale"], p_scale=p["p_scale"], rescale=p["rescale"],
                    out_dtype=TORCH_DTYPES[p["out_dtype"]], cluster=int(shape["cluster"]),
                )
        else:
            w2, b2, qs2, qsh2, *lut = step.consts  # a folded table rides fifth
            device = self._cuda_device(w2)
            x = self._matmul_input(device, int(shape["m"]), int(shape["k"]))

            def thunk():
                kops.quantized_matmul_planned(
                    x, w2, b2, qs2, qsh2, shape, out_dtype=TORCH_DTYPES[p["out_dtype"]],
                    relu=p["relu"], two_mul=p["two_mul"], lut=lut[0] if lut else None,
                )
        return self._time(thunk, device)


# ---------------------------------------------------------------------------
# incremental background search (the serving integration)
# ---------------------------------------------------------------------------

class TuneJob:
    """The search for one scenario cell, sliced into bounded increments.

    Built from a plan *template* + bindings, it gathers every tunable fused
    matmul step's candidate list up front (steps already resolved in the
    tuner's session or disk cache contribute no work), then :meth:`advance`
    measures at most ``max_candidates`` candidates per call — the unit the
    CompiledModelServer spends between batches.  When the last candidate
    lands the winners are recorded exactly as the blocking path records
    them; a later ``specialize_plan(..., tuner=...)`` of the cell is then a
    pure session lookup."""

    def __init__(self, tuner: Autotuner, template, bindings: Dict[str, int]) -> None:
        self.tuner = tuner
        self.bindings = {str(a): int(v) for a, v in bindings.items()}
        self.backend = template.backend
        self._items: List[Dict[str, Any]] = []
        for step in template.steps:
            if not step.params.get("dynamic_batch"):
                continue
            shape = kops.bind_qmatmul_axes(step.params["shape"], self.bindings)
            if not tuner.tunable(shape, self.backend):
                continue
            key = tuner.key_for(step, shape, self.backend, self.bindings)
            if tuner._resolve_cached(key) is not None:
                continue
            cands = tuner._search_list(shape)
            if len(cands) <= 1:
                tuner._session[key] = _Resolution(None, "heuristic")
                continue
            self._items.append(
                {"step": step, "shape": shape, "key": key, "cands": cands,
                 "i": 0, "timings": {}}
            )

    @property
    def done(self) -> bool:
        return not self._items

    @property
    def remaining(self) -> int:
        """Candidates still to measure."""
        return sum(len(it["cands"]) - it["i"] for it in self._items)

    def advance(self, max_candidates: int = 1) -> bool:
        """Measure up to ``max_candidates`` candidates; returns ``done``."""
        n = 0
        while self._items and n < max_candidates:
            it = self._items[0]
            cand = it["cands"][it["i"]]
            it["timings"][cand] = self.tuner.measure_candidate(
                it["step"], it["shape"], self.backend, cand
            )
            it["i"] += 1
            n += 1
            if it["i"] == len(it["cands"]):
                self.tuner.finish(it["key"], it["shape"], it["cands"][0], it["timings"])
                self._items.pop(0)
        return self.done


# ---------------------------------------------------------------------------
# CLI smoke (on the card: cold, then warm with --expect-cached)
# ---------------------------------------------------------------------------

def _smoke_artifact():
    from ..core.toolchain import MLPSpec, quantize_mlp

    rng = np.random.default_rng(4)
    d = 256
    spec = MLPSpec(
        weights=[rng.normal(0, 0.4, (d, d)).astype(np.float32) for _ in range(2)],
        biases=[rng.normal(0, 0.2, (d,)).astype(np.float32) for _ in range(2)],
        activations=["Relu", None],
    )
    calib = rng.normal(0, 1.0, (64, d)).astype(np.float32)
    return quantize_mlp(spec, calib, name="autotune_smoke")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="autotune smoke: tune a small dynamic MLP's cells on the CUDA card "
        "and persist the tile cache"
    )
    ap.add_argument("--smoke", action="store_true", help="run the smoke model")
    ap.add_argument("--budget", type=int, default=4, help="candidates per cell step")
    ap.add_argument("--cache", default="autotune_cache.json", help="tile cache path")
    ap.add_argument("--cells", default="8,64", help="comma-separated batch buckets")
    ap.add_argument(
        "--expect-cached", action="store_true",
        help="fail unless every cell resolves with zero new measurements "
        "(the warm-start acceptance check)",
    )
    args = ap.parse_args(argv)
    if not args.smoke:
        ap.error("nothing to do: pass --smoke")

    from ..core.compile import compile_model

    tuner = Autotuner(budget=args.budget, repeat=3, warmup=1, cache=args.cache)
    cm = compile_model(_smoke_artifact(), backend="cuda", batch="dynamic", autotune=tuner)
    sources: Dict[int, set] = {}
    for cell in (int(c) for c in args.cells.split(",")):
        plan, _ = cm.specialized(cell)
        ev = plan.provenance.specializations[-1]
        sources[cell] = {
            rec.rsplit("[", 1)[-1].rstrip("]") if rec.endswith("]") else "heuristic"
            for _, rec in ev.tiles
        }
    print(
        f"autotune smoke on {torch.cuda.get_device_name(cm.device)}: cells={sorted(sources)} "
        f"measurements={tuner.measurements} cache_entries={len(tuner.cache)} "
        f"cache={tuner.cache.path}"
    )
    for cell, src in sorted(sources.items()):
        print(f"  cell N={cell}: tile sources {sorted(src)}")
    if args.expect_cached and tuner.measurements:
        print(
            f"FAIL: expected a pure warm start but performed "
            f"{tuner.measurements} measurement(s)"
        )
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
