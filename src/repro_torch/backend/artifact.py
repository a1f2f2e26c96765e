"""AOT plan artifacts: a compiled model serialized as a versioned co-design
artifact that survives a process boundary.

The port of ``repro.backend.artifact``.  A compiled model's
:class:`~repro_torch.backend.plan.ExecutionPlan` — typed, slot-planned,
tile-annotated — becomes a stable file:

* **Schema** ``repro-plan-v1`` — ``repro``'s document layout, kept so that
  ``scripts/plan_diff.py`` diffs port artifacts unchanged.  Both packages
  share that id and ``ref`` as a backend name, so a port document carries
  one more top-level field, ``"package": "repro_torch"``, which
  ``plan_diff.py`` and ``repro`` ignore; :func:`load_artifact` refuses a
  document without it (one ``repro`` saved) and any plan whose backend is
  not ``cuda`` or ``ref``.  JSON with deterministic key order, written
  atomically (tempfile + ``os.replace``).
* **npz sidecar** — the plan's baked constants are device tensors (padded,
  laid-out and int4-packed weights, int32 bias, f32 scale rows, int8/uint8
  LUTs) or host arrays (Slice bounds).  They live next to the JSON in
  ``<path stem>.npz`` (``c.cpu().numpy()``, dtypes kept), keyed per step,
  with a sha256 digest recorded in the JSON so a mismatched or truncated
  sidecar is refused at load; each const record says whether it was a
  tensor (``"tensor": true``), so load puts it back on the device.
* **Warm start** — :func:`save_artifact` records the hot scenario cells
  resident in the model's :class:`~repro_torch.backend.plan.PlanCache`,
  with every fused step's tiling (``bm``/``splits`` or ``cluster``) and its
  ``heuristic|tuned|cache`` source.  :func:`load_artifact` rebuilds the
  compiled model **without re-running passes, fusion or lowering** — no
  ``compile.fuse`` / ``compile.lower`` span is emitted — and pre-seeds the
  plan cache by installing each recorded cell
  (:meth:`~repro_torch.core.compile.CompiledModel.install`) with a replay
  tuner that stamps the recorded tiles and source tags back in; ``warm=True``
  runs each recorded cell's executor once on zero feeds, which also builds
  and loads the kernels (and captures a decode cell's CUDA graph).
* **State slots** — the decode plan's int8 KV cache bindings round-trip.
* **Provenance** — passes and fusions carry over verbatim; the live record
  re-records the hot cells as they are re-seeded (with their source tags),
  and the artifact JSON keeps the full specialization history.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import tempfile
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import pqir
from ..kernels import ops as kops
from ..obs.provenance import PlanProvenance
from .generic import TORCH_DTYPES
from .plan import (
    Arg,
    ExecutionPlan,
    PlanStep,
    StateBinding,
    ValueInfo,
    bindings_key,
    resolve_bucketing,
)

if TYPE_CHECKING:  # imported lazily at runtime: core.compile imports this package
    from ..core.compile import CompiledModel

__all__ = ["ARTIFACT_SCHEMA", "PACKAGE", "save_artifact", "load_artifact", "sidecar_path"]

#: Versioned schema id (``repro``'s) — load rejects anything else.
ARTIFACT_SCHEMA = "repro-plan-v1"
#: The top-level ``package`` field that marks a document this package saved.
PACKAGE = "repro_torch"

#: Shape-record tile fields recorded per hot cell (subset present per step):
#: the qmatmul record's M, tiles and K splits (``bits`` for sub-8-bit
#: weights), the attention record's b/s/t/dh and cluster size.
_TILE_KEYS = ("m", "bm", "bk", "bn", "splits", "bits", "b", "s", "t", "dh", "cluster")


def sidecar_path(path: str) -> str:
    """The npz sidecar belonging to an artifact JSON path (``x.json`` →
    ``x.npz``; extensionless paths just append ``.npz``)."""
    stem, ext = os.path.splitext(path)
    return (stem if ext else path) + ".npz"


# ---------------------------------------------------------------------------
# params encoding: JSON with typed markers for the non-JSON leaves
# ---------------------------------------------------------------------------

def _enc(v: Any) -> Any:
    """Encode one params value: tuples and ndarrays get typed markers so the
    decode side restores the exact in-memory form (a loaded plan renders as
    the saved one did)."""
    if isinstance(v, np.ndarray):
        return {"__ndarray__": pqir._encode_array(v)}
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.bool_,)):
        return bool(v)
    if isinstance(v, tuple):
        return {"__tuple__": [_enc(x) for x in v]}
    if isinstance(v, list):
        return [_enc(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _enc(x) for k, x in v.items()}
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    raise TypeError(f"cannot serialize plan param of type {type(v).__name__}: {v!r}")


def _dec(v: Any) -> Any:
    if isinstance(v, dict):
        if "__ndarray__" in v:
            return pqir._decode_array(v["__ndarray__"])
        if "__tuple__" in v:
            return tuple(_dec(x) for x in v["__tuple__"])
        return {k: _dec(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_dec(x) for x in v]
    return v


def _shape_to_json(shape: Optional[Tuple]) -> Optional[List]:
    # dims may be int, named-axis str, or None (unknown) — all JSON-safe
    return None if shape is None else list(shape)


def _shape_from_json(shape: Optional[List]) -> Optional[Tuple]:
    return None if shape is None else tuple(shape)


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------

def _cell_records(cm: "CompiledModel") -> List[Dict[str, Any]]:
    """The hot-cell warm-start records: for every specialization resident in
    the plan cache (least- to most-recently used, so re-seeding preserves
    recency), the axis bindings plus each fused step's bound tiling and its
    provenance source tag."""
    if cm.plan_cache is None:
        return []
    sources = _tile_sources(cm.plan.provenance)
    own = cm.model.graph.name
    cells = []
    for key in cm.plan_cache.keys():
        bkey = key
        if cm._shared_cache:
            # shared cache (a token path's prefill + decode): keys are
            # (graph name, bindings key) — only this model's cells belong
            if not (isinstance(key, tuple) and len(key) == 2 and key[0] == own):
                continue
            bkey = key[1]
        entry = cm.plan_cache.peek(key)
        if entry is None:
            continue
        plan, _ = entry
        if plan.batch == "dynamic":
            # a partially-bound template has no tiles of its own: not a cell
            continue
        tiles: Dict[str, Any] = {}
        for step in plan.steps:
            shape = step.params.get("shape")
            if not isinstance(shape, dict) or not ("bm" in shape or "cluster" in shape):
                continue
            name = step.name or step.kernel
            rec = {k: int(shape[k]) for k in _TILE_KEYS if k in shape}
            rec["source"] = sources.get((bkey, name), "heuristic")
            tiles[name] = rec
        cells.append({"bindings": dict(bkey), "tiles": tiles})
    return cells


def _tile_sources(prov: Optional[PlanProvenance]) -> Dict[Tuple, str]:
    """(bindings key, step name) → tile source, parsed from the provenance
    specialization events (the latest event per cell wins — a tuned swap
    re-records the cell with its ``[tuned]`` tag)."""
    out: Dict[Tuple, str] = {}
    if prov is None:
        return out
    for ev in prov.specializations:
        for name, rec in ev.tiles:
            source = "heuristic"
            if rec.endswith("]") and " [" in rec:
                source = rec[rec.rindex(" [") + 2 : -1]
            out[(ev.bindings, name)] = source
    return out


def save_artifact(cm: "CompiledModel", path: str) -> str:
    """Serialize a compiled model (template or static plan, baked consts,
    provenance, hot scenario cells) to ``path`` + its npz sidecar.

    Both files are written atomically (tempfile in the destination
    directory, then ``os.replace``).  Returns ``path``.

    Axis bucketing specs must be declarative (``None`` = power-of-two, int =
    round-up granularity): a custom *callable* policy cannot survive a
    process boundary and is refused here rather than mis-serialized.
    """
    for axis, spec in cm.axis_specs.items():
        if spec is not None and not isinstance(spec, int):
            raise ValueError(
                f"axis {axis!r} uses a callable bucketing policy, which cannot "
                "be serialized — compile with a declarative spec (None or an "
                "int granularity) to make the model AOT-saveable"
            )
    plan = cm.plan
    arrays: Dict[str, np.ndarray] = {}
    steps_json: List[Dict[str, Any]] = []
    for i, step in enumerate(plan.steps):
        consts_json: List[Optional[Dict[str, Any]]] = []
        for j, c in enumerate(step.consts):
            if c is None:
                consts_json.append(None)
                continue
            key = f"s{i}_c{j}"
            tensor = isinstance(c, torch.Tensor)
            arrays[key] = c.detach().cpu().numpy() if tensor else np.asarray(c)
            consts_json.append({"key": key, "tensor": tensor})
        steps_json.append(
            {
                "kernel": step.kernel,
                "args": [[a.kind, a.index, a.name] for a in step.args],
                "out_slots": list(step.out_slots),
                "params": _enc(step.params),
                "consts": consts_json,
                "kind": step.kind,
                "name": step.name,
                "outputs": list(step.outputs),
                "out_info": [
                    None if info is None else [info.dtype, _shape_to_json(info.shape)]
                    for info in step.out_info
                ],
            }
        )
    doc = {
        "schema": ARTIFACT_SCHEMA,
        "package": PACKAGE,
        "model": cm.model.to_json(),
        "plan": {
            "backend": plan.backend,
            "num_slots": plan.num_slots,
            "inputs": [[n, s] for n, s in plan.inputs],
            "outputs": [[n, s] for n, s in plan.outputs],
            "batch": plan.batch if isinstance(plan.batch, str) else _enc(plan.batch),
            "axes": list(plan.axes),
            "steps": steps_json,
            # persistent state slots (the token path's int8 KV cache): name,
            # tensor endpoints, pinned slots, dtype and (possibly symbolic)
            # shape all round-trip
            "states": [
                [s.name, s.input, s.output, s.in_slot, s.out_slot,
                 s.dtype, _shape_to_json(s.shape)]
                for s in plan.states
            ],
        },
        "provenance": None if plan.provenance is None else plan.provenance.to_dict(),
        "stats": {k: int(v) for k, v in cm.stats.items()},
        "axis_specs": {a: spec for a, spec in cm.axis_specs.items()},
        "plan_cache_capacity": cm.plan_cache_capacity,
        "cells": _cell_records(cm),
    }
    npz_path = sidecar_path(path)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    payload = buf.getvalue()
    doc["sidecar"] = {
        "file": os.path.basename(npz_path),
        "sha256": hashlib.sha256(payload).hexdigest(),
    }
    _atomic_write(npz_path, payload)
    _atomic_write(path, json.dumps(doc, indent=1, sort_keys=True).encode("utf-8"))
    return path


def _atomic_write(path: str, payload: bytes) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".artifact-", dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------

class _ReplayTuner:
    """``tune_step`` provider that replays an artifact's recorded per-cell
    tilings instead of measuring: pre-seeding a loaded plan cache reproduces
    exactly the tiles (and provenance source tags) the saving process
    served, whether they came from the heuristic, a live search or the
    tuner's own persisted cache."""

    def __init__(self, cells: List[Dict[str, Any]]) -> None:
        self._tiles: Dict[Tuple, Dict[str, Any]] = {}
        for cell in cells:
            key = bindings_key({a: int(v) for a, v in cell["bindings"].items()})
            for name, rec in cell.get("tiles", {}).items():
                self._tiles[(key, name)] = rec

    def tune_step(self, step, shape, *, backend: str, bindings: Dict[str, int]):
        rec = self._tiles.get((bindings_key(bindings), step.name or step.kernel))
        if rec is None:
            return shape, "heuristic"
        if "cluster" in rec:  # fused attention: the cluster size is the tiling
            shape = kops.with_cluster(shape, int(rec["cluster"]))
        else:
            shape = kops.with_tiles(
                shape, bm=rec.get("bm"), bk=rec.get("bk"), bn=rec.get("bn"),
                splits=rec.get("splits"),
            )
        return shape, str(rec.get("source", "heuristic"))


def _load_doc(path: str) -> Dict[str, Any]:
    from ..core.compile import BACKENDS

    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except json.JSONDecodeError as e:
        raise ValueError(f"{path}: not a valid plan artifact (corrupt JSON: {e})")
    if not isinstance(doc, dict) or "schema" not in doc:
        raise ValueError(f"{path}: not a valid plan artifact (no schema field)")
    if doc["schema"] != ARTIFACT_SCHEMA:
        raise ValueError(
            f"{path}: schema {doc['schema']!r} does not match expected "
            f"{ARTIFACT_SCHEMA!r}"
        )
    if doc.get("package") != PACKAGE:
        raise ValueError(
            f"{path}: package {doc.get('package')!r} is not {PACKAGE!r} — a plan "
            "another package saved (repro's, for its own backends) cannot be "
            "loaded here"
        )
    if doc["plan"]["backend"] not in BACKENDS:
        raise ValueError(
            f"{path}: plan backend {doc['plan']['backend']!r} is not one of {BACKENDS}"
        )
    return doc


def _load_sidecar(path: str, doc: Dict[str, Any]) -> Dict[str, np.ndarray]:
    npz_path = os.path.join(
        os.path.dirname(os.path.abspath(path)), doc["sidecar"]["file"]
    )
    try:
        with open(npz_path, "rb") as f:
            payload = f.read()
    except FileNotFoundError:
        raise ValueError(f"{path}: missing npz sidecar {npz_path}")
    digest = hashlib.sha256(payload).hexdigest()
    if digest != doc["sidecar"]["sha256"]:
        raise ValueError(
            f"{path}: npz sidecar digest mismatch (artifact and sidecar are "
            "from different saves, or the sidecar is corrupt)"
        )
    with np.load(io.BytesIO(payload)) as npz:
        return {k: npz[k] for k in npz.files}


def load_artifact(
    path: str,
    *,
    device=None,
    warm: bool = False,
    autotuner=None,
    plan_cache=None,
    registry=None,
) -> "CompiledModel":
    """Reconstruct a :class:`CompiledModel` from an artifact on ``device``
    (None means the CUDA card, as every entry point) — **zero
    re-compilation**: no optimization passes run, no fusion patterns match,
    no liveness planning happens (no ``compile.fuse``/``compile.lower``
    span).  The plan cache is pre-seeded with every hot cell recorded at
    save time (recorded tiles + source tags replayed through
    ``CompiledModel.install``, so only ``backend.specialize`` spans appear
    and the cache's hit/miss counters stay at zero); serving
    the recorded traffic therefore specializes nothing new.

    ``warm=True`` additionally executes each pre-seeded cell once on zero
    feeds — the kernels build and load, and the first real batch runs at
    steady state.

    ``registry``/``autotuner``/``plan_cache`` attach exactly as on a fresh
    compile (the tuner only engages for *new* cells beyond the recorded
    set; a shared ``plan_cache`` receives the pre-seeded cells under their
    graph-qualified keys).
    """
    from ..core.compile import CompiledModel, resolve_device

    dev = resolve_device(device)
    doc = _load_doc(path)
    arrays = _load_sidecar(path, doc)
    model = pqir.Model.from_json(doc["model"])
    model.validate()
    p = doc["plan"]
    steps = []
    for sj in p["steps"]:
        consts = tuple(
            None if cj is None
            else (torch.from_numpy(arrays[cj["key"]]).to(dev) if cj["tensor"]
                  else arrays[cj["key"]])
            for cj in sj["consts"]
        )
        steps.append(
            PlanStep(
                kernel=sj["kernel"],
                args=tuple(Arg(k, i, n) for k, i, n in sj["args"]),
                out_slots=tuple(sj["out_slots"]),
                params=_dec(sj["params"]),
                consts=consts,
                kind=sj["kind"],
                name=sj["name"],
                outputs=tuple(sj["outputs"]),
                out_info=tuple(
                    None if ij is None else ValueInfo(ij[0], _shape_from_json(ij[1]))
                    for ij in sj["out_info"]
                ),
            )
        )
    prov = None
    if doc["provenance"] is not None:
        # passes/fusions carry over verbatim; the live record re-accumulates
        # its specialization history as the hot cells are re-seeded below
        pd = dict(doc["provenance"])
        pd["specializations"] = []
        prov = PlanProvenance.from_dict(pd)
    batch = p["batch"] if isinstance(p["batch"], str) else _dec(p["batch"])
    plan = ExecutionPlan(
        backend=p["backend"],
        steps=steps,
        num_slots=int(p["num_slots"]),
        inputs=tuple((n, int(s)) for n, s in p["inputs"]),
        outputs=tuple((n, int(s)) for n, s in p["outputs"]),
        batch=batch,
        axes=tuple(p["axes"]),
        provenance=prov,
        states=tuple(
            StateBinding(
                name=n, input=i, output=o, in_slot=int(isl), out_slot=int(osl),
                dtype=d, shape=_shape_from_json(sh),
            )
            for n, i, o, isl, osl, d, sh in p.get("states", [])
        ),
    )
    axis_specs = {
        a: (None if spec is None else int(spec))
        for a, spec in doc["axis_specs"].items()
    }
    cm = CompiledModel(
        model,
        plan,
        {k: int(v) for k, v in doc["stats"].items()},
        None,
        plan_cache_capacity=int(doc["plan_cache_capacity"]),
        plan_cache=plan_cache,
        dynamic_axes={a: resolve_bucketing(spec) for a, spec in axis_specs.items()},
        axis_specs=axis_specs,
        autotuner=autotuner,
        device=dev,
    )
    cells = doc.get("cells", [])
    if cells and cm.plan_cache is not None:
        replay = _ReplayTuner(cells)
        for cell in cells:
            bindings = {a: int(v) for a, v in cell["bindings"].items()}
            # no lookup, so hit/miss counters stay untouched and "zero new
            # specializations" is observable as misses == 0
            _, run = cm.install(bindings, replay)
            if warm:
                feeds = _zero_feeds(cm, bindings)
                if feeds is not None:
                    run(feeds)
    if registry is not None:
        cm.attach_metrics(registry)
    return cm


def _zero_feeds(cm: "CompiledModel", bindings: Dict[str, int]):
    """Zero-filled feeds on the model's device at a cell's bucket extents.
    Returns None when any input dim cannot be resolved to an int."""
    feeds = {}
    for t in cm.model.graph.inputs:
        dims = list(t.shape)
        for axis, by_input in cm.axis_input_positions.items():
            for pos in by_input.get(t.name, ()):
                if axis in bindings:
                    dims[pos] = bindings[axis]
        if not all(isinstance(d, int) for d in dims):
            return None
        feeds[t.name] = torch.zeros(tuple(dims), dtype=TORCH_DTYPES[t.dtype], device=cm.device)
    return feeds


# ---------------------------------------------------------------------------
# CLI smoke (on the card: compile + serve + save, then warm-load)
# ---------------------------------------------------------------------------

def _smoke_model():
    from ..core.toolchain import MLPSpec, quantize_mlp

    rng = np.random.default_rng(11)
    spec = MLPSpec(
        weights=[
            rng.normal(size=(16, 32)).astype(np.float32) * 0.2,
            rng.normal(size=(32, 8)).astype(np.float32) * 0.2,
        ],
        biases=[
            rng.normal(size=(32,)).astype(np.float32) * 0.1,
            rng.normal(size=(8,)).astype(np.float32) * 0.1,
        ],
        activations=["Relu", None],
    )
    calib = rng.normal(size=(64, 16)).astype(np.float32)
    return quantize_mlp(spec, calib, name="aot_smoke")


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    from ..core.compile import compile_model
    from ..obs import trace as _trace

    ap = argparse.ArgumentParser(
        description="AOT artifact smoke on the CUDA card: compile+serve+save, or "
        "warm-load and assert zero re-lowering + pre-seeded cache hits"
    )
    ap.add_argument("--smoke", action="store_true", required=True)
    ap.add_argument("--out", default="plan_artifact.json")
    ap.add_argument(
        "--expect-warm",
        action="store_true",
        help="load --out instead of compiling: fail unless no fuse/lower "
        "spans fire and every recorded cell is served without a new "
        "specialization",
    )
    args = ap.parse_args(argv)

    model = _smoke_model()
    rng = np.random.default_rng(12)
    xs = {b: rng.integers(-128, 128, (b, 16)).astype(np.int8) for b in (2, 8)}

    if not args.expect_warm:
        cm = compile_model(model, backend="cuda", batch="dynamic")
        inp = cm.input_names[0]
        for x in xs.values():
            cm.run({inp: x})
        save_artifact(cm, args.out)
        print(
            f"saved {args.out} (+ sidecar): "
            f"{len(cm.plan.steps)} steps, {len(cm.plan_cache.keys())} hot cells"
        )
        return 0

    tracer = _trace.install()
    try:
        cm = load_artifact(args.out, warm=True)
        inp = cm.input_names[0]
        outs = [cm.run({inp: x}) for x in xs.values()]
    finally:
        _trace.uninstall()
    # the fresh compile runs outside the tracer: its fuse/lower spans are its
    # own business — the assertion below is about the *load* path only
    fresh = compile_model(_smoke_model(), backend="ref", batch="dynamic")
    for x, got in zip(xs.values(), outs):
        want = fresh.run({fresh.input_names[0]: x})
        for k in want:
            if not torch.equal(got[k], want[k]):
                print(f"FAIL: output {k!r} of the loaded cuda plan differs from the ref backend")
                return 1
    relower = len(tracer.spans("compile.fuse")) + len(tracer.spans("compile.lower"))
    stats = cm.plan_cache.stats
    ok = relower == 0 and stats["misses"] == 0 and stats["hits"] == len(xs)
    print(
        f"warm load on {torch.cuda.get_device_name(cm.device)}: fuse/lower spans={relower} "
        f"plan-cache hits={stats['hits']} misses={stats['misses']} "
        f"(expected {len(xs)} hits, 0 misses); outputs == ref backend"
    )
    if not ok:
        print("FAIL: warm start re-lowered or re-specialized")
        return 1
    print("OK: zero re-lowering, all recorded cells served from the pre-seeded cache")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
