"""Traced runs of each cell at small sizes on the CPU, reading the program's
host spans: each per-layer metric that reads them is reported, finite and
not negative; the program's spans, mirrored into the profiler's trace, leave
the harness's labels, the ``breakdown``'s keys and the other metrics as they
are without the mirror; and no span of the program takes the name of a mark
the harness alone puts in the trace.

On the CPU the trace holds no device activity, so the window is one idle gap
and ``breakdown`` labels it by whatever mark is open at its middle. The
labels are compared instead on one traced run, with and without the
program's ranges, at the middle of every stretch between two mark
boundaries: the labels an idle gap can get."""
import math
import types

import pytest

from harness import cell
from harness.timeline import WINDOW_MARK
from portbench_tiny import cnn_config, engine_mix, server_mix, token_config

BENCH = cell.load_benchmark()
SEED = 2**31 + 11
#: The per-layer metrics that read the program's host spans, by cell.
SPAN_METRICS = {
    "tokpath-decode": {"decode_host_ms.qattention", "decode_host_ms.generic", "decode_host_ms.qlinear",
                       "decode_wait_ms"},
    "tokpath-prefill": {"decode_wait_ms", "prefill_wait_ms"},
    "cnn-batch64": {"h2d_ms.cnn", "serve_wait_ms.cnn"},
}
#: Marks the harness puts in the trace around calls into the program.
HARNESS_ONLY = {"engine.step", "clients.send", "CompiledModel.run", WINDOW_MARK}
_RUNS = {}


def _traced(workload, mirror=True):
    """One traced run of the cell at small sizes, the names of every span
    the program's tracer recorded in it, and the harness's timeline."""
    key = (workload, mirror)
    if key not in _RUNS:
        from repro_torch.obs import trace

        names, timelines = set(), []

        class Keeping(cell.Timeline):
            def __init__(self, prof, marks=()):
                super().__init__(prof, marks)
                self.prof = prof
                timelines.append(self)

        class Recording(trace.Tracer):
            def spans(self, name=None):
                out = super().spans(name)
                names.update(r.name for r in out)
                return out

        real_tracer, real_range, real_timeline = trace.Tracer, trace.profiler_range, cell.Timeline
        trace.Tracer, cell.Timeline = Recording, Keeping
        if not mirror:
            trace.profiler_range = lambda: None
        try:
            if workload == "cnn-batch64":
                out = cell.run(BENCH, workload, SEED, 0.4, True, device="cpu", config=cnn_config(),
                               mix=server_mix())
            else:
                traffic = "decode-long" if workload == "tokpath-decode" else "prefill-long"
                out = cell.run(BENCH, workload, SEED, 0.8, True, device="cpu", config=token_config(),
                               mix=engine_mix(traffic))
        finally:
            trace.Tracer, trace.profiler_range, cell.Timeline = real_tracer, real_range, real_timeline
        _RUNS[key] = (out["result"], names, timelines[0])
    return _RUNS[key]


def _harness_marks_only(tl):
    """The run's timeline rebuilt without the program's ranges: those of the
    harness are ``record_function`` user annotations, the program's are not."""
    events = [e for e in tl.prof.profiler.kineto_results.events()
              if e.is_user_annotation() or e.name() not in cell.MARKS]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    return cell.Timeline(prof, cell.MARKS)


def _doubled(tl):
    """Names with a mark nested in a mark of the same name."""
    return {n for n, a, b in tl.marks
            if any(m == n and (x, y) != (a, b) and x <= a and b <= y for m, x, y in tl.marks)}


@pytest.mark.parametrize("workload", sorted(SPAN_METRICS))
def test_traced_run_reports_each_span_metric(workload):
    res, _, _ = _traced(workload)
    assert res["correct"] is True
    for name in SPAN_METRICS[workload]:
        value = res["metrics"][name]["value"]
        assert math.isfinite(value) and value >= 0.0, name
    listed = {m["name"] for m in BENCH["per_layer"] if workload in m.get("workloads", ())}
    assert SPAN_METRICS[workload] <= listed


@pytest.mark.parametrize("workload", sorted(SPAN_METRICS))
def test_the_mirror_leaves_labels_and_other_metrics_alone(workload):
    on, _, tl = _traced(workload, mirror=True)
    off, _, tl_off = _traced(workload, mirror=False)
    bare = _harness_marks_only(tl)
    # the program's engine.* and serve.step spans put second ranges of the
    # same names among the marks ...
    assert _doubled(tl_off) == _doubled(bare) == set() and _doubled(tl)
    assert _doubled(tl) <= {"engine.decode", "engine.prefill", "serve.step"}
    assert len(bare.marks) < len(tl.marks)
    # ... and at every stretch between mark boundaries the label is one the
    # harness's marks alone give there
    edges = sorted({t for _, a, b in tl.marks for t in (a, b) if tl.lo <= t <= tl.hi})
    mids = [(a + b) / 2 for a, b in zip(edges, edges[1:]) if b > a]
    assert {tl.label_at(t) for t in mids} == {bare.label_at(t) for t in mids}
    assert {tl.label_at(t) for t in mids} <= set(cell.MARKS) | {WINDOW_MARK}
    assert bare.ranges("engine.step") == tl.ranges("engine.step")
    # the result lines with and without the mirror hold the same metrics
    assert set(on["breakdown"]) == set(off["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(on["metrics"]) == set(off["metrics"])


@pytest.mark.parametrize("workload", sorted(SPAN_METRICS))
def test_no_program_span_takes_a_harness_mark_name(workload):
    _, names, _ = _traced(workload)
    assert names and not names & HARNESS_ONLY
    assert {"plan.execute", "xfer.h2d"} <= names


#: Each new reader: the spans it reads and its value in ms on the spans below.
READERS = {
    "decode_host_ms.qattention": ("plan.fused_qattention", "engine.decode", 3.0),
    "decode_host_ms.generic": ("plan.generic", "engine.decode", 3.0),
    "decode_host_ms.qlinear": ("plan.fused_qlinear", "engine.decode", 3.0),
    "h2d_ms.cnn": ("xfer.h2d", "serve.step", 3.0),
    "decode_wait_ms": ("engine.decode.wait", None, 2.5),
    "prefill_wait_ms": ("engine.prefill.wait", None, 2.5),
    "serve_wait_ms.cnn": ("serve.wait", None, 2.5),
}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_span_reader_finds_nothing_in_a_program_without_the_spans(metric):
    """A program without the spans (as the parent of the change that added
    them) gives None, and the metric is left out of the line."""
    reader = cell.load_module(f"{cell.HERE}/metrics/{metric}.py")
    name, per, want = READERS[metric]
    ctx = types.SimpleNamespace(spans={"engine.decode": [0.2], "serve.step": [0.004]}, notes=[])
    assert reader.read(ctx) is None
    ctx.spans = {name: [0.001, 0.003, 0.002, 0.003]}
    if per is not None:
        assert reader.read(ctx) is None
        ctx.spans[per] = [0.2, 0.3, 0.1]
    assert reader.read(ctx) == pytest.approx(want)
