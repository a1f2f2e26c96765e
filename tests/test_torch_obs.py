"""The port's tracer (``repro_torch.obs.trace``) and the spans the serving
path opens with it, on the CPU.

* with no tracer installed, ``ExecutionPlan.execute`` opens no span and the
  engine builds no span attrs (the off path stays the untraced loop);
* with a tracer, a decode plan yields one ``plan.<kind>`` span per step,
  nested in one ``plan.execute`` span, the counts those of ``plan.kinds``;
* under a ``torch.profiler`` session every span is also a profiler range of
  the same name, nested as the spans are;
* the host's waits for the device (``engine.decode.wait``,
  ``engine.prefill.wait``, ``serve.wait``) appear once per decode step,
  prefill and batch, and ``xfer.h2d`` counts the feed's bytes;
* the Chrome export of all of it loads.

No numerics here, so no tolerance.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.compile import compile_model
from repro_torch.core.pqir import GraphBuilder
from repro_torch.obs import trace
from repro_torch.serving.compiled import CompiledModelServer, CompiledServerConfig
from repro_torch.serving.engine import EngineConfig, Request, ServeEngine
from repro_torch.serving.token_path import CompiledTokenAdapter, CompiledTokenPath, TokenPathConfig

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def tracer():
    t = trace.install()
    try:
        yield t
    finally:
        trace.uninstall()


@pytest.fixture(scope="module")
def token_path():
    return CompiledTokenPath(TokenPathConfig(), device="cpu", s_granularity=8)


def _decode_inputs(tp, n=2, s=16):
    cache = tp.init_cache(n, s)
    return np.array([[3], [5]], np.int32)[:n], np.array([4, 7], np.int32)[:n], cache


def _decode_plan(tp, n=2, s=16):
    plan, _ = tp.decode_cm.specialized({"N": n, "S": s})
    return plan


def _engine(tp, requests=2, new_tokens=3):
    eng = ServeEngine(ecfg=EngineConfig(slots=2, max_len=32, prefill_bucket=8, greedy=True),
                      adapter=CompiledTokenAdapter(tp))
    for i in range(requests):
        eng.submit(Request(uid=i, prompt=np.arange(1, 6 + i), max_new_tokens=new_tokens))
    return eng


def _relu_model():
    gb = GraphBuilder("relu")
    gb.add_input("x", "int8", (None, 4))
    y = gb.op("Relu", ["x"], out_hint="y")
    gb.add_output(y, "int8", (None, 4))
    return gb.build(opset=17)


def _count_span_calls(monkeypatch):
    """Wrap ``trace.span``; returns the list of (name, attrs) it was called with."""
    calls = []
    real = trace.span

    def counting(name, **attrs):
        calls.append((name, attrs))
        return real(name, **attrs)

    monkeypatch.setattr(trace, "span", counting)
    return calls


def test_without_a_tracer_execute_opens_no_span(monkeypatch, token_path):
    _decode_plan(token_path)  # specialized (a one-time span) before counting
    calls = _count_span_calls(monkeypatch)
    ranges = []
    monkeypatch.setattr(trace, "profiler_range", lambda: ranges.append(1))
    toks, pos, cache = _decode_inputs(token_path)
    logits, _ = token_path.decode_step(toks, pos, cache)
    assert logits.shape[0] == 2
    assert calls == [] and ranges == []
    assert trace.current() is None


def test_without_a_tracer_the_engine_builds_no_span_attrs(monkeypatch, token_path):
    """Off the tracer, the engine's spans are the shared no-op: no attrs dict
    (``live``, ``uid``, ``plen``, ``bucket``) is built for them."""
    eng = _engine(token_path)
    calls = _count_span_calls(monkeypatch)
    eng.run_until_drained()
    assert eng.metrics["decode_steps"] > 0 and eng.metrics["prefills"] == 2
    engine_calls = [(n, a) for n, a in calls if n.startswith("engine.")]
    assert engine_calls and all(attrs == {} for _, attrs in engine_calls)
    assert {name for name, _ in engine_calls} == {"engine.prefill.wait", "engine.decode.wait"}


def test_traced_decode_plan_has_one_span_per_step(tracer, monkeypatch, token_path):
    plan = _decode_plan(token_path)
    calls = _count_span_calls(monkeypatch)
    toks, pos, cache = _decode_inputs(token_path)
    token_path.decode_step(toks, pos, cache)
    # one span helper call for the whole plan, none per step
    assert [n for n, _ in calls if n.startswith("plan.")] == ["plan.execute"]
    (ex,) = tracer.spans("plan.execute")
    assert ex.attrs == {"steps": len(plan.steps), "batch": "(N=2,S=16)"}
    steps = [r for r in tracer.spans() if r.name.startswith("plan.") and r.name != "plan.execute"]
    counts = {}
    for r in steps:
        counts[r.name[len("plan."):]] = counts.get(r.name[len("plan."):], 0) + 1
    assert counts == plan.kinds
    assert {"generic", "fused_qlinear", "fused_qattention"} <= set(counts)
    assert [r.attrs["step"] for r in steps] == list(range(len(plan.steps)))
    for r in steps:
        st = plan.steps[r.attrs["step"]]
        assert r.name == "plan." + st.kind and r.attrs["kernel"] == st.kernel and r.attrs["name"] == st.name
        assert r.depth == ex.depth + 1 and r.tid == ex.tid
        assert ex.ts <= r.ts and r.ts + r.dur <= ex.ts + ex.dur
    ends = [r.ts + r.dur for r in steps]
    assert all(a <= b.ts for a, b in zip(ends, steps[1:]))


def test_add_steps_keeps_the_steps_a_failing_loop_finished(tracer):
    stamps = [tracer.epoch + 1.0, tracer.epoch + 2.0, tracer.epoch + 3.0, tracer.epoch + 3.5]
    with pytest.raises(RuntimeError):
        with trace.span("outer"):
            tracer.add_steps(stamps, lambda i: (f"step.{i}", {"i": i}))
            raise RuntimeError("fails after two steps")
    recs = {r.name: r for r in tracer.spans()}
    assert recs["outer"].attrs["error"] == "RuntimeError"
    assert (recs["step.0"].ts, recs["step.0"].dur) == pytest.approx((1.0, 1.0))
    assert (recs["step.1"].ts, recs["step.1"].dur) == pytest.approx((3.0, 0.5))
    assert recs["step.1"].depth == recs["outer"].depth + 1 and recs["step.1"].attrs == {"i": 1}
    assert len(tracer.spans()) == 3  # built once, not again on a second read


def _profiler_ranges(prof, prefixes=("plan.", "engine.", "xfer.", "serve.", "run.", "backend.")):
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(prefixes):
            out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return sorted(out, key=lambda r: (r[1], -r[2]))


def test_profiler_ranges_mirror_the_spans(tracer, token_path):
    eng = _engine(token_path)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.run_until_drained()
    spans = {}
    for r in tracer.spans():
        spans[r.name] = spans.get(r.name, 0) + 1
    ranges = _profiler_ranges(prof)
    counts = {}
    for name, _, _ in ranges:
        counts[name] = counts.get(name, 0) + 1
    assert counts == spans
    assert {"engine.decode", "engine.decode.wait", "engine.prefill", "engine.prefill.wait", "xfer.h2d",
            "plan.execute", "plan.generic", "plan.fused_qattention"} <= set(counts)
    # nesting on the profiler's clock: each step inside a plan.execute, each
    # decode plan inside an engine.decode
    execs = [(a, b) for n, a, b in ranges if n == "plan.execute"]
    decodes = [(a, b) for n, a, b in ranges if n == "engine.decode"]
    prefills = [(a, b) for n, a, b in ranges if n == "engine.prefill"]
    for n, a, b in ranges:
        if n.startswith("plan.") and n != "plan.execute":
            assert any(lo <= a and b <= hi for lo, hi in execs), n
    for a, b in execs:
        assert any(lo <= a and b <= hi for lo, hi in decodes + prefills)
    assert len(decodes) == eng.metrics["decode_steps"]


def test_without_profiler_hooks_no_range_reaches_the_profiler(tracer, monkeypatch, token_path):
    monkeypatch.setattr(trace, "profiler_range", lambda: None)
    toks, pos, cache = _decode_inputs(token_path)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        token_path.decode_step(toks, pos, cache)
    assert _profiler_ranges(prof) == []
    assert tracer.spans("plan.execute")


def test_wait_spans_once_per_decode_step_and_prefill(tracer, token_path):
    eng = _engine(token_path, requests=3, new_tokens=4)
    eng.run_until_drained()
    m = eng.metrics
    assert len(tracer.spans("engine.decode.wait")) == len(tracer.spans("engine.decode")) == m["decode_steps"]
    assert len(tracer.spans("engine.prefill.wait")) == len(tracer.spans("engine.prefill")) == m["prefills"] == 3
    for w in tracer.spans("engine.decode.wait"):
        assert w.depth == 0
    # decode_feeds copies the tokens and positions: two h2d a step
    h2d = tracer.spans("xfer.h2d")
    assert len([r for r in h2d if r.attrs["bytes"] == 4 * 2]) >= 2 * m["decode_steps"]
    assert {r.attrs.get("live") for r in tracer.spans("engine.decode")} <= {1, 2}
    events = json.loads(json.dumps(tracer.to_chrome_trace()))["traceEvents"]
    names = {e["name"] for e in events if e.get("ph") == "X"}
    assert {"plan.execute", "plan.generic", "engine.decode.wait", "engine.prefill.wait", "xfer.h2d"} <= names


def test_serve_wait_once_per_batch_and_h2d_bytes(tracer):
    cm = compile_model(_relu_model(), device="cpu", batch="dynamic")
    srv = CompiledModelServer(cm, CompiledServerConfig(max_batch=4))
    rng = np.random.default_rng(0)
    for _ in range(6):
        srv.submit(rng.integers(-128, 128, (4,)).astype(np.int8))
    srv.run_until_drained()
    assert srv.metrics["batches"] == 2
    waits = tracer.spans("serve.wait")
    assert len(waits) == len(tracer.spans("serve.compute")) == 2
    assert [w.attrs["bytes"] for w in waits] == [4 * 4, 2 * 4]
    computes = tracer.spans("serve.compute")
    for w, c in zip(waits, computes):
        assert w.depth == c.depth + 1 and c.ts <= w.ts and w.ts + w.dur <= c.ts + c.dur
    # the batch is stacked on the host (4 and 2 rows of 4 int8) and copied once
    assert [r.attrs["bytes"] for r in tracer.spans("xfer.h2d")] == [16, 8]
    assert not tracer.spans("run.execute")
    assert len(tracer.spans("plan.execute")) == 2
    json.loads(json.dumps(tracer.to_chrome_trace()))


@pytest.mark.parametrize("dtype", [np.int8, np.int32])
def test_h2d_bytes_equal_the_feed(tracer, dtype):
    cm = compile_model(_relu_model(), device="cpu")
    x = np.array([[-3, 0, 2, 7], [1, -1, 5, 6]], np.int8).astype(dtype)
    cm.run({"x": x})
    (h2d,) = tracer.spans("xfer.h2d")
    assert h2d.attrs == {"bytes": x.nbytes}
    (ex,) = tracer.spans("plan.execute")
    assert ex.ts >= h2d.ts + h2d.dur


def test_the_tracer_imports_no_torch():
    code = (
        "import sys\n"
        "from repro_torch.obs import trace\n"
        "t = trace.install()\n"
        "with trace.span('a', k=1):\n"
        "    with trace.span('b'):\n"
        "        pass\n"
        "trace.uninstall()\n"
        "assert [r.name for r in t.spans()] == ['a', 'b'], t.spans()\n"
        "assert trace.profiler_range() is None\n"
        "sys.exit(1 if 'torch' in sys.modules or 'numpy' in sys.modules else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                       env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stdout + r.stderr
