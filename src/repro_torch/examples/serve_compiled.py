"""Serving a compiled artifact on the port: one batch-polymorphic compile,
any traffic (``examples/serve_compiled.py`` on the H100).

1. Quantize + codify the §4 MLP (identical to the quickstart).
2. Compile ONCE with ``batch="dynamic"`` on the ``cuda`` backend: the plan
   is a shape-generic *template*; the batch-dependent tiles (``bm`` and the
   qmatmul K ``splits``) are bound lazily per power-of-two bucket through a
   bounded PlanCache.
3. Stand up the micro-batching server (``repro_torch.serving.compiled``):
   queued requests coalesce into buckets, pad, execute, slice.
4. Throw ragged traffic at it and check every response is bit-exact vs a
   solo reference-runtime run, then read the serving metrics.
5. Go multi-axis: a second artifact declares *named* symbolic axes
   ``("N", "S", …)`` and is compiled with ``dynamic_axes={"N": None, "S":
   16}``: variable-length sequence requests coalesce onto a 2-D (batch
   bucket × seq bucket) grid, with a ``max_wait_ms`` admission window.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_compiled [--trace out.json] [--device cpu]

``--trace`` installs a ``repro_torch.obs`` tracer for the whole run and dumps
the Chrome-trace JSON (chrome://tracing or ui.perfetto.dev): the compile
pass pipeline, one specialization span per visited bucket, and every
serving step with its per-request async spans.  The file is read back and
its compile, specialization, step and request spans are counted.  It also
prints the plan's provenance section (``pretty(verbose=True)``).
"""
import argparse
import json

import numpy as np

from repro_torch.core import patterns, pqir, quant
from repro_torch.core.compile import compile_model, resolve_device
from repro_torch.core.runtime import ReferenceRuntime
from repro_torch.core.toolchain import MLPSpec, quantize_mlp
from repro_torch.examples import add_device_arg, finish
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.obs import trace as obs_trace
from repro_torch.serving import CompiledModelServer, CompiledServerConfig

#: Request waves of part 4 (batch requests) and part 5 (sequence requests).
MLP_WAVES = (3, 1, 17, 9, 32, 2)
SEQ_WAVES = (5, 8, 3, 11)
#: The spans the trace must hold, by Chrome-trace event name.
TRACE_SPANS = ("compile", "backend.specialize", "serve.step", "serve.request")


def make_mlp(rng):
    """The §4 MLP artifact (the quickstart's recipe) and its input scale."""
    spec = MLPSpec(
        weights=[
            rng.normal(size=(64, 128)).astype(np.float32) * 0.2,
            rng.normal(size=(128, 128)).astype(np.float32) * 0.15,
            rng.normal(size=(128, 10)).astype(np.float32) * 0.2,
        ],
        biases=[
            rng.normal(size=(128,)).astype(np.float32) * 0.1,
            rng.normal(size=(128,)).astype(np.float32) * 0.1,
            rng.normal(size=(10,)).astype(np.float32) * 0.1,
        ],
        activations=["Relu", "Relu", None],
    )
    calib = rng.normal(size=(512, 64)).astype(np.float32)
    model = quantize_mlp(spec, calib, observer="percentile", name="served_mlp")
    return model, float(model.metadata["input_scale"])


def make_seq_model(rng2):
    """A per-token FC over named axes ``("N", "S", 32)``; returns the model
    and its output name."""
    p = quant.quantize_linear_layer(
        rng2.normal(size=(32, 16)).astype(np.float32) * 0.2,
        rng2.normal(size=(16,)).astype(np.float32) * 0.1, 0.05, 0.1,
    )
    gb = pqir.GraphBuilder("served_seq_mlp")
    x = gb.add_input("x", "int8", ("N", "S", 32))  # named symbolic axes
    y = patterns.fc_layer(gb, x, p, "fc0", two_mul=True, activation="Relu")
    gb.add_output(y, "int8", ("N", "S", 16))
    return gb.build(), y


def serve_mlp_waves(srv, rng, s_in, waves=MLP_WAVES):
    """Ragged traffic: ``waves`` of single-row requests, each wave drained;
    returns the requests in submission order."""
    reqs = []
    for wave in waves:
        for _ in range(wave):
            x = quant.quantize(rng.normal(size=(64,)).astype(np.float32), s_in, "int8")
            reqs.append(srv.submit(x))
        srv.run_until_drained()
    return reqs


def serve_seq_waves(srv, rng2, waves=SEQ_WAVES):
    """Variable-length sequence requests (1–39 tokens), each wave drained."""
    reqs = []
    for wave in waves:
        for _ in range(wave):
            s = int(rng2.integers(1, 40))  # ragged sequence lengths
            reqs.append(srv.submit(rng2.integers(-128, 128, (s, 32)).astype(np.int8)))
        srv.run_until_drained()
    return reqs


def all_equal_solo(reqs, model, out_name, input_name) -> bool:
    """Every response equals its request run alone through the numpy
    ``ReferenceRuntime``, bit for bit."""
    rt = ReferenceRuntime(model)
    for req in reqs:
        solo = rt.run({input_name: req.x[None]})[out_name][0]
        got = req.outputs[out_name]
        if got.dtype != solo.dtype or not np.array_equal(got, solo):
            print(f"request {req.uid} diverged")
            return False
    return True


def trace_counts(path):
    """Events per name in a dumped Chrome trace (async request spans count
    their begin events)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    counts = {}
    for ev in events:
        if ev.get("ph") in ("X", "b"):
            counts[ev["name"]] = counts.get(ev["name"], 0) + 1
    return counts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--trace", metavar="PATH",
        help="dump a Chrome-trace JSON of the whole run (compile, "
        "specializations, serving steps, per-request spans)",
    )
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    tracer = obs_trace.install() if args.trace else None
    reset_launch_counts()

    rng = np.random.default_rng(0)

    # -- 1. the artifact (same recipe as the quickstart) ----------------------
    model, s_in = make_mlp(rng)

    # -- 2. one batch-polymorphic compile -------------------------------------
    cm = compile_model(model, backend="cuda", device=device, batch="dynamic")
    print("template plan (batch-open shape records — no m/bm yet):")
    print(cm.plan)
    print()

    # -- 3. the micro-batching server -----------------------------------------
    srv = CompiledModelServer(cm, CompiledServerConfig(max_batch=32))

    # -- 4. ragged traffic: 64 requests arriving in uneven waves --------------
    out_name = cm.output_names[0]
    all_reqs = serve_mlp_waves(srv, rng, s_in)
    mlp_equal = all_equal_solo(all_reqs, model, out_name, "input_q")
    assert mlp_equal, "a request diverged from its solo reference run"
    print(f"{len(all_reqs)} requests served, every response bit-exact vs the "
          "reference runtime ✓")

    s = srv.summary()
    print(f"batches: {s['batches']}  bucket histogram: {s['bucket_batches']}  "
          f"padded rows: {s['padded_rows']}")
    print(f"plan cache: {s['plan_cache']}  hit rate: {s['plan_cache_hit_rate']:.2f}")
    print(f"latency: avg {s['latency_avg_ms']:.2f} ms  p95 {s['latency_p95_ms']:.2f} ms")
    specialized, _ = cm.specialized(8)
    print("\nthe bucket-8 specialization a hardware designer reads "
          "(m/bm/splits bound, everything else shared with the template):")
    print(specialized)

    # -- 5. named multi-axis serving: variable-length sequences ---------------
    print("\n— multi-axis: one artifact over a (batch × sequence) grid —\n")
    rng2 = np.random.default_rng(1)
    seq_model, y = make_seq_model(rng2)

    # batch buckets power-of-two; sequence buckets in multiples of 16 (the
    # token engine's prefill-bucket discipline, reused as an axis policy)
    cm2 = compile_model(seq_model, backend="cuda", device=device,
                        dynamic_axes={"N": None, "S": 16})
    print("two-axis template (named lead dims, open over N and S):")
    print(cm2.plan)
    print()

    # a small admission window: hold partial batches up to 5 ms for more
    # arrivals instead of draining greedily (window hits in summary())
    srv2 = CompiledModelServer(cm2, CompiledServerConfig(max_batch=8, max_wait_ms=5.0))
    seq_reqs = serve_seq_waves(srv2, rng2)
    seq_equal = all_equal_solo(seq_reqs, seq_model, y, "x")
    assert seq_equal, "a sequence request diverged from its solo reference run"
    print(f"{len(seq_reqs)} variable-length requests served bit-exactly ✓")

    s2 = srv2.summary()
    print(f"grid histogram (batch bucket, seq bucket): {s2['grid_batches']}")
    print(f"padded rows: {s2['padded_rows']}  padded tokens: {s2['padded_tokens']}  "
          f"window hits: {s2['window_hits']}")
    print(f"plan cache: {s2['plan_cache']}")
    result = {
        "example": "serve_compiled", "device": str(device),
        "mlp_requests": len(all_reqs), "mlp_equal": mlp_equal,
        "mlp_batches": s["batches"], "mlp_latency_p95_ms": s["latency_p95_ms"],
        "seq_requests": len(seq_reqs), "seq_equal": seq_equal,
        "seq_batches": s2["batches"], "seq_latency_p95_ms": s2["latency_p95_ms"],
        "launches": launch_counts(),
    }

    if tracer is not None:
        obs_trace.uninstall()
        tracer.dump(args.trace)
        print(f"\nwrote {len(tracer.records)} trace events to {args.trace} "
              f"(trace_id={tracer.trace_id}) — load at chrome://tracing")
        print("\nplan provenance (how the first artifact came to be):")
        print(cm.plan.pretty(verbose=True))
        counts = trace_counts(args.trace)
        result["trace_spans"] = {name: counts.get(name, 0) for name in TRACE_SPANS}
        result["trace_complete"] = all(result["trace_spans"].values())
        assert result["trace_complete"], f"the trace lacks spans: {result['trace_spans']}"
    return finish(result)


if __name__ == "__main__":
    main()
