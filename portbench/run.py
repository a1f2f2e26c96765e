#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card this process sees.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell, its configuration, traffic mix and
metrics are named in ``BENCHMARK.json``. The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` and, traced, ``breakdown``; last, ``checks``:
each number the comparison with the plain reference read, beside its
limit. The same numbers are the last lines of standard error. A fuller
record goes to ``portbench/out/``.

Exits non-zero, printing no result, when no card is visible, when the
program cannot be imported, or when JAX or the JAX package is loaded once
the window has closed. ``--calibrate N`` (not part of a benchmark run)
reads the program and the reference's lower-precision control on N seeds in
one process: the readings the limits are set from.
"""
import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: Top-level module names that may not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden():
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--calibrate", type=int, default=0,
                    help="read the program and the control on this many seeds from --seed on, "
                         "in one process, and print no result")
    args = ap.parse_args(argv)

    # every build and kernel cache at a fixed place inside the checkout
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, HERE)
    import torch

    from harness import cell

    bench = cell.load_benchmark(ROOT)
    chips = cell.find(bench["workloads"], args.workload, "workload")["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible", file=sys.stderr)
        return 2
    card = card_line()
    if args.calibrate:
        rows = cell.calibrate(bench, args.workload, [args.seed + i for i in range(args.calibrate)],
                              args.seconds, log=lambda line: print(line, file=sys.stderr, flush=True))
        os.makedirs(os.path.join(HERE, "out"), exist_ok=True)
        with open(os.path.join(HERE, "out", f"calibrate-{args.workload}-s{args.seed}.json"), "w") as f:
            json.dump({"card": card, "seconds": args.seconds, "rows": rows}, f, indent=1)
        return 0
    out = cell.run(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: the run loaded {bad}: the benchmark measures the port alone", file=sys.stderr)
        return 3
    result, details = out["result"], out["details"]
    details.update(workload=args.workload, seed=args.seed, seconds=args.seconds, trace=args.trace,
                   card=card, torch=torch.__version__, cuda=torch.version.cuda, result=result)
    os.makedirs(os.path.join(HERE, "out"), exist_ok=True)
    path = os.path.join(HERE, "out", f"{args.workload}-s{args.seed}-t{args.trace}.json")
    with open(path, "w") as f:
        json.dump(details, f, indent=1, default=float)
    print(f"portbench: {args.workload} seed {args.seed} on {card}; record in {os.path.relpath(path, ROOT)}",
          file=sys.stderr)
    print("portbench: details " + json.dumps({k: details[k] for k in ("phases", "setup_s", "counts",
                                                                      "reference_s")}, default=float),
          file=sys.stderr)
    print(f"portbench: correct = {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
