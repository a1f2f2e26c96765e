#!/usr/bin/env python3
"""Slice A's LUT layers unfolded against folded, kernel by kernel and, with
``--parent``, slice A served end to end by an earlier tree against this one,
on one card.

    python3 scripts/qact_lut_ab.py [--parent DIR]

Unfolded is what the plan ran before the table moved into the matmul
epilogue: the qmatmul kernel, then the standalone qact_lut kernel (then, for
the Sigmoid layer whose uint8 output the last FC reads as int8, the shift
``u - 128``).  Folded is one qmatmul launch with the table in its epilogue
(the Sigmoid table stored shifted, as the plan stores it).

Kernels: the slice-A rows of ``chip_smoke.LUT_EPILOGUE_ROWS`` (both LUT
layers at M = 1, 17, 64) through ``chip_smoke._check_lut_epilogue``, which
holds folded, unfolded and the plain version bit for bit and times them in
turns (unfolded / folded / no table / no table / folded / unfolded, median of
25 runs each, L2 flushed before each run).

End to end, with ``--parent DIR`` (an unpacked checkout of an earlier
commit): slice A on backend cuda served by each tree in turns, DIR / this /
this / DIR, each turn a process that imports its tree's ``repro_torch`` and
measures it with this tree's ``chip_smoke`` functions, so both trees are
read with one yardstick: requests/s over the served window, the 101-rep
median forward at batch 64, and device time by kernel over the profiled
window.  The four turns' responses must be identical.

Prints one line per row and per turn, writes every number to
``chiprun_out/qact_lut_ab.json``; exits non-zero on any mismatch.  Needs one
CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def serve_tree(tree: str) -> dict:
    """Slice A served by ``tree``'s repro_torch, measured by this tree's
    chip_smoke; one JSON-able dict."""
    import numpy as np

    import chip_smoke as cs

    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))  # ahead of this tree's src
    import repro_torch
    from repro_torch.core.compile import compile_model
    from repro_torch.kernels import _build

    if not os.path.abspath(repro_torch.__file__).startswith(os.path.abspath(tree) + os.sep):
        raise AssertionError(f"imported {repro_torch.__file__}, not the tree {tree}")
    _build.build(["qmatmul", "qact_lut"])
    model, examples = cs.build_mlp()
    cm = compile_model(model, backend="cuda", device="cuda", batch="dynamic")
    cs._serve(cm, examples, cs.MLP_WAVES, cs.MLP_MAX_BATCH)  # warm: first launches, specializations
    reqs, summ, wall, rounds = cs._serve(cm, examples, cs.MLP_WAVES, cs.MLP_MAX_BATCH, cs.MIN_WINDOW_S)
    out = cm.output_names[0]
    first = np.stack([r.outputs[out] for r in reqs[:len(examples)]])
    dev = cs.device_breakdown(cm, examples, cs.MLP_MAX_BATCH, top=8)
    return dict(tree=tree, steps=[s.kernel for s in cm.plan.steps],
                requests_per_s=len(reqs) / wall, window_s=wall, rounds=rounds,
                p50_ms=summ["latency_p50_ms"], p95_ms=summ["latency_p95_ms"],
                batch_ms=cs._batch_ms(cm, examples, cs.MLP_MAX_BATCH),
                device_ms=None if dev is None else dev[0],
                by_kernel=None if dev is None else dev[1],
                responses_sha256=hashlib.sha256(first.tobytes()).hexdigest())


def kernel_rows(rows) -> list:
    import numpy as np
    import torch

    import chip_smoke as cs

    device = torch.device("cuda", 0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    rng = np.random.default_rng(0)
    worst = {"qact_lut": 0}
    for row in cs.LUT_EPILOGUE_ROWS:
        if row[0] == "sliceA" and row[5] in ("int8", "uint8-128"):
            cs._check_lut_epilogue(rng, device, flush, rows, worst, *row)
    for r in rows:
        r["speedup"] = r["unfolded_ms"] / r["ms"]
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an unpacked checkout of an earlier commit to serve slice A against")
    ap.add_argument("--serve-tree", help=argparse.SUPPRESS)  # one end-to-end turn, in its own process
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("qact_lut_ab: no CUDA device is available", file=sys.stderr)
        return 2
    if args.serve_tree:
        print(json.dumps(serve_tree(args.serve_tree), default=float))
        return 0

    import chip_smoke as cs
    from repro_torch.kernels import _build

    card = cs.card_line()
    _build.build(["qmatmul", "qact_lut"])
    print(f"qact_lut A/B: qmatmul -> qact_lut [-> shift] (unfolded) vs qmatmul with the table in "
          f"its epilogue (folded), slice A's LUT layers ({card})", flush=True)
    rows = kernel_rows([])
    result = {"card": card, "rows": rows, "turns": []}
    if args.parent:
        print(f"slice A end to end, {args.parent} / this tree / this tree / {args.parent}, "
              "each measured by this tree's chip_smoke", flush=True)
        for tree in (args.parent, ROOT, ROOT, args.parent):
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--serve-tree", tree],
                                  capture_output=True, text=True)
            if proc.returncode:
                sys.stderr.write(proc.stderr)
                raise SystemExit(f"the turn of {tree} failed with code {proc.returncode}")
            turn = json.loads(proc.stdout.strip().splitlines()[-1])
            result["turns"].append(turn)
            who = "this" if tree == ROOT else "parent"
            dev = "not measured" if turn["device_ms"] is None else f"{turn['device_ms']:.4f} ms"
            print(f"  {who:6s} {turn['requests_per_s']:9.1f} requests/s (p50 {turn['p50_ms']:.3f} ms); "
                  f"forward at batch {cs.MLP_MAX_BATCH} {turn['batch_ms']:.4f} ms; device {dev}; "
                  f"{len(turn['steps'])} steps", flush=True)
            for key, ms, calls in turn["by_kernel"] or []:
                print(f"         {ms:9.4f} ms  x{calls:<4g} {key[:80]}")
        if len({t["responses_sha256"] for t in result["turns"]}) != 1:
            raise SystemExit("the trees served different responses")
        print("  every turn served the same responses")
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "qact_lut_ab.json"), "w") as f:
        json.dump(result, f, indent=1, default=str)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
