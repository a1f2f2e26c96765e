#!/usr/bin/env python3
"""The tuner's cost-model seeding held against the full tile lattice, on one
card.

    python3 scripts/autotune_sweep.py [--layers 8] [--budget 8]

Builds the compiled token path at Qwen3-1.7B widths (vocab 151936, d_model
2048, 16 heads of 128, d_ff 6144, w4 qkv/down; depth cut to ``--layers``) on
backend ``cuda`` and tunes its prefill (4,128) and decode (4,512) cells with
a tuner whose budget holds every lattice point: each fused step times its
whole ``(bm, splits)`` lattice, each attention step every cluster size, as
the tuner times them (the real planned kernel, cold L2, median of 5).

For every step it then asks, from the sweep's own times, whether the full
sweep's winner is among the ``seed_candidates`` list that a tuner of budget
``--budget`` (the default) times — the heuristic plus the tiles the cost
model ranks best — and how much slower the best of that list is than the
winner (its regret; 0 when the winner is in the list).  The heuristic's
regret is given beside it.

Prints one line per (cell, step shape) group and writes every step's
record to ``chiprun_out/autotune_sweep.json``.  Needs one CUDA card and
``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

OUT_DIR = os.path.join(ROOT, "chiprun_out")
CELLS = ({"N": 4, "S": 128}, {"N": 4, "S": 512})  # prefill, decode


def _parse(tiles: str):
    return tuple(int(v) for v in tiles.split(","))


def step_record(key: str, entry: dict, budget: int) -> dict:
    """One cache entry of the full sweep against the list a tuner of
    ``budget`` would have measured for the same step."""
    from repro_torch.backend.autotune import seed_attention_candidates, seed_candidates

    step, _, cell, skey = key.split("|")
    shape = {f: int(v) for f, v in (kv.split("=") for kv in skey.split(","))}
    times = {_parse(c): us for c, us in entry["candidates_us"].items()}
    heuristic = _parse(entry["heuristic"])
    if "cluster" in entry:
        shape["cluster"] = heuristic[0]
        seeded = [(c,) for c in seed_attention_candidates(shape, budget=budget)]
        winner = (int(entry["cluster"]),)
    else:
        shape["bm"], shape["splits"] = heuristic
        seeded = seed_candidates(shape, budget=budget)
        winner = (int(entry["bm"]), int(entry["splits"]))
    best = min(times.values())
    return {
        "step": step, "cell": cell, "shape": skey, "lattice": len(times),
        "heuristic": heuristic, "winner": winner, "best_us": best,
        "winner_in_seeded": winner in seeded,
        "seeded_best": min(seeded, key=lambda c: times[c]),
        "seeded_regret": min(times[c] for c in seeded) / best - 1.0,
        "heuristic_regret": times[heuristic] / best - 1.0,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=8, help="depth of the token path")
    ap.add_argument("--budget", type=int, default=8, help="the seeded list's budget")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("autotune_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.backend.autotune import Autotuner
    from repro_torch.kernels import _build
    from repro_torch.serving.token_path import (
        CompiledTokenPath, TokenPathConfig, make_token_params,
    )

    card = cs.card_line()
    _build.build(["qmatmul", "qattention"])
    cfg = TokenPathConfig(vocab=151936, d_model=2048, n_heads=16, d_ff=6144, n_layers=args.layers)
    os.makedirs(OUT_DIR, exist_ok=True)
    cache = os.path.join(OUT_DIR, "autotune_sweep_cache.json")
    if os.path.exists(cache):
        os.unlink(cache)
    tuner = Autotuner(budget=1 << 30, cache=cache)  # every lattice point
    tp = CompiledTokenPath(cfg, make_token_params(cfg, seed=0), backend="cuda",
                           device=torch.device("cuda", 0), autotune=tuner)
    t0 = time.perf_counter()
    for cm, cell in zip((tp.prefill_cm, tp.decode_cm), CELLS):
        cm.specialized(cell)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    print(f"full sweep: {args.layers} of 28 layers, {tuner.measurements} candidates in "
          f"{sweep_s:.1f} s; seeded list budget {args.budget}  ({card})", flush=True)

    with open(cache) as f:
        entries = json.load(f)["entries"]
    steps = [step_record(k, e, args.budget) for k, e in sorted(entries.items())]
    groups = {}
    for r in steps:
        groups.setdefault((r["cell"], r["shape"]), []).append(r)
    summary = []
    for (cell, skey), rs in sorted(groups.items()):
        reg = sorted(r["seeded_regret"] for r in rs)
        hreg = sorted(r["heuristic_regret"] for r in rs)
        winners = {}
        for r in rs:
            w = ",".join(map(str, r["winner"]))
            winners[w] = winners.get(w, 0) + 1
        g = {"cell": cell, "shape": skey, "steps": len(rs), "lattice": rs[0]["lattice"],
             "winner_in_seeded": sum(r["winner_in_seeded"] for r in rs), "winners": winners,
             "seeded_regret_median": reg[len(reg) // 2], "seeded_regret_max": reg[-1],
             "heuristic_regret_median": hreg[len(hreg) // 2]}
        summary.append(g)
        print(f"  {cell} {skey}: {g['steps']} steps x {g['lattice']} tiles; full winner in the "
              f"seeded list for {g['winner_in_seeded']}/{g['steps']}; seeded best over the full "
              f"best: median +{100 * g['seeded_regret_median']:.2f} %, max "
              f"+{100 * g['seeded_regret_max']:.2f} %; heuristic median "
              f"+{100 * g['heuristic_regret_median']:.2f} %; winners {winners}", flush=True)
    with open(os.path.join(OUT_DIR, "autotune_sweep.json"), "w") as f:
        json.dump({"card": card, "layers": args.layers, "budget": args.budget,
                   "measurements": tuner.measurements, "sweep_s": sweep_s,
                   "groups": summary, "steps": steps}, f, indent=1, default=list)
    n_in = sum(r["winner_in_seeded"] for r in steps)
    print(f"full-sweep winner in the seeded list for {n_in} of {len(steps)} steps  ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
