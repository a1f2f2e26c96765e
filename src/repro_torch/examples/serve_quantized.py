"""End-to-end serving on the port: batched requests through the
continuous-batching engine, comparing three quantization postures of the
SAME model (``examples/serve_quantized.py`` on the H100):

    bf16 weights + bf16 KV cache   (baseline)
    bf16 weights + int8 KV cache   (paper scheme on the cache)
    W8A8 weights + int8 KV cache   (fully pre-quantized serving)

The float32 masters are drawn by ``models.model.init_params`` from a
``torch.Generator`` seeded with 0 on the serving device (``repro``'s
example draws from ``jax.random.PRNGKey(0)``); the prompts come from numpy's
``default_rng(0)`` as in the original.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_quantized [--arch minicpm_2b] [--device cpu]
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.compile import resolve_device
from repro_torch.core.convert import convert_params_w8a8
from repro_torch.examples import add_device_arg, finish
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import model as M
from repro_torch.serving.engine import EngineConfig, Request, ServeEngine


def run_engine(params, cfg, prompts, new_tokens, slots):
    """Serve ``prompts`` greedily through ``ServeEngine``'s default adapter;
    returns the requests, tokens/s over the drain and the engine metrics."""
    ecfg = EngineConfig(slots=slots, max_len=int(max(len(p) for p in prompts)) + new_tokens + 8)
    eng = ServeEngine(params, cfg, ecfg)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=new_tokens) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    t0 = time.monotonic()
    eng.run_until_drained()  # every step reads its tokens back on the host
    dt = time.monotonic() - t0
    toks = sum(len(r.generated) for r in reqs)
    return reqs, toks / dt, eng.metrics


def serve_postures(params, cfg, prompts, new_tokens, slots):
    """The three postures in order; posture name -> (requests, tokens/s,
    metrics)."""
    results = {"bf16/bf16-kv": run_engine(params, cfg, prompts, new_tokens, slots)}
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    results["bf16/int8-kv"] = run_engine(params, cfg8, prompts, new_tokens, slots)
    pq = convert_params_w8a8(params)
    results["w8a8/int8-kv"] = run_engine(pq, cfg8, prompts, new_tokens, slots)
    return results


def agreement(reqs, base) -> float:
    """Mean per-request share of generated tokens equal to ``base``'s."""
    return float(np.mean([
        np.mean([a == b for a, b in zip(x.generated, y.generated)]) for x, y in zip(reqs, base)
    ]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm_2b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    reset_launch_counts()

    cfg = get_config(args.arch, reduced=True)
    params = M.init_params(torch.Generator(device=device).manual_seed(0), cfg, device=device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (args.prompt_len,)).astype(np.int32)
               for _ in range(args.requests)]

    results = serve_postures(params, cfg, prompts, args.new_tokens, args.slots)

    base = results["bf16/bf16-kv"][0]
    print(f"\n{args.arch} — {args.requests} requests × {args.new_tokens} new tokens, "
          f"{args.slots} slots")
    print(f"{'config':16s} {'tok/s':>8s} {'vs-baseline token agreement':>30s}")
    postures = {}
    for name, (reqs, tput, _) in results.items():
        match = agreement(reqs, base)
        postures[name] = {"tokens_per_s": tput, "agreement": match,
                          "generated": sum(len(r.generated) for r in reqs)}
        print(f"{name:16s} {tput:8.1f} {match:29.1%}")
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)
    print(f"\n(tokens/s: this run's wall clock over each drain, on {where}; "
          "agreement: greedy tokens equal to bf16/bf16-kv's, position by position)")
    done = all(p["generated"] == args.requests * args.new_tokens for p in postures.values())
    assert done, f"a posture generated fewer tokens than asked: {postures}"
    return finish({
        "example": "serve_quantized", "device": str(device), "arch": args.arch,
        "postures": postures, "all_generated": done, "launches": launch_counts(),
    })


if __name__ == "__main__":
    main()
