"""Serving launcher: batched generation with the continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_1_7b \
        --requests 8 --prompt-len 24 --new-tokens 8 [--int8-kv] [--device cpu]

Runs on the CUDA card unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import get_config
from ..core.compile import resolve_device
from ..models import model as M
from ..serving.engine import EngineConfig, Request, ServeEngine


def serve_demo(
    arch: str,
    *,
    requests: int = 8,
    prompt_len: int = 24,
    new_tokens: int = 8,
    slots: int = 4,
    int8_kv: bool = False,
    reduced: bool = True,
    seed: int = 0,
    greedy: bool = True,
    temperature: float = 1.0,
    top_k: int = 0,
    device=None,
):
    """Serve ``requests`` random prompts of ``arch`` (seeded weights) through
    :class:`ServeEngine`'s default adapter on ``device`` (``None``: the
    card); returns the requests and the engine."""
    dev = resolve_device(device)
    cfg = get_config(arch, reduced=reduced)
    if int8_kv:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    if cfg.family == "encdec" or cfg.frontend is not None:
        raise SystemExit(f"serve demo supports text decoder archs; {arch} needs frontend feeds")
    params = M.init_params(torch.Generator(device=dev).manual_seed(seed), cfg, device=dev)
    ecfg = EngineConfig(
        slots=slots, max_len=prompt_len + new_tokens + 8,
        greedy=greedy, temperature=temperature, top_k=top_k, seed=seed,
    )
    eng = ServeEngine(params, cfg, ecfg)
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(requests):
        r = Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, (prompt_len,)).astype(np.int32),
                    max_new_tokens=new_tokens)
        reqs.append(r)
        eng.submit(r)
    t0 = time.monotonic()
    eng.run_until_drained()
    dt = time.monotonic() - t0
    toks = sum(len(r.generated) for r in reqs)
    ttfts = [r.t_first - r.t_submit for r in reqs]
    print(
        f"[serve] {arch} on {dev} kv={cfg.kv_cache_dtype} requests={requests} tokens={toks} "
        f"wall={dt:.2f}s tput={toks / dt:.1f} tok/s "
        f"ttft p50={np.percentile(ttfts, 50):.3f}s metrics={eng.metrics}"
    )
    return reqs, eng


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--int8-kv", action="store_true")
    ap.add_argument("--sample", action="store_true", help="temperature/top-k sampling instead of greedy")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    serve_demo(
        args.arch, requests=args.requests, prompt_len=args.prompt_len,
        new_tokens=args.new_tokens, slots=args.slots, int8_kv=args.int8_kv,
        greedy=not args.sample, temperature=args.temperature, top_k=args.top_k,
        device=args.device,
    )


if __name__ == "__main__":
    main()
