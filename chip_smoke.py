#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``).

Drives the port's main path on one CUDA card and fails loudly:

1. environment — the card's name and power limit, torch and CUDA versions;
2. build — ``nvcc`` compiles ``kernels/csrc/*.cu`` for sm_90a, one process per
   source, all at once;
3. kernels — each hand-written kernel (qmatmul, qmatmul_packed, qattention)
   held bit-exact against its plain PyTorch version at the token path's
   shapes, then timed with CUDA events beside its bound;
4. slice — the compiled token path at Qwen3-1.7B widths (vocab 151936,
   d_model 2048, 16 heads of 128, d_ff 6144; depth cut to ``N_LAYERS``),
   built twice from one seed — backend ``cuda`` and backend ``ref`` — and
   held identical through prefill, decode steps and ServeEngine generation;
5. summary — one JSON line of the kernels with their launch counts on the
   slice phase, then the card line, then the ``{"ok": true, ...}`` line.

Any mismatch or exception exits non-zero; nothing falls back to the CPU or
to a kernel's plain version.  Run from the repository root:

    python3 chip_smoke.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: Depth cut of the 28-layer configuration (widths are full).
N_LAYERS = 8
#: H100 SXM peaks the bounds are computed from (NVIDIA data sheet, dense).
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT8_OPS_PER_S = 1979e12
#: Timing: launches per median, after warm-up.
REPS, WARMUP = 25, 3
OUT_DIR = os.path.join(ROOT, "chiprun_out")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def bound_ms(nbytes: float, ops: float):
    t_mem = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT8_OPS_PER_S * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def time_ms(fn, flush) -> float:
    """Median device time of ``fn`` over REPS launches, each after the 50 MB
    L2 cache was overwritten: on the main path a decode step's layers
    together outgrow L2, so each kernel meets its weights cold.  A spin of
    about a millisecond on the card precedes each launch, so the host has
    queued the launch before the start event fires and the time is the
    device's, not the wrapper's Python."""
    import torch

    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(REPS):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

MATMUL_SHAPES = [  # (K, N, bits, relu): qkv, o, up, down of one layer
    (2048, 6144, 4, False),
    (2048, 2048, 8, False),
    (2048, 6144, 8, True),
    (6144, 2048, 4, False),
]
MATMUL_M = (4, 77, 128, 512)
ATTN_SHAPES = [(1, 512), (1, 77), (128, 128), (77, 96)]  # (S, T) at B=4, dh=128
DECODE_M = 4  # rows of a decode step at 4 slots


def _matmul_operands(rng, k, n, bits, device):
    import numpy as np

    from repro_torch.kernels import ops

    lo, hi = (-8, 8) if bits == 4 else (-128, 128)
    w = rng.integers(lo, hi, (k, n)).astype(np.int8)
    bias = rng.integers(-(1 << 20), 1 << 20, (n,)).astype(np.int32)
    qs = rng.integers(1 << 20, 1 << 24, (n,)).astype(np.float32)  # §3.1 integer scales
    qsh = (2.0 ** -rng.integers(30, 40, (n,))).astype(np.float32)
    return ops.template_qmatmul_params(w, bias, qs, qsh, weight_bits=bits, device=device)


def check_kernels(device, flush, rows):
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import qattention as qatt
    from repro_torch.kernels import qmatmul as qmm
    from repro_torch.core.patterns import ATTN_BIG, ATTN_LUT_SCALE, ATTN_P_SCALE, build_exp_lut

    rng = np.random.default_rng(0)
    worst = {"qmatmul": 0, "qmatmul_packed": 0, "qattention": 0}
    for k, n, bits, relu in MATMUL_SHAPES:
        consts, shape = _matmul_operands(rng, k, n, bits, device)
        name = "qmatmul_packed" if bits == 4 else "qmatmul"
        kern = qmm.qmatmul_packed if bits == 4 else qmm.qmatmul
        plain = qmm.qmatmul_packed_plain if bits == 4 else qmm.qmatmul_plain
        for m in MATMUL_M:
            x = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(np.int8)).to(device)
            bm = ops.bind_qmatmul_axes({**shape, "lead": (m,)}, None)["bm"]
            kw = dict(n=n, relu=relu, two_mul=True, bm=bm)
            got = kern(x, *consts, **kw)
            want = plain(x, *consts, **kw)
            torch.cuda.synchronize()
            err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
            worst[name] = max(worst[name], err)
            if err:
                raise AssertionError(f"{name} K={k} N={n} M={m}: max |kernel - plain| = {err}")
            wbytes = k * n // 2 if bits == 4 else k * n
            b_ms, b_by = bound_ms(m * k + wbytes + 12 * n + m * n, 2.0 * m * n * k)
            ms = time_ms(lambda: kern(x, *consts, **kw), flush)
            pms = time_ms(lambda: plain(x, *consts, **kw), flush)
            rows.append(dict(kernel=name, shape=f"M={m},K={k},N={n},w{bits}{',relu' if relu else ''}",
                             ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err))
            log(f"  {name:15s} M={m:4d} K={k} N={n} w{bits}: exact, {ms:.4f} ms "
                f"(plain {pms:.4f} ms, bound {b_ms:.4f} ms by {b_by})")

    lut = torch.from_numpy(build_exp_lut()).to(device)
    scal = dict(qk_scale=float(np.float32(0.05 * 0.05 / np.sqrt(128))), big=ATTN_BIG,
                lut_scale=ATTN_LUT_SCALE, p_scale=ATTN_P_SCALE, rescale=float(np.float32(1 / ATTN_P_SCALE)))
    b, dh = 4, 128
    for s, t in ATTN_SHAPES:
        q = torch.from_numpy(rng.integers(-128, 128, (b, s, dh)).astype(np.int8)).to(device)
        kk = torch.from_numpy(rng.integers(-128, 128, (b, t, dh)).astype(np.int8)).to(device)
        v = torch.from_numpy(rng.integers(-128, 128, (b, t, dh)).astype(np.int8)).to(device)
        if s == 1:  # decode: keys up to a per-row position are valid
            pos = rng.integers(0, t, (b,))
            mk = (np.arange(t)[None, None, :] <= pos[:, None, None]).astype(np.float32)
        else:  # prefill: causal over a right-aligned window
            mk = np.broadcast_to(np.tril(np.ones((s, t), np.float32), t - s), (b, s, t)).copy()
        mask = torch.from_numpy(mk).to(device)
        got = qatt.qattention(q, kk, v, mask, lut, **scal)
        want = qatt.qattention_plain(q, kk, v, mask, lut, **scal)
        torch.cuda.synchronize()
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        worst["qattention"] = max(worst["qattention"], err)
        if err:
            raise AssertionError(f"qattention B={b} S={s} T={t}: max |kernel - plain| = {err}")
        nbytes = b * s * dh * 2 + 2 * b * t * dh + 4 * b * s * t + 256
        b_ms, b_by = bound_ms(nbytes, 4.0 * b * s * t * dh)
        ms = time_ms(lambda: qatt.qattention(q, kk, v, mask, lut, **scal), flush)
        pms = time_ms(lambda: qatt.qattention_plain(q, kk, v, mask, lut, **scal), flush)
        rows.append(dict(kernel="qattention", shape=f"B={b},S={s},T={t},dh={dh}",
                         ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err))
        log(f"  qattention      B={b} S={s:3d} T={t:3d} dh={dh}: exact, {ms:.4f} ms "
            f"(plain {pms:.4f} ms, bound {b_ms:.4f} ms by {b_by})")
    return worst


# ---------------------------------------------------------------------------
# phase 4: the token path, cuda backend against ref backend
# ---------------------------------------------------------------------------

def _same(a, b, what: str) -> None:
    import torch

    if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
        raise AssertionError(f"{what}: backends cuda and ref disagree")


def run_slice(device):
    import numpy as np
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving.engine import EngineConfig, Request, ServeEngine
    from repro_torch.serving.token_path import (
        CompiledTokenAdapter, CompiledTokenPath, TokenPathConfig, make_token_params,
    )

    cfg = TokenPathConfig(vocab=151936, d_model=2048, n_heads=16, d_ff=6144, n_layers=N_LAYERS)
    log(f"  config: vocab={cfg.vocab} d_model={cfg.d_model} heads={cfg.n_heads}x{cfg.d_head} "
        f"d_ff={cfg.d_ff} layers={cfg.n_layers} of 28 (depth cut), w4 qkv/down, w8 o/up")
    t0 = time.perf_counter()
    params = make_token_params(cfg, seed=0)
    tps = {b: CompiledTokenPath(cfg, params, backend=b, device=device) for b in ("cuda", "ref")}
    log(f"  params + compile of both backends: {time.perf_counter() - t0:.1f} s")
    for b, tp in tps.items():
        log(f"  {b}: prefill {tp.prefill_cm.stats}")

    rng = np.random.default_rng(1)
    n, plen, s_max, steps = 4, 128, 512, 8
    toks = rng.integers(1, cfg.vocab, (n, plen)).astype(np.int32)
    mask = np.broadcast_to(np.tril(np.ones((plen, plen), np.float32)), (n, plen, plen)).copy()
    dec_toks = rng.integers(1, cfg.vocab, (steps, n, 1)).astype(np.int32)
    prompts = [rng.integers(1, cfg.vocab, (p,)).astype(np.int32) for p in (17, 64, 100, 200)]

    def drive(tp):
        """Prefill (4,128), 8 decode steps at (4,512), then 4 engine requests."""
        out = {}
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, pcache = tp.prefill(toks, mask)
        torch.cuda.synchronize()
        out["prefill_ms"] = (time.perf_counter() - t) * 1e3
        out["prefill"] = (logits, pcache)
        cache = tp.init_cache(n, s_max)
        for name in cache:
            cache[name][:, :plen] = pcache[name]
        step_logits, step_ms = [], []
        for i in range(steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            lg, cache = tp.decode_step(dec_toks[i], np.full((n,), plen + i), cache)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            step_logits.append(lg)
        out["decode"] = (step_logits, cache)
        out["decode_ms"] = sorted(step_ms)[len(step_ms) // 2]
        eng = ServeEngine(EngineConfig(slots=4, max_len=512, prefill_bucket=32),
                          adapter=CompiledTokenAdapter(tp))
        reqs = [Request(uid=i, prompt=p, max_new_tokens=16) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.run_until_drained()
        torch.cuda.synchronize()
        out["engine_s"] = time.perf_counter() - t
        out["engine_tokens"] = sum(len(r.generated) for r in reqs)
        out["generated"] = [list(r.generated) for r in reqs]
        return out

    # warm the cuda path once (first launches, allocator), then the counted run
    drive(tps["cuda"])
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(device)
    got = drive(tps["cuda"])
    torch.cuda.synchronize()
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    want = drive(tps["ref"])

    (gl, gc), (wl, wc) = got["prefill"], want["prefill"]
    if gl.shape != (n, plen, cfg.vocab) or not bool(torch.isfinite(gl).all()):
        raise AssertionError(f"prefill logits: shape {tuple(gl.shape)} or non-finite values")
    _same(gl, wl, "prefill logits")
    for name in wc:
        _same(gc[name], wc[name], f"prefill state {name}")
    for i, (a, b) in enumerate(zip(got["decode"][0], want["decode"][0])):
        if a.shape != (n, cfg.vocab) or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"decode step {i} logits: shape {tuple(a.shape)} or non-finite")
        _same(a, b, f"decode step {i} logits")
    for name in want["decode"][1]:
        _same(got["decode"][1][name], want["decode"][1][name], f"decode state {name}")
    if got["generated"] != want["generated"]:
        raise AssertionError(f"engine generation differs: {got['generated']} vs {want['generated']}")
    if [len(g) for g in got["generated"]] != [16] * 4:
        raise AssertionError(f"engine generated {[len(g) for g in got['generated']]} tokens, want 16 each")
    log("  prefill (4,128), 8 decode steps at (4,512) and 4 engine requests: cuda == ref, bit for bit")
    perf = dict(
        prefill_ms=got["prefill_ms"], decode_step_ms=got["decode_ms"],
        decode_tokens_per_s=n / (got["decode_ms"] / 1e3),
        engine_tokens_per_s=got["engine_tokens"] / got["engine_s"],
        peak_bytes=peak, ref_prefill_ms=want["prefill_ms"], ref_decode_step_ms=want["decode_ms"],
    )
    return perf, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = card_line()
    log(f"[1/5] environment: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    secs = _build.build()
    log(f"[2/5] build: {', '.join(f'{k} {v:.1f} s' for k, v in secs.items())} "
        f"(wall {time.perf_counter() - t0:.1f} s, nvcc sm_90a into {_build.BUILD_DIR.name}/)")

    log("[3/5] kernels against their plain versions (tolerance 0)")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    rows = []
    worst = check_kernels(device, flush, rows)

    log(f"[4/5] slice: compiled token path, backend cuda vs backend ref  ({card})")
    perf, launches = run_slice(device)
    log(f"  prefill (4,128): {perf['prefill_ms']:.2f} ms; decode step (4,512): "
        f"{perf['decode_step_ms']:.2f} ms = {perf['decode_tokens_per_s']:.1f} tokens/s; engine "
        f"{perf['engine_tokens_per_s']:.1f} tokens/s; peak allocated "
        f"{perf['peak_bytes'] / 2**30:.2f} GiB  ({card})")
    log(f"  ref backend on the card: prefill {perf['ref_prefill_ms']:.2f} ms, decode step "
        f"{perf['ref_decode_step_ms']:.2f} ms")
    log(f"  launches on the slice phase: {launches}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")

    # per layer per decode step at (N, S) = (4, 512): the kernel's launches
    # at the decode shapes (qattention: one launch per head)
    def decode_sum(kernel, shapes, mult=1):
        sel = [r for r in rows if r["kernel"] == kernel and r["shape"] in shapes]
        return {f: mult * sum(r[f] for r in sel) for f in ("ms", "plain_ms", "bound_ms")}, sel

    summaries = {
        "qmatmul": decode_sum("qmatmul", {f"M={DECODE_M},K=2048,N=2048,w8", f"M={DECODE_M},K=2048,N=6144,w8,relu"}),
        "qmatmul_packed": decode_sum("qmatmul_packed", {f"M={DECODE_M},K=2048,N=6144,w4", f"M={DECODE_M},K=6144,N=2048,w4"}),
        "qattention": decode_sum("qattention", {"B=4,S=1,T=512,dh=128"}, mult=16),
    }
    sources = {
        "qmatmul": ("src/repro_torch/kernels/csrc/qmatmul.cu", "src/repro/kernels/qmatmul.py:217"),
        "qmatmul_packed": ("src/repro_torch/kernels/csrc/qmatmul.cu", "src/repro/kernels/qmatmul.py:170"),
        "qattention": ("src/repro_torch/kernels/csrc/qattention.cu", "src/repro/kernels/qattention.py:105"),
    }
    kernels = []
    for name, (tot, sel) in summaries.items():
        b_by = "bytes" if all(r["bound_by"] == "bytes" for r in sel) else "operations"
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0], "replaces": sources[name][1],
            "launches": launches[name], "max_abs_err": worst[name],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": b_by, "library_ms": None,
        })
    log("[5/5] summary: ms/plain_ms/bound_ms are per layer per decode step at (N,S)=(4,512) "
        "(qattention: 16 head launches); library_ms is null: no single PyTorch call computes "
        "either fused function (int8 matmul + bias + two-Mul rescale + requant; the LUT-softmax "
        "attention region)")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                   "n_layers": N_LAYERS, "rows": rows, "slice": perf, "launches": launches,
                   "kernels": kernels}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
