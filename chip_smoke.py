#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``).

Drives the port's main path on one CUDA card and fails loudly:

1. environment — the card's name and power limit, torch and CUDA versions;
2. build — ``nvcc`` compiles ``kernels/csrc/*.cu`` (qmatmul, qattention,
   qact_lut, qmoe, kv_write) for sm_90a, one process per source, all at once;
3. kernels — each hand-written kernel (qmatmul, qmatmul_packed, qattention,
   qact_lut, qmoe, kv_write) held bit-exact against its plain PyTorch version at the shapes
   its paths give it (the token path; slice A's three layers, slice B's five
   conv GEMMs and its FC head at their largest buckets; K off the 16-byte
   copies; the MLP's LUT layers), then timed with CUDA events beside its
   bound; each matmul row prints the route it took (instruction, tiles, K
   splits, staging of x) and, where ``torch._int_mm`` takes the shape, that
   call's time for the int32 GEMM body alone (``gemm_library_ms``, a
   yardstick the port never calls); qattention also runs on the token
   path's per-head q/k/v views (head ``ATTN_HEAD`` of buffers of width
   3·``ATTN_D``) at every cluster size at decode, each row with its
   cluster size and threads per block; the qmatmul epilogue with an
   activation table (the main path's LUT route) at slice A's two LUT
   layers, at the decode route with split-K and on the packed lane, each
   timed beside the same matmul without a table and beside matmul →
   standalone qact_lut (→ shift); the routed-expert step (qmoe's five
   launches) at one Mellum2 expert layer's widths (64 experts of 896 over
   2304, top-8) at the benchmark's decode step (64 tokens) and its largest
   prefill bucket (4,608 tokens), timed beside its plain version and its
   bound (the router and the weights of the experts its rows can reach);
   the decode step's KV update (kv_write) on the decode cells' caches —
   MiniCPM-2B's (16, 4,096, 2,304), Mellum2's ring (64, 1,024, 512) and
   full cache (64, 7,680, 512) — over five kinds of onehot, against its
   plain version and the four int8 ops it replaces, timed beside both;
   and every qmatmul kernel instance's static shared memory and registers
   as CUDA reports them;
4. token path — the compiled token path at Qwen3-1.7B widths (vocab 151936,
   d_model 2048, 16 heads of 128, d_ff 6144; depth cut to ``N_LAYERS``),
   built twice from one seed — backend ``cuda`` and backend ``ref`` — and
   held identical through prefill, decode steps and ServeEngine generation;
   then one decode step traced with ``torch.profiler`` after a discarded,
   profiled warm-up step (device time by kernel, the card's idle share),
   which fails if any per-head q/k/v view was copied;
5. slice A — the paper's Tanh/Sigmoid MLP (§4/§6; fp16 tanh flow) at the
   feed-forward widths 2048 → 6144 → 6144 → 2048, served by
   ``CompiledModelServer`` on both backends, responses identical and equal
   to the numpy ``ReferenceRuntime`` on a sample; on ``cuda`` both tables
   ride in the qmatmul epilogue (3 launches a batch, 2 with a table) and
   the profiled forward shows no standalone LUT or shift kernel;
6. slice B — the paper's §5 CNN (stride-2 ConvInteger stack with ResNet-18's
   stage widths, 7×7/2 stem, 1000-way FC head, 3×224×224 input), served
   the same way;
7. autotune — the measured tile search (``repro_torch.backend.autotune``)
   on phase 4's token path: cold, it tunes the prefill (4,128) and decode
   (4,512) cells into a tile cache under ``chiprun_out/`` (every fused
   step ``[tuned]``; qmatmul, qmatmul_packed and qattention candidates all
   launched); warm, a second token path on that cache measures nothing
   (every step ``[cache]``); both equal phase 4's ``ref`` run bit for bit.
   The tuned decode plan is saved as an AOT artifact
   (``repro_torch.backend.artifact``) and served by a fresh process
   (``chip_smoke.py --load-artifact``, importing only ``repro_torch``) with
   no fuse/lower span and no plan-cache miss, its outputs equal to the
   ``ref`` backend's; ``scripts/plan_diff.py`` and the port's
   ``python -m repro_torch.scripts.plan_diff`` self-diff it identical, and
   the port's diff of the same decode plan saved with heuristic tiles
   against it exits 1, names every fused step of the cell and shows moved
   tiles (``bm``/``splits`` or ``cluster``) on exactly the steps the tile
   cache moved (``scripts/plan_diff.py``'s reading of that pair is logged).
   Slice A is served with a background tuner (``tuned_swaps`` >= 1,
   nothing pending, responses equal to ``ref``).  Log lines give heuristic
   vs winning tiles per tuned step shape and the phase's wall times;
8. fleet and checkpoints — (a) a two-axis per-token FFN at the widths of
   ``src/repro/configs/qwen3_1_7b.py`` (x int8 (N, S, 2048) → FC 6144 +
   ReLU, w8 → FC 2048, w4; per-channel, seed 0) compiled on ``cuda``, its
   hot cells (batch 8 × seq buckets 64/128/192) recorded by a server and
   saved as an AOT artifact, then served by three replicas warm-started
   from it (``ShardedRouter.from_artifact``) for at least MIN_WINDOW_S:
   each cell on its own replica, no plan-cache miss, nothing lost or
   served twice, every response equal to its solo run on the ``ref``
   backend and a sample equal to ``ReferenceRuntime``; (b) a further wave
   with one replica raising: one failover, its queue migrated in order,
   its cell re-pointed, responses still equal; (c) phase 4's ``cuda``
   decode checkpointed by ``CheckpointManager`` under ``run_resilient``
   through a crash, equal to an uninterrupted run bit for bit, and a
   CPU-written checkpoint restored onto the card; (d) the generic
   MaxPool / AveragePool ops on the card against ``ReferenceRuntime``;
9. model zoo — (a) ``qwen3_1_7b`` at its full published config (28 layers,
   vocab padded to 152064; float32 masters from a seeded generator on the
   card) served by ``ServeEngine(params, cfg, EngineConfig(slots=4))``
   through its default ``OpaqueModelAdapter`` in the three postures of
   ``examples/serve_quantized.py`` (bf16/bf16-kv, bf16/int8-kv,
   w8a8/int8-kv): 8 greedy requests (six prompts of 24 tokens, two of 40),
   8 new tokens each; tokens/s, prefill and decode-step ms, peak memory,
   token agreement with bf16/bf16-kv, and one profiled decode step; (b)
   the same weights cut to ``ZOO_CUT_LAYERS`` layers, prefill + 4 decode
   steps on the card against the CPU in bf16/bf16-kv and w8a8/int8-kv;
   (c) every other architecture at ``reduced()`` the same way, 2 decode
   steps; (d) ``QuantizedLinear`` 2048 → 6144 at M = 4, 77, 512 on backend
   ``cuda`` (the qmatmul kernel) equal to ``ref`` bit for bit;
10. training — (a) ``qwen3_1_7b`` at its full config trained by
   ``repro_torch.launch.train.train`` on the card (float32 masters and
   compute, TF32 off, remat ``nothing_saveable``, ``warmup_cosine``, batch
   4 × seq 512) for 6 steps plain and 6 with QAT: per step loss, grad norm,
   lr, host step ms, tokens/s and peak memory; one plain step profiled
   (device ms by kernel, idle share); fails on a non-finite loss or any
   hand-written kernel launch; (b) its weights cut to 2 layers: one grad
   step (batch 2 × seq 128) plain and with QAT on the card and on the CPU
   (loss within 1e-5 relative, gradients within 1e-3 · max(1, max |CPU|)),
   the QAT codes of every weight equal, AdamW fed the CPU's gradients on
   both devices within 1e-6 relative; (c) ``TestTrainLoop`` on the card at
   ``reduced()`` (8 steps, resume to 10) and a CPU-written checkpoint
   resumed on the card at step 5; (d) ``grad_compress`` over a one-rank
   NCCL/gloo group on (b)'s gradients, card == CPU;
11. mesh — a one-rank NCCL process group in this process (a ``HashStore``,
   no network) and ``launch.mesh.make_test_mesh((1, 1))`` on the card: (a)
   ``train("qwen3_1_7b", reduced=False, mesh=)`` with phase 10 (a)'s seed,
   data, schedule and remat for ``MESH_STEPS`` steps, every param and
   moment a DTensor on cuda, each step's loss and grad norm within
   ``MESH_TOL`` relative of phase 10 (a)'s, median step ms beside phase
   10's and peak memory; (b) ``qwen3_1_7b`` at full widths cut to
   ``ZOO_CUT_LAYERS`` layers, prefill + ``ZOO_DECODE_STEPS`` decode steps
   through ``launch.steps`` with params and caches laid out by
   ``specs.params_shardings`` / ``cache_shardings``, logits within
   ``MESH_TOL`` · max(1, max |unsharded|) of the same steps unsharded on the
   card; (c) (b)'s params saved from the mesh and restored with
   ``shardings=`` onto the mesh and onto the plain card, bit for bit;
   (a)–(c) launch no hand-written kernel; (d) ``tests/test_torch_mesh.py``'s
   4-rank gloo train step and prefill + decode steps, spawned as CPU
   processes under the card's torch, against one device; (e) the
   dry-run's byte accounting (``launch.dryrun._Accounting``) over one
   train step on the mesh beside the allocator's peak rise, at full width
   and at ``reduced()``;
12. recurrent families at full width — ``rwkv6_3b`` at its published config
   (32 layers, d_model 2560, 40 heads of 64, d_ff 8960, vocab 65536;
   float32 masters from a seeded card generator): (a) served by
   ``ServeEngine``'s default adapter, 4 slots, ``RECUR_REQUESTS`` greedy
   requests of ``RECUR_PROMPT`` tokens (tokens/s, prefill and decode-step
   ms, peak memory, one profiled prefill and decode step), and one
   prefill and one decode step with the chunked WKV6 against the same
   through its per-step plain version (host ms of each, logits within
   ``ZOO_TOL``);
   (b) the chunked ``_wkv_scan`` against its plain version at one layer's
   full shape ``RECUR_LAYER`` (outputs, final state, the gradients of r,
   k, v, the log-decay, u and the state within ``RECUR_TOL``; each timed),
   and the weights cut to ``ZOO_CUT_LAYERS`` layers, card against CPU as
   phase 9 (b); (c) ``train("rwkv6_3b", reduced=False)`` as phase 10 (a)
   runs qwen3 (float32, TF32 off, ``nothing_saveable``, batch 4 × 512) for
   ``RECUR_TRAIN_STEPS`` steps and one profiled step; no hand-written
   kernel launches;
13. examples — each of ``src/repro_torch/examples`` (quickstart,
   cnn_prequant, serve_compiled, fleet_serve, serve_quantized, train_qat)
   run as a child process, ``python -m repro_torch.examples.<name>``, at the
   defaults of its ``examples/`` original: every check in its last JSON
   line true (codes and responses equal to ``ReferenceRuntime``, nothing
   lost or served twice, finite QAT losses and the W8A8 loss drift under
   0.15 after 200 QAT steps), the four compiled examples launching qmatmul;
   each child counts its own launches from its start;
14. Mellum2 — the compiled token path at Mellum2-12B-A2.5B's widths
   (vocab 98304, d_model 2304, 32 query heads over 4 KV heads of 128, 64
   routed int8 experts of 896, top-8; one period of its layer pattern,
   three window layers with 1,024-row rings and a full one), built twice
   from one seed — backend ``cuda`` and backend ``ref`` — and served by
   ``ServeEngine`` through ``CompiledTokenAdapter`` (``MELLUM2_REQUESTS``:
   prompts under, across and past the window, slots taken over): every
   logits row, every prefill's K/V rows, the final full caches and rings
   and the generated tokens identical; one fused ``qmoe`` step a layer,
   exactly five qmoe launches a layer per prefill and per decode step, the
   decode steps all graph replays;
15. summary — one JSON line of the kernels with their launch counts summed
   over the served runs of phases 4–14, then the card line, then the
   ``{"ok": true, ...}`` line.

Each of phases 4–12 and 14 zeroes the launch counters just before each counted run
and reads them just after; a kernel of that path launched no time fails
(the zoo's served runs, phase 10's training runs, phase 11's mesh runs and
phase 12's runs launch none of the hand-written kernels — they compute in
plain PyTorch, as ``repro`` computes them in XLA — and must show none; the
zoo's kernel is qmatmul under ``QuantizedLinear``).
Phase 7's served runs are the tuned and the warm-started token path's
drives; phase 8's, the fleet's rounds, its failover wave and the resilient
decode; the launches of the tuner's candidates (timed on synthetic inputs,
also between the slice A server's batches) are read on their own and kept
in ``chiprun_out/chip_smoke.json`` only.

Any mismatch or exception exits non-zero; nothing falls back to the CPU or
to a kernel's plain version.  Run from the repository root:

    python3 chip_smoke.py
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import textwrap
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: Depth cut of the 28-layer configuration (widths are full).
N_LAYERS = 8
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
    """The least time (ms) the card could take for ``nbytes`` moved and
    ``ops`` int8 operations, and which of the two bounds it: the H100 SXM
    data sheet's peaks (dense), held by the port's cost model
    (``repro_torch.backend.cost.H100_SXM``).  Imported here, not at the
    top: ``scripts/qact_lut_ab.py --parent`` imports this module before it
    puts an earlier tree's ``repro_torch`` first on the path."""
    from repro_torch.backend.cost import roofline_terms

    t = roofline_terms(ops, nbytes)
    t_mem, t_ops = t["t_mem_s"] * 1e3, t["t_ops_s"] * 1e3
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


def _int8(rng, shape):
    import numpy as np

    return rng.integers(-128, 128, shape).astype(np.int8)


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
#: K off the kernel's 16-byte copies (the conv route's C·kH·kW), both lanes
EDGE_K, EDGE_M, EDGE_N = (10, 27, 147), (4, 77), 64
#: qact_lut shapes: a decode row, slice A's largest bucket, a large batch,
#: a ragged tile whose numel is not a multiple of 16
LUT_SHAPES = [(1, 6144), (64, 6144), (4096, 6144), (37, 2051)]
ATTN_SHAPES = [(1, 512), (1, 77), (128, 128), (77, 96)]  # (S, T) at B=4, dh=128
#: the token path's per-head views: (S, T) at decode (every cluster size)
#: and prefill, cut at head ATTN_HEAD from buffers of width 3·ATTN_D
ATTN_VIEW_SHAPES = [(1, 512), (1, 77), (128, 128)]
ATTN_D, ATTN_HEAD = 2048, 5
DECODE_M = 4  # rows of a decode step at 4 slots
#: One Mellum2-12B-A2.5B expert layer (64 SwiGLU experts of width 896 over
#: d_model 2304, top-8) for the qmoe rows: the benchmark's decode step (64
#: sessions, row tile 16) and its largest prefill bucket (4,608 tokens,
#: row tile 64).
QMOE_D, QMOE_F, QMOE_E, QMOE_K = 2304, 896, 64, 8
QMOE_TOKENS = (64, 4608)
#: The caches the decode cells' kv_write steps update, (N, R, W): MiniCPM-2B's
#: (tokpath-decode: 16 slots, 4,096 rows, 36 heads of 64), Mellum2's
#: 1,024-row ring and its full cache (mellum2-decode64: 64 slots, 4 KV heads
#: of 128), whose rows span two of a block's 4,096-row chunks.
KV_WRITE_SHAPES = [("minicpm2b-cache", 16, 4096, 2304), ("mellum2-ring", 64, 1024, 512),
                   ("mellum2-cache", 64, 7680, 512)]
#: The onehots the CPU tests hold the update to (tests/test_torch_kv_write.py);
#: the path's own, one 1 a slot, is timed.
KV_WRITE_ONEHOTS = ("one-a-row", "padded-slot", "two-in-a-row", "minus-one", "max")
#: Phase 8's fleet FFN: d_model and d_ff of src/repro/configs/qwen3_1_7b.py;
#: batches of FLEET_MAX_BATCH requests padded to each seq bucket.
FLEET_D, FLEET_FF = 2048, 6144
FLEET_MAX_BATCH, FLEET_SEQ = 8, 64
FLEET_BUCKETS = (64, 128, 192)
FLEET_M = tuple(FLEET_MAX_BATCH * s for s in FLEET_BUCKETS[1:])
#: The qmatmul epilogue with a table: (tag, M, K, N, weight bits, table) —
#: slice A's Tanh layer (int8 table) and Sigmoid layer (uint8 table shifted
#: to int8 as the plan folds it before the last FC) at a lone row, a ragged
#: bucket and batch 64, the Sigmoid table unshifted, the decode route with
#: split-K, and the packed lane.
LUT_EPILOGUE_ROWS = [
    ("sliceA", m, k, 6144, 8, kind)
    for m in (1, 17, 64) for k, kind in ((2048, "int8"), (6144, "uint8-128"))
] + [
    ("sliceA", 64, 6144, 6144, 8, "uint8"),
    ("decode", 4, 2048, 6144, 8, "int8"),
    ("packed", 4, 6144, 2048, 4, "uint8"),
]


def _matmul_operands(rng, k, n, bits, device):
    import numpy as np

    from repro_torch.kernels import ops

    lo, hi = (-8, 8) if bits == 4 else (-128, 128)
    w = rng.integers(lo, hi, (k, n)).astype(np.int8)
    bias = rng.integers(-(1 << 20), 1 << 20, (n,)).astype(np.int32)
    qs = rng.integers(1 << 20, 1 << 24, (n,)).astype(np.float32)  # §3.1 integer scales
    qsh = (2.0 ** -rng.integers(30, 40, (n,))).astype(np.float32)
    return ops.template_qmatmul_params(w, bias, qs, qsh, weight_bits=bits, device=device)


def _max_err(got, want) -> int:
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"kernel gave {got.dtype}{tuple(got.shape)}, plain {want.dtype}{tuple(want.shape)}")
    return int((got.to(torch.int32) - want.to(torch.int32)).abs().max())


def served_gemms():
    """The qmatmul shapes of slices A and B at their largest buckets, as
    ``(tag, M, K, N, relu)``: slice A's three layers at batch 64, slice B's
    five conv GEMMs (M = 16·OH·OW, K = C·kH·kW) and its FC head at batch 16."""
    out = [("sliceA", MLP_MAX_BATCH, a, b, False) for a, b in zip(MLP_WIDTHS, MLP_WIDTHS[1:])]
    side = CNN_IN[1]
    for m, c, k, st, pd in CNN_CONVS:
        side = (side + 2 * pd - k) // st + 1
        out.append(("conv", CNN_MAX_BATCH * side * side, c * k * k, m, True))
    out.append(("fc", CNN_MAX_BATCH, CNN_CONVS[-1][0] * side * side, CNN_CLASSES, False))
    return out


def _int_mm_ms(x, w2, k, n, flush):
    """Time of ``torch._int_mm`` for the int32 GEMM body of the same
    product (no bias, rescale or requant), or None where it refuses the
    shape (it wants M > 16 and K, N multiples of 8)."""
    import torch

    wt = w2[:n, :k].t()
    try:
        torch._int_mm(x, wt)
    except RuntimeError:
        return None
    return time_ms(lambda: torch._int_mm(x, wt), flush)


def _check_matmul(rng, device, flush, rows, worst, m, k, n, bits, relu, tag=""):
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import qmatmul as qmm

    consts, shape = _matmul_operands(rng, k, n, bits, device)
    name = "qmatmul_packed" if bits == 4 else "qmatmul"
    kern = qmm.qmatmul_packed if bits == 4 else qmm.qmatmul
    plain = qmm.qmatmul_packed_plain if bits == 4 else qmm.qmatmul_plain
    x = torch.from_numpy(_int8(rng, (m, k))).to(device)
    bound = ops.bind_qmatmul_axes({**shape, "lead": (m,)}, None)
    kw = dict(n=n, relu=relu, two_mul=True, bm=bound["bm"], splits=bound["splits"])
    rt = qmm.route(x, bound["bm"], bound["splits"])
    err = _max_err(kern(x, *consts, **kw), plain(x, *consts, **kw))
    worst[name] = max(worst[name], err)
    if err:
        raise AssertionError(f"{name} K={k} N={n} M={m} {rt}: max |kernel - plain| = {err}")
    wbytes = k * n // 2 if bits == 4 else k * n
    b_ms, b_by = bound_ms(m * k + wbytes + 12 * n + m * n, 2.0 * m * n * k)
    ms = time_ms(lambda: kern(x, *consts, **kw), flush)
    pms = time_ms(lambda: plain(x, *consts, **kw), flush)
    # no library GEMM takes int4 nibble pairs
    gms = _int_mm_ms(x, consts[0], k, n, flush) if bits == 8 else None
    rows.append(dict(kernel=name, shape=f"M={m},K={k},N={n},w{bits}{',relu' if relu else ''}{tag}",
                     ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                     route=rt, gemm_library_ms=gms))
    gtxt = "refused" if gms is None else f"{gms:.4f} ms"
    log(f"  {name:15s} M={m:6d} K={k:5d} N={n:4d} w{bits}{tag}: exact, {ms:.4f} ms (plain "
        f"{pms:.4f} ms, bound {b_ms:.3g} ms by {b_by}, _int_mm body {gtxt}) "
        f"[{rt['instruction']} bm={rt['bm']} bn={rt['bn']} splits={rt['splits']} {rt['staging']}]")


def _check_lut(flush, rows, worst, x, lut, tag):
    import torch

    from repro_torch.kernels import qact_lut as qact

    err = _max_err(qact.qact_lut(x, lut), qact.qact_lut_plain(x, lut))
    worst["qact_lut"] = max(worst["qact_lut"], err)
    if err:
        raise AssertionError(f"qact_lut {tag}: max |kernel - plain| = {err}")
    # the library yardstick gathers with int64 indices converted beforehand,
    # so its time leaves out the int8 -> int64 conversion a real call needs
    idx = x.to(torch.int64) + 128
    lms = time_ms(lambda: torch.take(lut, idx), flush)
    ms = time_ms(lambda: qact.qact_lut(x, lut), flush)
    pms = time_ms(lambda: qact.qact_lut_plain(x, lut), flush)
    b_ms, b_by = bound_ms(2 * x.numel() + 256, 0.0)
    rows.append(dict(kernel="qact_lut", shape=tag, ms=ms, plain_ms=pms, bound_ms=b_ms,
                     bound_by=b_by, library_ms=lms, max_abs_err=err))
    log(f"  qact_lut        {tag}: exact, {ms:.4f} ms (plain {pms:.4f} ms, torch.take "
        f"{lms:.4f} ms, bound {b_ms:.3g} ms by {b_by})")


def _table(rng, kind, device):
    """A random activation table: int8, uint8, or uint8 stored shifted to
    int8 (``u - 128``), with the uint8 table it came from (else None)."""
    import numpy as np
    import torch

    dt = "int8" if kind == "int8" else "uint8"
    info = np.iinfo(dt)
    lut = torch.from_numpy(rng.integers(info.min, info.max + 1, (256,)).astype(dt)).to(device)
    if kind != "uint8-128":
        return lut, None
    return (lut ^ 128).view(torch.int8), lut


def _check_lut_epilogue(rng, device, flush, rows, worst, tag, m, k, n, bits, kind):
    """The matmul with a table in its epilogue against its plain version and
    against the unfolded chain, matmul → standalone qact_lut (→ the uint8
    shift, for a shifted table), bit for bit; then the three timed in turns,
    unfolded / table / no table / no table / table / unfolded, so a drift of
    the card's clock hits each alike.  ``added_ms`` is the table's cost
    (with minus without), ``added_range_ms`` its spread over the turns."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import qact_lut as qact
    from repro_torch.kernels import qmatmul as qmm

    consts, shape = _matmul_operands(rng, k, n, bits, device)
    kern = qmm.qmatmul_packed if bits == 4 else qmm.qmatmul
    plain = qmm.qmatmul_packed_plain if bits == 4 else qmm.qmatmul_plain
    x = torch.from_numpy(_int8(rng, (m, k))).to(device)
    bound = ops.bind_qmatmul_axes({**shape, "lead": (m,)}, None)
    kw = dict(n=n, relu=False, two_mul=True, bm=bound["bm"], splits=bound["splits"])
    lut, unshifted = _table(rng, kind, device)
    rt = qmm.route(x, bound["bm"], bound["splits"])

    def unfolded():
        y = qact.qact_lut(kern(x, *consts, **kw), lut if unshifted is None else unshifted)
        return y if unshifted is None else ops.shift_uint8(y)

    got = kern(x, *consts, lut=lut, **kw)
    err = max(_max_err(got, plain(x, *consts, lut=lut, **kw)), _max_err(got, unfolded()))
    worst["qact_lut"] = max(worst["qact_lut"], err)
    if err:
        raise AssertionError(f"qmatmul+lut {tag} M={m} K={k} N={n} w{bits} {kind} {rt}: "
                             f"max |kernel - plain| = {err}")
    fns = {"unfolded": unfolded, "table": lambda: kern(x, *consts, lut=lut, **kw),
           "bare": lambda: kern(x, *consts, **kw)}
    turns = {who: [] for who in fns}
    for who in ("unfolded", "table", "bare", "bare", "table", "unfolded"):
        turns[who].append(time_ms(fns[who], flush))
    ms, bare_ms, unfolded_ms = (sum(turns[w]) / 2 for w in ("table", "bare", "unfolded"))
    added = (min(turns["table"]) - max(turns["bare"]), max(turns["table"]) - min(turns["bare"]))
    pms = time_ms(lambda: plain(x, *consts, lut=lut, **kw), flush)
    wbytes = k * n // 2 if bits == 4 else k * n
    b_ms, b_by = bound_ms(m * k + wbytes + 12 * n + 256 + m * n, 2.0 * m * n * k)
    rows.append(dict(kernel="qmatmul_lut", shape=f"{tag},M={m},K={k},N={n},w{bits},{kind}",
                     ms=ms, bare_ms=bare_ms, added_ms=ms - bare_ms, added_range_ms=added,
                     unfolded_ms=unfolded_ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                     max_abs_err=err, route=rt, turns_ms=turns))
    log(f"  qmatmul+lut     {tag} M={m:3d} K={k:5d} N={n:4d} w{bits} {kind:9s}: exact, {ms:.4f} ms "
        f"(no table {bare_ms:.4f} ms, table adds {ms - bare_ms:+.4f} ms [{added[0]:+.4f}, "
        f"{added[1]:+.4f}]; unfolded {unfolded_ms:.4f} ms, x{unfolded_ms / ms:.2f}; plain "
        f"{pms:.4f} ms; bound {b_ms:.3g} ms by {b_by}) "
        f"[{rt['instruction']} bm={rt['bm']} splits={rt['splits']} {rt['staging']}]")


def kernel_instances():
    """Static shared memory and registers of every qmatmul kernel instance
    (cudaFuncGetAttributes); raises past the 48 KB static limit."""
    from repro_torch.kernels import qmatmul as qmm

    out = []
    for bm in qmm.SUPPORTED_BM:
        for packed in (False, True):
            for x16 in (True, False):
                a = qmm.kernel_attrs(bm, packed, x16)
                if a["shared_bytes"] > 48 * 1024:
                    raise AssertionError(f"qmatmul bm={bm} packed={packed} x16={x16}: "
                                         f"{a['shared_bytes']} B of static shared memory")
                out.append(dict(bm=bm, packed=packed, x16=x16, **a))
    log("  qmatmul instances (static shared B / registers): " + "; ".join(
        f"bm={r['bm']}{' packed' if r['packed'] else ''}{' x16' if r['x16'] else ' bytes'} "
        f"{r['shared_bytes']}/{r['regs']}" for r in out))
    return out


def attention_constants(device):
    """The exp LUT and the token path's attention scalars (dh = 128)."""
    import numpy as np
    import torch

    from repro_torch.core.patterns import ATTN_BIG, ATTN_LUT_SCALE, ATTN_P_SCALE, build_exp_lut

    lut = torch.from_numpy(build_exp_lut()).to(device)
    scal = dict(qk_scale=float(np.float32(0.05 * 0.05 / np.sqrt(128))), big=ATTN_BIG,
                lut_scale=ATTN_LUT_SCALE, p_scale=ATTN_P_SCALE,
                rescale=float(np.float32(1 / ATTN_P_SCALE)))
    return lut, scal


def _attention_mask(rng, b, s, t):
    import numpy as np

    if s == 1:  # decode: keys up to a per-row position are valid
        pos = rng.integers(0, t, (b,))
        return (np.arange(t)[None, None, :] <= pos[:, None, None]).astype(np.float32)
    # prefill: causal over a right-aligned window
    return np.broadcast_to(np.tril(np.ones((s, t), np.float32), t - s), (b, s, t)).copy()


def attention_operands(rng, b, s, t, dh, device):
    """Contiguous q (B, S, dh), k and v (B, T, dh) and mask (B, S, T)."""
    import torch

    return (torch.from_numpy(_int8(rng, (b, s, dh))).to(device),
            torch.from_numpy(_int8(rng, (b, t, dh))).to(device),
            torch.from_numpy(_int8(rng, (b, t, dh))).to(device),
            torch.from_numpy(_attention_mask(rng, b, s, t)).to(device))


def attention_head_views(rng, b, s, t, dh, d_model, head, device):
    """q, k and v as the token path hands them to the kernel: per-head
    slices (feature columns head·dh onward) of a (B, S, 3·D) query buffer and
    a (B, T, 3·D) key/value buffer; a prefill mask is one (S, T) causal mask
    broadcast over the batch (batch stride 0)."""
    import torch

    qb = torch.from_numpy(_int8(rng, (b, s, 3 * d_model))).to(device)
    kvb = torch.from_numpy(_int8(rng, (b, t, 3 * d_model))).to(device)
    lo = head * dh
    q = qb[:, :, lo:lo + dh]
    k = kvb[:, :, d_model + lo:d_model + lo + dh]
    v = kvb[:, :, 2 * d_model + lo:2 * d_model + lo + dh]
    mask = torch.from_numpy(_attention_mask(rng, b if s == 1 else 1, s, t)).to(device)
    return q, k, v, mask.expand(b, s, t)


def attention_bound(b, s, t, dh):
    """Each input read once (q, k, v, the mask, the LUT), the output written
    once; 4·B·S·T·dh int8 operations (QKᵀ and PV)."""
    return bound_ms(b * s * dh * 2 + 2 * b * t * dh + 4 * b * s * t + 256, 4.0 * b * s * t * dh)


def _check_attention(flush, rows, worst, ops, lut, scal, cluster, tag):
    """Hold the kernel at ``cluster`` (None: as planned) against the plain
    version on ``ops``, then time both."""
    from repro_torch.kernels import qattention as qatt

    q, k, v, mask = ops
    b, s, dh = q.shape
    t = k.shape[1]
    c = qatt.choose_cluster(b * s, t, dh) if cluster is None else cluster
    route = {"cluster": c, "threads": qatt.threads_for(b * s, t, c), "keys_per_block": qatt.keys_per_block(t, c),
             "planned": cluster is None or c == qatt.choose_cluster(b * s, t, dh)}
    err = _max_err(qatt.qattention(q, k, v, mask, lut, cluster=c, **scal),
                   qatt.qattention_plain(q, k, v, mask, lut, **scal))
    worst["qattention"] = max(worst["qattention"], err)
    if err:
        raise AssertionError(f"qattention {tag} cluster={c}: max |kernel - plain| = {err}")
    b_ms, b_by = attention_bound(b, s, t, dh)
    ms = time_ms(lambda: qatt.qattention(q, k, v, mask, lut, cluster=c, **scal), flush)
    pms = time_ms(lambda: qatt.qattention_plain(q, k, v, mask, lut, **scal), flush)
    if cluster is not None:
        tag += f",C={c}"
    rows.append(dict(kernel="qattention", shape=tag, ms=ms, plain_ms=pms, bound_ms=b_ms,
                     bound_by=b_by, max_abs_err=err, route=route))
    log(f"  qattention      {tag}: exact, {ms:.4f} ms (plain {pms:.4f} ms, bound {b_ms:.3g} ms "
        f"by {b_by}) [cluster={c}{' planned' if route['planned'] else ''} "
        f"threads={route['threads']} keys/block={route['keys_per_block']}]")


def qmoe_operands(device):
    """Seeded operands of one Mellum2 expert layer as the plan lays them
    out (``kernels/qmoe.py::prepare``): the weights, the exp and SiLU
    tables, and the scalars."""
    import numpy as np
    import torch

    from repro_torch.core import moe
    from repro_torch.kernels import qmoe as kqmoe

    p = moe.make_moe_params(np.random.default_rng(3), QMOE_D, QMOE_F, QMOE_E, QMOE_K, 0.05)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def pair(r):
        return float(np.float32(r.quant_scale)), float(r.quant_shift)

    wr, gu, wd = kqmoe.prepare(dev(p.router), dev(p.gate), dev(p.up), dev(p.down))
    s = kqmoe.MoEScalars(top_k=QMOE_K, router_scale=p.router_scale, lut_scale=moe.ATTN_LUT_SCALE,
                         p_scale=moe.MOE_P_SCALE, gate=pair(p.gate_rescale), up=pair(p.up_rescale),
                         down=pair(p.down_rescale), h_scale=p.h_scale,
                         out_rescale=float(np.float32(1.0 / moe.MOE_P_SCALE)))
    return (wr, gu, wd, dev(moe.build_exp_lut()), dev(p.silu)), s


def qmoe_bound(tokens):
    """(bytes, ops) one routed-expert step over ``tokens`` rows needs: the
    router and the weights of the experts its ``tokens · k`` routed rows can
    reach read; the rows read and written; the routed hidden ``h`` and
    outputs ``y`` written and read back; the router's and the ``k`` chosen
    experts' operations (``portbench/work/tokpath-mellum2.py``'s count)."""
    d, f, e, k = QMOE_D, QMOE_F, QMOE_E, QMOE_K
    pairs = tokens * k
    nbytes = e * d + min(e, pairs) * 3 * d * f + 2 * tokens * d + 2 * pairs * (f + d) + 512
    return nbytes, 2.0 * tokens * d * e + 2.0 * pairs * 3 * d * f


def _check_qmoe(rng, flush, rows, worst, operands, tokens):
    import torch

    from repro_torch.kernels import qmoe as kqmoe

    consts, s = operands
    x = torch.from_numpy(rng.integers(-40, 41, (tokens, QMOE_D)).astype("int8")).to(consts[0].device)
    before = kqmoe.LAUNCHES["qmoe"]
    got = kqmoe.qmoe(x, *consts, s)
    if kqmoe.LAUNCHES["qmoe"] - before != kqmoe.LAUNCHES_PER_CALL:
        raise AssertionError(f"qmoe counted {kqmoe.LAUNCHES['qmoe'] - before} launches a call, "
                             f"want {kqmoe.LAUNCHES_PER_CALL}")
    want = kqmoe.qmoe_plain(x, *consts, s)
    err = _max_err(got, want)
    worst["qmoe"] = max(worst["qmoe"], err)
    bm = kqmoe.choose_bm(tokens, QMOE_K, QMOE_E)
    shape = f"T={tokens},D={QMOE_D},F={QMOE_F},E={QMOE_E},k={QMOE_K}"
    if err or len(torch.unique(want)) < 50:
        raise AssertionError(f"qmoe {shape}: max |kernel - plain| = {err}, "
                             f"{len(torch.unique(want))} distinct output codes")
    b_ms, b_by = bound_ms(*qmoe_bound(tokens))
    ms = time_ms(lambda: kqmoe.qmoe(x, *consts, s), flush)
    pms = time_ms(lambda: kqmoe.qmoe_plain(x, *consts, s), flush)
    rows.append(dict(kernel="qmoe", shape=shape, ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                     max_abs_err=err, route={"bm": bm, "launches": kqmoe.LAUNCHES_PER_CALL}))
    log(f"  qmoe            {shape}: exact, {ms:.4f} ms (plain {pms:.4f} ms, bound {b_ms:.3g} ms "
        f"by {b_by}) [bm={bm}, {kqmoe.LAUNCHES_PER_CALL} launches]")


def _kv_onehot(rng, kind, n, r):
    """An int8 (n, r, 1) onehot of ``kind`` (``KV_WRITE_ONEHOTS``): one 1 a
    slot at a random row; slot 1 all zero (a padded slot); slot 0 with a
    second 1; or the slots' bytes -1 or 127 and slot 2 a second row at 1."""
    import numpy as np

    h = np.zeros((n, r, 1), np.int8)
    pos = rng.integers(0, r, n)
    h[np.arange(n), pos] = 1
    if kind == "padded-slot":
        h[1] = 0
    elif kind == "two-in-a-row":
        h[0, (pos[0] + 1) % r] = 1
    elif kind in ("minus-one", "max"):
        h[np.arange(n), pos] = -1 if kind == "minus-one" else 127
        h[2, (pos[2] + 3) % r] = 1
    return h


def _check_kv_write(rng, device, flush, rows, worst, tag, n, r, w):
    """kv_write == kv_write_plain == the four codified int8 ops (tolerance
    0) on a cache of (n, r, w), its new rows a (n, 1, w) view of a qkv-like
    (n, 1, 3w) buffer as the plan slices them, over every onehot kind; the
    path's onehot timed against the plain version and the four ops, beside
    the bound of the onehot's n·r bytes and three passes over the n·w bytes
    of the rows written (old row and new row read, row written)."""
    import torch

    from repro_torch.kernels import kv_write as kvw

    s = torch.from_numpy(_int8(rng, (n, r, w))).to(device)
    x = torch.from_numpy(_int8(rng, (n, 1, 3 * w))).to(device)[:, :, w:2 * w]
    for kind in KV_WRITE_ONEHOTS:
        h = torch.from_numpy(_kv_onehot(rng, kind, n, r)).to(device)
        before = kvw.LAUNCHES["kv_write"]
        got = kvw.kv_write(s.clone(), h, x)
        if kvw.LAUNCHES["kv_write"] - before != 1:
            raise AssertionError(f"kv_write counted {kvw.LAUNCHES['kv_write'] - before} launches a call")
        want = kvw.kv_write_plain(s.clone(), h, x)
        four = s * (1 - h) + x * h
        err = max(_max_err(got, want), _max_err(four, want))
        worst["kv_write"] = max(worst["kv_write"], err)
        written = int((h != 0).sum())
        moved = int((want != s).any(dim=2).sum())
        if err or not 0 < moved <= written:
            raise AssertionError(f"kv_write {tag} {kind}: max |kernel - plain|, |four ops - plain| = {err}; "
                                 f"{moved} rows changed for {written} non-zero onehot bytes")
        if kind != KV_WRITE_ONEHOTS[0]:
            continue
        b_ms, b_by = bound_ms(n * r + 3 * written * w, 3 * written * w)
        buf, pbuf = s.clone(), s.clone()
        ms = time_ms(lambda: kvw.kv_write(buf, h, x), flush)
        pms = time_ms(lambda: kvw.kv_write_plain(pbuf, h, x), flush)
        fms = time_ms(lambda: s * (1 - h) + x * h, flush)
        shape = f"N={n},R={r},W={w},{tag}"
        rows.append(dict(kernel="kv_write", shape=shape, ms=ms, plain_ms=pms, bound_ms=b_ms,
                         bound_by=b_by, max_abs_err=err,
                         route={"four_ops_ms": fms, "row_chunks": -(-r // 4096)}))
        log(f"  kv_write        {shape}: exact over {len(KV_WRITE_ONEHOTS)} onehot kinds, {ms:.4f} ms "
            f"(plain {pms:.4f} ms, the four int8 ops {fms:.4f} ms, bound {b_ms:.3g} ms by {b_by})")
        del buf, pbuf


def check_kernels(device, flush, rows):
    import numpy as np
    import torch

    from repro_torch.kernels import qattention as qatt

    rng = np.random.default_rng(0)
    worst = {"qmatmul": 0, "qmatmul_packed": 0, "qattention": 0, "qact_lut": 0, "qmoe": 0, "kv_write": 0}
    for k, n, bits, relu in MATMUL_SHAPES:
        for m in MATMUL_M:
            _check_matmul(rng, device, flush, rows, worst, m, k, n, bits, relu)
    for k in EDGE_K:
        for bits in (8, 4):
            for m in EDGE_M:
                _check_matmul(rng, device, flush, rows, worst, m, k, EDGE_N, bits, False)
    for tag, m, k, n, relu in served_gemms():
        _check_matmul(rng, device, flush, rows, worst, m, k, n, 8, relu, tag=f",{tag}")
    for m in FLEET_M:  # phase 8's FFN at seq buckets 128 and 192 (bucket 64's M = 512 is above)
        _check_matmul(rng, device, flush, rows, worst, m, FLEET_D, FLEET_FF, 8, True, tag=",fleet")
        _check_matmul(rng, device, flush, rows, worst, m, FLEET_FF, FLEET_D, 4, False, tag=",fleet")

    for m, n in LUT_SHAPES:
        x = torch.from_numpy(_int8(rng, (m, n))).to(device)
        for dt in ("int8", "uint8"):
            info = np.iinfo(dt)
            lut = torch.from_numpy(rng.integers(info.min, info.max + 1, (256,)).astype(dt)).to(device)
            _check_lut(flush, rows, worst, x, lut, f"M={m},N={n},{dt}")
    # a base one byte into a larger tensor: the head loop and byte stores
    big = torch.from_numpy(_int8(rng, (37 * 2051 + 1,))).to(device)
    lut = torch.from_numpy(rng.integers(0, 256, (256,)).astype(np.uint8)).to(device)
    _check_lut(flush, rows, worst, big[1:].view(37, 2051), lut, "M=37,N=2051,uint8,offset1")
    for row in LUT_EPILOGUE_ROWS:
        _check_lut_epilogue(rng, device, flush, rows, worst, *row)

    lut, scal = attention_constants(device)
    b, dh = 4, 128
    for s, t in ATTN_SHAPES:
        ops = attention_operands(rng, b, s, t, dh, device)
        _check_attention(flush, rows, worst, ops, lut, scal, None, f"B={b},S={s},T={t},dh={dh}")
    # the token path's operands: per-head views of head ATTN_HEAD of a
    # (B, ., 3·D) buffer, at every cluster size at decode
    for s, t in ATTN_VIEW_SHAPES:
        ops = attention_head_views(rng, b, s, t, dh, ATTN_D, ATTN_HEAD, device)
        sizes = [c for c in qatt.CLUSTER_SIZES if c <= t] if s == 1 else [None]
        for c in sizes:
            _check_attention(flush, rows, worst, ops, lut, scal, c,
                             f"B={b},S={s},T={t},dh={dh},views,h={ATTN_HEAD}")
    moe_ops = qmoe_operands(device)
    for tokens in QMOE_TOKENS:
        _check_qmoe(rng, flush, rows, worst, moe_ops, tokens)
    for tag, n, r, w in KV_WRITE_SHAPES:
        _check_kv_write(rng, device, flush, rows, worst, tag, n, r, w)
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

    def drive(tp, engine=True):
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
        # the cache is the decode graph's state buffers, which the engine's
        # steps below (the same bucket) overwrite
        out["decode"] = (step_logits, {k: v.clone() for k, v in cache.items()})
        out["decode_ms"] = sorted(step_ms)[len(step_ms) // 2]
        if not engine:
            return out
        eng = ServeEngine(ecfg=EngineConfig(slots=4, max_len=512, prefill_bucket=32),
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

    # warm the cuda path once (first launches, allocator, the decode graph's
    # capture), then the counted run
    drive(tps["cuda"])
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(device)
    graphs_before = tps["cuda"].graph_stats()
    got = drive(tps["cuda"])
    torch.cuda.synchronize()
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    graphs = {k: v - graphs_before[k] for k, v in tps["cuda"].graph_stats().items()}
    want = drive(tps["ref"])

    same_as_ref(got, want, n, plen, cfg.vocab)
    if got["generated"] != want["generated"]:
        raise AssertionError(f"engine generation differs: {got['generated']} vs {want['generated']}")
    if [len(g) for g in got["generated"]] != [16] * 4:
        raise AssertionError(f"engine generated {[len(g) for g in got['generated']]} tokens, want 16 each")
    log("  prefill (4,128), 8 decode steps at (4,512) and 4 engine requests: cuda == ref, bit for bit")
    log(f"  decode plans as CUDA graphs, the counted run: {graphs['captures']} captures, "
        f"{graphs['replays']} replays, {graphs['eager']} eager calls (prefills); since compile: "
        f"{tps['cuda'].graph_stats()}; ref: {tps['ref'].graph_stats()}")
    if graphs["captures"] or graphs["replays"] < steps or tps["ref"].graph_stats()["replays"]:
        raise AssertionError(f"decode graphs: counted run {graphs}, ref {tps['ref'].graph_stats()}")
    if launches["kv_write"] != 2 * cfg.n_layers * graphs["replays"]:
        raise AssertionError(f"kv_write launches {launches['kv_write']}, want K and V of "
                             f"{cfg.n_layers} layers in each of {graphs['replays']} decode replays")
    profiled, head_copies = profile_decode_step(
        tps["cuda"], dec_toks[0], np.full((n,), plen), n, s_max, cfg.d_head)
    if head_copies:
        raise AssertionError(f"the decode step copied {len(head_copies)} per-head q/k/v views: "
                             f"{head_copies[:4]}")
    perf = dict(
        decode_device=profiled, decode_head_view_copies=len(head_copies),
        prefill_ms=got["prefill_ms"], decode_step_ms=got["decode_ms"],
        decode_tokens_per_s=n / (got["decode_ms"] / 1e3),
        engine_tokens_per_s=got["engine_tokens"] / got["engine_s"],
        peak_bytes=peak, ref_prefill_ms=want["prefill_ms"], ref_decode_step_ms=want["decode_ms"],
        decode_graphs=graphs,
    )
    # what phase 7 holds its tuned token path against (this run's ref
    # backend), and the cuda path phase 8 decodes on
    ref = dict(cfg=cfg, params=params, tp=tps["ref"], cuda_tp=tps["cuda"], want=want, drive=drive,
               first_step=(dec_toks[0], np.full((n,), plen)), n=n, plen=plen, s_max=s_max)
    return perf, launches, ref


def same_as_ref(got, want, n, plen, vocab):
    """A drive of the token path equals the ref backend's, bit for bit:
    prefill logits and KV rows, every decode step's logits and next tokens,
    and the final KV cache; logits finite, of the expected shapes."""
    import torch

    (gl, gc), (wl, wc) = got["prefill"], want["prefill"]
    if gl.shape != (n, plen, vocab) or not bool(torch.isfinite(gl).all()):
        raise AssertionError(f"prefill logits: shape {tuple(gl.shape)} or non-finite values")
    _same(gl, wl, "prefill logits")
    for name in wc:
        _same(gc[name], wc[name], f"prefill state {name}")
    for i, (a, b) in enumerate(zip(got["decode"][0], want["decode"][0])):
        if a.shape != (n, vocab) or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"decode step {i} logits: shape {tuple(a.shape)} or non-finite")
        _same(a, b, f"decode step {i} logits")
        _same(a.argmax(-1), b.argmax(-1), f"decode step {i} next tokens")
    for name in want["decode"][1]:
        _same(got["decode"][1][name], want["decode"][1][name], f"decode state {name}")


def device_rows(prof, steps=1):
    """Device ms and calls per step by kernel name, largest first, from a
    ``torch.profiler`` trace over ``steps`` steps ([] when it recorded no
    device time).  The schedule's step annotation spans the window on the
    device too: not a kernel."""
    from torch.autograd import DeviceType

    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and not e.key.startswith("ProfilerStep")]
    return sorted(((e.key, e.self_device_time_total / 1e3 / steps, e.count / steps) for e in evs),
                  key=lambda r: -r[1])


def profile_decode_step(tp, toks, pos, n, s_max, d_head, top=12):
    """One decode step at (n, s_max) under ``torch.profiler``, after a
    profiled warm-up step that the trace discards (as ``device_breakdown``
    does: a trace that starts with the step may drop its first device
    event): device ms by kernel name (``(total_ms, [(name, ms, calls)])``,
    None when the profiler records no device time) and every copy made of a
    per-head q/k/v view — an ``aten::clone`` of a 3-D tensor whose last dim
    is ``d_head``; the token path hands those views to qattention as they
    are.  The step replays the decode graph; the copies are looked for in
    one step of the plan's eager loop, which the graph holds."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    cache = tp.init_cache(n, s_max)
    tp.decode_step(toks, pos, cache)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True,
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        tp.decode_step(toks, pos, cache)
        torch.cuda.synchronize()
        prof.step()
        tp.decode_step(toks, pos, cache)
        torch.cuda.synchronize()  # the active step ends with the context
    plan, _ = tp.decode_cm.specialized({"N": n, "S": s_max})
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as eager:
        plan.execute(tp.decode_feeds(toks, pos, cache))
        torch.cuda.synchronize()
    if not any(e.input_shapes for e in eager.events() if e.name.startswith("aten::")):
        raise AssertionError("the profiler recorded no input shapes: the view copies cannot be checked")
    copies = [e.input_shapes[0] for e in eager.events()
              if e.name == "aten::clone" and e.input_shapes and len(e.input_shapes[0]) == 3
              and e.input_shapes[0][-1] == d_head]
    rows = device_rows(prof)
    if not rows:
        return None, copies
    return (sum(r[1] for r in rows), rows[:top]), copies


# ---------------------------------------------------------------------------
# phases 5 and 6: compiled models served by CompiledModelServer
# ---------------------------------------------------------------------------

#: Slice A: the FFN widths of src/repro/configs/qwen3_1_7b.py as the paper's
#: §4/§6 MLP (Tanh, Sigmoid, no activation); requests arrive in waves.
MLP_WIDTHS = (2048, 6144, 6144, 2048)
MLP_WAVES, MLP_MAX_BATCH, MLP_REF_SAMPLE = (3, 1, 17, 9, 64, 2, 32), 64, 16
#: Slice B: (out channels, in channels, kernel, stride, pad) of each conv —
#: ResNet-18's stage widths, its 7×7/2 stem — then a 25088 → 1000 FC head.
CNN_CONVS = [(64, 3, 7, 2, 3), (128, 64, 3, 2, 1), (256, 128, 3, 2, 1),
             (512, 256, 3, 2, 1), (512, 512, 3, 2, 1)]
CNN_IN, CNN_CLASSES = (3, 224, 224), 1000
CNN_WAVES, CNN_MAX_BATCH, CNN_REF_SAMPLE = (1, 7, 16, 3, 13), 16, 2
#: The counted serving window lasts at least this long: the waves repeat in
#: rounds over the same requests until it has passed.
MIN_WINDOW_S = 1.0


def build_mlp():
    """quantize_mlp (Fig 5 fp16 tanh flow, Fig 6 sigmoid, per-channel) from
    seed-0 weights scaled by 1/sqrt(fan_in) and 256 calibration rows."""
    import numpy as np

    from repro_torch.core import quant
    from repro_torch.core.toolchain import MLPSpec, quantize_mlp

    rng = np.random.default_rng(0)
    pairs = list(zip(MLP_WIDTHS, MLP_WIDTHS[1:]))
    spec = MLPSpec(
        weights=[rng.standard_normal((a, b), np.float32) / np.float32(np.sqrt(a)) for a, b in pairs],
        biases=[rng.standard_normal((b,), np.float32) * np.float32(0.1) for _, b in pairs],
        activations=["Tanh", "Sigmoid", None],
    )
    calib = rng.standard_normal((256, MLP_WIDTHS[0]), np.float32)
    model = quantize_mlp(spec, calib, tanh_mode="fp16", per_channel=True, name="paper_mlp")
    x = rng.standard_normal((sum(MLP_WAVES), MLP_WIDTHS[0]), np.float32)
    return model, list(quant.quantize(x, float(model.metadata["input_scale"]), "int8"))


def build_cnn():
    """quantize_cnn (ConvInteger chains with ReLU, per-channel) from seed-0
    weights scaled by 1/sqrt(fan_in) and 8 calibration images."""
    import numpy as np

    from repro_torch.core import quant
    from repro_torch.core.toolchain import CNNSpec, ConvLayerSpec, MLPSpec, quantize_cnn

    rng = np.random.default_rng(0)
    convs = []
    for m, c, k, st, pd in CNN_CONVS:
        w = rng.standard_normal((m, c, k, k), np.float32) / np.float32(np.sqrt(c * k * k))
        convs.append(ConvLayerSpec(w, rng.standard_normal((m,), np.float32) * np.float32(0.1),
                                   strides=(st, st), pads=(pd,) * 4, activation="Relu"))
    side = CNN_IN[1]
    for _, _, k, st, pd in CNN_CONVS:
        side = (side + 2 * pd - k) // st + 1
    flat = CNN_CONVS[-1][0] * side * side
    head = MLPSpec([rng.standard_normal((flat, CNN_CLASSES), np.float32) / np.float32(np.sqrt(flat))],
                   [rng.standard_normal((CNN_CLASSES,), np.float32) * np.float32(0.1)], [None])
    calib = rng.standard_normal((8,) + CNN_IN, np.float32)
    model = quantize_cnn(CNNSpec(convs, head), calib, per_channel=True, name="paper_cnn")
    x = rng.standard_normal((sum(CNN_WAVES),) + CNN_IN, np.float32)
    return model, list(quant.quantize(x, float(model.metadata["input_scale"]), "int8"))


def _serve(cm, examples, waves, max_batch, min_s=0.0):
    """One server, the waves submitted in turn, each drained before the
    next arrives; the whole sequence in rounds over the same examples until
    ``min_s`` seconds have passed (one round at least).  Outputs reach the
    host inside step(), so the wall time covers the device work.  Returns
    the requests, ``summary()``, the wall seconds and the rounds."""
    from repro_torch.serving import CompiledModelServer, CompiledServerConfig

    srv = CompiledModelServer(cm, CompiledServerConfig(max_batch=max_batch))
    reqs, rounds = [], 0
    t = time.perf_counter()
    while rounds == 0 or time.perf_counter() - t < min_s:
        it = iter(examples)
        for w in waves:
            reqs += [srv.submit(next(it)) for _ in range(w)]
            srv.run_until_drained()
        rounds += 1
    return reqs, srv.summary(), time.perf_counter() - t, rounds


def _batch_ms(cm, examples, max_batch, reps=101) -> float:
    """Median host-clock ms of one synchronised forward at the largest
    bucket (``max_batch`` requests); many reps, since the host is shared and
    a few slow ones would move a short median."""
    import numpy as np
    import torch

    feeds = {cm.input_names[0]: np.stack(examples[:max_batch])}
    cm.run(feeds)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        cm.run(feeds)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return sorted(times)[reps // 2]


#: Forwards in the profiled window of phases 5-6, after one warm-up step.
PROFILED_FORWARDS = 5


def device_breakdown(cm, examples, max_batch, top=6):
    """Device time of one forward at the largest bucket, by kernel name, from
    a ``torch.profiler`` trace of PROFILED_FORWARDS forwards after a warm-up
    step that the trace discards (without it the window's first device
    event, the input's copy, went unrecorded): ``(total_ms, [(name, ms,
    calls)], names)`` per forward, copies included, or None when the
    profiler records no device time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    feeds = {cm.input_names[0]: np.stack(examples[:max_batch])}
    cm.run(feeds)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        cm.run(feeds)
        torch.cuda.synchronize()
        prof.step()
        for _ in range(PROFILED_FORWARDS):
            cm.run(feeds)
        torch.cuda.synchronize()  # the active step ends with the context
    rows = device_rows(prof, PROFILED_FORWARDS)
    if not rows:
        return None
    return sum(r[1] for r in rows), rows[:top], [r[0] for r in rows]


#: Device kernels a forward whose LUTs all ride in the matmul epilogue must
#: not launch: the standalone table kernel and the uint8 shift (an XOR).
UNFOLDED_KERNELS = ("qact_lut", "xor")


def run_served(device, name, build, waves, max_batch, n_ref, want_stats, per_batch):
    """Build the artifact, compile it batch-polymorphic on backends cuda and
    ref, serve the waves on each (one round to warm up, then the counted
    window of at least MIN_WINDOW_S), require every response identical to the ref
    server's for the same example and the first ``n_ref`` equal to the numpy
    ReferenceRuntime.  ``want_stats`` maps each backend to the compile stats
    it must show.  ``per_batch`` is each kernel's launches per forward;
    the counted run must show exactly that times the batches."""
    import numpy as np
    import torch

    from repro_torch.core.compile import compile_model
    from repro_torch.core.runtime import ReferenceRuntime
    from repro_torch.kernels import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    model, examples = build()
    t_build = time.perf_counter() - t0
    cms, compile_s = {}, {}
    for b in ("cuda", "ref"):
        t = time.perf_counter()
        cms[b] = compile_model(model, backend=b, device=device, batch="dynamic")
        compile_s[b] = time.perf_counter() - t
        got = {k: cms[b].stats[k] for k in want_stats[b]}
        if got != want_stats[b]:
            raise AssertionError(f"{name} {b}: fused stats {got}, want {want_stats[b]}")
    log(f"  quantize (toolchain, host) {t_build:.1f} s; compile cuda {compile_s['cuda']:.2f} s, "
        f"ref {compile_s['ref']:.2f} s; stats {cms['cuda'].stats}")

    _serve(cms["cuda"], examples, waves, max_batch)  # warm: first launches, specializations
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(device)
    got, summ, wall, rounds = _serve(cms["cuda"], examples, waves, max_batch, MIN_WINDOW_S)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    reset_launch_counts()
    _serve(cms["ref"], examples, waves, max_batch)
    want, ref_summ, ref_wall, ref_rounds = _serve(cms["ref"], examples, waves, max_batch, MIN_WINDOW_S)
    if any(launch_counts().values()):
        raise AssertionError(f"{name}: the ref backend launched kernels: {launch_counts()}")

    out = cms["cuda"].output_names[0]
    batches, n = summ["batches"], len(examples)
    served = (batches / rounds, summ["completed"], ref_summ["completed"])
    if served != (ref_summ["batches"] / ref_rounds, rounds * n, ref_rounds * n):
        raise AssertionError(f"{name}: served {summ['completed']} in {batches} batches over "
                             f"{rounds} rounds, ref {ref_summ['completed']} in "
                             f"{ref_summ['batches']} over {ref_rounds}")
    for i, a in enumerate(got):  # each response against the ref's for its example
        ga, gb = a.outputs[out], want[i % n].outputs[out]
        if ga.dtype != gb.dtype or ga.shape != gb.shape or not np.array_equal(ga, gb):
            raise AssertionError(f"{name} request {i}: backends cuda and ref disagree")
    for i, b in enumerate(want[n:], n):  # the ref server's later rounds repeat its first
        if not np.array_equal(b.outputs[out], want[i % n].outputs[out]):
            raise AssertionError(f"{name} ref request {i}: differs from its first round")
    if len(np.unique(np.stack([r.outputs[out] for r in got]))) < 2:
        raise AssertionError(f"{name}: every response holds one code — a degenerate pipeline")
    rt = ReferenceRuntime(model)
    sample = np.stack([r.x for r in got[:n_ref]])
    ref_out = rt.run({cms["cuda"].input_names[0]: sample})[out]
    if not np.array_equal(np.stack([r.outputs[out] for r in got[:n_ref]]), ref_out):
        raise AssertionError(f"{name}: the first {n_ref} responses differ from ReferenceRuntime")
    expect = {k: v * batches for k, v in per_batch.items()}
    path = {k: launches[k] for k in expect}
    if path != expect or any(v <= 0 for v in path.values()):
        raise AssertionError(f"{name}: launches {launches}, want {expect} over {batches} batches")
    if any(v for k, v in launches.items() if k not in expect):
        raise AssertionError(f"{name}: kernels off this path launched: {launches}")
    log(f"  {len(got)} requests: {rounds} rounds of waves {waves} in {wall:.3f} s, {batches} "
        f"batches {summ['bucket_batches']}: cuda == ref bit for bit; first {n_ref} == "
        f"ReferenceRuntime (ref: {len(want)} requests, {ref_rounds} rounds in {ref_wall:.3f} s)")
    perf = dict(
        compile_s=compile_s["cuda"], ref_compile_s=compile_s["ref"], quantize_s=t_build,
        rounds=rounds, requests=len(got), window_s=wall, ref_rounds=ref_rounds,
        ref_window_s=ref_wall,
        requests_per_s=len(got) / wall, ref_requests_per_s=len(want) / ref_wall,
        p50_ms=summ["latency_p50_ms"], p95_ms=summ["latency_p95_ms"],
        batch_ms=_batch_ms(cms["cuda"], examples, max_batch),
        ref_batch_ms=_batch_ms(cms["ref"], examples, max_batch),
        peak_bytes=peak, batches=batches, bucket_batches=summ["bucket_batches"],
        device=device_breakdown(cms["cuda"], examples, max_batch),
    )
    return perf, launches


def check_no_unfolded_kernels(name, perf):
    """The profiled forward launched no standalone LUT and no shift kernel."""
    if perf["device"] is None:
        raise AssertionError(f"{name}: the profiler recorded no device time, so the forward's "
                             "kernels cannot be checked")
    names = perf["device"][2]
    bad = [k for k in names if any(u in k.lower() for u in UNFOLDED_KERNELS)]
    if bad:
        raise AssertionError(f"{name}: the profiled forward launched unfolded kernels {bad}")


def _perf_line(name, perf, card, max_batch, extra=""):
    log(f"  {name}: compile {perf['compile_s']:.2f} s; {perf['requests_per_s']:.1f} requests/s "
        f"over {perf['window_s']:.2f} s (ref {perf['ref_requests_per_s']:.1f} over "
        f"{perf['ref_window_s']:.2f} s); latency p50 {perf['p50_ms']:.2f} ms, p95 "
        f"{perf['p95_ms']:.2f} ms; batch of {max_batch} {perf['batch_ms']:.2f} ms (ref "
        f"{perf['ref_batch_ms']:.2f} ms); peak allocated {perf['peak_bytes'] / 2**30:.2f} GiB"
        f"{extra}  ({card})")
    if perf["device"] is None:
        log(f"  {name} device time by kernel at batch {max_batch}: not measured "
            "(the profiler recorded no device time)")
        return
    total, top, _ = perf["device"]
    log(f"  {name} device time of one forward at batch {max_batch} (torch.profiler, mean of "
        f"{PROFILED_FORWARDS}): {total:.4f} ms of the {perf['batch_ms']:.4f} ms forward; by kernel "
        "(launches per forward):")
    for key, ms, calls in top:
        log(f"    {ms:9.4f} ms  x{calls:<4g} {key[:90]}")


# ---------------------------------------------------------------------------
# phase 7: the measured autotuner, its tile cache and the AOT plan artifact
# ---------------------------------------------------------------------------

#: The token path's two tuned cells: prefill (4,128) and decode (4,512).
PREFILL_CELL, DECODE_CELL = {"N": 4, "S": 128}, {"N": 4, "S": 512}
#: Where phase 7 writes its tile caches (small JSON, brought back) and its
#: plan artifact (about 2 GB with the vocab-wide embedding and lm_head: kept
#: in the git-ignored build directory and removed after the phase).
TUNE_CACHE = os.path.join(OUT_DIR, "autotune_cache.json")
SLICE_A_CACHE = os.path.join(OUT_DIR, "autotune_slice_a.json")
ARTIFACT_DIR = os.path.join(ROOT, "build", "chip_smoke_artifact")


def cell_sources(cm, cell):
    """Step name -> tile source (heuristic | tuned | cache) of the newest
    specialization of ``cell`` in the plan's provenance."""
    key = tuple(sorted(cell.items()))
    events = [e for e in cm.plan.provenance.specializations if e.bindings == key]
    if not events:
        raise AssertionError(f"cell {cell} was never specialized")
    return {name: rec.rsplit(" [", 1)[1][:-1] if rec.endswith("]") else "heuristic"
            for name, rec in events[-1].tiles}


def _require_sources(tp, want_source):
    """Every fused step of both cells carries ``want_source``; returns the
    number of records checked in each of the two plans."""
    n = {}
    for cm, cell in ((tp.prefill_cm, PREFILL_CELL), (tp.decode_cm, DECODE_CELL)):
        plan, _ = cm.specialized(cell)
        fused = [s.name for s in plan.steps if s.kind in ("fused_qlinear", "fused_qattention")]
        src = cell_sources(cm, cell)
        bad = {k: v for k, v in src.items() if v != want_source}
        if sorted(src) != sorted(fused) or bad:
            raise AssertionError(f"cell {cell}: {len(fused)} fused steps, {len(src)} tile records, "
                                 f"not [{want_source}]: {dict(list(bad.items())[:4])}")
        n[cm.model.graph.name] = len(src)
    return n


def tuned_groups(cache_path):
    """The tile cache's entries grouped by (cell, problem shape): how many
    steps, the heuristic tiling, the winners and the median heuristic and
    best µs over the group (the cache keys each layer's, each head's step
    on its own)."""
    with open(cache_path) as f:
        entries = json.load(f)["entries"]
    groups = {}
    for key, e in entries.items():
        _, _, cell, shape = key.split("|")
        g = groups.setdefault((cell, shape), {"steps": 0, "heuristic": set(), "winners": {},
                                              "heuristic_us": [], "best_us": [], "measured": 0})
        win = str(e["cluster"]) if "cluster" in e else f"{e['bm']},{e['splits']}"
        g["steps"] += 1
        g["heuristic"].add(e["heuristic"])
        g["winners"][win] = g["winners"].get(win, 0) + 1
        g["heuristic_us"].append(e["heuristic_us"])
        g["best_us"].append(e["best_us"])
        g["measured"] += e["measured"]
    out = []
    for (cell, shape), g in sorted(groups.items()):
        med = lambda v: sorted(v)[len(v) // 2]  # noqa: E731
        out.append({"cell": cell, "shape": shape, "steps": g["steps"],
                    "tiling": "cluster" if ",dh=" in shape else "bm,splits",
                    "heuristic": sorted(g["heuristic"]), "winners": g["winners"],
                    "measured": g["measured"], "heuristic_us_median": med(g["heuristic_us"]),
                    "best_us_median": med(g["best_us"])})
    return out


#: A changed hot-cell line of a plan diff: the step, then its tiles and their
#: source on each side.
DIFF_CELL_LINE = re.compile(r"\((?P<cell>[^)]*)\) (?P<name>\S+): (?P<a>.*) \[(?P<sa>[^\]]+)\] -> "
                            r"(?P<b>.*) \[(?P<sb>[^\]]+)\]  \[changed\]")


def run_plan_diff(script, a, b):
    """One plan diff as a child process: ``script`` is ``scripts/plan_diff.py``
    (a path) or the port's module (``-m repro_torch.scripts.plan_diff``).
    Returns the exit code, the output and the seconds it took."""
    cmd = [sys.executable] + (["-m", script] if script.startswith("repro_torch.") else [script])
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t = time.perf_counter()
    r = subprocess.run(cmd + [a, b], capture_output=True, text=True, timeout=900, cwd=ROOT, env=env)
    if r.returncode not in (0, 1):
        raise AssertionError(f"{script} {a} {b}: rc {r.returncode}\n{r.stdout[-2000:]}{r.stderr[-2000:]}")
    return r.returncode, r.stdout, time.perf_counter() - t


def diffed_steps(stdout, cell):
    """The steps a plan diff names on changed lines of hot cell ``cell``, and
    those of them whose tiles differ (the source tag aside)."""
    named, moved = [], []
    for line in stdout.splitlines():
        m = DIFF_CELL_LINE.fullmatch(line.strip())
        if m and m["cell"] == cell:
            named.append(m["name"])
            if m["a"] != m["b"]:
                moved.append(m["name"])
    return sorted(named), sorted(moved)


def moved_by_cache(cache_path, cell):
    """The steps of ``cell`` whose tiles the tile cache moved off their
    heuristic (the tuner keys each step by name)."""
    with open(cache_path) as f:
        entries = json.load(f)["entries"]
    moved = []
    for key, e in entries.items():
        name, _, key_cell, _ = key.split("|")
        win = str(e["cluster"]) if "cluster" in e else f"{e['bm']},{e['splits']}"
        if key_cell == cell and win != e["heuristic"]:
            moved.append(name)
    return sorted(moved)


def plan_diffs(tuned_path, heuristic_path, cell, groups, n_steps, card):
    """Phase 7's plan diffs: the port's self-diff of the tuned decode
    artifact (exit 0), the port's diff of its heuristic twin against it (exit
    1, naming every step of the cell and moving the tiles of exactly the
    steps the tile cache moved, as many as ``tuned_groups`` counts), and
    ``scripts/plan_diff.py`` on the same pair (logged, no gate)."""
    port = "repro_torch.scripts.plan_diff"
    rc, out, self_s = run_plan_diff(port, tuned_path, tuned_path)
    if rc != 0 or not out.rstrip().endswith("structurally identical"):
        raise AssertionError(f"the port's plan diff of the tuned artifact against itself: rc {rc}\n"
                             f"{out[-2000:]}")
    rc, out, pair_s = run_plan_diff(port, heuristic_path, tuned_path)
    named, moved = diffed_steps(out, cell)
    want = moved_by_cache(TUNE_CACHE, cell)
    n_groups = 0
    for g in groups:
        if g["cell"] == cell:
            if len(g["heuristic"]) != 1:
                raise AssertionError(f"tuned group {g['shape']}: heuristics {g['heuristic']}")
            n_groups += g["steps"] - g["winners"].get(g["heuristic"][0], 0)
    if rc != 1 or len(named) != n_steps or moved != want or len(moved) != n_groups:
        raise AssertionError(
            f"the port's plan diff, heuristic vs tuned decode artifact: rc {rc}, {len(named)} of "
            f"{n_steps} steps named, tiles moved on {moved}; the tile cache moved {want} "
            f"({n_groups} by tuned_groups)\n{out[-3000:]}")
    old_rc, old_out, old_s = run_plan_diff(os.path.join(ROOT, "scripts", "plan_diff.py"),
                                           heuristic_path, tuned_path)
    old_named, old_moved = diffed_steps(old_out, cell)
    log(f"  plan diff (python -m {port}): self-diff exit 0 ({self_s:.1f} s); heuristic vs tuned "
        f"decode artifact exit {rc} ({pair_s:.1f} s): all {len(named)} fused steps of ({cell}) "
        f"named (tile source heuristic -> tuned), tiles moved on {len(moved)} == the tile cache's "
        f"{len(want)} moved steps == tuned_groups' {n_groups}  ({card})")
    log(f"  scripts/plan_diff.py on the same pair (no gate): exit {old_rc} ({old_s:.1f} s), "
        f"{len(old_named)} steps named, tiles shown moved on {len(old_moved)} of the "
        f"{len(moved)} (it has no splits or cluster key)  ({card})")
    return dict(self_s=self_s, pair_rc=rc, pair_s=pair_s, named=len(named), moved=moved,
                cache_moved=len(want), groups_moved=n_groups, old_rc=old_rc, old_s=old_s,
                old_named=len(old_named), old_moved=len(old_moved))


def artifact_child(path, feeds_path, out_path) -> int:
    """The fresh process of phase 7 (``chip_smoke.py --load-artifact``): load
    the saved decode plan with ``warm=True`` under a tracer, run the feeds,
    write the outputs, print one JSON report line."""
    import numpy as np
    import torch

    from repro_torch.backend.artifact import load_artifact
    from repro_torch.obs import trace as _trace

    t0 = time.perf_counter()
    tracer = _trace.install()
    try:
        cm = load_artifact(path, warm=True)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        with np.load(feeds_path) as f:
            feeds = {k: torch.from_numpy(f[k]).to(cm.device) for k in f.files}
        outs = cm.run(feeds)
        torch.cuda.synchronize()
    finally:
        _trace.uninstall()
    np.savez(out_path, **{k: v.cpu().numpy() for k, v in outs.items()})
    sources = {}
    for ev in cm.plan.provenance.specializations:
        for _, rec in ev.tiles:
            src = rec.rsplit(" [", 1)[1][:-1] if rec.endswith("]") else "heuristic"
            sources[src] = sources.get(src, 0) + 1
    print(json.dumps({
        "load_s": load_s, "cells": len(cm.plan_cache.keys()), "cache": cm.cache_stats,
        "graphs": cm.plan_cache.graph_stats,
        "fuse_lower_spans": len(tracer.spans("compile.fuse")) + len(tracer.spans("compile.lower")),
        "sources": sources,
        "foreign_modules": sorted(m for m in sys.modules
                                  if m.split(".")[0] in ("jax", "jaxlib", "repro")),
    }))
    return 0


def run_tuning(device, ref, card):
    """Phase 7: tune the token path on the card (cold, into a tile cache),
    warm-start a second one from that cache, save the tuned decode plan and
    serve it from a fresh process, and tune slice A in the background of
    its server; everything bit for bit against the ref backend.  Returns
    the phase's record and its kernels' launches in the token path's two
    served drives (the tuning's and the slice A server's are in the record)."""
    import numpy as np
    import torch

    from repro_torch.backend.artifact import save_artifact, sidecar_path
    from repro_torch.backend.autotune import Autotuner, cell_key
    from repro_torch.core.compile import compile_model
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import CompiledModelServer, CompiledServerConfig
    from repro_torch.serving.token_path import CompiledTokenPath

    cfg, params, n, plen = ref["cfg"], ref["params"], ref["n"], ref["plen"]
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    os.makedirs(OUT_DIR, exist_ok=True)
    for stale in (TUNE_CACHE, SLICE_A_CACHE):
        if os.path.exists(stale):
            os.unlink(stale)  # a cold start
    log(f"  config: phase 4's ({cfg.n_layers} of 28 layers, widths full); cells "
        f"prefill {PREFILL_CELL}, decode {DECODE_CELL}")

    # cold: compile with a tuner on an empty cache, then tune both cells
    t = time.perf_counter()
    tuner = Autotuner(cache=TUNE_CACHE)
    tp = CompiledTokenPath(cfg, params, backend="cuda", device=device, autotune=tuner)
    cold_compile_s = time.perf_counter() - t
    reset_launch_counts()
    t = time.perf_counter()
    for cm, cell in ((tp.prefill_cm, PREFILL_CELL), (tp.decode_cm, DECODE_CELL)):
        cm.specialized(cell)
    torch.cuda.synchronize()
    cold_tune_s = time.perf_counter() - t
    tuning_launches = launch_counts()
    missing = [k for k in ("qmatmul", "qmatmul_packed", "qattention") if tuning_launches[k] <= 0]
    if tuner.measurements <= 0 or missing:
        raise AssertionError(f"cold tuning: {tuner.measurements} measurements, candidates of "
                             f"{missing} never launched")
    records = _require_sources(tp, "tuned")
    n_records = sum(records.values())
    reset_launch_counts()
    same_as_ref(ref["drive"](tp, engine=False), ref["want"], n, plen, cfg.vocab)
    add(launch_counts())
    log(f"  cold: compile {cold_compile_s:.1f} s, tuning both cells {cold_tune_s:.1f} s: "
        f"{tuner.measurements} candidates measured ({tuning_launches['qmatmul']} qmatmul, "
        f"{tuning_launches['qmatmul_packed']} qmatmul_packed, {tuning_launches['qattention']} "
        f"qattention launches), {n_records} fused steps [tuned], {len(tuner.cache)} cache "
        f"entries; prefill, 8 decode steps, next tokens == ref bit for bit  ({card})")

    # warm: a second token path on the same cache file measures nothing
    t = time.perf_counter()
    warm_tuner = Autotuner(cache=TUNE_CACHE)
    warm = CompiledTokenPath(cfg, params, backend="cuda", device=device, autotune=warm_tuner)
    warm_compile_s = time.perf_counter() - t
    t = time.perf_counter()
    for cm, cell in ((warm.prefill_cm, PREFILL_CELL), (warm.decode_cm, DECODE_CELL)):
        cm.specialized(cell)
    warm_specialize_s = time.perf_counter() - t
    if warm_tuner.measurements != 0:
        raise AssertionError(f"warm start measured {warm_tuner.measurements} candidates, want 0")
    _require_sources(warm, "cache")
    reset_launch_counts()
    same_as_ref(ref["drive"](warm, engine=False), ref["want"], n, plen, cfg.vocab)
    add(launch_counts())
    del warm
    log(f"  warm: compile {warm_compile_s:.1f} s, both cells {warm_specialize_s:.2f} s, 0 "
        f"measurements, {n_records} fused steps [cache]; outputs == ref bit for bit  ({card})")

    groups = tuned_groups(TUNE_CACHE)
    for g in groups:
        log(f"  tuned {g['cell']} {g['shape']} ({g['steps']} steps, {g['tiling']}): heuristic "
            f"{'/'.join(g['heuristic'])} {g['heuristic_us_median']:.2f} us, winners "
            f"{g['winners']} {g['best_us_median']:.2f} us (medians over the steps)  ({card})")

    # the artifact: save the tuned decode plan, serve it from a fresh process
    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    path = os.path.join(ARTIFACT_DIR, "decode.json")
    feeds_path = os.path.join(ARTIFACT_DIR, "feeds.npz")
    out_path = os.path.join(ARTIFACT_DIR, "outs.npz")
    try:
        t = time.perf_counter()
        save_artifact(tp.decode_cm, path)
        save_s = time.perf_counter() - t
        size = os.path.getsize(path) + os.path.getsize(path[:-5] + ".npz")
        cache = ref["tp"].init_cache(n, ref["s_max"])
        for name, rows in ref["want"]["prefill"][1].items():
            cache[name][:, :plen] = rows
        feeds = ref["tp"].decode_feeds(*ref["first_step"], cache)
        np.savez(feeds_path, **{k: v.cpu().numpy() for k, v in feeds.items()})
        want = ref["tp"].decode_cm.run(feeds)
        del tp
        t = time.perf_counter()
        child = subprocess.run([sys.executable, os.path.abspath(__file__), "--load-artifact", path,
                                feeds_path, out_path], capture_output=True, text=True, timeout=900)
        child_s = time.perf_counter() - t
        if child.returncode != 0:
            raise AssertionError(f"the artifact process failed ({child.returncode}):\n"
                                 f"{child.stdout[-2000:]}\n{child.stderr[-4000:]}")
        report = json.loads(child.stdout.strip().splitlines()[-1])
        if report["fuse_lower_spans"] or report["cache"]["misses"] or report["foreign_modules"]:
            raise AssertionError(f"the artifact process re-lowered, re-specialized or loaded "
                                 f"jax/repro: {report}")
        want_sources = {"tuned": records[ref["tp"].decode_model.graph.name]}
        if report["sources"] != want_sources:
            raise AssertionError(f"the loaded decode cell's tile sources {report['sources']}, "
                                 f"want {want_sources}")
        with np.load(out_path) as got:
            if sorted(got.files) != sorted(want):
                raise AssertionError(f"the artifact process returned {sorted(got.files)}")
            for k, v in want.items():
                _same(torch.from_numpy(got[k]), v.cpu(), f"loaded decode plan output {k}")
        rc, out, diff_s = run_plan_diff(os.path.join(ROOT, "scripts", "plan_diff.py"), path, path)
        if rc != 0 or "structurally identical" not in out:
            raise AssertionError(f"plan_diff of the artifact against itself: rc {rc}\n{out[-2000:]}")
        # the same decode plan with the heuristic tiles (no tuner), beside the tuned one
        heuristic = CompiledTokenPath(cfg, params, backend="cuda", device=device)
        heuristic.decode_cm.specialized(DECODE_CELL)
        heuristic_path = os.path.join(ARTIFACT_DIR, "decode_heuristic.json")
        save_artifact(heuristic.decode_cm, heuristic_path)
        del heuristic
        os.unlink(sidecar_path(heuristic_path))  # the diff reads the JSON only
        diffs = plan_diffs(path, heuristic_path, cell_key(DECODE_CELL), groups,
                           records[ref["tp"].decode_model.graph.name], card)
    finally:
        shutil.rmtree(ARTIFACT_DIR, ignore_errors=True)
    log(f"  artifact: save {save_s:.1f} s ({size / 2**30:.2f} GiB with its sidecar); a fresh "
        f"process loaded it with warm=True in {report['load_s']:.1f} s ({child_s:.1f} s with "
        f"start-up and the run): 0 fuse/lower spans, cache {report['cache']['hits']} hit / "
        f"{report['cache']['misses']} misses, decode graphs {report['graphs']}, sources "
        f"{report['sources']}, no jax/repro module; "
        f"decode logits and KV == ref bit for bit; plan_diff self-diff identical "
        f"({diff_s:.1f} s)  ({card})")

    # slice A served with a background tuner: swaps, then bit for bit
    model, examples = build_mlp()
    cm = compile_model(model, backend="cuda", device=device, batch="dynamic")
    ref_cm = compile_model(model, backend="ref", device=device, batch="dynamic")
    srv_tuner = Autotuner(cache=SLICE_A_CACHE)
    srv = CompiledModelServer(cm, CompiledServerConfig(max_batch=MLP_MAX_BATCH),
                              autotuner=srv_tuner)
    reset_launch_counts()
    t = time.perf_counter()
    got = []
    for _ in range(2):  # round 1 tunes in the background, round 2 runs the swapped plans
        it = iter(examples)
        for w in MLP_WAVES:
            got += [srv.submit(next(it)) for _ in range(w)]
            srv.run_until_drained()
        while srv.tuning_pending:
            srv.step()  # idle cycles spend the tuning budget
    serve_s = time.perf_counter() - t
    server_launches = launch_counts()
    want_a, _, _, _ = _serve(ref_cm, examples, MLP_WAVES, MLP_MAX_BATCH)
    summ = srv.summary()
    if summ["tuned_swaps"] < 1 or srv.tuning_pending != 0:
        raise AssertionError(f"slice A server: {summ['tuned_swaps']} tuned swaps, "
                             f"{srv.tuning_pending} candidates pending")
    out = cm.output_names[0]
    for i, r in enumerate(got):
        w = want_a[i % len(examples)].outputs[out]
        if not np.array_equal(r.outputs[out], w) or r.outputs[out].dtype != w.dtype:
            raise AssertionError(f"slice A tuned request {i}: backends cuda and ref disagree")
    log(f"  slice A server: {len(got)} requests in {summ['batches']} batches ({serve_s:.2f} s), "
        f"{srv_tuner.measurements} candidates measured between batches, {summ['tuned_swaps']} "
        f"tuned swaps, 0 pending; responses == ref bit for bit  ({card})")
    groups_a = tuned_groups(SLICE_A_CACHE)
    for g in groups_a:
        log(f"  tuned slice A {g['cell']} {g['shape']}: heuristic {'/'.join(g['heuristic'])} "
            f"{g['heuristic_us_median']:.2f} us, winners {g['winners']} "
            f"{g['best_us_median']:.2f} us  ({card})")
    log(f"  wall: cold tuning {cold_compile_s + cold_tune_s:.1f} s (compile {cold_compile_s:.1f} + "
        f"tune {cold_tune_s:.1f}), warm start {warm_compile_s + warm_specialize_s:.1f} s, save "
        f"{save_s:.1f} s, load in a fresh process {report['load_s']:.1f} s  ({card})")
    record = dict(
        measurements=tuner.measurements, records=records, cold_compile_s=cold_compile_s,
        cold_tune_s=cold_tune_s, warm_compile_s=warm_compile_s,
        warm_specialize_s=warm_specialize_s, save_s=save_s, artifact_bytes=size,
        child_s=child_s, child=report, plan_diff_s=diff_s, plan_diffs=diffs,
        tuning_launches=tuning_launches,
        groups=groups, slice_a=dict(measurements=srv_tuner.measurements,
                                    tuned_swaps=summ["tuned_swaps"], requests=len(got),
                                    serve_s=serve_s, groups=groups_a,
                                    launches=server_launches),
    )
    return record, launches


# ---------------------------------------------------------------------------
# phase 8: fleet serving, failover, checkpointed decode, generic pooling ops
# ---------------------------------------------------------------------------

#: Where phase 8 writes its fleet artifact and its checkpoints (git-ignored,
#: removed after the phase).
FLEET_DIR = os.path.join(ROOT, "build", "chip_smoke_fleet")
CKPT_DIR = os.path.join(ROOT, "build", "chip_smoke_ckpt")
FLEET_REPLICAS, FLEET_REF_SAMPLE = 3, 4
#: Checkpointed decode: steps, save interval, checkpoints kept, and the step
#: whose first attempt crashes.
CKPT_STEPS, CKPT_INTERVAL, CKPT_KEEP, CKPT_CRASH_AT = 8, 2, 2, 5
#: Pooling cases (op, kernel, stride, pad) on a ResNet stem's output.
POOL_CASES = [(op, k, st, pd) for op in ("MaxPool", "AveragePool")
              for k, st, pd in ((2, 2, 0), (3, 2, 1))]
POOL_IN = (4, 64, 112, 112)
#: The float32 AveragePool against the numpy ReferenceRuntime, which sums a
#: 3x3 window in another order (every other case is exact).
POOL_FLOAT_RTOL, POOL_FLOAT_ATOL = 1e-5, 1e-6


def build_fleet_ffn():
    """The fleet's model: a two-axis per-token FFN, x int8 (N, S, 2048) →
    FC 2048→6144 + ReLU (w8) → FC 6144→2048 (w4, as the token path's
    down projection), the Fig 1 two-Mul rescale, per-channel, from seed-0
    weights scaled by 1/sqrt(fan_in)."""
    import numpy as np

    from repro_torch.core import patterns, pqir, quant

    rng = np.random.default_rng(0)
    layers = []
    for (a, b), bits, scale_x in (((FLEET_D, FLEET_FF), 8, 0.05), ((FLEET_FF, FLEET_D), 4, 0.1)):
        w = rng.standard_normal((a, b), np.float32) / np.float32(np.sqrt(a))
        bias = rng.standard_normal((b,), np.float32) * np.float32(0.1)
        layers.append(quant.quantize_linear_layer(w, bias, scale_x, 0.1, per_channel=True, bits=bits))
    gb = pqir.GraphBuilder("fleet_ffn")
    x = gb.add_input("x", "int8", ("N", "S", FLEET_D))
    h = patterns.fc_layer(gb, x, layers[0], "up", two_mul=True, activation="Relu")
    y = patterns.fc_layer(gb, h, layers[1], "down", two_mul=True)
    gb.add_output(y, "int8", ("N", "S", FLEET_D))
    return gb.build()


def fleet_waves(seed=1):
    """One wave of FLEET_MAX_BATCH requests per seq bucket, each length
    drawn from its bucket's range (1–64, 65–128, 129–192)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    waves = []
    for hi in FLEET_BUCKETS:
        lens = rng.integers(hi - FLEET_SEQ + 1, hi + 1, FLEET_MAX_BATCH)
        waves.append([_int8(rng, (int(s), FLEET_D)) for s in lens])
    return waves


def _check_fleet(what, router, reqs, solo):
    """The fleet's uid accounting holds, no replica missed its plan cache,
    and request i equals example ``i % len(solo)`` run solo on the ref
    backend, bit for bit.  Returns ``summary()``."""
    import numpy as np

    s = router.summary()
    if s["lost"] or s["duplicates"] or s["pending"] or s["completed"] != s["requests"]:
        raise AssertionError(f"{what}: requests {s['requests']}, completed {s['completed']}, "
                             f"pending {s['pending']}, lost {s['lost']}, duplicates {s['duplicates']}")
    misses = {name: rep["plan_cache"]["misses"] for name, rep in s["replicas"].items()}
    if any(misses.values()):
        raise AssertionError(f"{what}: plan-cache misses {misses}")
    for i, r in enumerate(reqs):
        (got,) = r.outputs.values()
        want = solo[i % len(solo)]
        if not r.done or got.dtype != want.dtype or not np.array_equal(got, want):
            raise AssertionError(f"{what} request {i} (uid {r.uid}, {r.replica}): differs from "
                                 "its solo run on the ref backend")
    return s


def _raiser(feeds):
    raise RuntimeError("replica down (injected)")


def run_fleet(device, card):
    """Phase 8 (a) and (b): record the FFN's hot cells, save the artifact,
    warm-start FLEET_REPLICAS replicas behind a ShardedRouter, serve rounds
    of the waves for MIN_WINDOW_S, then a wave with one replica failing.
    Returns the record and the kernels' launches in the two served runs."""
    import numpy as np
    import torch

    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.backend.artifact import save_artifact
    from repro_torch.core.compile import compile_model
    from repro_torch.core.runtime import ReferenceRuntime
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import (
        CompiledModelServer, CompiledServerConfig, RouterConfig, ShardedRouter,
    )

    t = time.perf_counter()
    model = build_fleet_ffn()
    waves = fleet_waves()
    examples = [x for wave in waves for x in wave]
    axes = {"N": None, "S": FLEET_SEQ}
    cm = compile_model(model, backend="cuda", device=device, dynamic_axes=axes)
    ref_cm = compile_model(model, backend="ref", device=device, dynamic_axes=axes)
    build_s = time.perf_counter() - t
    out = cm.output_names[0]
    log(f"  model: x int8 (N, S, {FLEET_D}) -> FC {FLEET_D}->{FLEET_FF} ReLU w8 -> FC "
        f"{FLEET_FF}->{FLEET_D} w4, per-channel, seed 0 (quantize + compile cuda and ref "
        f"{build_s:.1f} s); waves of {FLEET_MAX_BATCH} requests at lengths "
        f"{[sorted(x.shape[0] for x in w) for w in waves]}")

    srv = CompiledModelServer(cm, CompiledServerConfig(max_batch=FLEET_MAX_BATCH))
    for wave in waves:  # record the hot cells: one batch per seq bucket
        for x in wave:
            srv.submit(x)
        srv.run_until_drained()
    if len(cm.plan_cache.keys()) != len(FLEET_BUCKETS):
        raise AssertionError(f"recorded cells {cm.plan_cache.keys()}, want one per seq bucket")
    solo = [ref_cm.run({"x": x[None]})[out][0].cpu().numpy() for x in examples]
    if len(np.unique(np.concatenate([s.ravel() for s in solo]))) < 2:
        raise AssertionError("fleet: every solo response holds one code — a degenerate model")

    os.makedirs(FLEET_DIR, exist_ok=True)
    path = os.path.join(FLEET_DIR, "fleet.json")
    try:
        t = time.perf_counter()
        save_artifact(cm, path)
        save_s = time.perf_counter() - t
        size = os.path.getsize(path) + os.path.getsize(path[:-5] + ".npz")
        t = time.perf_counter()
        router = ShardedRouter.from_artifact(
            path, replicas=FLEET_REPLICAS, device=device, warm=True,
            server_cfg=CompiledServerConfig(max_batch=FLEET_MAX_BATCH),
            cfg=RouterConfig(failure_threshold=1))
        torch.cuda.synchronize()
        start_s = time.perf_counter() - t
    finally:
        shutil.rmtree(FLEET_DIR, ignore_errors=True)
    const_bytes = sum(c.numel() * c.element_size() for st in router.replicas[0].server.cm.plan.steps
                      for c in st.consts if isinstance(c, torch.Tensor))
    log(f"  artifact: {size} bytes with its sidecar, saved in {save_s:.2f} s; {FLEET_REPLICAS} "
        f"replicas warm-started in {start_s:.2f} s, {const_bytes} bytes of device "
        f"constants each  ({card})")

    # (a) rounds of the waves, each wave submitted and drained
    reset_launch_counts()
    reqs, rounds = [], 0
    t = time.perf_counter()
    while rounds == 0 or time.perf_counter() - t < MIN_WINDOW_S:
        for wave in waves:
            reqs += [router.submit(x) for x in wave]
            router.run_until_drained()
        rounds += 1
    wall = time.perf_counter() - t
    launches = launch_counts()
    s = _check_fleet("fleet", router, reqs, solo)
    owners = s["cell_owners"]
    if sorted(owners) != sorted(f"S={b}" for b in FLEET_BUCKETS) or len(set(owners.values())) != 3:
        raise AssertionError(f"fleet: cell owners {owners}, want 3 cells on 3 replicas")
    batches = sum(rep["batches"] for rep in s["replicas"].values())
    if (launches["qmatmul"], launches["qmatmul_packed"]) != (batches, batches):
        raise AssertionError(f"fleet: launches {launches} over {batches} batches, want one "
                             "qmatmul and one qmatmul_packed a batch")
    # the shortest requests, one thread each: numpy's integer matmul has no
    # BLAS, so the oracle costs seconds a request at these widths
    sample = sorted(range(len(examples)), key=lambda i: examples[i].shape[0])[:FLEET_REF_SAMPLE]
    t = time.perf_counter()
    with ThreadPoolExecutor(len(sample)) as pool:
        oracle = list(pool.map(lambda i: ReferenceRuntime(model).run({"x": examples[i][None]})[out][0],
                               sample))
    rt_s = time.perf_counter() - t
    for i, want in zip(sample, oracle):
        if not np.array_equal(want, reqs[i].outputs[out]):
            raise AssertionError(f"fleet request {i}: differs from ReferenceRuntime")
    log(f"  {len(reqs)} requests: {rounds} rounds of waves {[len(w) for w in waves]} in "
        f"{wall:.3f} s = {len(reqs) / wall:.1f} requests/s, {batches} batches; cells {owners}; "
        f"0 plan-cache misses, lost 0, duplicates 0; every response == its solo run on ref bit "
        f"for bit; requests {sample} == ReferenceRuntime ({rt_s:.1f} s)  ({card})")
    replicas = {}
    for name, h in s["health"].items():
        rep = s["replicas"][name]
        replicas[name] = dict(steps=h["steps"], p50_ms=rep["latency_p50_ms"],
                              p95_ms=rep["latency_p95_ms"], ewma_s=h["step_time_ewma_s"],
                              straggler_steps=len(h["straggler_steps"]))
        log(f"  replica {name}: {h['steps']} steps, latency p50 {rep['latency_p50_ms']:.2f} ms, "
            f"p95 {rep['latency_p95_ms']:.2f} ms, step-time EWMA "
            f"{1e3 * h['step_time_ewma_s']:.3f} ms, {len(h['straggler_steps'])} straggler "
            f"steps  ({card})")

    # (b) a fourth wave of the pattern with the S=64 cell's replica failing
    victim_cell = ("S", FLEET_BUCKETS[0])
    failed = [router.submit(x) for x in examples]
    victim = router.replicas[router._cell_owner[victim_cell]]
    survivor = next(r for r in router.replicas if r is not victim)
    expect = [r.uid for r in victim.server.queue]
    victim.server.cm.run = _raiser
    reset_launch_counts()
    router.run_until_drained()
    launches_b = launch_counts()
    s2 = _check_fleet("failover", router, reqs + failed, solo)
    migrated = [r for r in failed if r.rerouted]
    if (s2["failovers"], s2["rerouted"]) != (1, len(expect)) or not expect:
        raise AssertionError(f"failover: failovers {s2['failovers']}, rerouted {s2['rerouted']}, "
                             f"the victim held {len(expect)}")
    if [r.uid for r in migrated] != expect or any(r.replica != survivor.name for r in migrated):
        raise AssertionError("failover: the migrated requests lost their order or their owner")
    if victim.healthy or s2["cell_owners"][f"S={FLEET_BUCKETS[0]}"] != survivor.name:
        raise AssertionError(f"failover: victim healthy {victim.healthy}, owners "
                             f"{s2['cell_owners']}, survivor {survivor.name}")
    log(f"  failover: {victim.name} (cell S={FLEET_BUCKETS[0]}) raised; failovers 1, rerouted "
        f"{len(expect)} in order onto {survivor.name}, the cell re-pointed; lost 0, duplicates "
        f"0, 0 misses; responses == ref bit for bit  ({card})")
    record = dict(requests=len(reqs), rounds=rounds, window_s=wall, requests_per_s=len(reqs) / wall,
                  batches=batches, artifact_bytes=size, save_s=save_s, start_s=start_s,
                  const_bytes_per_replica=const_bytes, replicas=replicas, cell_owners=owners,
                  failover=dict(victim=victim.name, survivor=survivor.name, rerouted=len(expect),
                                owners=s2["cell_owners"]),
                  reference_runtime_s=rt_s)
    return record, {k: launches[k] + launches_b[k] for k in launches}


def _state_leaves(state):
    return [state["tokens"], state["pos"]] + [state["kv"][k] for k in sorted(state["kv"])]


def _same_state(a, b, what):
    for x, y in zip(_state_leaves(a), _state_leaves(b)):
        _same(x, y, what)


def run_checkpointed_decode(ref, card):
    """Phase 8 (c): phase 4's cuda token path decodes CKPT_STEPS steps at
    (4, 512) under ``run_resilient``, checkpointing every CKPT_INTERVAL
    steps, its first attempt at step CKPT_CRASH_AT crashing; the result
    equals an uninterrupted run bit for bit.  Returns the record and the
    kernels' launches in the resilient run."""
    import torch

    from repro_torch.checkpoint import ckpt
    from repro_torch.distributed import CheckpointManager, CheckpointManagerConfig, run_resilient
    from repro_torch.kernels import launch_counts, reset_launch_counts

    tp, n, plen, s_max = ref["cuda_tp"], ref["n"], ref["plen"], ref["s_max"]
    toks0 = ref["first_step"][0]
    rows = ref["want"]["prefill"][1]

    def make_state():
        kv = tp.init_cache(n, s_max)
        for name, r in rows.items():
            kv[name][:, :plen] = r
        return {"kv": kv, "tokens": torch.as_tensor(toks0, device=tp.device),
                "pos": torch.full((n,), plen, dtype=torch.int64, device=tp.device)}

    def step_fn(state, step):
        logits, kv = tp.decode_step(state["tokens"].cpu().numpy(), state["pos"].cpu().numpy(),
                                    state["kv"])
        return {"kv": kv, "tokens": logits.argmax(-1).to(torch.int32)[:, None],
                "pos": state["pos"] + 1}

    state = make_state()
    for step in range(CKPT_STEPS):
        state = step_fn(state, step)
        if step == CKPT_STEPS - 2:  # what the last checkpoint will hold
            last_saved = {"kv": {k: v.clone() for k, v in state["kv"].items()},
                          "tokens": state["tokens"].clone(), "pos": state["pos"].clone()}
    # the KV is the decode graph's state buffers, which the resilient run overwrites
    want = dict(state, kv={k: v.clone() for k, v in state["kv"].items()})

    crashes = []

    def crashing(state, step):
        if step == CKPT_CRASH_AT and not crashes:
            crashes.append(step)
            raise RuntimeError("node failure (injected)")
        return step_fn(state, step)

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    try:
        mgr = CheckpointManager(CheckpointManagerConfig(
            os.path.join(CKPT_DIR, "run"), interval_steps=CKPT_INTERVAL, keep_last=CKPT_KEEP))
        reset_launch_counts()
        t = time.perf_counter()
        got = run_resilient(make_state, crashing, manager=mgr, total_steps=CKPT_STEPS)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        launches = launch_counts()
        kept = sorted(p for p in os.listdir(mgr.cfg.directory) if p.startswith("step_"))
        if crashes != [CKPT_CRASH_AT] or kept != ["step_4", "step_6"]:
            raise AssertionError(f"resilient decode: crashes {crashes}, checkpoints kept {kept}")
        _same_state(got, want, "resilient decode against the uninterrupted one")
        back, step, _ = ckpt.restore(mgr.cfg.directory, make_state())
        if step != CKPT_STEPS - 2 or any(x.device.type != "cuda" for x in _state_leaves(back)):
            raise AssertionError(f"restored step {step} on {[x.device.type for x in _state_leaves(back)]}")
        _same_state(back, last_saved, "the last checkpoint")

        # one save and one restore of the state, timed (cuda -> disk -> cuda)
        target = make_state()
        torch.cuda.synchronize()
        t = time.perf_counter()
        saved = ckpt.save(os.path.join(CKPT_DIR, "timed"), CKPT_STEPS, got)
        save_ms = (time.perf_counter() - t) * 1e3
        nbytes = sum(os.path.getsize(os.path.join(saved, f)) for f in os.listdir(saved))
        t = time.perf_counter()
        back, _, _ = ckpt.restore(os.path.join(CKPT_DIR, "timed"), target)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t) * 1e3
        _same_state(back, got, "timed restore")

        # written from CPU tensors, restored onto the card
        host = {"kv": {k: v.cpu() for k, v in got["kv"].items()}, "tokens": got["tokens"].cpu(),
                "pos": got["pos"].cpu()}
        ckpt.save(os.path.join(CKPT_DIR, "host"), 0, host)
        card_side, _, _ = ckpt.restore(os.path.join(CKPT_DIR, "host"), host, shardings="cuda")
        if any(x.device.type != "cuda" for x in _state_leaves(card_side)):
            raise AssertionError("a CPU-written checkpoint restored with shardings='cuda' left the card")
        _same_state(card_side, got, "CPU-written checkpoint on the card")
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    log(f"  checkpointed decode: {CKPT_STEPS} steps at ({n},{s_max}) under run_resilient in "
        f"{run_s:.2f} s, saved every {CKPT_INTERVAL}, step {CKPT_CRASH_AT} crashed once and "
        f"resumed from step {CKPT_CRASH_AT - 1}; tokens and KV == the uninterrupted run bit for "
        f"bit; the last checkpoint restored on cuda; a CPU-written checkpoint restored with "
        f"shardings='cuda' == the original  ({card})")
    log(f"  checkpoint: {nbytes} bytes ({len(_state_leaves(got))} leaves), save {save_ms:.1f} ms, "
        f"restore {restore_ms:.1f} ms  ({card})")
    record = dict(steps=CKPT_STEPS, run_s=run_s, bytes=nbytes, save_ms=save_ms,
                  restore_ms=restore_ms, leaves=len(_state_leaves(got)))
    return record, launches


def run_pooling(device, card):
    """Phase 8 (d): the generic MaxPool / AveragePool ops on the card, int8
    and float32, against the numpy ReferenceRuntime and the same ops run on
    the CPU."""
    import numpy as np

    from repro_torch.core.compile import compile_model
    from repro_torch.core.pqir import GraphBuilder
    from repro_torch.core.runtime import ReferenceRuntime

    rng = np.random.default_rng(2)
    out = []
    for dtype in ("int8", "float32"):
        x = _int8(rng, POOL_IN) if dtype == "int8" else rng.standard_normal(POOL_IN, np.float32)
        for op, k, st, pd in POOL_CASES:
            side = (POOL_IN[2] + 2 * pd - k) // st + 1
            gb = GraphBuilder(f"{op.lower()}_{dtype}")
            gb.add_input("x", dtype, POOL_IN)
            y = gb.op(op, ["x"], kernel_shape=(k, k), strides=(st, st), pads=(pd,) * 4)
            gb.add_output(y, dtype, POOL_IN[:2] + (side, side))
            model = gb.build()
            kw = dict(backend="cuda", fuse=False, optimize=False)
            cm = compile_model(model, device=device, **kw)
            if [s.kernel for s in cm.plan.steps] != [f"op.{op}"]:
                raise AssertionError(f"{op}: plan {[s.kernel for s in cm.plan.steps]}")
            (got,) = cm.run({"x": x}).values()
            got = got.cpu().numpy()
            (host,) = compile_model(model, device="cpu", **kw).run({"x": x}).values()
            (want,) = ReferenceRuntime(model).run({"x": x}).values()
            tag = f"{op} {k}x{k}/{st} pad {pd} {dtype} {tuple(got.shape)}"
            if got.dtype != want.dtype or got.shape != want.shape or not np.array_equal(got, host.numpy()):
                raise AssertionError(f"{tag}: the card and the CPU disagree")
            if dtype == "float32" and op == "AveragePool":
                np.testing.assert_allclose(got, want, rtol=POOL_FLOAT_RTOL, atol=POOL_FLOAT_ATOL,
                                           err_msg=tag)
                err = float(np.abs(got - want).max())
            elif not np.array_equal(got, want):
                raise AssertionError(f"{tag}: differs from ReferenceRuntime")
            else:
                err = 0.0
            out.append(dict(case=tag, max_abs_err_vs_reference_runtime=err))
    log(f"  pooling on cuda: {len(out)} cases ({', '.join(c['case'] for c in out[:4])}; the same "
        f"in float32) == the CPU bit for bit and == ReferenceRuntime (float32 AveragePool "
        f"within rtol {POOL_FLOAT_RTOL}, atol {POOL_FLOAT_ATOL}: max |diff| "
        f"{max(c['max_abs_err_vs_reference_runtime'] for c in out):.3g})  ({card})")
    return out


# ---------------------------------------------------------------------------
# phase 9: the model zoo served through ServeEngine's default adapter
# ---------------------------------------------------------------------------

#: The three postures of ``examples/serve_quantized.py``: KV cache dtype and
#: whether the weights are converted to W8A8.
ZOO_POSTURES = {"bf16/bf16-kv": ("bf16", False), "bf16/int8-kv": ("int8", False),
                "w8a8/int8-kv": ("int8", True)}
#: (a)'s traffic: greedy requests, prompt lengths (six fill the 32-token
#: bucket short of its end, two the 64-token one), new tokens each, slots.
ZOO_PROMPTS, ZOO_NEW_TOKENS, ZOO_SLOTS = (24,) * 6 + (40,) * 2, 8, 4
#: (b) and (c): the card against the CPU.  Logits within ZOO_TOL ·
#: max(1, max |CPU|): the two devices sum float32 products in other orders
#: (measured on the CPU against repro: ≤ 1e-6 · max), and a bf16 KV entry
#: or an int8 activation / KV code can round to its neighbour on one side
#: (one such code moved a reduced model's logits by 1.7e-4 · max on the
#: CPU); greedy tokens equal wherever the CPU's top-2 margin exceeds 10×
#: that bound.
ZOO_TOL = 1e-3
ZOO_CUT_LAYERS, ZOO_DECODE_STEPS, ZOO_REDUCED_STEPS = 2, 4, 2
#: (d): QuantizedLinear 2048 -> 6144 at these M.
ZOO_QLINEAR_M = (4, 77, 512)


def _timed(fn, times):
    """``fn`` wrapped to append its synchronised host-clock ms to ``times``."""
    import torch

    def timed(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        return out

    return timed


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def serve_posture(params, cfg, prompts, profile=False, new_tokens=ZOO_NEW_TOKENS):
    """One posture of (a) (phase 12 (a) serves the same way): warm the
    engine's paths on one request of each prompt length, then serve every
    request, timing each adapter call; optionally profile one decode step
    and one prefill of the first prompt, each after a discarded warm-up
    call."""
    import numpy as np
    import torch

    from repro_torch.backend.plan import bucket_multiple
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving.engine import EngineConfig, Request, ServeEngine

    lens = [len(p) for p in prompts]
    ecfg = EngineConfig(slots=ZOO_SLOTS, max_len=max(lens) + new_tokens + 8)
    warm = ServeEngine(params, cfg, ecfg)
    for i, n in enumerate(sorted(set(lens))):
        warm.submit(Request(uid=i, prompt=prompts[lens.index(n)], max_new_tokens=2))
    warm.run_until_drained()
    del warm
    eng = ServeEngine(params, cfg, ecfg)
    prefill_ms, decode_ms = [], []
    prefill = eng.adapter.prefill
    eng.adapter.prefill = _timed(prefill, prefill_ms)
    decode = eng.adapter.decode
    eng.adapter.decode = _timed(decode, decode_ms)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=new_tokens) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    reset_launch_counts()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    out = dict(tokens=sum(len(r.generated) for r in reqs), wall_s=wall,
               prefill_ms=_median(prefill_ms), decode_step_ms=_median(decode_ms),
               decode_steps=len(decode_ms), resident_bytes=resident,
               peak_bytes=torch.cuda.max_memory_allocated(),
               metrics=dict(eng.metrics), launches=launch_counts(),
               generated=[list(r.generated) for r in reqs])
    out["tokens_per_s"] = out["tokens"] / wall
    if [len(g) for g in out["generated"]] != [new_tokens] * len(prompts):
        raise AssertionError(f"generated {[len(g) for g in out['generated']]} tokens")
    if profile:
        toks = np.array([[g[-1]] for g in out["generated"][:ZOO_SLOTS]], np.int32)
        pos = np.full((ZOO_SLOTS,), max(lens), np.int32)
        cache = eng.adapter.init_cache(ZOO_SLOTS, eng.ecfg.max_len)
        out["decode_device"] = profile_steps(lambda: decode(toks, pos, cache))
        padded = np.zeros((1, bucket_multiple(lens[0], ecfg.prefill_bucket)), np.int32)
        padded[0, :lens[0]] = prompts[0]
        out["prefill_device"] = profile_steps(lambda: prefill(padded, lens[0], eng.ecfg.max_len))
    # the timed wrappers close over the adapter's own methods: a cycle that
    # would keep the weights alive until the garbage collector ran
    del eng.adapter.prefill, eng.adapter.decode
    return out


def log_profiles(res, what):
    """Log a served run's profiled decode step and prefill (device ms by
    kernel, idle share against the run's unprofiled median) and keep each
    idle share in ``res``."""
    for kind, host_key, unit in (("decode", "decode_step_ms", f"decode step of {ZOO_SLOTS} slots"),
                                 ("prefill", "prefill_ms", "prefill of one prompt")):
        prof = res.get(f"{kind}_device")
        if prof is None:
            log(f"    {what} {unit} device time by kernel: not measured (no device time)")
            continue
        total, top = prof
        host = res[host_key]
        res[f"{kind}_idle_share"] = 1 - total / host
        log(f"    one {what} {unit} (torch.profiler, after a discarded warm-up call): {total:.4f} ms of "
            f"device time against the {host:.4f} ms call (median, unprofiled): the card idles "
            f"{100 * (1 - total / host):.1f} %; by kernel:")
        for key, ms, calls in top:
            log(f"      {ms:9.4f} ms  x{calls:<4g} {key[:90]}")


def profile_steps(fn, steps=1, top=12):
    """``steps`` calls of ``fn`` under ``torch.profiler`` after a profiled
    warm-up call that the trace discards: ``(device ms per call, [(kernel,
    ms, calls) per call])``, or None when the profiler recorded no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()  # the active step ends with the context
    rows = device_rows(prof, steps)
    if not rows:
        return None
    return sum(r[1] for r in rows), rows[:top]


def _zoo_compare(what, got, want, vocab):
    """Card logits against the CPU's within ZOO_TOL over the ``vocab`` real
    columns (the padded tail, masked to -1e30, must be equal); returns (max
    |Δ| / max(1, max |CPU|), clear rows, clear rows with equal tokens)."""
    import torch

    got, want = got.float().cpu(), want.float()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: card logits {tuple(got.shape)} or non-finite values")
    if not torch.equal(got[:, vocab:], want[:, vocab:]):
        raise AssertionError(f"{what}: the padded vocab tail differs")
    got, want = got[:, :vocab], want[:, :vocab]
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max()) / scale
    if err > ZOO_TOL:
        raise AssertionError(f"{what}: card and CPU logits differ by {err:.3g} · max(1, max |CPU|) "
                             f"> {ZOO_TOL}")
    top2 = torch.topk(want, 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 10 * ZOO_TOL * scale
    same = got.argmax(-1) == want.argmax(-1)
    if bool((clear & ~same).any()):
        raise AssertionError(f"{what}: the card's greedy token differs where the CPU's is clear")
    return err, int(clear.sum()), int((clear & same).sum())


def card_vs_cpu(params, cfg, batch, steps, w8a8, device):
    """Prefill ``batch`` and ``steps`` greedy decode steps on the card and on
    the CPU from the same weights (W8A8-converted on each device when
    ``w8a8``; the conversions must agree bit for bit), every step fed the
    CPU's greedy token; returns each step's (err, clear, equal)."""
    import numpy as np
    import torch

    from repro_torch.core.convert import convert_params_w8a8
    from repro_torch.models import model as M

    cpu = M.tree_map(lambda _, a: a.cpu(), params)
    if w8a8:
        params, cpu = convert_params_w8a8(params), convert_params_w8a8(cpu)
        for (path, a), (_, b) in zip(_leaves(params), _leaves(cpu)):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"W8A8 conversion of {path} differs between the card and the CPU")
    b, s = batch["tokens"].shape
    if "patch_embeds" in batch:  # the patches precede the text
        s += batch["patch_embeds"].shape[1]
    src = batch["src_embeds"].shape[1] if "src_embeds" in batch else 0
    kw = dict(compute_dtype=torch.float32, q_chunk=min(s, 512), kv_chunk=min(s, 512))
    caches = {d: M.init_cache(cfg, b, s + steps + 1, src, device=d) for d in (device, "cpu")}
    got, caches[device] = M.prefill(params, batch, cfg, caches[device], **kw)
    want, caches["cpu"] = M.prefill(cpu, batch, cfg, caches["cpu"], **kw)
    out = [_zoo_compare("prefill", got, want, cfg.vocab_size)]
    for i in range(steps):
        tok = want.argmax(-1)[:, None].to(torch.int32).numpy()
        pos = np.full((b,), s + i, np.int32)
        got, caches[device] = M.decode_step(params, tok, pos, caches[device], cfg,
                                            compute_dtype=torch.float32)
        want, caches["cpu"] = M.decode_step(cpu, tok, pos, caches["cpu"], cfg,
                                            compute_dtype=torch.float32)
        out.append(_zoo_compare(f"decode step {i}", got, want, cfg.vocab_size))
    return out


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    elif tree is not None:
        yield path, tree


def zoo_batch(cfg, rng, b, s):
    """A batch as ``tests/test_w8a8.py::_batch`` builds one: text tokens,
    with patch embeddings (vision) or source-frame embeddings (enc-dec)."""
    import numpy as np

    tok = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    batch = {"tokens": tok}
    if cfg.frontend == "vision":
        batch["tokens"] = tok[:, : s - cfg.frontend_tokens]
        batch["patch_embeds"] = rng.normal(size=(b, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["src_embeds"] = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    return batch


def run_zoo(device, card):
    """Phase 9: (a) qwen3_1_7b at its full config served in three postures
    by ServeEngine's default adapter; (b) its weights cut to 2 layers, card
    against CPU; (c) every other architecture at reduced() on the card
    against the CPU; (d) QuantizedLinear on the qmatmul kernel against ref.
    Returns the phase's record and the launches of its served runs."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.core.convert import convert_params_w8a8
    from repro_torch.core.qlayers import prepare_quantized_linear
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import model as M

    rec = {}
    cfg = get_config("qwen3_1_7b")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()  # what earlier phases still hold
    t = time.perf_counter()
    params = M.init_params(torch.Generator(device=device).manual_seed(0), cfg, device=device)
    torch.cuda.synchronize()
    n_params = sum(a.numel() for _, a in _leaves(params))
    log(f"  (a) {cfg.name} full config: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} "
        f"heads ({cfg.n_kv_heads} kv) of {cfg.hd()}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} padded "
        f"to {M.padded_vocab(cfg)}: {n_params:,} parameters, float32 masters initialised on the card "
        f"in {time.perf_counter() - t:.1f} s; compute float32 (the engine's default)")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32) for n in ZOO_PROMPTS]
    postures, base = {}, None
    for name, (kv, w8a8) in ZOO_POSTURES.items():
        pcfg = dataclasses.replace(cfg, kv_cache_dtype=kv)
        p = convert_params_w8a8(params) if w8a8 else params
        res = serve_posture(p, pcfg, prompts, profile=name == "bf16/bf16-kv")
        del p
        torch.cuda.empty_cache()
        gen = res.pop("generated")
        base = base or gen
        # as examples/serve_quantized.py prints it: per request, the share of
        # positions where the posture's token equals the baseline's
        res["agreement"] = float(np.mean([np.mean([a == b for a, b in zip(x, y)])
                                          for x, y in zip(gen, base)]))
        postures[name] = res
        log(f"    {name:13s} {res['tokens_per_s']:8.1f} tokens/s ({res['tokens']} tokens in "
            f"{res['wall_s']:.2f} s); prefill {res['prefill_ms']:.2f} ms, decode step "
            f"{res['decode_step_ms']:.2f} ms (medians, {res['decode_steps']} steps of "
            f"{ZOO_SLOTS} slots); peak {(res['peak_bytes'] - before) / 2**30:.2f} GiB over the "
            f"{(res['resident_bytes'] - before) / 2**30:.2f} GiB it holds at rest; vs bf16/bf16-kv token "
            f"agreement {res['agreement']:.1%}; prefill cache {res['metrics']['prefill_cache_size']} "
            f"buckets, {res['metrics']['prefill_cache_hits']} hits  ({card})")
        if any(res["launches"].values()):
            raise AssertionError(f"{name}: the zoo's path launched {res['launches']}")
    log_profiles(postures["bf16/bf16-kv"], "bf16/bf16-kv")
    rec["full"] = dict(n_params=n_params, postures=postures, earlier_phases_bytes=before)

    # (b) the same weights, 2 of 28 layers, card against the CPU
    cut = dataclasses.replace(cfg, n_layers=ZOO_CUT_LAYERS)
    p2 = {**params, "layers": M.tree_map(lambda _, a: a[:ZOO_CUT_LAYERS].clone(), params["layers"])}
    del params
    torch.cuda.empty_cache()
    batch = zoo_batch(cut, np.random.default_rng(2), 2, 24)
    rec["cut"] = {}
    for name in ("bf16/bf16-kv", "w8a8/int8-kv"):
        kv, w8a8 = ZOO_POSTURES[name]
        t = time.perf_counter()
        steps = card_vs_cpu(p2, dataclasses.replace(cut, kv_cache_dtype=kv), batch,
                            ZOO_DECODE_STEPS, w8a8, device)
        rec["cut"][name] = steps
        log(f"  (b) {cfg.name}, {ZOO_CUT_LAYERS} of 28 layers at full widths, {name}: prefill + "
            f"{ZOO_DECODE_STEPS} decode steps, card vs CPU max |Δ| / max(1, max |CPU|) "
            f"{max(e for e, _, _ in steps):.3g} (≤ {ZOO_TOL}); greedy tokens equal at "
            f"{sum(q for _, _, q in steps)} of {sum(c for _, c, _ in steps)} clear rows "
            f"({time.perf_counter() - t:.1f} s)")
    del p2
    torch.cuda.empty_cache()

    # (c) every other architecture at reduced(), card against the CPU
    rec["reduced"] = {}
    for i, arch in enumerate(a for a in ARCH_IDS if a != cfg.name):
        rcfg = get_config(arch, reduced=True)
        params = M.init_params(torch.Generator(device=device).manual_seed(i), rcfg, device=device)
        batch = zoo_batch(rcfg, np.random.default_rng(3 + i), 2, 16)
        for name in ("bf16/bf16-kv", "w8a8/int8-kv"):
            kv, w8a8 = ZOO_POSTURES[name]
            rec["reduced"][f"{arch} {name}"] = card_vs_cpu(
                params, dataclasses.replace(rcfg, kv_cache_dtype=kv), batch, ZOO_REDUCED_STEPS,
                w8a8, device)
    worst = max(e for steps in rec["reduced"].values() for e, _, _ in steps)
    log(f"  (c) {len(ARCH_IDS) - 1} other architectures at reduced(), bf16/bf16-kv and "
        f"w8a8/int8-kv: prefill + {ZOO_REDUCED_STEPS} decode steps, card vs CPU max |Δ| / max(1, "
        f"max |CPU|) {worst:.3g} (≤ {ZOO_TOL}); greedy tokens equal at "
        f"{sum(q for s in rec['reduced'].values() for _, _, q in s)} of "
        f"{sum(c for s in rec['reduced'].values() for _, c, _ in s)} clear rows")

    # (d) QuantizedLinear on the qmatmul kernel
    rng = np.random.default_rng(4)
    w = rng.normal(scale=0.02, size=(2048, 6144)).astype(np.float32)
    bias = rng.normal(scale=0.1, size=(6144,)).astype(np.float32)
    ql = prepare_quantized_linear(w, bias, 0.05, 0.1, device=device)
    xs = {m: torch.from_numpy(_int8(rng, (m, 2048))).to(device) for m in ZOO_QLINEAR_M}
    reset_launch_counts()
    got = {m: ql(x, backend="cuda") for m, x in xs.items()}
    torch.cuda.synchronize()
    launches = launch_counts()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    rec["qlinear"] = []
    for m, x in xs.items():
        want = ql(x, backend="ref")
        if not torch.equal(got[m], want):
            raise AssertionError(f"QuantizedLinear M={m}: backend cuda differs from ref")
        row = dict(m=m, ms=time_ms(lambda: ql(x, backend="cuda"), flush),
                   ref_ms=time_ms(lambda: ql(x, backend="ref"), flush))
        rec["qlinear"].append(row)
    if launches["qmatmul"] < len(ZOO_QLINEAR_M):
        raise AssertionError(f"QuantizedLinear(backend='cuda') launched qmatmul {launches['qmatmul']} "
                             f"times for {len(ZOO_QLINEAR_M)} calls")
    times = "; ".join("M={m}: cuda {ms:.4f} ms, ref {ref_ms:.4f} ms".format(**r) for r in rec["qlinear"])
    log(f"  (d) QuantizedLinear 2048 -> 6144, backend cuda == ref bit for bit at M = "
        f"{', '.join(map(str, ZOO_QLINEAR_M))}; {launches['qmatmul']} qmatmul launches; {times} "
        f"(median of {REPS}, L2 flushed; the weight is laid out on every call)  ({card})")
    return rec, launches


# ---------------------------------------------------------------------------
# phase 10: training
# ---------------------------------------------------------------------------

#: (a): the full config trained by ``launch.train.train``: steps, batch, seq.
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 6, 4, 512
#: (b): the same weights cut to TRAIN_CUT_LAYERS layers, one grad step on
#: the card and on the CPU at batch × seq.  Loss within TRAIN_LOSS_TOL
#: relative; each gradient within ZOO_TOL · max(1, max |CPU|) (phase 9's
#: bound, float32 sums in other orders); AdamW fed the CPU's gradients on
#: both devices within TRAIN_ADAMW_TOL relative.
TRAIN_CUT_LAYERS, TRAIN_CUT_BATCH, TRAIN_CUT_SEQ = 2, 2, 128
TRAIN_LOSS_TOL, TRAIN_ADAMW_TOL = 1e-5, 1e-6
#: (c): resume at reduced(), as tests/test_substrate.py::TestTrainLoop runs it.
RESUME_KW = dict(batch=4, seq=32, log_every=100)
TRAIN_DIR = os.path.join(ROOT, "build", "chip_smoke_train")
#: The H100 SXM's float32 peak outside the tensor cores (data sheet, dense,
#: at 700 W): (a) runs float32 with TF32 off, so its GEMMs run there.
F32_PEAK_FLOPS = 67e12


def train_step_flops(cfg, batch, seq):
    """Matmul FLOPs of one training step of a decoder ``cfg`` (GQA, gated
    MLP) or an RWKV6 ``cfg``: the forward's 2 · weights · tokens over every
    layer projection and the readout over the padded vocab, plus, for the
    decoder, 4 · B · H · S² · dh of attention a layer (one query and one key
    chunk: every score is computed, the causal mask applied after; RWKV6's
    scan, under 1 % of its layer, is left out); the backward twice the
    forward; and ``nothing_saveable``'s second forward of every layer."""
    from repro_torch.models.model import padded_vocab

    d, hd, tokens = cfg.d_model, cfg.hd(), batch * seq
    if cfg.family == "rwkv6":  # r, k, v, g, o; the LoRAs; channel-mix k, v, r
        r = cfg.ssm.lora_rank
        weights = 5 * d * d + 10 * d * r + 2 * d * r + 2 * d * cfg.d_ff + d * d
        layer = 2 * weights * tokens
    else:
        weights = d * cfg.n_heads * hd * 2 + d * cfg.n_kv_heads * hd * 2 + 3 * d * cfg.d_ff
        layer = 2 * weights * tokens + 4 * batch * cfg.n_heads * seq * seq * hd
    forward = cfg.n_layers * layer + 2 * d * padded_vocab(cfg) * tokens
    return 3 * forward + cfg.n_layers * layer


def _finite(x, what):
    import math

    if not math.isfinite(float(x)):
        raise AssertionError(f"{what}: non-finite value {float(x)}")


def train_full(device, card, qat, arch="qwen3_1_7b", steps_n=TRAIN_STEPS):
    """(a): ``train(arch, reduced=False)`` on the card for ``steps_n`` steps
    (phase 12 (c) trains rwkv6_3b so), per step loss, grad norm, lr, host
    step ms, tokens/s and peak memory; returns the run's record and its
    (params, opt) for the profiled step."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import train

    steps = []

    def on_step(step, m):
        steps.append(dict(step=step, loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                          lr=float(m["lr"]), step_ms=m["step_time_s"] * 1e3,
                          tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / m["step_time_s"],
                          peak_bytes=torch.cuda.max_memory_allocated()))

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t = time.perf_counter()
    params, opt, _ = train(arch, steps=steps_n, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                           reduced=False, qat=qat, schedule="warmup_cosine", seed=0,
                           log_every=steps_n, device=device, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = launch_counts()
    if any(launches.values()):
        raise AssertionError(f"training launched hand-written kernels: {launches}")
    for s in steps:
        _finite(s["loss"], f"step {s['step']} loss")
        _finite(s["grad_norm"], f"step {s['step']} grad norm")
    rest = torch.cuda.memory_allocated()
    rec = dict(qat=qat, steps=steps, wall_s=wall, earlier_phases_bytes=before,
               resident_bytes=rest - before, peak_bytes=torch.cuda.max_memory_allocated() - before,
               median_step_ms=_median([s["step_ms"] for s in steps[1:]]), launches=launches)
    rec["median_tokens_per_s"] = TRAIN_BATCH * TRAIN_SEQ / rec["median_step_ms"] * 1e3
    rec["step_flops"] = train_step_flops(get_config(arch), TRAIN_BATCH, TRAIN_SEQ)
    rec["bound_ms"] = rec["step_flops"] / F32_PEAK_FLOPS * 1e3  # the fake-quant's elementwise work aside
    rec["achieved_tflops"] = rec["step_flops"] / rec["median_step_ms"] / 1e9
    if torch.cuda.max_memory_allocated() >= torch.cuda.get_device_properties(0).total_memory:
        raise AssertionError("training's peak memory exceeds the card")
    name = "qat" if qat else "plain"
    for s in steps:
        log(f"    {name:5s} step {s['step']}: loss {s['loss']:.4f}, grad norm {s['grad_norm']:.4f}, lr "
            f"{s['lr']:.3e}; {s['step_ms']:.1f} ms, {s['tokens_per_s']:.0f} tokens/s; peak "
            f"{(s['peak_bytes'] - before) / 2**30:.2f} GiB over earlier phases  ({card})")
    log(f"    {name:5s} median step (steps 1-{steps_n - 1}) {rec['median_step_ms']:.1f} ms = "
        f"{rec['median_tokens_per_s']:.0f} tokens/s, {rec['step_flops']:.3e} matmul FLOP a step: "
        f"{rec['achieved_tflops']:.1f} TFLOP/s, {rec['bound_ms']:.1f} ms at the float32 peak "
        f"({100 * rec['bound_ms'] / rec['median_step_ms']:.1f} % of it); params + AdamW moments held at rest "
        f"{rec['resident_bytes'] / 2**30:.2f} GiB, peak {rec['peak_bytes'] / 2**30:.2f} GiB over "
        f"earlier phases ({before / 2**30:.2f} GiB); {steps_n} steps in {wall:.1f} s; "
        f"hand-written kernel launches: 0  ({card})")
    return rec, params, opt


def profile_train_step(params, opt, device, step_ms, arch="qwen3_1_7b"):
    """One plain training step of (a)'s shape under ``torch.profiler`` after
    a discarded warm-up step, on (a)'s trained weights."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.launch.steps import make_train_step

    cfg = get_config(arch)
    step = make_train_step(cfg, ShapeConfig("custom", "train", TRAIN_SEQ, TRAIN_BATCH),
                           compute_dtype=torch.float32, q_chunk=TRAIN_SEQ, kv_chunk=TRAIN_SEQ,
                           sched_kwargs=dict(peak_lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS))
    data = Pipeline(cfg, DataConfig(seed=0)).batch(TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ)
    batch = {k: torch.from_numpy(v).to(device) for k, v in data.items()}
    prof = profile_steps(lambda: step(params, opt, batch), top=14)
    if prof is None:
        return None
    total, top = prof
    return dict(device_ms=total, step_ms=step_ms, idle_share=1 - total / step_ms, top=top)


def train_card_vs_cpu(device, card):
    """(b): the full config's weights cut to TRAIN_CUT_LAYERS layers (float32
    masters from a seeded card generator, copied to the CPU): one grad step
    plain and with QAT on both devices, the QAT codes of every weight, and
    AdamW fed the CPU's gradients on both."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.qat import weight_codes_per_channel
    from repro_torch.launch.steps import make_grad_step
    from repro_torch.models import model as M
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(get_config("qwen3_1_7b"), n_layers=TRAIN_CUT_LAYERS)
    params = M.init_params(torch.Generator(device=device).manual_seed(1), cfg, device=device)
    cpu = M.tree_map(lambda _, a: a.cpu(), params)
    rng = np.random.default_rng(5)
    tok = rng.integers(0, cfg.vocab_size, (TRAIN_CUT_BATCH, TRAIN_CUT_SEQ)).astype(np.int32)
    batch = {"tokens": tok, "labels": tok}
    sc = ShapeConfig("custom", "train", TRAIN_CUT_SEQ, TRAIN_CUT_BATCH)
    kw = dict(compute_dtype=torch.float32, q_chunk=TRAIN_CUT_SEQ, kv_chunk=TRAIN_CUT_SEQ)
    rec = {}
    for qat in (False, True):
        name = "qat" if qat else "plain"
        step = make_grad_step(cfg, sc, qat=qat, **kw)
        t = time.perf_counter()
        l_card, g_card = step(params, {k: torch.from_numpy(v).to(device) for k, v in batch.items()})
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t
        t = time.perf_counter()
        l_cpu, g_cpu = step(cpu, batch)
        t_cpu = time.perf_counter() - t
        loss_err = abs(float(l_card) - float(l_cpu)) / abs(float(l_cpu))
        if loss_err > TRAIN_LOSS_TOL:
            raise AssertionError(f"(b) {name}: card loss {float(l_card)} vs CPU {float(l_cpu)}")
        worst = 0.0
        for (path, a), (_, b) in zip(_leaves(g_card), _leaves(g_cpu)):
            err = float((a.cpu() - b).abs().max()) / max(1.0, float(b.abs().max()))
            if not (err <= ZOO_TOL):
                raise AssertionError(f"(b) {name}: gradient {path} differs card vs CPU by {err:.3g}")
            worst = max(worst, err)
        rec[name] = dict(loss_card=float(l_card), loss_cpu=float(l_cpu), loss_rel_err=loss_err,
                         grad_err=worst, card_s=t_card, cpu_s=t_cpu)
        log(f"  (b) {name:5s} grad step, {TRAIN_CUT_LAYERS} of 28 layers at full widths, batch "
            f"{TRAIN_CUT_BATCH} x seq {TRAIN_CUT_SEQ}: loss {float(l_card):.6f} card vs {float(l_cpu):.6f} "
            f"CPU (rel {loss_err:.2e} <= {TRAIN_LOSS_TOL}); gradients max |d| / max(1, max |CPU|) "
            f"{worst:.3g} (<= {ZOO_TOL}); card {t_card:.2f} s, CPU {t_cpu:.2f} s  ({card})")
        if not qat:
            g_plain_cpu = g_cpu
        del g_card
    # the QAT fake-quant codes of every weight, card == CPU (the div127 trap)
    n_codes = 0
    for (path, a), (_, b) in zip(_leaves(params), _leaves(cpu)):
        if a.ndim >= 2 and path[-1] != "router":
            qa, sa = weight_codes_per_channel(a)
            qb, sb = weight_codes_per_channel(b)
            if not (torch.equal(qa.cpu(), qb) and torch.equal(sa.cpu(), sb)):
                raise AssertionError(f"(b) QAT codes of {path} differ card vs CPU")
            n_codes += qa.numel()
    # AdamW fed the CPU's gradients on both devices, from a fresh state
    lr = 1e-3
    opt_cpu = adamw.init(cpu)
    new_cpu, st_cpu, m_cpu = adamw.update(g_plain_cpu, opt_cpu, cpu, torch.tensor(lr))
    g_dev = M.tree_map(lambda _, a: a.to(device), g_plain_cpu)
    new_card, st_card, m_card = adamw.update(g_dev, adamw.init(params), params,
                                             torch.tensor(lr, device=device))
    adam_err = 0.0
    for got_tree, want_tree in ((new_card, new_cpu), (st_card["m"], st_cpu["m"]), (st_card["v"], st_cpu["v"])):
        for (path, a), (_, b) in zip(_leaves(got_tree), _leaves(want_tree)):
            err = float((a.cpu() - b).abs().max()) / max(1e-30, float(b.abs().max()))
            if not (err <= TRAIN_ADAMW_TOL):
                raise AssertionError(f"(b) AdamW {path} differs card vs CPU by {err:.3g} relative")
            adam_err = max(adam_err, err)
    gn_err = abs(float(m_card["grad_norm"]) - float(m_cpu["grad_norm"])) / float(m_cpu["grad_norm"])
    rec.update(qat_codes=n_codes, adamw_rel_err=adam_err, grad_norm_rel_err=gn_err)
    log(f"  (b) QAT fake-quant codes of every weight equal card vs CPU ({n_codes:,} codes); AdamW fed "
        f"the CPU's gradients: params and moments within {adam_err:.3g} relative (<= {TRAIN_ADAMW_TOL}), "
        f"grad norm {gn_err:.2e}  ({card})")
    return rec, g_plain_cpu


def train_resume(device, card):
    """(c): TestTrainLoop on the card at reduced(), then a checkpoint the
    CPU wrote resumed on the card."""
    from repro_torch.launch.train import train

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    try:
        d = os.path.join(TRAIN_DIR, "card")
        _, opt, hist = train("qwen3_1_7b", steps=8, ckpt_dir=d, ckpt_interval=4, device=device, **RESUME_KW)
        if not hist[-1] < hist[0]:
            raise AssertionError(f"(c) the loss did not decrease on the card: {hist}")
        _, opt2, hist2 = train("qwen3_1_7b", steps=10, ckpt_dir=d, ckpt_interval=100, device=device,
                               **RESUME_KW)
        if len(hist2) != 5 or int(opt2["step"]) != 10 or opt2["step"].device.type != device.type:
            raise AssertionError(f"(c) resume on the card ran {len(hist2)} steps to step {int(opt2['step'])}")
        d = os.path.join(TRAIN_DIR, "cpu")
        _, _, hist_cpu = train("qwen3_1_7b", steps=8, ckpt_dir=d, ckpt_interval=4, device="cpu", **RESUME_KW)
        _, opt3, hist3 = train("qwen3_1_7b", steps=10, ckpt_dir=d, ckpt_interval=100, device=device,
                               **RESUME_KW)
        if len(hist3) != 5 or int(opt3["step"]) != 10:
            raise AssertionError(f"(c) the CPU's checkpoint resumed on the card ran {len(hist3)} steps")
        err = abs(hist3[0] - hist_cpu[5]) / abs(hist_cpu[5])
        if err > TRAIN_LOSS_TOL:
            raise AssertionError(f"(c) step 5 on the card from the CPU's checkpoint: loss {hist3[0]} vs the "
                                 f"CPU's {hist_cpu[5]}")
    finally:
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    log(f"  (c) reduced(): 8 steps on the card, loss {hist[0]:.4f} -> {hist[-1]:.4f}; resumed from step 4 "
        f"to 10 (5 steps, opt step 10); the CPU's step-4 checkpoint resumed on the card: step 5 loss "
        f"{hist3[0]:.6f} vs the CPU's {hist_cpu[5]:.6f} (rel {err:.2e})  ({card})")
    return dict(card=hist, resumed=hist2, cpu=hist_cpu, cpu_resumed_on_card=hist3, step5_rel_err=err)


def train_grad_compress(device, grads_cpu, card):
    """(d): ``compressed_cross_pod_mean`` over a single-process group (NCCL
    for the card, gloo for the CPU; a file store) on (b)'s CPU gradients,
    two rounds: averages and residuals equal card vs CPU."""
    import torch
    import torch.distributed as dist

    from repro_torch.models import model as M
    from repro_torch.optim import grad_compress as gc

    os.makedirs(TRAIN_DIR, exist_ok=True)
    store = os.path.join(TRAIN_DIR, "store")
    dist.init_process_group("cpu:gloo,cuda:nccl", init_method=f"file://{store}", rank=0, world_size=1)
    try:
        res = {"cpu": gc.init_residuals(grads_cpu)}
        g_dev = M.tree_map(lambda _, a: a.to(device), grads_cpu)
        res["card"] = gc.init_residuals(g_dev)
        n = 0
        for _ in range(2):
            avg_cpu, res["cpu"] = gc.compressed_cross_pod_mean(grads_cpu, res["cpu"])
            avg_card, res["card"] = gc.compressed_cross_pod_mean(g_dev, res["card"])
            torch.cuda.synchronize()
            for got_tree, want_tree in ((avg_card, avg_cpu), (res["card"], res["cpu"])):
                for (path, a), (_, b) in zip(_leaves(got_tree), _leaves(want_tree)):
                    if not torch.equal(a.cpu(), b):
                        raise AssertionError(f"(d) grad_compress {path} differs card vs CPU")
                    n += a.numel()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    log(f"  (d) grad_compress over a one-rank group (NCCL on the card, gloo on the CPU), 2 rounds on (b)'s "
        f"gradients: averages and residuals equal card vs CPU ({n:,} values)  ({card})")
    return dict(values=n)


def run_training(device, card):
    """Phase 10: (a) qwen3_1_7b at its full config trained on the card, plain
    and with QAT, and one profiled step; (b) card vs CPU on its weights cut
    to 2 layers; (c) resume; (d) grad_compress.  Returns the phase's record
    and the launches of its training runs (none may launch a kernel)."""
    import torch

    rec = {}
    log(f"  (a) qwen3_1_7b full config, float32 masters and compute (TF32 off), remat nothing_saveable, "
        f"warmup_cosine, batch {TRAIN_BATCH} x seq {TRAIN_SEQ} ({TRAIN_BATCH * TRAIN_SEQ} tokens a step), "
        f"{TRAIN_STEPS} steps through repro_torch.launch.train.train")
    rec["plain"], params, opt = train_full(device, card, qat=False)
    rec["profile"] = profile_train_step(params, opt, device, rec["plain"]["median_step_ms"])
    if rec["profile"] is None:
        log("    one training step device time by kernel: not measured (no device time)")
    else:
        p = rec["profile"]
        log(f"    one plain training step (torch.profiler, after a discarded warm-up step): "
            f"{p['device_ms']:.1f} ms of device time against the {p['step_ms']:.1f} ms step (median, "
            f"unprofiled): the card idles {100 * p['idle_share']:.1f} %; by kernel  ({card}):")
        for key, ms, calls in p["top"]:
            log(f"      {ms:10.3f} ms  x{calls:<5g} {key[:90]}")
    del params, opt
    torch.cuda.empty_cache()
    rec["qat"], params, opt = train_full(device, card, qat=True)
    del params, opt
    torch.cuda.empty_cache()
    rec["card_vs_cpu"], grads_cpu = train_card_vs_cpu(device, card)
    torch.cuda.empty_cache()
    rec["resume"] = train_resume(device, card)
    rec["grad_compress"] = train_grad_compress(device, grads_cpu, card)
    launches = {k: rec["plain"]["launches"][k] + rec["qat"]["launches"][k] for k in rec["plain"]["launches"]}
    return rec, launches


# ---------------------------------------------------------------------------
# phase 11: the mesh
# ---------------------------------------------------------------------------

#: (a): phase 10 (a)'s run on a one-rank mesh, its first MESH_STEPS steps
#: (a step's loss and grad norm depend on the lr of the steps before it
#: only, and the warm-up's two steps have the same lr for any total).
#: Loss and grad norm within MESH_TOL relative of phase 10 (a)'s.
MESH_STEPS, MESH_TOL = 3, 1e-5
#: (b): prefill MESH_PROMPT tokens, then ZOO_DECODE_STEPS greedy steps, on
#: the full widths cut to ZOO_CUT_LAYERS layers; logits within MESH_TOL ·
#: max(1, max |unsharded|).
MESH_BATCH, MESH_PROMPT = 4, 64
MESH_DIR = os.path.join(ROOT, "build", "chip_smoke_mesh")


def _dtensors_on(device, tree, what):
    from torch.distributed.tensor import DTensor

    leaves = [a for _, a in _leaves(tree)]
    bad = [type(a).__name__ for a in leaves if not (isinstance(a, DTensor) and a.device.type == device.type)]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} of {len(leaves)} leaves are not DTensors on {device.type}")
    return len(leaves)


def mesh_train(mesh, device, card, plain):
    """(a): ``train(qwen3_1_7b, reduced=False, mesh=)`` as phase 10 (a) runs
    it, MESH_STEPS steps, held against phase 10 (a)'s first steps."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import train

    steps = []

    def on_step(step, m):
        steps.append(dict(step=step, loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                          step_ms=m["step_time_s"] * 1e3))

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t = time.perf_counter()
    params, opt, _ = train("qwen3_1_7b", steps=MESH_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, reduced=False,
                           schedule="warmup_cosine", seed=0, log_every=MESH_STEPS, mesh=mesh, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = launch_counts()
    if any(launches.values()):
        raise AssertionError(f"(a) training on the mesh launched hand-written kernels: {launches}")
    n = _dtensors_on(device, params, "(a) params") + _dtensors_on(device, {"m": opt["m"], "v": opt["v"]}, "(a) moments")
    worst = 0.0
    for got, want in zip(steps, plain["steps"]):
        for key in ("loss", "grad_norm"):
            err = abs(got[key] - want[key]) / abs(want[key])
            if not err <= MESH_TOL:
                raise AssertionError(f"(a) step {got['step']} {key}: mesh {got[key]} vs phase 10's {want[key]}")
            worst = max(worst, err)
    rec = dict(steps=steps, wall_s=wall, leaves=n, rel_err=worst, launches=launches,
               median_step_ms=_median([s["step_ms"] for s in steps[1:]]),
               plain_median_step_ms=_median([s["step_ms"] for s in plain["steps"][1:MESH_STEPS]]),
               peak_bytes=torch.cuda.max_memory_allocated() - before, earlier_phases_bytes=before)
    for s in steps:
        log(f"    step {s['step']}: loss {s['loss']:.6f}, grad norm {s['grad_norm']:.6f}; {s['step_ms']:.1f} ms  ({card})")
    log(f"  (a) qwen3_1_7b full config on the one-rank mesh (1,1), {MESH_STEPS} steps: {n} params and moments, "
        f"each a DTensor on {device.type}; loss and grad norm of every step within {worst:.2e} relative of phase 10's "
        f"(<= {MESH_TOL}); median step (steps 1-{MESH_STEPS - 1}) {rec['median_step_ms']:.1f} ms against phase "
        f"10's {rec['plain_median_step_ms']:.1f} ms over the same steps; peak {rec['peak_bytes'] / 2**30:.2f} GiB "
        f"over earlier phases ({before / 2**30:.2f} GiB); hand-written kernel launches: 0  ({card})")
    del params, opt
    return rec


def mesh_serve(mesh, device, card):
    """(b): prefill + ZOO_DECODE_STEPS decode steps through ``launch.steps``
    on the cut full-width model, params and caches laid out on the mesh by
    ``specs.params_shardings`` / ``cache_shardings``, against the same
    steps unsharded on the card.  Returns the record and the mesh's params
    (for (c))."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shlib
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import specs, steps
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config("qwen3_1_7b"), n_layers=ZOO_CUT_LAYERS)
    params = M.init_params(torch.Generator(device=device).manual_seed(2), cfg, device=device)
    rng = np.random.default_rng(11)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (MESH_BATCH, MESH_PROMPT)).astype(np.int32)).to(device)
    t_max = MESH_PROMPT + ZOO_DECODE_STEPS
    prefill, decode = steps.make_prefill_step(cfg), steps.make_decode_step(cfg)
    reset_launch_counts()
    want = []
    logits, cache = prefill(params, {"tokens": toks}, M.init_cache(cfg, MESH_BATCH, t_max, device=device))
    feed = [logits.argmax(-1)[:, None].to(torch.int32)]
    want.append(logits)
    for i in range(ZOO_DECODE_STEPS):
        pos = torch.full((MESH_BATCH,), MESH_PROMPT + i, dtype=torch.int32, device=device)
        logits, cache = decode(params, feed[-1], pos, cache)
        want.append(logits)
        feed.append(logits.argmax(-1)[:, None].to(torch.int32))
    del cache
    with shlib.use_mesh(mesh):
        p_d = shlib.distribute(params, specs.params_shardings(params, mesh))
        c_plain = M.init_cache(cfg, MESH_BATCH, t_max, device=device)
        c_d = shlib.distribute(c_plain, specs.cache_shardings(c_plain, mesh))
        t_in = shlib.distribute({"tokens": toks}, specs.batch_shardings({"tokens": toks}, mesh))
        got = []
        logits, c_d = prefill(p_d, t_in, c_d)
        got.append(logits.full_tensor())
        for i in range(ZOO_DECODE_STEPS):
            tp = {"tokens": feed[i], "pos": torch.full((MESH_BATCH,), MESH_PROMPT + i, dtype=torch.int32,
                                                       device=device)}
            tp = shlib.distribute(tp, specs.batch_shardings(tp, mesh))
            logits, c_d = decode(p_d, tp["tokens"], tp["pos"], c_d)
            got.append(logits.full_tensor())
    torch.cuda.synchronize()
    launches = launch_counts()
    if any(launches.values()):
        raise AssertionError(f"(b) serving on the mesh launched hand-written kernels: {launches}")
    n_cache = _dtensors_on(device, c_d, "(b) cache")
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        real = w[:, :cfg.vocab_size]
        err = float((g[:, :cfg.vocab_size] - real).abs().max()) / max(1.0, float(real.abs().max()))
        if not err <= MESH_TOL:
            raise AssertionError(f"(b) step {i}: logits on the mesh differ from the unsharded step by {err:.3g}")
        worst = max(worst, err)
    log(f"  (b) {ZOO_CUT_LAYERS} of 28 layers at full widths, batch {MESH_BATCH}: prefill {MESH_PROMPT} tokens + "
        f"{ZOO_DECODE_STEPS} decode steps through launch.steps (bf16 compute), params and the {n_cache}-leaf "
        f"cache laid out by specs.params_shardings / cache_shardings: logits max |d| / max(1, max |unsharded|) "
        f"{worst:.3g} (<= {MESH_TOL}); hand-written kernel launches: 0  ({card})")
    del c_d, params
    return dict(rel_err=worst, steps=len(got), cache_leaves=n_cache, launches=launches), p_d


def mesh_checkpoint(mesh, device, card, params):
    """(c): (b)'s params saved from the mesh, restored with ``shardings=``
    onto the mesh and onto the plain card, bit for bit."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import ckpt
    from repro_torch.launch import specs
    from repro_torch.models import model as M

    shutil.rmtree(MESH_DIR, ignore_errors=True)
    try:
        t = time.perf_counter()
        ckpt.save(MESH_DIR, 1, {"params": params})
        save_s = time.perf_counter() - t
        target = {"params": M.tree_map(lambda _, a: torch.empty(a.shape, dtype=a.dtype, device="meta"), params)}
        p_sh = specs.params_shardings(target["params"], mesh)
        t = time.perf_counter()
        on_mesh, _, _ = ckpt.restore(MESH_DIR, target, shardings={"params": p_sh})
        restore_s = time.perf_counter() - t
        on_card, _, _ = ckpt.restore(MESH_DIR, target, shardings=device)
    finally:
        shutil.rmtree(MESH_DIR, ignore_errors=True)
    n = 0
    for (path, a), (_, b), (_, c) in zip(_leaves(params), _leaves(on_mesh["params"]), _leaves(on_card["params"])):
        if not (isinstance(b, DTensor) and tuple(b.placements) == tuple(a.placements)
                and torch.equal(b.to_local(), a.to_local())):
            raise AssertionError(f"(c) {path} restored onto the mesh differs")
        if isinstance(c, DTensor) or c.device != device or not torch.equal(c, a.full_tensor()):
            raise AssertionError(f"(c) {path} restored onto the card differs")
        n += a.numel()
    log(f"  (c) (b)'s params ({n:,} values) saved from the mesh in {save_s:.2f} s, restored onto the mesh "
        f"(shardings=params_shardings) in {restore_s:.2f} s and onto the plain card (shardings={device}): equal bit "
        f"for bit  ({card})")
    return dict(values=n, save_s=save_s, restore_s=restore_s)


#: (d): ``tests/test_torch_mesh.py``'s 4-rank gloo train and serve cases,
#: in spawned processes on CPU tensors under the card's torch (this copy
#: imports only ``repro_torch``; the test file imports ``repro`` too).
#: Held to the test's bounds: train loss within MESH_GLOO_LOSS_TOL, grad
#: norm within MESH_TOL relative, params within MESH_GLOO_PARAM_TOL; served
#: logits within MESH_TOL · max(1, max |one device|).
MESH_WORLD, MESH_GLOO_LOSS_TOL, MESH_GLOO_PARAM_TOL = 4, 1e-3, 2e-4
MESH_WORKER = textwrap.dedent("""
    import sys
    import numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    mode, rank, world, store, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world)
    from repro_torch.checkpoint.ckpt import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import specs as SP, steps as S
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model as M
    from repro_torch.optim import adamw

    cfg = get_config("qwen3_1_7b", reduced=True)
    try:
        mesh = make_test_mesh((2, 2), device_type="cpu")
        if mode == "train":
            sc = ShapeConfig("t", "train", 32, 4, microbatches=2)
            step = S.make_train_step(cfg, sc, compute_dtype=torch.float32, q_chunk=16, kv_chunk=16)
            batch = {k: torch.from_numpy(v) for k, v in Pipeline(cfg, DataConfig(0)).batch(0, 4, 32).items()}
            params = M.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
            with sh.use_mesh(mesh):
                params = sh.distribute(params, SP.params_shardings(SP.params_specs(cfg), mesh))
                opt = adamw.init(params)
                batch = sh.distribute(batch, SP.batch_shardings(batch, mesh))
                params, opt, m = step(params, opt, batch)
            # full_tensor() is a collective: every rank gathers, rank 0 writes
            arrays = {f"leaf{i}": a.full_tensor().numpy() for i, a in enumerate(tree_leaves(params))}
            arrays.update(loss=m["loss"].full_tensor().numpy(), gnorm=m["grad_norm"].full_tensor().numpy())
            if rank == 0:
                np.savez(out, **arrays)
        else:  # serve
            params = M.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
            toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 24)).astype(np.int32))
            prefill = S.make_prefill_step(cfg, compute_dtype=torch.float32, q_chunk=8, kv_chunk=8)
            decode = S.make_decode_step(cfg, compute_dtype=torch.float32)
            with sh.use_mesh(mesh):
                params = sh.distribute(params, SP.params_shardings(SP.params_specs(cfg), mesh))
                cache = sh.distribute(M.init_cache(cfg, 4, 32, device="cpu"),
                                      SP.cache_shardings(SP.cache_specs(cfg, 4, 32), mesh))
                batch = {"tokens": toks[:, :16]}
                logits, cache = prefill(params, sh.distribute(batch, SP.batch_shardings(batch, mesh)), cache)
                outs = [logits.full_tensor().numpy()]
                for i in range(3):
                    t_in = {"tokens": toks[:, 16 + i:17 + i], "pos": torch.full((4,), 16 + i, dtype=torch.int32)}
                    t_in = sh.distribute(t_in, SP.batch_shardings(t_in, mesh))
                    logits, cache = decode(params, t_in["tokens"], t_in["pos"], cache)
                    outs.append(logits.full_tensor().numpy())
            if rank == 0:
                np.savez(out, logits=np.stack(outs))
    finally:
        dist.destroy_process_group()
""")


def _spawn_mesh_workers(mode, out):
    """MESH_WORLD gloo processes of MESH_WORKER (a file store under
    MESH_DIR, the loopback interface, one thread each); every one is
    reaped, and any failure raises with the workers' output."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    store = os.path.join(MESH_DIR, f"store_{mode}")
    procs = [subprocess.Popen([sys.executable, "-c", MESH_WORKER, mode, str(rank), str(MESH_WORLD), store, out],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(MESH_WORLD)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise AssertionError(f"(d) the {mode} workers failed:\n" + "\n".join(logs)[-6000:])


def mesh_gloo(card):
    """(d): the 4-rank gloo train step and prefill + 3 decode steps on a
    (2, 2) mesh of CPU processes, held against the same steps on one CPU
    device in this process."""
    import numpy as np
    import torch

    from repro_torch.checkpoint.ckpt import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.optim import adamw

    shutil.rmtree(MESH_DIR, ignore_errors=True)
    os.makedirs(MESH_DIR)
    t = time.perf_counter()
    try:
        out = {mode: os.path.join(MESH_DIR, f"{mode}.npz") for mode in ("train", "serve")}
        for mode in out:
            _spawn_mesh_workers(mode, out[mode])
        got = {mode: dict(np.load(path)) for mode, path in out.items()}
    finally:
        shutil.rmtree(MESH_DIR, ignore_errors=True)
    wall = time.perf_counter() - t
    cfg = get_config("qwen3_1_7b", reduced=True)
    step = steps.make_train_step(cfg, ShapeConfig("t", "train", 32, 4, microbatches=2),
                                 compute_dtype=torch.float32, q_chunk=16, kv_chunk=16)
    batch = {k: torch.from_numpy(v) for k, v in Pipeline(cfg, DataConfig(0)).batch(0, 4, 32).items()}
    params = M.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    p1, _, m1 = step(params, adamw.init(params), batch)
    g = got["train"]
    loss_err = abs(float(m1["loss"]) - float(g["loss"]))
    gnorm_err = abs(float(m1["grad_norm"]) - float(g["gnorm"])) / float(m1["grad_norm"])
    param_err = max(float(np.abs(g[f"leaf{i}"] - a.numpy()).max()) for i, a in enumerate(tree_leaves(p1)))
    if not (loss_err < MESH_GLOO_LOSS_TOL and gnorm_err <= MESH_TOL and param_err < MESH_GLOO_PARAM_TOL):
        raise AssertionError(f"(d) the 4-rank train step differs from one device: loss {loss_err:.3g}, "
                             f"grad norm {gnorm_err:.3g} relative, params {param_err:.3g}")
    params = M.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 24)).astype(np.int32))
    logits, cache = steps.make_prefill_step(cfg, compute_dtype=torch.float32, q_chunk=8, kv_chunk=8)(
        params, {"tokens": toks[:, :16]}, M.init_cache(cfg, 4, 32, device="cpu"))
    decode = steps.make_decode_step(cfg, compute_dtype=torch.float32)
    want = [logits.numpy()]
    for i in range(3):
        logits, cache = decode(params, toks[:, 16 + i:17 + i], torch.full((4,), 16 + i, dtype=torch.int32), cache)
        want.append(logits.numpy())
    real = np.stack(want)[..., :cfg.vocab_size]
    serve_err = float(np.abs(got["serve"]["logits"][..., :cfg.vocab_size] - real).max()) / max(1.0, float(np.abs(real).max()))
    if not serve_err <= MESH_TOL:
        raise AssertionError(f"(d) the 4-rank prefill + decode differ from one device by {serve_err:.3g}")
    log(f"  (d) {MESH_WORLD} gloo ranks on a (2, 2) mesh of CPU processes (torch {torch.__version__}), "
        f"{cfg.name} at reduced(): a train step of 2 microbatches against one device: loss |d| {loss_err:.3g} "
        f"(< {MESH_GLOO_LOSS_TOL}), grad norm {gnorm_err:.3g} relative (<= {MESH_TOL}), params max |d| "
        f"{param_err:.3g} (< {MESH_GLOO_PARAM_TOL}); prefill + 3 decode steps: logits {serve_err:.3g} · max "
        f"(<= {MESH_TOL}); the two spawns took {wall:.1f} s")
    return dict(world=MESH_WORLD, loss_abs_err=loss_err, grad_norm_rel_err=gnorm_err, param_abs_err=param_err,
                serve_rel_err=serve_err, wall_s=wall)


def mesh_accounting(mesh, device, card):
    """(e): the dry-run's byte accounting (``launch.dryrun._Accounting``)
    over one train step on the one-rank mesh, beside the rise of the
    allocator's peak over the same step, at full width and at reduced()
    (after a warm-up step each).  No gate: the ratio is a record."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as shlib
    from repro_torch.launch import dryrun, specs, steps
    from repro_torch.models import model as M
    from repro_torch.optim import adamw

    rows = {}
    for name, reduced in (("full", False), ("reduced", True)):
        cfg = get_config("qwen3_1_7b", reduced=reduced)
        step = steps.make_train_step(cfg, ShapeConfig("custom", "train", TRAIN_SEQ, TRAIN_BATCH),
                                     compute_dtype=torch.float32, q_chunk=TRAIN_SEQ, kv_chunk=TRAIN_SEQ,
                                     sched_kwargs=dict(peak_lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS))
        data = {"tokens": torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ), dtype=torch.int32,
                                        generator=torch.Generator().manual_seed(3))}
        data["labels"] = data["tokens"]
        with shlib.use_mesh(mesh):
            params = M.init_params(torch.Generator(device=device).manual_seed(0), cfg, device=device)
            params = shlib.distribute(params, specs.params_shardings(params, mesh))
            opt = adamw.init(params)
            batch = shlib.distribute({k: v.to(device) for k, v in data.items()},
                                     specs.batch_shardings(data, mesh))
            params, opt, _ = step(params, opt, batch)  # warm-up
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            acct = dryrun._Accounting((params, opt, batch))
            with acct:
                params, opt, m = step(params, opt, batch)
            torch.cuda.synchronize()
            rise = torch.cuda.max_memory_allocated() - base
            _finite(m["loss"].full_tensor(), f"(e) {name} loss")
        rows[name] = dict(accounted_bytes=acct.peak, allocator_rise_bytes=rise, ratio=acct.peak / rise)
        log(f"  (e) {cfg.name} {name}, one train step (batch {TRAIN_BATCH} x seq {TRAIN_SEQ}) on the mesh: the "
            f"dry-run's accounting peak {acct.peak / 2**30:.3f} GiB against the allocator's peak rise "
            f"{rise / 2**30:.3f} GiB: ratio {acct.peak / rise:.3f}  ({card})")
        del params, opt, batch, acct
        torch.cuda.empty_cache()
    return rows


def run_mesh(device, card, plain):
    """Phase 11: a one-rank NCCL process group in this process and a (1, 1)
    ("data", "model") mesh on the card; (a) training, (b) serving, (c)
    checkpoints on it.  Returns the phase's record and its launches (none
    may launch a hand-written kernel)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import describe, make_test_mesh

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_test_mesh((1, 1), device_type=device.type)
        log(f"  {describe(mesh)}, {mesh.device_type}, process group {dist.get_backend()}")
        rec = {"train": mesh_train(mesh, device, card, plain)}
        torch.cuda.empty_cache()
        rec["serve"], params = mesh_serve(mesh, device, card)
        rec["checkpoint"] = mesh_checkpoint(mesh, device, card, params)
        del params
        torch.cuda.empty_cache()
        rec["gloo"] = mesh_gloo(card)
        rec["accounting"] = mesh_accounting(mesh, device, card)
    finally:
        dist.destroy_process_group()
    launches = {k: rec["train"]["launches"][k] + rec["serve"]["launches"][k] for k in rec["train"]["launches"]}
    return rec, launches


# ---------------------------------------------------------------------------
# phase 12: the recurrent families at full width
# ---------------------------------------------------------------------------

#: (a): rwkv6_3b served on ZOO_SLOTS slots: requests, prompt tokens (one
#: prefill bucket), new tokens each.
RECUR_ARCH = "rwkv6_3b"
RECUR_REQUESTS, RECUR_PROMPT, RECUR_NEW_TOKENS = 8, 512, 16
#: (b): one layer's full shape (B, S, H, D).  The chunked WKV6 against its
#: per-step plain version on the card: every value within RECUR_TOL ·
#: max(1, max |plain|) — float32 sums in other orders; the CPU tests
#: measure ≤ 4e-7 against repro at D = 16 and S ≤ 256, and D = 64, S = 512
#: sum more terms.
RECUR_LAYER = (4, 512, 40, 64)
RECUR_TOL = 1e-5
#: (b): the full widths cut to ZOO_CUT_LAYERS layers, card against the CPU
#: on a prompt of two rematerialization chunks.
RECUR_CUT_BATCH, RECUR_CUT_SEQ = 2, 256
#: (c): steps of train(rwkv6_3b, reduced=False) at TRAIN_BATCH x TRAIN_SEQ.
RECUR_TRAIN_STEPS = 3


def _sync_ms(fn, reps=3):
    """Median host ms of ``reps`` synchronised calls of ``fn`` after one
    discarded call; returns (ms, the last call's result)."""
    import torch

    times = []
    out = fn()
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return _median(times), out


def serve_chunked_vs_plain(params, cfg, prompt, card):
    """(a): one full-width prefill of ``prompt`` and one decode step of
    ZOO_SLOTS slots (each slot holding that prefill's state) through the
    engine's adapter, with the chunked WKV6 and with its per-step plain
    version swapped in: host ms of each, and their logits within ZOO_TOL."""
    import numpy as np
    import torch

    from repro_torch.models import rwkv6
    from repro_torch.serving.engine import OpaqueModelAdapter

    adapter = OpaqueModelAdapter(params, cfg)
    padded = np.asarray(prompt, np.int32)[None]
    plen = padded.shape[1]
    _, pcache = adapter.prefill(padded, plen, plen + 8)
    cache = adapter.init_cache(ZOO_SLOTS, plen + 8)
    for slot in range(ZOO_SLOTS):
        cache = adapter.scatter(cache, slot, pcache)
    del pcache
    toks = np.asarray(prompt[-ZOO_SLOTS:], np.int32)[:, None]
    pos = np.full((ZOO_SLOTS,), plen, np.int32)

    def prefill():
        return adapter.prefill(padded, plen, plen + 8)[0]

    def decode():  # the adapter's decode returns a new cache; ``cache`` stays as it is
        return adapter.decode(toks, pos, cache)[0]

    rec, out = {}, {}
    chunked = rwkv6._wkv_scan
    for name, scan in (("chunked", chunked), ("plain", rwkv6.wkv_scan_plain)):
        rwkv6._wkv_scan = scan
        try:
            rec[f"{name}_ms"], out[name, "prefill"] = _sync_ms(prefill)
            rec[f"{name}_decode_ms"], out[name, "decode"] = _sync_ms(decode, reps=5)
        finally:
            rwkv6._wkv_scan = chunked
    for what in ("prefill", "decode"):
        got, want = out["chunked", what], out["plain", what]
        err = float((got - want).abs().max()) / max(1.0, float(want.abs().max()))
        if not (bool(torch.isfinite(got).all()) and err <= ZOO_TOL):
            raise AssertionError(f"(a) the chunked {what}'s logits differ from the plain scan's by {err:.3g}")
        rec[f"{what}_logits_rel_err"] = err
    rec["ratio"] = rec["plain_ms"] / rec["chunked_ms"]
    rec["decode_ratio"] = rec["plain_decode_ms"] / rec["chunked_decode_ms"]
    log(f"    one prefill of {plen} tokens: chunked WKV6 {rec['chunked_ms']:.1f} ms, per-step plain scan "
        f"{rec['plain_ms']:.1f} ms ({rec['ratio']:.2f}x; medians of 3, host clock); logits max |d| "
        f"{rec['prefill_logits_rel_err']:.3g} · max (<= {ZOO_TOL})  ({card})")
    log(f"    one decode step of {ZOO_SLOTS} slots: chunked WKV6 {rec['chunked_decode_ms']:.2f} ms, per-step "
        f"plain scan {rec['plain_decode_ms']:.2f} ms ({rec['decode_ratio']:.3f}x; medians of 5, host clock); "
        f"logits max |d| {rec['decode_logits_rel_err']:.3g} · max (<= {ZOO_TOL})  ({card})")
    return rec


def wkv_layer_check(device, card):
    """(b): the chunked ``_wkv_scan`` against ``wkv_scan_plain`` on the card
    at RECUR_LAYER, seeded (decays ``-exp(x)``, x ~ N(0, 1)): outputs,
    final state and the gradients of all six inputs; each timed forward
    and forward + backward."""
    import torch

    from repro_torch.models import rwkv6

    b, s, h, d = RECUR_LAYER
    gen = torch.Generator(device=device).manual_seed(7)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device)

    ins = [rnd(b, s, h, d), rnd(b, s, h, d), rnd(b, s, h, d), -torch.exp(rnd(b, s, h, d)),
           rnd(h, d) * 0.5, rnd(b, h, d, d)]
    gy, gs = rnd(b, s, h, d), rnd(b, h, d, d)

    def both(fn):
        xs = [a.clone().requires_grad_() for a in ins]
        y, st = fn(*xs)
        grads = torch.autograd.grad((y * gy).sum() + (st * gs).sum(), xs)
        return [y.detach(), st.detach(), *grads]

    def forward(fn):
        with torch.no_grad():
            return fn(*ins)

    rec = {}
    for name, fn in (("chunked", rwkv6._wkv_scan), ("plain", rwkv6.wkv_scan_plain)):
        rec[f"{name}_fwd_ms"], _ = _sync_ms(lambda: forward(fn))
        rec[f"{name}_fwd_bwd_ms"], rec[name] = _sync_ms(lambda: both(fn))
    names = ("y", "state", "dr", "dk", "dv", "dlw", "du", "dstate")
    errs = {}
    for n, g, w in zip(names, rec.pop("chunked"), rec.pop("plain")):
        errs[n] = float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
        if not (bool(torch.isfinite(g).all()) and errs[n] <= RECUR_TOL):
            raise AssertionError(f"(b) chunked WKV6 {n} differs from the plain scan by {errs[n]:.3g}")
    rec["rel_err"] = errs
    log(f"  (b) chunked WKV6 against its per-step plain version at (B, S, H, D) = {RECUR_LAYER}: outputs, "
        f"state and the gradients of r, k, v, lw, u, state max |d| / max(1, max |plain|) "
        f"{max(errs.values()):.3g} (<= {RECUR_TOL}); forward {rec['chunked_fwd_ms']:.2f} ms against "
        f"{rec['plain_fwd_ms']:.2f} ms, forward + backward {rec['chunked_fwd_bwd_ms']:.2f} ms against "
        f"{rec['plain_fwd_bwd_ms']:.2f} ms (medians of 3, host clock)  ({card})")
    return rec


def run_recurrent(device, card):
    """Phase 12: rwkv6_3b at its full config (a) served, (b) its scan and
    its 2-layer cut against their references, (c) trained.  Returns the
    phase's record and the launches of its served and training runs (none
    may launch a hand-written kernel)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    rec = {}
    cfg = get_config(RECUR_ARCH)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    params = M.init_params(torch.Generator(device=device).manual_seed(0), cfg, device=device)
    n_params = sum(a.numel() for _, a in _leaves(params))
    log(f"  (a) {cfg.name} full config: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.d_model // cfg.ssm.head_dim} heads of {cfg.ssm.head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}: {n_params:,} float32 parameters; {RECUR_REQUESTS} greedy requests of "
        f"{RECUR_PROMPT} tokens, {RECUR_NEW_TOKENS} new tokens each, {ZOO_SLOTS} slots")
    t = time.perf_counter()
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, (RECUR_PROMPT,)).astype(np.int32) for _ in range(RECUR_REQUESTS)]
    res = serve_posture(params, cfg, prompts, profile=True, new_tokens=RECUR_NEW_TOKENS)
    res.pop("generated")
    if any(res["launches"].values()):
        raise AssertionError(f"(a) serving {cfg.name} launched {res['launches']}")
    log(f"    {res['tokens_per_s']:.1f} tokens/s ({res['tokens']} tokens in {res['wall_s']:.2f} s); prefill "
        f"{res['prefill_ms']:.2f} ms, decode step {res['decode_step_ms']:.2f} ms (medians, {res['decode_steps']} "
        f"steps of {ZOO_SLOTS} slots); peak {(res['peak_bytes'] - before) / 2**30:.2f} GiB over the "
        f"{(res['resident_bytes'] - before) / 2**30:.2f} GiB it holds at rest  ({card})")
    log_profiles(res, cfg.name)
    res["chunked_vs_plain"] = serve_chunked_vs_plain(params, cfg, prompts[0], card)
    rec["serve"] = dict(n_params=n_params, earlier_phases_bytes=before, phase_wall_s=time.perf_counter() - t, **res)
    log(f"    (a) took {rec['serve']['phase_wall_s']:.1f} s")

    rec["scan"] = wkv_layer_check(device, card)
    cut = dataclasses.replace(cfg, n_layers=ZOO_CUT_LAYERS)
    p2 = {**params, "layers": M.tree_map(lambda _, a: a[:ZOO_CUT_LAYERS].clone(), params["layers"])}
    del params
    torch.cuda.empty_cache()
    t = time.perf_counter()
    steps = card_vs_cpu(p2, cut, zoo_batch(cut, np.random.default_rng(13), RECUR_CUT_BATCH, RECUR_CUT_SEQ),
                        ZOO_DECODE_STEPS, False, device)
    rec["cut"] = steps
    log(f"  (b) {cfg.name}, {ZOO_CUT_LAYERS} of {cfg.n_layers} layers at full widths, batch {RECUR_CUT_BATCH} x "
        f"{RECUR_CUT_SEQ}: prefill + {ZOO_DECODE_STEPS} decode steps, card vs CPU max |d| / max(1, max |CPU|) "
        f"{max(e for e, _, _ in steps):.3g} (<= {ZOO_TOL}); greedy tokens equal at "
        f"{sum(q for _, _, q in steps)} of {sum(c for _, c, _ in steps)} clear rows "
        f"({time.perf_counter() - t:.1f} s)")
    del p2
    torch.cuda.empty_cache()

    t = time.perf_counter()
    log(f"  (c) {cfg.name} full config trained by repro_torch.launch.train.train: float32, TF32 off, remat "
        f"{cfg.remat_policy}, warmup_cosine, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, {RECUR_TRAIN_STEPS} steps")
    rec["train"], params, opt = train_full(device, card, qat=False, arch=RECUR_ARCH, steps_n=RECUR_TRAIN_STEPS)
    prof = profile_train_step(params, opt, device, rec["train"]["median_step_ms"], arch=RECUR_ARCH)
    rec["train"]["profile"] = prof
    if prof is None:
        log("    one training step device time by kernel: not measured (no device time)")
    else:
        log(f"    one training step (torch.profiler, after a discarded warm-up step): {prof['device_ms']:.1f} ms "
            f"of device time against the {prof['step_ms']:.1f} ms step (median, unprofiled): the card idles "
            f"{100 * prof['idle_share']:.1f} %; by kernel  ({card}):")
        for key, ms, calls in prof["top"]:
            log(f"      {ms:10.3f} ms  x{calls:<5g} {key[:90]}")
    del params, opt
    torch.cuda.empty_cache()
    log(f"    (c) took {time.perf_counter() - t:.1f} s")
    launches = {k: res["launches"][k] + rec["train"]["launches"][k] for k in res["launches"]}
    return rec, launches


def lut_row(rows, worst, launches):
    """The kernels-line row of qact_lut, which runs by two routes: on the
    main path as the table in the qmatmul epilogue (slice A's Tanh layer
    and its Sigmoid layer, shifted as the plan folds it), for a LUT the plan
    does not fold as the standalone kernel.  The row's times are the main
    route's kernel, the two matmuls with their tables, against that fused
    function's own bound and plain version; no single PyTorch call computes
    it.  The table's added time, with its spread over the turns, and the
    standalone kernel's times at the same layers ride in ``routes``."""
    def pick(kernel, shape):
        sel = [r for r in rows if r["kernel"] == kernel and r["shape"] == shape]
        if len(sel) != 1:
            raise AssertionError(f"{kernel}: row {shape} missing")
        return sel[0]

    fused = [pick("qmatmul_lut", f"sliceA,M={MLP_MAX_BATCH},K=2048,N=6144,w8,int8"),
             pick("qmatmul_lut", f"sliceA,M={MLP_MAX_BATCH},K=6144,N=6144,w8,uint8-128")]
    alone = [pick("qact_lut", f"M={MLP_MAX_BATCH},N=6144,int8"),
             pick("qact_lut", f"M={MLP_MAX_BATCH},N=6144,uint8")]
    if launches["qmatmul_lut"] <= 0:
        raise AssertionError("qact_lut was launched no time on the main paths (no qmatmul launch "
                             "carried a table)")

    def total(sel, field):
        return sum(r[field] for r in sel)

    return {
        "name": "qact_lut", "route": "cuda", "source": "src/repro_torch/kernels/csrc/qmatmul.cu",
        "replaces": "src/repro/kernels/qact_lut.py:57",
        "launches": launches["qmatmul_lut"] + launches["qact_lut"],
        "max_abs_err": worst["qact_lut"], "ms": total(fused, "ms"),
        "plain_ms": total(fused, "plain_ms"), "bound_ms": total(fused, "bound_ms"),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in fused) else "operations",
        "library_ms": None,
        "routes": [
            {"where": "main path: the table in the qmatmul epilogue",
             "source": "src/repro_torch/kernels/csrc/qmatmul.cu",
             "launches": launches["qmatmul_lut"], "with_table_ms": total(fused, "ms"),
             "without_table_ms": total(fused, "bare_ms"), "added_ms": total(fused, "added_ms"),
             "added_range_ms": [sum(r["added_range_ms"][i] for r in fused) for i in (0, 1)],
             "unfolded_ms": total(fused, "unfolded_ms")},
            {"where": "LUTs the plan does not fold: the standalone kernel",
             "source": "src/repro_torch/kernels/csrc/qact_lut.cu",
             "launches": launches["qact_lut"], "ms": total(alone, "ms"),
             "plain_ms": total(alone, "plain_ms"), "bound_ms": total(alone, "bound_ms"),
             "library_ms": total(alone, "library_ms")},
        ],
    }


# ---------------------------------------------------------------------------
# phase 14: Mellum2's block on the compiled token path
# ---------------------------------------------------------------------------

#: Mellum2-12B-A2.5B's widths (the benchmark's tokpath-mellum2): 32 query
#: heads over 4 KV heads of 128, 1,024-row rings on the window layers, 64
#: routed experts of width 896, top-8; one period of its layer pattern.
MELLUM2 = dict(vocab=98304, d_model=2304, n_heads=32, n_kv_heads=4, head_dim=128, n_layers=4,
               layer_kinds=("window", "window", "window", "full"), window=1024,
               n_experts=64, top_k=8, d_expert=896)
#: The engine's requests (prompt tokens, new tokens) on MELLUM2_SLOTS slots:
#: a prompt under the window whose decode wraps the rings, prompts of one
#: to two windows, and two shorter ones that take over freed slots (stale
#: ring rows from the slot's earlier request).
MELLUM2_REQUESTS = ((1013, 24), (1100, 12), (1500, 24), (2100, 16), (300, 20), (700, 24))
MELLUM2_SLOTS, MELLUM2_MAX_LEN, MELLUM2_BUCKET = 4, 2304, 128


class _RecordingAdapter:
    """A token path adapter that keeps a copy of every logits row and every
    prefill's K/V rows it hands the engine."""

    def __init__(self, inner):
        self.inner, self.cfg = inner, inner.cfg
        self.logits, self.prefilled = [], []

    def init_cache(self, slots, max_len):
        return self.inner.init_cache(slots, max_len)

    def prefill(self, padded, plen, max_len):
        last, pcache = self.inner.prefill(padded, plen, max_len)
        self.logits.append(last.clone())
        self.prefilled.append({k: v.clone() for k, v in pcache.items()})
        return last, pcache

    def scatter(self, cache, slot, pcache):
        return self.inner.scatter(cache, slot, pcache)

    def decode(self, toks, pos, cache):
        logits, cache = self.inner.decode(toks, pos, cache)
        self.logits.append(logits.clone())
        return logits, cache


def run_mellum2(device, card):
    """Phase 14: the compiled token path at Mellum2's widths, built from one
    seed on backends ``cuda`` and ``ref`` and driven by ``ServeEngine``
    through ``CompiledTokenAdapter``: every logits row the engine reads, every
    prefill's K/V rows (the rings in ring order), the final caches (full
    layers and rings, every slot) and the generated tokens equal, bit for
    bit.  On ``cuda`` each expert layer is one fused ``qmoe`` step and the
    decode plan replays as one CUDA graph; the counted run (after a warm
    run) launches qmoe exactly 5 times a layer per prefill and per decode
    step, and kv_write twice a layer (K and V) per decode step.  Returns the phase's record and the counted run's launches."""
    import numpy as np
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.qmoe import LAUNCHES_PER_CALL
    from repro_torch.serving.engine import EngineConfig, Request, ServeEngine
    from repro_torch.serving.token_path import (
        CompiledTokenAdapter, CompiledTokenPath, TokenPathConfig, make_token_params,
    )

    cfg = TokenPathConfig(**MELLUM2)
    t0 = time.perf_counter()
    params = make_token_params(cfg, seed=0)
    tps = {b: CompiledTokenPath(cfg, params, backend=b, device=device) for b in ("cuda", "ref")}
    build_s = time.perf_counter() - t0
    for b, tp in tps.items():
        for what, cm in (("prefill", tp.prefill_cm), ("decode", tp.decode_cm)):
            if cm.stats["fused_qmoe"] != cfg.n_layers:
                raise AssertionError(f"{b} {what}: {cm.stats['fused_qmoe']} fused qmoe steps, want "
                                     f"one a layer ({cfg.n_layers})")
    log(f"  params + compile of both backends: {build_s:.1f} s; each plan: one fused qmoe step a "
        f"layer; cuda decode {tps['cuda'].decode_cm.stats}")
    rng = np.random.default_rng(14)
    prompts = [rng.integers(1, cfg.vocab, (p,)).astype(np.int32) for p, _ in MELLUM2_REQUESTS]

    def drive(tp):
        ad = _RecordingAdapter(CompiledTokenAdapter(tp))
        eng = ServeEngine(ecfg=EngineConfig(slots=MELLUM2_SLOTS, max_len=MELLUM2_MAX_LEN,
                                            prefill_bucket=MELLUM2_BUCKET), adapter=ad)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=n)
                for i, (p, (_, n)) in enumerate(zip(prompts, MELLUM2_REQUESTS))]
        for r in reqs:
            eng.submit(r)
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.run_until_drained()
        torch.cuda.synchronize()
        return dict(engine_s=time.perf_counter() - t, adapter=ad, steps=eng.metrics["decode_steps"],
                    prefills=eng.metrics["prefills"], generated=[list(r.generated) for r in reqs],
                    cache={k: v.clone() for k, v in eng.cache.items()})

    drive(tps["cuda"])  # first launches, prefill buckets, the decode graph's capture
    graphs_before = tps["cuda"].graph_stats()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    got = drive(tps["cuda"])
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    graphs = {k: v - graphs_before[k] for k, v in tps["cuda"].graph_stats().items()}
    want = drive(tps["ref"])

    if got["generated"] != want["generated"]:
        raise AssertionError(f"engine generation differs: {got['generated']} vs {want['generated']}")
    lens = [len(g) for g in got["generated"]]
    if lens != [n for _, n in MELLUM2_REQUESTS]:
        raise AssertionError(f"engine generated {lens} tokens, want {[n for _, n in MELLUM2_REQUESTS]}")
    ga, wa = got["adapter"], want["adapter"]
    if len(ga.logits) != len(wa.logits) or len(ga.prefilled) != len(MELLUM2_REQUESTS):
        raise AssertionError(f"{len(ga.logits)} vs {len(wa.logits)} logits calls, "
                             f"{len(ga.prefilled)} prefills")
    for i, (a, b) in enumerate(zip(ga.logits, wa.logits)):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"logits call {i}: non-finite values")
        _same(a, b, f"logits call {i}")
    for i, (a, b) in enumerate(zip(ga.prefilled, wa.prefilled)):
        for name in b:
            _same(a[name], b[name], f"prefill {i} rows {name}")
    for name in want["cache"]:
        _same(got["cache"][name], want["cache"][name], f"final cache {name}")
    rings = sorted(tps["cuda"].ring_inputs)
    if len(rings) != 6 or any(got["cache"][r].shape[1] != cfg.window for r in rings):
        raise AssertionError(f"ring caches: {[(r, tuple(got['cache'][r].shape)) for r in rings]}")
    calls = got["prefills"] + got["steps"]
    want_moe = LAUNCHES_PER_CALL * cfg.n_layers * calls
    if launches["qmoe"] != want_moe:
        raise AssertionError(f"qmoe launches {launches['qmoe']}, want {want_moe} "
                             f"({LAUNCHES_PER_CALL} a layer for each of {calls} plan runs)")
    if launches["kv_write"] != 2 * cfg.n_layers * got["steps"]:
        raise AssertionError(f"kv_write launches {launches['kv_write']}, want K and V of "
                             f"{cfg.n_layers} layers in each of {got['steps']} decode steps")
    missing = [k for k in ("qmatmul", "qmatmul_packed", "qattention") if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the Mellum2 token path: {missing}")
    if graphs["captures"] or graphs["replays"] != got["steps"] or graphs["eager"] != got["prefills"]:
        raise AssertionError(f"decode graphs in the counted run: {graphs}, want {got['steps']} replays "
                             f"and {got['prefills']} eager prefills")
    tokens = sum(lens)
    log(f"  {len(MELLUM2_REQUESTS)} requests (prompts {[p for p, _ in MELLUM2_REQUESTS]}) on "
        f"{MELLUM2_SLOTS} slots: cuda == ref in all {len(ga.logits)} logits rows, every prefill's K/V "
        f"rows, the final caches (2 full, 6 ring) and {tokens} generated tokens, bit for bit")
    log(f"  counted run: {got['prefills']} prefills, {got['steps']} decode steps as "
        f"{graphs['replays']} graph replays (captures {graphs['captures']}, eager {graphs['eager']}); "
        f"launches {launches}; engine {got['engine_s']:.2f} s = {tokens / got['engine_s']:.1f} tokens/s "
        f"(ref {want['engine_s']:.2f} s); peak allocated {peak / 2**30:.2f} GiB  ({card})")
    rec = dict(config=dict(MELLUM2), requests=[list(r) for r in MELLUM2_REQUESTS],
               slots=MELLUM2_SLOTS, max_len=MELLUM2_MAX_LEN, build_s=build_s,
               prefills=got["prefills"], decode_steps=got["steps"], logits_calls=len(ga.logits),
               graphs=graphs, engine_s=got["engine_s"], ref_engine_s=want["engine_s"],
               tokens=tokens, peak_bytes=peak)
    del tps, got, want
    torch.cuda.empty_cache()
    return rec, launches


# ---------------------------------------------------------------------------
# phase 13: the port's examples, each run as a user runs it
# ---------------------------------------------------------------------------

#: ``python -m repro_torch.examples.<name>`` at its defaults (those of
#: ``examples/<name>.py``), with the keys of its last line that must be true.
EXAMPLE_CHECKS = {
    "quickstart": ("codes_equal", "round_trip_equal"),
    "cnn_prequant": ("per_tensor_equal", "per_channel_equal"),
    "serve_compiled": ("mlp_equal", "seq_equal"),
    "fleet_serve": ("fleet_equal", "failover_equal"),
    "serve_quantized": ("all_generated",),
    "train_qat": ("losses_finite", "drift_ok"),
}
#: The examples that serve compiled artifacts: each must launch qmatmul.
COMPILED_EXAMPLES = ("quickstart", "cnn_prequant", "serve_compiled", "fleet_serve")
EXAMPLES_LOG_DIR = os.path.join(OUT_DIR, "examples")


def run_example(name):
    """One example as a child process on the card; returns its last line
    (one JSON object) with the child's wall seconds.  Its whole output goes
    to ``chiprun_out/examples/<name>.log``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", f"repro_torch.examples.{name}"], capture_output=True,
                       text=True, timeout=900, cwd=ROOT, env=env)
    wall_s = time.perf_counter() - t
    os.makedirs(EXAMPLES_LOG_DIR, exist_ok=True)
    with open(os.path.join(EXAMPLES_LOG_DIR, f"{name}.log"), "w") as f:
        f.write(r.stdout + "\n--- stderr ---\n" + r.stderr)
    if r.returncode != 0:
        raise AssertionError(f"example {name} exited {r.returncode}:\n{r.stdout[-2000:]}\n"
                             f"{r.stderr[-4000:]}")
    out = json.loads(r.stdout.strip().splitlines()[-1])
    out["wall_s"] = wall_s
    return out


def run_examples(card):
    """Phase 13: the six examples of ``src/repro_torch/examples`` on the card,
    each a child process at the original's defaults; every check of each
    must hold (codes and responses equal to ``ReferenceRuntime`` in 1-4,
    nothing lost or served twice in 4, finite losses and the W8A8 drift
    under 0.15 in 6), and 1-4 must launch qmatmul.  Returns the phase's
    record and the launches summed over the six runs."""
    record, launches = {}, {}
    for name, checks in EXAMPLE_CHECKS.items():
        r = run_example(name)
        failed = [k for k in checks if r.get(k) is not True]
        if name == "fleet_serve" and (r["lost"] or r["duplicates"] or r["plan_cache_misses"]):
            failed.append(f"lost {r['lost']}, duplicates {r['duplicates']}, "
                          f"misses {r['plan_cache_misses']}")
        if name in COMPILED_EXAMPLES and r["launches"]["qmatmul"] <= 0:
            failed.append("no qmatmul launch")
        if failed or r["device"] != "cuda":
            raise AssertionError(f"example {name} on {r['device']}: {failed}; its line: {r}")
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
        if name == "quickstart":
            detail = (f"codes == ReferenceRuntime, {r['eliminated']} nodes eliminated, round trip "
                      f"equal, int8 vs fp32 {r['rel_err_vs_f32']:.4f}")
        elif name == "cnn_prequant":
            detail = (f"per-tensor and per-channel == ReferenceRuntime, accuracy fp32 "
                      f"{r['acc_f32']:.3f}, int8 {r['acc_int8']:.3f}, per-channel "
                      f"{r['acc_int8_per_channel']:.3f}")
        elif name == "serve_compiled":
            detail = (f"{r['mlp_requests']} + {r['seq_requests']} requests == their solo runs, "
                      f"server p95 {r['mlp_latency_p95_ms']:.2f} / {r['seq_latency_p95_ms']:.2f} ms")
        elif name == "fleet_serve":
            detail = (f"{r['requests']} + {r['wave']} requests == their solo runs, {r['failovers']} "
                      f"failover, {r['rerouted']} rerouted, lost 0, duplicates 0")
        elif name == "serve_quantized":
            detail = ", ".join(f"{k} {p['tokens_per_s']:.1f} tokens/s (agreement "
                               f"{p['agreement']:.1%})" for k, p in r["postures"].items())
        else:
            detail = (f"{r['steps']} QAT steps, loss {r['loss_first']:.4f} -> {r['loss_last']:.4f} "
                      f"(Δ {r['loss_delta']:.4f}); eval f32 {r['loss_f32']:.4f}, W8A8 "
                      f"{r['loss_w8a8']:.4f}, drift {r['drift']:.4f} < 0.15; greedy agreement "
                      f"{r['agreement']:.2%}")
        log(f"  {name}: {r['wall_s']:.1f} s wall; {detail}; launches "
            f"{ {k: v for k, v in r['launches'].items() if v} }  ({card})")
        record[name] = r
    return record, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    # every plain version contracts in float64; state the float32 settings too
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[1/15] environment: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    secs = _build.build()
    log(f"[2/15] build: {', '.join(f'{k} {v:.1f} s' for k, v in secs.items())} "
        f"(wall {time.perf_counter() - t0:.1f} s, nvcc sm_90a into {_build.BUILD_DIR.name}/)")

    log("[3/15] kernels against their plain versions (tolerance 0)")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    rows = []
    instances = kernel_instances()
    worst = check_kernels(device, flush, rows)

    log(f"[4/15] token path: compiled token path, backend cuda vs backend ref  ({card})")
    perf, launches_tok, ref = run_slice(device)
    log(f"  prefill (4,128): {perf['prefill_ms']:.2f} ms; decode step (4,512): "
        f"{perf['decode_step_ms']:.2f} ms = {perf['decode_tokens_per_s']:.1f} tokens/s; engine "
        f"{perf['engine_tokens_per_s']:.1f} tokens/s; peak allocated "
        f"{perf['peak_bytes'] / 2**30:.2f} GiB  ({card})")
    log(f"  ref backend on the card: prefill {perf['ref_prefill_ms']:.2f} ms, decode step "
        f"{perf['ref_decode_step_ms']:.2f} ms")
    log(f"  launches on the token path: {launches_tok}")
    if perf["decode_device"] is None:
        log("  decode step device time by kernel: not measured (the profiler recorded no device time)")
    else:
        total, top = perf["decode_device"]
        log(f"  one decode step at (4,512) (torch.profiler): {total:.4f} ms of device time against "
            f"the {perf['decode_step_ms']:.4f} ms step (median, unprofiled): the card idles "
            f"{100 * (1 - total / perf['decode_step_ms']):.1f} % of the step; copies of per-head "
            f"q/k/v views: {perf['decode_head_view_copies']}; by kernel:")
        for key, ms, calls in top:
            log(f"    {ms:9.4f} ms  x{calls:<4g} {key[:90]}")
    missing = [k for k in ("qmatmul", "qmatmul_packed", "qattention") if launches_tok[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the token path: {missing}")

    log(f"[5/15] slice A: the paper's Tanh/Sigmoid MLP {' -> '.join(map(str, MLP_WIDTHS))}, "
        f"CompiledModelServer(max_batch={MLP_MAX_BATCH}), backend cuda vs ref  ({card})")
    stats_a = {"fused_lut": 2, "fused_qlinear": 3}
    perf_a, launches_a = run_served(
        device, "slice A", build_mlp, MLP_WAVES, MLP_MAX_BATCH, MLP_REF_SAMPLE,
        {"cuda": {**stats_a, "lut_epilogues": 2}, "ref": {**stats_a, "lut_epilogues": 0}},
        {"qmatmul": 3, "qmatmul_lut": 2},
    )
    _perf_line("slice A", perf_a, card, MLP_MAX_BATCH)
    check_no_unfolded_kernels("slice A", perf_a)
    log(f"  launches on slice A: {launches_a} (no standalone LUT or shift kernel in the profiled "
        "forward)")

    log(f"[6/15] slice B: the paper's §5 CNN, {len(CNN_CONVS)} stride-2 convs "
        f"{[c[0] for c in CNN_CONVS]} + FC {CNN_CLASSES} at {CNN_IN}, "
        f"CompiledModelServer(max_batch={CNN_MAX_BATCH}), backend cuda vs ref  ({card})")
    perf_b, launches_b = run_served(
        device, "slice B", build_cnn, CNN_WAVES, CNN_MAX_BATCH, CNN_REF_SAMPLE,
        {b: {"fused_qconv": len(CNN_CONVS), "fused_qlinear": 1} for b in ("cuda", "ref")},
        {"qmatmul": len(CNN_CONVS) + 1},
    )
    perf_b["conv_steps_on_qmatmul"] = perf_b["batches"] * len(CNN_CONVS)
    _perf_line("slice B", perf_b, card, CNN_MAX_BATCH,
               f"; {perf_b['conv_steps_on_qmatmul']} conv steps ran on the qmatmul kernel")
    log(f"  launches on slice B: {launches_b}")

    log(f"[7/15] autotune: the token path tuned on the card (cold, then warm from the tile "
        f"cache), its decode plan saved and served from a fresh process, slice A tuned in its "
        f"server's background; every output against the ref backend  ({card})")
    tuning, launches_tune = run_tuning(device, ref, card)
    log(f"  launches in phase 7's two served token-path drives: {launches_tune}; "
        f"tuning the token path: {tuning['tuning_launches']}; the slice A server, its "
        f"candidates measured between batches included: {tuning['slice_a']['launches']}")

    log(f"[8/15] fleet and checkpoints: a two-axis FFN ({FLEET_D} -> {FLEET_FF} -> {FLEET_D}) served "
        f"by {FLEET_REPLICAS} replicas warm-started from its artifact behind a ShardedRouter, one "
        f"replica failing; phase 4's decode checkpointed through a crash; the generic pooling ops  "
        f"({card})")
    t = time.perf_counter()
    fleet, launches_fleet = run_fleet(device, card)
    checkpoint, launches_ckpt = run_checkpointed_decode(ref, card)
    pooling = run_pooling(device, card)
    launches_8 = {k: launches_fleet.get(k, 0) + launches_ckpt.get(k, 0) for k in launches_tok}
    missing = [k for k in ("qmatmul", "qmatmul_packed", "qattention") if launches_8[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched in phase 8's served runs: {missing}")
    log(f"  launches in phase 8's served runs (the fleet's rounds and its failover wave, the "
        f"resilient decode): qmatmul {launches_8['qmatmul']}, qmatmul_packed "
        f"{launches_8['qmatmul_packed']}, qattention {launches_8['qattention']}; phase 8 took "
        f"{time.perf_counter() - t:.1f} s  ({card})")

    log(f"[9/15] model zoo: qwen3_1_7b at its full config served by ServeEngine's default "
        f"adapter in three postures; its weights cut to {ZOO_CUT_LAYERS} layers and every other "
        f"architecture at reduced() on the card against the CPU; QuantizedLinear on the qmatmul "
        f"kernel  ({card})")
    t = time.perf_counter()
    zoo, launches_zoo = run_zoo(device, card)
    log(f"  launches in phase 9's served run (QuantizedLinear, backend cuda): {launches_zoo}; "
        f"phase 9 took {time.perf_counter() - t:.1f} s")

    log(f"[10/15] training: qwen3_1_7b at its full config trained on the card by "
        f"repro_torch.launch.train, plain and with QAT, one step profiled; its weights cut to "
        f"{TRAIN_CUT_LAYERS} layers, card vs CPU; resume; grad_compress  ({card})")
    t = time.perf_counter()
    training, launches_train = run_training(device, card)
    log(f"  launches in phase 10's training runs: {launches_train} (training computes in plain "
        f"PyTorch, as repro trains in XLA); phase 10 took {time.perf_counter() - t:.1f} s  ({card})")

    log(f"[11/15] mesh: a one-rank NCCL process group and a (1, 1) (data, model) DeviceMesh on the card; "
        f"qwen3_1_7b at its full config trained on it ({MESH_STEPS} steps, against phase 10), served cut to "
        f"{ZOO_CUT_LAYERS} layers (against the unsharded steps), checkpointed from it and restored  ({card})")
    t = time.perf_counter()
    mesh, launches_mesh = run_mesh(device, card, training["plain"])
    log(f"  launches in phase 11's mesh runs: {launches_mesh} (the sharded steps compute in plain PyTorch); "
        f"phase 11 took {time.perf_counter() - t:.1f} s  ({card})")

    log(f"[12/15] recurrent families at full width: {RECUR_ARCH} at its published config served by "
        f"ServeEngine's default adapter ({RECUR_REQUESTS} requests of {RECUR_PROMPT} tokens), its chunked "
        f"WKV6 against the per-step plain version at one layer's shape, cut to {ZOO_CUT_LAYERS} layers card vs "
        f"CPU, trained {RECUR_TRAIN_STEPS} steps  ({card})")
    t = time.perf_counter()
    recurrent, launches_rec = run_recurrent(device, card)
    if any(launches_rec.values()):
        raise AssertionError(f"phase 12 launched hand-written kernels: {launches_rec}")
    log(f"  launches in phase 12's served and training runs: {launches_rec} (the recurrent families compute in "
        f"plain PyTorch, as repro computes them in XLA); phase 12 took {time.perf_counter() - t:.1f} s  ({card})")

    log(f"[13/15] examples: python -m repro_torch.examples.<name> for each of "
        f"{', '.join(EXAMPLE_CHECKS)}, on the card at the originals' defaults  ({card})")
    t = time.perf_counter()
    examples, launches_ex = run_examples(card)
    examples_s = time.perf_counter() - t
    log(f"  launches in phase 13's six runs: {launches_ex}; phase 13 took {examples_s:.1f} s  ({card})")

    log(f"[14/15] Mellum2: the compiled token path at Mellum2-12B-A2.5B's widths ({MELLUM2['n_layers']} "
        f"layers, one period of its pattern), served by ServeEngine, backend cuda vs ref  ({card})")
    t = time.perf_counter()
    mellum2, launches_mel = run_mellum2(device, card)
    log(f"  phase 14 took {time.perf_counter() - t:.1f} s  ({card})")

    launches = {k: launches_tok.get(k, 0) + launches_a.get(k, 0) + launches_b.get(k, 0)
                + launches_tune.get(k, 0) + launches_8.get(k, 0) + launches_zoo.get(k, 0)
                + launches_train.get(k, 0) + launches_mesh.get(k, 0) + launches_rec.get(k, 0)
                + launches_ex.get(k, 0) + launches_mel.get(k, 0)
                for k in launches_tok}

    # per layer per decode step at (N, S) = (4, 512): the kernel's launches
    # at the decode shapes (qattention: one launch per head)
    def summed(kernel, shapes, mult=1):
        sel = [r for r in rows if r["kernel"] == kernel and r["shape"] in shapes]
        if len(sel) != len(shapes):
            raise AssertionError(f"{kernel}: rows {sorted(shapes)} missing")
        tot = {f: mult * sum(r[f] for r in sel) for f in ("ms", "plain_ms", "bound_ms")}
        tot["library_ms"] = (mult * sum(r["library_ms"] for r in sel)
                             if all("library_ms" in r for r in sel) else None)
        return tot, sel

    summaries = {
        "qmatmul": summed("qmatmul", {f"M={DECODE_M},K=2048,N=2048,w8", f"M={DECODE_M},K=2048,N=6144,w8,relu"}),
        "qmatmul_packed": summed("qmatmul_packed", {f"M={DECODE_M},K=2048,N=6144,w4", f"M={DECODE_M},K=6144,N=2048,w4"}),
        "qattention": summed("qattention", {"B=4,S=1,T=512,dh=128"}, mult=16),
        "qmoe": summed("qmoe", {f"T={QMOE_TOKENS[0]},D={QMOE_D},F={QMOE_F},E={QMOE_E},k={QMOE_K}"}),
        "kv_write": summed("kv_write", {"N={},R={},W={},{}".format(*KV_WRITE_SHAPES[0][1:], KV_WRITE_SHAPES[0][0])},
                           mult=2),
    }
    sources = {
        "qmatmul": ("src/repro_torch/kernels/csrc/qmatmul.cu", "src/repro/kernels/qmatmul.py:217"),
        "qmatmul_packed": ("src/repro_torch/kernels/csrc/qmatmul.cu", "src/repro/kernels/qmatmul.py:170"),
        "qattention": ("src/repro_torch/kernels/csrc/qattention.cu", "src/repro/kernels/qattention.py:105"),
        "qmoe": ("src/repro_torch/kernels/csrc/qmoe.cu", None),  # new in the port: no TPU original
        "kv_write": ("src/repro_torch/kernels/csrc/kv_write.cu", None),  # new in the port: no TPU original
    }
    kernels = []
    for name, (tot, sel) in summaries.items():
        if launches[name] <= 0:
            raise AssertionError(f"{name} was launched no time on the main paths")
        b_by = "bytes" if all(r["bound_by"] == "bytes" for r in sel) else "operations"
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0], "replaces": sources[name][1],
            "launches": launches[name], "max_abs_err": worst[name],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": b_by, "library_ms": tot["library_ms"],
        })
    kernels.append(lut_row(rows, worst, launches))
    log("[15/15] summary: launches are summed over the served runs of phases 4-14 (phase 7: "
        "the tuned and the warm-started token path's drives, no tuning candidate; phase 8: "
        "the fleet's rounds and failover wave and the resilient decode; phase 9: "
        "QuantizedLinear on backend cuda; phase 10's training runs, phase 11's mesh runs and phase 12's "
        "recurrent runs launch none; phase 13: the six examples' runs; phase 14: the Mellum2 "
        "token path's counted run); "
        "ms/plain_ms/bound_ms are per layer per decode step at (N,S)=(4,512) for the matmul "
        "kernels and qattention (16 head launches), per Mellum2 expert layer at the benchmark's "
        f"decode step ({QMOE_TOKENS[0]} tokens, five launches) for qmoe, per layer per decode step of "
        f"tokpath-decode for kv_write (K and V, two launches on a {KV_WRITE_SHAPES[0][1:]} cache each), "
        f"and per slice-A forward at batch "
        f"{MLP_MAX_BATCH} for qact_lut (its two LUT layers): its launches are the qmatmul "
        "launches that carried a table, its ms/plain_ms/bound_ms those of slice A's two "
        "matmuls with their tables, and its routes hold the time the tables add (with its "
        "spread over the turns) and the standalone kernel's time, bound and torch.take; "
        "library_ms is null: no single PyTorch call computes a fused function; each matmul row of "
        "chip_smoke.json carries gemm_library_ms, torch._int_mm's int32 GEMM body alone, "
        "where it takes the shape")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                   "n_layers": N_LAYERS, "rows": rows, "qmatmul_instances": instances,
                   "slice": perf, "slice_a": perf_a,
                   "slice_b": perf_b, "autotune": tuning, "fleet": fleet,
                   "checkpoint": checkpoint, "pooling": pooling, "zoo": zoo, "training": training,
                   "mesh": mesh, "recurrent": recurrent, "mellum2": mellum2,
                   "examples": dict(examples, wall_s=examples_s),
                   "launches": {"token_path": launches_tok, "slice_a": launches_a,
                                "slice_b": launches_b, "autotune": launches_tune,
                                "fleet_and_checkpoints": launches_8, "zoo": launches_zoo,
                                "training": launches_train, "mesh": launches_mesh,
                                "recurrent": launches_rec, "examples": launches_ex,
                                "mellum2": launches_mel},
                   "kernels": kernels}, f, indent=1, default=str)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--load-artifact"]:
        sys.exit(artifact_child(*sys.argv[2:5]))
    sys.exit(main())
