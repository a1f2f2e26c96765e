#!/usr/bin/env python3
"""Time an earlier qattention CUDA source against the port's current kernel,
in one process on one card, at the attention shapes of the main path.

    python3 scripts/qattention_ab.py --old path/to/old_qattention.cu

The old source must export the C entry point of the first port kernel,
``repro_qattention(q, k, v, mask, lut, out, B, S, T, dh, qk_scale, big,
lut_scale, p_scale, rescale, out_uint8, stream)``, on contiguous operands.
It is built with ``nvcc`` into ``build/qattention_ab/``; nothing of it is
kept in the repository.  At each shape of ``chip_smoke.ATTN_SHAPES`` (B = 4,
dh = 128; they hold the token path's decode row S = 1, T = 512 and its
prefill S = T = 128) both kernels are first held bit-exact against the
plain PyTorch version on contiguous operands, then timed in turns — old,
new, new, old — with ``chip_smoke.time_ms`` (median of 25 launches, L2
flushed before each).  Then, at the token path's decode and prefill shapes,
the step as the main path runs it: per-head q/k/v views of a head h != 0 of
a (B, ·, 3·2048) buffer — the old kernel after the three ``.contiguous()``
copies it needs, the new one on the views — held exact and timed the same
way.  Prints one line per row and writes every number to
``qattention_ab.json`` beside ``chip_smoke.py``'s output; exits non-zero if
either kernel disagrees with the plain version.  Needs one CUDA card and
``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

OLD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float] * 5 + [
    ctypes.c_int, ctypes.c_void_p,
]
#: (path, S, T) of the token path whose step is also timed on per-head views
MAIN_PATH = (("decode", 1, 512), ("prefill", 128, 128))
D_MODEL, HEAD = 2048, 5


def build_old(src: str) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    target = os.path.join(ROOT, "build", "qattention_ab", f"old-{digest}.so")
    os.makedirs(os.path.dirname(target), exist_ok=True)
    if not os.path.exists(target):
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", target, src], check=True)
    return ctypes.CDLL(target)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, help="the earlier qattention.cu to build and time")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import qattention as qatt

    if not torch.cuda.is_available():
        print("qattention_ab: no CUDA device is available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = cs.card_line()
    _build.build(["qattention"])
    old_fn = build_old(args.old).repro_qattention
    old_fn.argtypes, old_fn.restype = OLD_ARGTYPES, ctypes.c_int
    lut, scal = cs.attention_constants(device)

    def old(q, k, v, mask):
        b, s, dh = q.shape
        out = torch.empty((b, s, dh), dtype=torch.int8, device=device)
        rc = old_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), lut.data_ptr(),
                    out.data_ptr(), b, s, k.shape[1], dh,
                    *(scal[n] for n in ("qk_scale", "big", "lut_scale", "p_scale", "rescale")),
                    0, torch.cuda.current_stream(device).cuda_stream)
        _build.check(rc, "old qattention")
        return out

    def new(q, k, v, mask):
        return qatt.qattention(q, k, v, mask, lut, **scal)

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    rows, bad = [], []

    def measure(tag, path, ops, old_ops, b_ms, b_by, extra):
        want = qatt.qattention_plain(*ops, lut, **scal)
        errs = {"old": cs._max_err(old(*old_ops()), want), "new": cs._max_err(new(*ops), want)}
        if any(errs.values()):
            bad.append((tag, errs))
            print(f"  {tag}: MISMATCH {errs}", flush=True)
            return
        turns = []
        for who in ("old", "new", "new", "old"):
            fn = (lambda: old(*old_ops())) if who == "old" else (lambda: new(*ops))
            turns.append(cs.time_ms(fn, flush))
        old_ms, new_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        b, s, dh = ops[0].shape
        t = ops[1].shape[1]
        c = qatt.choose_cluster(b * s, t, dh)
        thr = qatt.threads_for(b * s, t, c)
        rows.append(dict(path=path, shape=tag, turns_ms=turns, old_ms=old_ms, new_ms=new_ms,
                         speedup=old_ms / new_ms, bound_ms=b_ms, bound_by=b_by, cluster=c,
                         threads=thr, **extra))
        print(f"  {tag:44s} old {turns[0]:.4f}/{turns[3]:.4f}  new {turns[1]:.4f}/{turns[2]:.4f} ms"
              f"  x{old_ms / new_ms:6.2f}  bound {b_ms:.4f} ({b_by})  cluster={c} threads={thr}",
              flush=True)

    import numpy as np

    rng = np.random.default_rng(0)
    print(f"qattention A/B: old {os.path.relpath(args.old, ROOT)} vs new csrc/qattention.cu ({card})")
    b, dh = 4, 128
    for s, t in cs.ATTN_SHAPES:
        q, k, v, mask = cs.attention_operands(rng, b, s, t, dh, device)
        b_ms, b_by = cs.attention_bound(b, s, t, dh)
        path = {(1, 512): "decode", (128, 128): "prefill"}.get((s, t), "shape")
        measure(f"B={b} S={s} T={t} dh={dh}", path, (q, k, v, mask), lambda: (q, k, v, mask),
                b_ms, b_by, {"views": False})
    for path, s, t in MAIN_PATH:
        q, k, v, mask = cs.attention_head_views(rng, b, s, t, dh, D_MODEL, HEAD, device)

        def copies(q=q, k=k, v=v, mask=mask):
            return tuple(x.contiguous() for x in (q, k, v, mask))

        b_ms, b_by = cs.attention_bound(b, s, t, dh)
        measure(f"{path} views B={b} S={s} T={t} h={HEAD} (old: +copies)", path, (q, k, v, mask),
                copies, b_ms, b_by, {"views": True})
    summary = {}
    for path in ("decode", "prefill"):
        for views in (False, True):
            sel = [r for r in rows if r["path"] == path and r["views"] == views]
            if sel:
                o, nw = sel[0]["old_ms"], sel[0]["new_ms"]
                key = f"{path}{'_views' if views else ''}"
                summary[key] = dict(old_ms=o, new_ms=nw, speedup=o / nw,
                                    old_16_heads_ms=16 * o, new_16_heads_ms=16 * nw)
    slower = [r["shape"] for r in rows if r["new_ms"] > 1.05 * r["old_ms"]]
    print(f"  summary: {json.dumps(summary)}")
    print(f"  shapes where the new kernel is slower by more than 5%: {slower or 'none'}")
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "qattention_ab.json"), "w") as f:
        json.dump({"card": card, "old": os.path.relpath(args.old, ROOT), "rows": rows,
                   "summary": summary, "slower_by_5pct": slower, "mismatches": bad}, f, indent=1)
    print(card)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
