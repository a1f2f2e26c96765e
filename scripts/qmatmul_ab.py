#!/usr/bin/env python3
"""Time an earlier qmatmul CUDA source against the port's current kernel, in
one process on one card, at every main-path shape.

    python3 scripts/qmatmul_ab.py --old path/to/old_qmatmul.cu

The old source must export the C entry point of the first port kernel,
``repro_qmatmul(x, w, bias, qs, qsh, out, M, K, N, Kp, Np, bm, packed,
relu, two_mul, out_uint8, stream)``, on the same template operands (the
``(Np, Kp)`` K-contiguous weight, or its ``(Np, Kp/2)`` nibble pairs).  It
is built with ``nvcc`` into ``build/qmatmul_ab/``; nothing of it is kept in
the repository.  At each shape both kernels are first held bit-exact
against the plain PyTorch version, then timed in turns — old, new, new, old
— with ``chip_smoke.time_ms`` (median of 25 launches, L2 flushed before
each).  Prints one line per shape and writes every number to
``qmatmul_ab.json`` beside ``chip_smoke.py``'s output; exits non-zero if
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

OLD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


def main_path_shapes(cs):
    """(path, M, K, N, bits, relu): the token path's four projections at
    decode (4 slots) and prefill (4 × 128 rows), then slices A and B."""
    out = []
    for m, path in ((cs.DECODE_M, "decode"), (512, "prefill")):
        out += [(path, m, k, n, bits, relu) for k, n, bits, relu in cs.MATMUL_SHAPES]
    out += [(tag, m, k, n, 8, relu) for tag, m, k, n, relu in cs.served_gemms()]
    return out


def build_old(src: str) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    target = os.path.join(ROOT, "build", "qmatmul_ab", f"old-{digest}.so")
    os.makedirs(os.path.dirname(target), exist_ok=True)
    if not os.path.exists(target):
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", target, src], check=True)
    return ctypes.CDLL(target)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, help="the earlier qmatmul.cu to build and time")
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import qmatmul as qmm

    if not torch.cuda.is_available():
        print("qmatmul_ab: no CUDA device is available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = cs.card_line()
    _build.build(["qmatmul"])
    old_fn = build_old(args.old).repro_qmatmul
    old_fn.argtypes, old_fn.restype = OLD_ARGTYPES, ctypes.c_int

    def old(x, w, b, qs, qsh, *, n, relu, bm, packed):
        m, k = x.shape
        kp = w.shape[1] * (2 if packed else 1)
        out = torch.empty((m, n), dtype=torch.int8, device=device)
        rc = old_fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), qs.data_ptr(), qsh.data_ptr(),
                    out.data_ptr(), m, k, n, kp, w.shape[0], bm, int(packed), int(relu), 1, 0,
                    torch.cuda.current_stream(device).cuda_stream)
        _build.check(rc, "old qmatmul")
        return out

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    rng = np.random.default_rng(0)
    rows, bad = [], []
    print(f"qmatmul A/B: old {os.path.relpath(args.old, ROOT)} vs new csrc/qmatmul.cu ({card})")
    for path, m, k, n, bits, relu in main_path_shapes(cs):
        consts, shape = cs._matmul_operands(rng, k, n, bits, device)
        bound = ops.bind_qmatmul_axes({**shape, "lead": (m,)}, None)
        packed = bits == 4
        kern = qmm.qmatmul_packed if packed else qmm.qmatmul
        plain = qmm.qmatmul_packed_plain if packed else qmm.qmatmul_plain
        x = torch.from_numpy(cs._int8(rng, (m, k))).to(device)
        kw = dict(n=n, relu=relu, two_mul=True, bm=bound["bm"])
        new_kw = dict(kw, splits=bound["splits"])
        old_kw = dict(n=n, relu=relu, bm=bound["bm"], packed=packed)
        want = plain(x, *consts, **kw)
        errs = {"old": cs._max_err(old(x, *consts, **old_kw), want),
                "new": cs._max_err(kern(x, *consts, **new_kw), want)}
        tag = f"{path} M={m} K={k} N={n} w{bits}"
        if any(errs.values()):
            bad.append((tag, errs))
            print(f"  {tag}: MISMATCH {errs}", flush=True)
            continue
        turns = []
        for who in ("old", "new", "new", "old"):
            fn = (lambda: old(x, *consts, **old_kw)) if who == "old" else (lambda: kern(x, *consts, **new_kw))
            turns.append(cs.time_ms(fn, flush))
        old_ms, new_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        b_ms, b_by = cs.bound_ms(m * k + (k * n // 2 if packed else k * n) + 12 * n + m * n,
                                 2.0 * m * n * k)
        rt = qmm.route(x, bound["bm"], bound["splits"])
        rows.append(dict(path=path, m=m, k=k, n=n, bits=bits, relu=relu, turns_ms=turns,
                         old_ms=old_ms, new_ms=new_ms, speedup=old_ms / new_ms, bound_ms=b_ms,
                         bound_by=b_by, route=rt))
        print(f"  {tag:38s} old {turns[0]:.4f}/{turns[3]:.4f}  new {turns[1]:.4f}/{turns[2]:.4f} ms"
              f"  x{old_ms / new_ms:6.2f}  bound {b_ms:.4f} ({b_by})  splits={rt['splits']} "
              f"bm={rt['bm']} {rt['staging']}", flush=True)
    summary = {}
    for path in ("decode", "prefill", "sliceA", "conv", "fc"):
        sel = [r for r in rows if r["path"] == path]
        if sel:
            o, nw = sum(r["old_ms"] for r in sel), sum(r["new_ms"] for r in sel)
            summary[path] = dict(old_ms=o, new_ms=nw, speedup=o / nw, shapes=len(sel))
            print(f"  sum over {path:8s} ({len(sel)} shapes): old {o:.4f} ms, new {nw:.4f} ms, x{o / nw:.2f}")
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "qmatmul_ab.json"), "w") as f:
        json.dump({"card": card, "old": os.path.relpath(args.old, ROOT), "rows": rows,
                   "summary": summary, "mismatches": bad}, f, indent=1)
    print(card)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
