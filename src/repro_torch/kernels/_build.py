"""Build and load the port's hand-written CUDA kernels.

Each ``kernels/csrc/<stem>.cu`` compiles with ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface, which is
loaded with :mod:`ctypes` (pointers and the stream go as ``c_void_p``).  No
PyTorch header is included, so a build takes seconds, not minutes.

Libraries land in ``build/repro_torch/`` at the repository root, named by a
hash of the source, of every shared header ``csrc/*.cuh`` and of the flags:
a changed source or header builds anew at its first use, an unchanged one
loads what is there.  :func:`build` starts one
``nvcc`` per source, all at once, and waits for them together.  A failed
build raises with ``nvcc``'s output in the message; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
STEMS = ("qmatmul", "qattention", "qact_lut", "qmoe", "kv_write")

_LOCK = threading.Lock()
_FUNCS: Dict[tuple, object] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc`` as PyTorch locates the
    toolkit, else ``nvcc`` on ``PATH``."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")
    return found


def library_path(stem: str) -> Path:
    """Where ``csrc/<stem>.cu`` builds to: named by a hash of the source,
    the headers it may include (every ``csrc/*.cuh``) and the flags."""
    h = hashlib.sha256((CSRC / f"{stem}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def build(stems: Sequence[str] = STEMS) -> Dict[str, float]:
    """Compile every listed source whose library is missing, one ``nvcc``
    per source, all started together.  Returns the wall seconds each build
    took (0.0 for a library already built).  Raises on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds: Dict[str, float] = {}
    t0 = time.perf_counter()
    for stem in stems:
        target = library_path(stem)
        if target.exists():
            seconds[stem] = 0.0
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        procs[stem] = (cmd, tmp, target, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failures = []
    for stem, (cmd, tmp, target, proc) in procs.items():
        out, _ = proc.communicate()
        seconds[stem] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"$ {' '.join(cmd)}\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)  # atomic: a concurrent builder sees all or nothing
    if failures:
        raise RuntimeError("nvcc failed to build the CUDA kernels:\n" + "\n".join(failures))
    return seconds


def function(stem: str, symbol: str, argtypes: Sequence) -> object:
    """The C entry point ``symbol`` of ``csrc/<stem>.cu`` as a ctypes
    function returning ``int`` (a ``cudaError_t``), building the library at
    first use."""
    key = (stem, symbol)
    with _LOCK:
        fn = _FUNCS.get(key)
        if fn is None:
            build([stem])
            fn = getattr(ctypes.CDLL(str(library_path(stem))), symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _FUNCS[key] = fn
    return fn


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {rc}")
