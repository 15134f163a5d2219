"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by nvcc for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ctypes.  The build
runs at first use (or all at once through :func:`build_all`, one nvcc
process per source started together) into ``founddiff_tpu_torch/_build/``,
a directory git ignores.  A library is named after a hash of its sources and
flags, so an edited source is rebuilt and a stale library is never loaded.

Nothing here imports or builds at module import: the CPU tests import every
module on a host without CUDA or nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("ln_mod", "ss2d_block", "attn_block", "scan", "scan_image", "flash_attention",
           "groupnorm", "mamba_block")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
]

DTYPE_CODE = {"float32": 0, "bfloat16": 1}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc") or ""):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a host "
                       "with the CUDA toolkit")


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def _start(name: str):
    out = _lib_path(name)
    if os.path.exists(out):
        return out, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return out, (proc, tmp)


def _finish(name: str, out: str, job) -> str:
    """Wait for one nvcc job; returns its compiler log ('' when cached)."""
    if job is None:
        return ""
    proc, tmp = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> Dict[str, object]:
    """Compile every kernel source in parallel and load the libraries.
    Returns ``{"seconds": wall time, "logs": {name: ptxas log}}``."""
    t0 = time.perf_counter()
    jobs = {n: _start(n) for n in SOURCES}
    logs = {n: _finish(n, *jobs[n]) for n in SOURCES}
    for n in SOURCES:
        load(n)
    return {"seconds": time.perf_counter() - t0, "logs": logs}


def load(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        out, job = _start(name)
        _finish(name, out, job)
        lib = ctypes.CDLL(out)
        _LIBS[name] = lib
    return lib


def declare(lib: ctypes.CDLL, fn: str, n_ptrs: int, tail: List) -> ctypes._CFuncPtr:
    """Set the C signature ``int fn(void* x n_ptrs, *tail, void* stream)``."""
    f = getattr(lib, fn)
    f.argtypes = [ctypes.c_void_p] * n_ptrs + list(tail) + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream() -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def expect(device, **named) -> None:
    """Raise unless every named ``(tensor, shape)`` pair has that shape and
    lies on ``device``; a ``None`` tensor is skipped."""
    for name, (t, shape) in named.items():
        if t is None:
            continue
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {tuple(shape)}")
        if t.device != device:
            raise ValueError(f"{name} lies on {t.device}, want {device}")


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def dtype_code(t) -> int:
    name = str(t.dtype).replace("torch.", "")
    if name not in DTYPE_CODE:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODE[name]
