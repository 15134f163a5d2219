"""ctypes binding to the native C++ slice reader (``native/fastloader.cc``),
the ABI of ``founddiff_tpu/data/native.py``.

The library is built at first use: ``g++ -O3 -fPIC -std=c++17 -pthread
-shared`` (``CXX`` names another compiler) into ``founddiff_tpu_torch/_build/``,
a directory git ignores, named after a hash of the source and flags, as
``ops/_build.py`` builds the CUDA kernels.  Decoding is host work, so when no
compiler or source is there :func:`read_npy` falls back to ``np.load``;
:func:`reader` says which one runs, and :data:`decodes` counts the files the
native reader decoded (a caller sets it to 0 and reads it after a pass).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Optional, Sequence

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "fastloader.cc")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-pthread", "-shared"]

_lib = None
_tried = False

# files decoded by the native reader (read_npy and PrefetchPool.wait); a file
# that read_npy hands to np.load is not counted
decodes = 0
_decodes_lock = threading.Lock()


def _count_decode() -> None:
    global decodes
    with _decodes_lock:
        decodes += 1


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libfastloader_{h.hexdigest()[:16]}.so")


def build() -> Optional[str]:
    """The library's path, compiled now if it is not there yet; None when
    the source or a C++ compiler is missing or the compile fails."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if not os.path.exists(SOURCE):
        return None
    out = _lib_path()
    if os.path.exists(out):
        return out
    if cxx is None:
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True)
    if proc.returncode != 0:
        return None
    os.replace(tmp, out)
    return out


def _load_lib():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    path = build()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.fl_read_npy.restype = ctypes.c_int
    lib.fl_read_npy.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
    lib.fl_pool_create.restype = ctypes.c_void_p
    lib.fl_pool_create.argtypes = [ctypes.c_int]
    lib.fl_pool_destroy.argtypes = [ctypes.c_void_p]
    lib.fl_pool_submit.restype = ctypes.c_int
    lib.fl_pool_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.fl_pool_wait.restype = ctypes.c_int
    lib.fl_pool_wait.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
                                 ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
    _lib = lib
    return lib


def available() -> bool:
    return _load_lib() is not None


def reader() -> str:
    """``"native"`` when :func:`read_npy` decodes with the C++ reader, else
    ``"numpy"``."""
    return "native" if available() else "numpy"


_MAX_ELEMS = 8 * 1024 * 1024  # 8M floats = 32MB per slice cap


def _out(buf: np.ndarray, shape, ndim: int) -> np.ndarray:
    dims = tuple(int(shape[i]) for i in range(ndim))
    n = int(np.prod(dims)) if dims else 1
    return buf[:n].reshape(dims).copy()


def read_npy(path: str) -> np.ndarray:
    """Decode an .npy file to float32 via the native reader (numpy fallback)."""
    lib = _load_lib()
    if lib is None:
        return np.load(path).astype(np.float32)
    buf = np.empty(_MAX_ELEMS, np.float32)
    shape = (ctypes.c_int64 * 4)()
    ndim = lib.fl_read_npy(path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                           _MAX_ELEMS, shape)
    if ndim < 0:
        return np.load(path).astype(np.float32)
    _count_decode()
    return _out(buf, shape, ndim)


class PrefetchPool:
    """Async decode pool over the native thread pool."""

    def __init__(self, num_threads: int = 4):
        self._lib = _load_lib()
        if self._lib is None:
            raise RuntimeError(f"native fastloader could not be built from {SOURCE}")
        self._pool = self._lib.fl_pool_create(num_threads)

    def submit(self, path: str) -> int:
        return self._lib.fl_pool_submit(self._pool, path.encode())

    def wait(self, ticket: int) -> np.ndarray:
        buf = np.empty(_MAX_ELEMS, np.float32)
        shape = (ctypes.c_int64 * 4)()
        ndim = self._lib.fl_pool_wait(self._pool, ticket,
                                      buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                      _MAX_ELEMS, shape)
        if ndim < 0:
            raise IOError(f"native decode failed (ticket {ticket})")
        _count_decode()
        return _out(buf, shape, ndim)

    def load_many(self, paths: Sequence[str]) -> List[np.ndarray]:
        tickets = [self.submit(p) for p in paths]
        return [self.wait(t) for t in tickets]

    def close(self):
        if self._pool is not None:
            self._lib.fl_pool_destroy(self._pool)
            self._pool = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
