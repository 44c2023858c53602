"""Native (C) host kernels: build-on-demand + ctypes bindings.

The TPC-H generator keeps its hot host loops native (the reference's
loader tier is C/Java-JIT).  The shared library builds once per checkout
with the system compiler into ``build/native/`` at the repository root (a
directory of this package's own, so it never loads another package's
library); every entry point falls back to the numpy implementation when
no compiler is available.  Both give bit-identical columns.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "lcgkernels.c")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)),
                          "build", "native")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> str | None:
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
    except OSError:
        return None
    so = os.path.join(_BUILD_DIR, "lcgkernels.so")
    try:
        if os.path.getmtime(so) >= os.path.getmtime(_SRC):
            return so
    except OSError:
        pass
    for cc in ("cc", "gcc", "clang"):
        tmp = so + f".tmp{os.getpid()}"
        try:
            subprocess.run([cc, "-O3", "-shared", "-fPIC", _SRC, "-o", tmp],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
            return so
        except (OSError, subprocess.SubprocessError):
            continue
    return None


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        i64 = ctypes.c_int64
        p64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        pu8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.lcg_values.argtypes = [i64, i64, i64, i64, i64, p64]
        lib.lcg_matrix.argtypes = [i64, i64, i64, i64, p64]
        lib.lcg_bounded.argtypes = [i64, i64, i64, i64, i64, i64, i64, p64]
        lib.gather_substrings.argtypes = [pu8, p64, p64, i64, i64, pu8]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def lcg_values(seed: int, uses: int, use_index: int, first_row: int,
               n: int):
    """Native dbgen stream draw #use_index for rows [first_row, +n)."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(n, np.int64)
    lib.lcg_values(seed, uses, use_index, first_row, n, out)
    return out


def lcg_matrix(seed: int, uses: int, first_row: int, n: int):
    """[n, uses] matrix of every draw of every row (one native pass)."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((n, uses), np.int64)
    lib.lcg_matrix(seed, uses, first_row, n, out.reshape(-1))
    return out


def lcg_bounded(seed: int, uses: int, use_index: int, first_row: int,
                n: int, low: int, high: int):
    lib = _load()
    if lib is None:
        return None
    out = np.empty(n, np.int64)
    lib.lcg_bounded(seed, uses, use_index, first_row, n, low, high, out)
    return out


def gather_substrings(pool: np.ndarray, offsets: np.ndarray,
                      lengths: np.ndarray, width: int):
    lib = _load()
    if lib is None:
        return None
    n = offsets.shape[0]
    out = np.empty((n, width), np.uint8)
    lib.gather_substrings(
        np.ascontiguousarray(pool),
        np.ascontiguousarray(offsets, np.int64),
        np.ascontiguousarray(lengths, np.int64), n, width, out)
    return out
