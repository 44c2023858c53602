"""Hand-written CUDA kernels for Hopper (counterpart of
``presto_tpu/ops/pallas_kernels.py``).

- ``masked_sum``:   Σ int64 values where mask, exact mod 2^64
                    (``csrc/masked_sum.cu``; replaces the Pallas
                    ``masked_sum``), behind ``agg.g_sum``.
- ``sorted_probe``: lower bound of each int64 probe in a sorted int64 key
                    column over [0, n_valid) (``csrc/sorted_probe.cu``;
                    replaces the Pallas ``sorted_probe``), behind
                    ``hashtable.lookup`` for single-key tables.

Each wrapper takes its plain PyTorch version only for a tensor that lies
on the CPU (the tests); for a CUDA tensor it launches its kernel or
raises.  There is no switch that routes a CUDA tensor elsewhere.

The sources are compiled at first use with ``nvcc`` for ``sm_90a`` into
shared libraries with a plain C interface (one ``nvcc`` per source, all
started together), cached under ``build/kernels/`` at the repository root
by a hash of the source and the flags, and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)),
                          "build", "kernels")

SOURCES = {"masked_sum": "masked_sum.cu", "sorted_probe": "sorted_probe.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")

# launches of each kernel since the last reset_launches() — the proof that
# a run went through the kernels and not their plain versions
LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> str:
    with open(os.path.join(_CSRC, SOURCES[name]), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(_BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build() -> Dict[str, ctypes.CDLL]:
    """Compile (when the sources changed) and load every kernel library."""
    with _lock:
        if _libs:
            return _libs
        os.makedirs(_BUILD_DIR, exist_ok=True)
        procs = {}
        for name in SOURCES:
            so = _lib_path(name)
            if os.path.exists(so):
                continue
            tmp = f"{so}.tmp{os.getpid()}"
            procs[name] = (so, tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                 os.path.join(_CSRC, SOURCES[name])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        failed = []
        for name, (so, tmp, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{SOURCES[name]}:\n{out.decode(errors='replace')}")
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        libs = {name: ctypes.CDLL(_lib_path(name)) for name in SOURCES}
        vp, i64 = ctypes.c_void_p, ctypes.c_longlong
        libs["masked_sum"].masked_sum_launch.argtypes = [vp, vp, i64, vp, vp]
        libs["masked_sum"].masked_sum_launch.restype = ctypes.c_int
        libs["sorted_probe"].sorted_probe_launch.argtypes = [
            vp, i64, vp, vp, i64, vp, vp]
        libs["sorted_probe"].sorted_probe_launch.restype = ctypes.c_int
        _libs.update(libs)
        return _libs


def _on_card(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises otherwise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"tensors on {sorted(str(t.device) for t in tensors)}"
                         ": expected all on one CUDA device, or all on the CPU")
    return True


def _check(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous 1-D {dtype} tensor, "
                         f"got {t.dtype} {tuple(t.shape)} "
                         f"contiguous={t.is_contiguous()}")


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc}")


# ---------------------------------------------------------------- masked sum

def masked_sum_plain(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``masked_sum`` (int64 sum, wraps mod 2^64)."""
    return torch.where(mask, values, 0).sum()


def masked_sum(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Σ ``values`` where ``mask`` as a 0-d int64 tensor, exact mod 2^64."""
    _check(values, "values", torch.int64)
    _check(mask, "mask", torch.bool)
    if mask.shape != values.shape:
        raise ValueError(f"mask {tuple(mask.shape)} vs values "
                         f"{tuple(values.shape)}")
    if not _on_card(values, mask):
        return masked_sum_plain(values, mask)
    out = torch.zeros((1,), dtype=torch.int64, device=values.device)
    n = values.shape[0]
    if n:
        lib = build()["masked_sum"]
        stream = torch.cuda.current_stream(values.device).cuda_stream
        _raise_on(lib.masked_sum_launch(values.data_ptr(), mask.data_ptr(), n,
                                        out.data_ptr(), stream), "masked_sum")
        LAUNCHES["masked_sum"] += 1
    return out[0]


# ------------------------------------------------------------- sorted probe

def _n_valid_tensor(n_valid, device) -> torch.Tensor:
    if isinstance(n_valid, torch.Tensor):
        if n_valid.numel() != 1:
            raise ValueError(f"n_valid: expected one element, got "
                             f"{tuple(n_valid.shape)}")
        return n_valid.reshape(1).to(device=device, dtype=torch.int64)
    return torch.tensor([int(n_valid)], dtype=torch.int64, device=device)


def sorted_probe_plain(sorted_keys: torch.Tensor, probe_keys: torch.Tensor,
                       n_valid) -> torch.Tensor:
    """Plain PyTorch version of ``sorted_probe``: a vectorised binary search
    of every probe at once (log2(n) rounds of gathers)."""
    n = sorted_keys.shape[0]
    p = probe_keys.shape[0]
    nv = _n_valid_tensor(n_valid, sorted_keys.device).clamp(0, n)
    lo = torch.zeros((p,), dtype=torch.int64, device=probe_keys.device)
    if n == 0:
        return lo.to(torch.int32)
    hi = nv.expand(p).clone()
    for _ in range(max(n.bit_length(), 1)):
        mid = (lo + hi) >> 1
        lt = sorted_keys[mid.clamp(max=n - 1)] < probe_keys
        go = lo < hi
        lo = torch.where(go & lt, mid + 1, lo)
        hi = torch.where(go & ~lt, mid, hi)
    return lo.to(torch.int32)


def sorted_probe(sorted_keys: torch.Tensor, probe_keys: torch.Tensor,
                 n_valid) -> torch.Tensor:
    """Lower-bound positions (int32 [P]) of ``probe_keys`` in
    ``sorted_keys[:n_valid]``; ``n_valid`` is an int or a one-element
    tensor (read on the device, so the caller does not wait for it)."""
    _check(sorted_keys, "sorted_keys", torch.int64)
    _check(probe_keys, "probe_keys", torch.int64)
    if not _on_card(sorted_keys, probe_keys):
        return sorted_probe_plain(sorted_keys, probe_keys, n_valid)
    nv = _n_valid_tensor(n_valid, sorted_keys.device)
    p = probe_keys.shape[0]
    out = torch.empty((p,), dtype=torch.int32, device=probe_keys.device)
    if p:
        lib = build()["sorted_probe"]
        stream = torch.cuda.current_stream(probe_keys.device).cuda_stream
        _raise_on(lib.sorted_probe_launch(
            sorted_keys.data_ptr(), sorted_keys.shape[0], nv.data_ptr(),
            probe_keys.data_ptr(), p, out.data_ptr(), stream), "sorted_probe")
        LAUNCHES["sorted_probe"] += 1
    return out
