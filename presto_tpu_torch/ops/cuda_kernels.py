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
by a hash of the source and the flags, and loaded with ``ctypes``.  Each
launch function is looked up once; after the first build a wrapper takes
no lock.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Tuple

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)),
                          "build", "kernels")

SOURCES = {"masked_sum": "masked_sum.cu", "sorted_probe": "sorted_probe.cu",
           "seg_reduce": "seg_reduce.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# launches of each kernel since the last reset_launches() — the proof that
# a run went through the kernels and not their plain versions
LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}
# of the seg_reduce launches, those that took the privatised branch
SEG_PRIVATISED = 0
# while set (set_probe_recorder, set_sum_recorder), called with the inputs
# of every sorted_probe (sorted_keys, probe_keys, n_valid) or masked_sum
# (values, mask) launch: how a caller captures the inputs the main path
# gives a kernel, whoever imported the wrapper and how
_probe_recorder = None
_sum_recorder = None
# nvcc's output (with -Xptxas -v: registers, shared memory, spills) of each
# source this process compiled
BUILD_LOG: Dict[str, str] = {}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_launch: Dict[str, ctypes._CFuncPtr] = {}  # the C launch functions
_sms: Dict[int, int] = {}                  # SM count by device index
# sorted_probe takes its arguments in one int64 array: ctypes then converts
# one pointer per call instead of eleven numbers; one array per thread
_ProbeArgs = ctypes.c_longlong * 11
_SegArgs = ctypes.c_longlong * 12
_tls = threading.local()


def reset_launches() -> None:
    global SEG_PRIVATISED
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    SEG_PRIVATISED = 0


def set_probe_recorder(fn) -> None:
    """Call ``fn(sorted_keys, probe_keys, n_valid)`` at every launch of
    ``sorted_probe`` from now on; ``None`` stops it."""
    global _probe_recorder
    _probe_recorder = fn


def set_sum_recorder(fn) -> None:
    """Call ``fn(values, mask)`` at every launch of ``masked_sum`` from
    now on; ``None`` stops it."""
    global _sum_recorder
    _sum_recorder = fn


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
            BUILD_LOG[name] = out.decode(errors="replace")
            if proc.returncode != 0:
                failed.append(f"{SOURCES[name]}:\n{BUILD_LOG[name]}")
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        libs = {name: ctypes.CDLL(_lib_path(name)) for name in SOURCES}
        vp, i64 = ctypes.c_void_p, ctypes.c_longlong
        fns = {"masked_sum": (libs["masked_sum"].masked_sum_launch,
                              [vp, vp, i64, vp, vp]),
               "sorted_probe": (libs["sorted_probe"].sorted_probe_launch,
                                [_ProbeArgs]),
               "seg_reduce": (libs["seg_reduce"].seg_reduce_launch,
                              [_SegArgs])}
        for name, (fn, argtypes) in fns.items():
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _launch[name] = fn
        _libs.update(libs)
        return _libs


def _launcher(name: str):
    """The C launch function of kernel ``name``, built on first use; no
    lock once it is loaded."""
    fn = _launch.get(name)
    if fn is None:
        build()
        fn = _launch[name]
    return fn


def _stream(index: int) -> int:
    # the current stream's raw handle: what torch.cuda.current_stream(index)
    # .cuda_stream gives, without making a Stream object on every launch
    return torch._C._cuda_getCurrentRawStream(index)


def _sm_count(index: int) -> int:
    sms = _sms.get(index)
    if sms is None:
        sms = _sms[index] = \
            torch.cuda.get_device_properties(index).multi_processor_count
    return sms


def _card_index(a: torch.Tensor, b: torch.Tensor) -> int:
    """The CUDA device index of two tensors on one card, -1 for two CPU
    tensors; raises otherwise."""
    index = a.get_device()  # -1 on the CPU
    if b.get_device() == index and (a.is_cuda if index >= 0 else
                                    a.device.type == b.device.type == "cpu"):
        return index
    raise ValueError(f"tensors on {a.device} and {b.device}: expected both "
                     "on one CUDA device, or both on the CPU")


def _check(a: torch.Tensor, a_dtype: torch.dtype, b: torch.Tensor,
           b_dtype: torch.dtype, names: Tuple[str, str]) -> None:
    """Both tensors 1-D, contiguous and of their types; raises otherwise."""
    if (a.dtype == a_dtype and b.dtype == b_dtype and a.dim() == 1
            and b.dim() == 1 and a.is_contiguous() and b.is_contiguous()):
        return
    for t, dtype, name in ((a, a_dtype, names[0]), (b, b_dtype, names[1])):
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous 1-D {dtype} "
                             f"tensor, got {t.dtype} {tuple(t.shape)} "
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
    _check(values, torch.int64, mask, torch.bool, ("values", "mask"))
    n = values.shape[0]
    if mask.shape[0] != n:
        raise ValueError(f"mask {tuple(mask.shape)} vs values "
                         f"{tuple(values.shape)}")
    index = _card_index(values, mask)
    if index < 0:
        return masked_sum_plain(values, mask)
    out = values.new_zeros((1,))
    if n:
        _raise_on(_launcher("masked_sum")(
            values.data_ptr(), mask.data_ptr(), n, out.data_ptr(),
            _stream(index)), "masked_sum")
        LAUNCHES["masked_sum"] += 1
        if _sum_recorder is not None:
            _sum_recorder(values, mask)
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


SAMPLE_LOG2 = (0, 8)  # the sample sizes the plan picks: 1 .. 256 keys


def sorted_probe_plan(p: int, sms: int) -> Tuple[int, int, int]:
    """Launch of ``sorted_probe`` for ``p`` probes on a card of ``sms`` SMs:
    (blocks, threads, sample_log2), one search a thread at a time.

    With at least two 1024-thread blocks' worth of probes for every SM, a
    persistent grid of one block of 1024 threads per SM; with fewer,
    128-thread blocks, so that every SM gets searches.  The sample is the
    power of two nearest below half the block's probes, at most 256 keys:
    each block stages its sample from L2, and past that size a sample cost
    more than it saved the interpolating search (PERF.md)."""
    if p >= 2 * sms * 1024:
        blocks, threads = sms, 1024
    else:
        threads = 128
        blocks = max(1, -(-p // threads))
    per_block = -(-p // blocks)
    sample_log2 = min(SAMPLE_LOG2[1], max(SAMPLE_LOG2[0],
                                          per_block.bit_length() - 2))
    return blocks, threads, sample_log2


@functools.lru_cache(maxsize=256)
def _plan(p: int, index: int) -> Tuple[int, int, int]:
    return sorted_probe_plan(p, _sm_count(index))


def _new_probe_args() -> ctypes.Array:
    _tls.probe_args = _ProbeArgs()
    return _tls.probe_args


def _n_valid_arg(n_valid, index: int):
    """``n_valid`` as the kernel takes it: (tensor to keep alive, device
    pointer or 0, value).  A one-element int64 tensor on the probes' card
    passes its pointer; another CUDA tensor is converted on the card (no
    wait); an int or a CPU tensor passes its value."""
    if not isinstance(n_valid, torch.Tensor):
        return None, 0, int(n_valid)
    if n_valid.numel() != 1:
        raise ValueError(f"n_valid: expected one element, got "
                         f"{tuple(n_valid.shape)}")
    where = n_valid.get_device()
    if where < 0:
        return None, 0, int(n_valid)
    if where != index or n_valid.dtype != torch.int64:
        n_valid = n_valid.reshape(1).to(device=torch.device("cuda", index),
                                        dtype=torch.int64)
    return n_valid, n_valid.data_ptr(), 0


def sorted_probe(sorted_keys: torch.Tensor, probe_keys: torch.Tensor,
                 n_valid) -> torch.Tensor:
    """Lower-bound positions (int32 [P]) of ``probe_keys`` in
    ``sorted_keys[:n_valid]``; ``n_valid`` is an int or a one-element
    tensor (a CUDA tensor is read on the device, so the caller does not
    wait for it)."""
    _check(sorted_keys, torch.int64, probe_keys, torch.int64,
           ("sorted_keys", "probe_keys"))
    index = _card_index(sorted_keys, probe_keys)
    if index < 0:
        return sorted_probe_plain(sorted_keys, probe_keys, n_valid)
    cap, p = sorted_keys.shape[0], probe_keys.shape[0]
    if cap >= 2**31:
        raise ValueError(f"sorted_keys: {cap} keys, int32 positions need "
                         "fewer than 2^31")
    nv, nv_ptr, nv_value = _n_valid_arg(n_valid, index)
    out = probe_keys.new_empty(p, dtype=torch.int32)
    if p:
        args = getattr(_tls, "probe_args", None) or _new_probe_args()
        args[:] = (sorted_keys.data_ptr(), cap, nv_ptr, nv_value,
                   probe_keys.data_ptr(), p, out.data_ptr(),
                   *_plan(p, index), _stream(index))
        _raise_on(_launcher("sorted_probe")(args), "sorted_probe")
        LAUNCHES["sorted_probe"] += 1
        if _probe_recorder is not None:
            _probe_recorder(sorted_keys, probe_keys, n_valid)
    return out


# --------------------------------------------------------------- seg reduce

SEG_OPS = {"add": 0, "min": 1, "max": 2}
SEG_THREADS = 256            # 8 warps a block
SEG_ROWS = 4                 # rows a lane takes a step (csrc/seg_reduce.cu)
SEG_BLOCKS_PER_SM = 8
SEG_SHARED_BYTES = 48 << 10  # the slots' copies of one block, one a warp
SEG_PRIVATE_SLOTS = SEG_SHARED_BYTES // (8 * (SEG_THREADS // 32))  # 768
_I64 = torch.iinfo(torch.int64)


def seg_identity(op: str) -> int:
    """What a slot no row reaches holds: 0 for add, the int64 extreme
    for min and max."""
    return {"add": 0, "min": _I64.max, "max": _I64.min}[op]


def seg_reduce_plain(values, slot: torch.Tensor, mask: torch.Tensor,
                     capacity: int, op: str = "add") -> torch.Tensor:
    """Plain PyTorch version of ``seg_reduce``: a colliding scatter into
    ``capacity`` slots plus one spare slot that takes the skipped rows,
    cut off after (``values`` None: a count)."""
    g = torch.where(mask & (slot >= 0) & (slot < capacity),
                    slot.to(torch.int64), capacity)
    out = torch.full((capacity + 1,), seg_identity(op), dtype=torch.int64,
                     device=slot.device)
    if values is None:
        values = torch.ones(slot.shape, dtype=torch.int64, device=slot.device)
    if op == "add":
        out.index_add_(0, g, values)
    else:
        out.scatter_reduce_(0, g, values, reduce="a" + op)
    return out[:capacity]


def seg_reduce_plan(n: int, capacity: int,
                    sms: int) -> Tuple[int, int, bool]:
    """Launch of ``seg_reduce`` for ``n`` rows into ``capacity`` slots on a
    card of ``sms`` SMs: (blocks, threads, privatised).

    A grid of at most SEG_BLOCKS_PER_SM blocks of 8 warps an SM, fewer
    where the rows do not fill it (a warp step is 32 x SEG_ROWS rows): at
    Q1's shapes 8 blocks an SM beat 4, 5 and 6 (tools/seg_reduce_sweep.py;
    a count's 32 registers keep all 8 resident, a sum's 48 five).
    Privatised when a copy of the slots for each warp fits the block's
    shared memory (at most SEG_PRIVATE_SLOTS slots) and the rows outnumber
    the slots of every block together (each block sends at most
    ``capacity`` atomics at its end); otherwise the global branch."""
    warps = SEG_THREADS // 32
    steps = -(-n // (32 * SEG_ROWS))
    blocks = max(1, min(sms * SEG_BLOCKS_PER_SM, -(-steps // warps)))
    privatised = capacity <= SEG_PRIVATE_SLOTS and blocks * capacity <= n
    return blocks, SEG_THREADS, privatised


@functools.lru_cache(maxsize=1024)
def _seg_plan(n: int, capacity: int, index: int) -> Tuple[int, int, bool]:
    return seg_reduce_plan(n, capacity, _sm_count(index))


def seg_reduce(values, slot: torch.Tensor, mask: torch.Tensor, capacity: int,
               op: str = "add") -> torch.Tensor:
    """Per-slot ``op`` (add, min, max) of int64 ``values`` over the rows
    where ``mask`` holds and ``slot`` (int32 or int64) lies in ``[0,
    capacity)``, as int64 [capacity]; ``values`` None counts the rows.  A
    slot no row reaches holds ``seg_identity(op)``.  Sums wrap mod 2^64."""
    global SEG_PRIVATISED
    if values is not None:
        _check(values, torch.int64, mask, torch.bool, ("values", "mask"))
        if values.shape != slot.shape:
            raise ValueError(f"values {tuple(values.shape)} vs slot "
                             f"{tuple(slot.shape)}")
    if op not in SEG_OPS or (values is None and op != "add"):
        raise ValueError(f"seg_reduce: op {op!r}"
                         + (" of no values" if values is None else ""))
    _check(slot, slot.dtype, mask, torch.bool, ("slot", "mask"))
    if slot.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"slot: expected int32 or int64, got {slot.dtype}")
    n = slot.shape[0]
    if mask.shape[0] != n:
        raise ValueError(f"mask {tuple(mask.shape)} vs slot {tuple(slot.shape)}")
    index = _card_index(slot, mask)
    if values is not None:
        _card_index(values, slot)
    if index < 0:
        return seg_reduce_plain(values, slot, mask, capacity, op)
    if capacity >= 2**31:
        raise ValueError(f"capacity {capacity}: the kernel takes fewer than "
                         "2^31 slots")
    out = torch.full((capacity,), seg_identity(op), dtype=torch.int64,
                     device=slot.device)
    if n and capacity:
        blocks, threads, privatised = _seg_plan(n, capacity, index)
        args = getattr(_tls, "seg_args", None)
        if args is None:
            args = _tls.seg_args = _SegArgs()
        args[:] = (0 if values is None else values.data_ptr(),
                   slot.data_ptr(), slot.element_size(), mask.data_ptr(), n,
                   capacity, SEG_OPS[op], out.data_ptr(), blocks, threads,
                   int(privatised), _stream(index))
        _raise_on(_launcher("seg_reduce")(args), "seg_reduce")
        LAUNCHES["seg_reduce"] += 1
        SEG_PRIVATISED += privatised
    return out
