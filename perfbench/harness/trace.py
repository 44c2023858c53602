"""What a ``--trace 1`` run reads from ``torch.profiler``, one stream at a
time, each in its own profiler session (the profiler has been seen to
drop device activities late in a long session; the count of device
activities of every stream is printed, so a drop shows).

The profiler arithmetic follows ``tools/torch_query_profile.py``: device
activities are every CUDA kernel, memset and memcpy the profiler recorded.
Per stream it keeps each kernel's device time by name, the union of the
device intervals (busy time), the idle gaps between them, labelled by the
innermost host operation open at the gap's middle and the statement's
span (``stmt:qN``), and the kernel launches the program's wrappers
report.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

# the longest gaps of a stream that get a label
_LABELLED_GAPS = 400


@dataclass
class StreamTrace:
    wall_s: float = 0.0
    device_ops: int = 0
    busy_s: float = 0.0
    kernel_device_s: Dict[str, float] = field(default_factory=dict)
    gaps_s: Dict[str, float] = field(default_factory=dict)
    launches: Dict[str, list] = field(default_factory=dict)


def _union_s(starts: np.ndarray, ends: np.ndarray):
    """(busy seconds, gap starts, gap ends) of intervals in microseconds."""
    if starts.size == 0:
        return 0.0, np.zeros(0), np.zeros(0)
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.r_[True, s[1:] > run_end[:-1]]
    first = np.flatnonzero(new)
    m_start = s[first]
    m_end = np.r_[run_end[first[1:] - 1], run_end[-1]]
    busy = float((m_end - m_start).sum()) / 1e6
    return busy, m_end[:-1], m_start[1:]


def summarize(prof, wall_s: float, launches: Dict[str, list]) -> StreamTrace:
    """One stream's profile, read from the profiler's raw events (building
    its ``FunctionEvent`` tree takes tens of seconds a stream)."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    name = [e.name() for e in events]
    cuda = np.array([e.device_type() == DeviceType.CUDA for e in events],
                    dtype=bool)
    # a host span's device-side range (a user annotation) is no activity
    note = np.array([bool(getattr(e, "is_user_annotation", lambda: False)())
                     or n.startswith("stmt:") for e, n in zip(events, name)],
                    dtype=bool)
    start = np.array([e.start_ns() for e in events], dtype=np.float64) / 1e3
    end = start + np.array([e.duration_ns() for e in events],
                           dtype=np.float64) / 1e3
    dev = np.flatnonzero(cuda & ~note)
    cpu = np.flatnonzero(~cuda)
    st = StreamTrace(wall_s=wall_s, device_ops=int(dev.size),
                     launches={k: list(v) for k, v in launches.items()})
    if not dev.size:
        return st
    kernels: Dict[str, float] = defaultdict(float)
    for i in dev:
        kernels[name[i]] += (end[i] - start[i]) / 1e6
    st.kernel_device_s = dict(kernels)
    st.busy_s, g_start, g_end = _union_s(start[dev], end[dev])
    if g_start.size and cpu.size:
        c_start, c_end = start[cpu], end[cpu]
        spans = np.array([name[i].startswith("stmt:") for i in cpu])
        longest = np.argsort(g_start - g_end)[:_LABELLED_GAPS]
        gaps: Dict[str, float] = defaultdict(float)
        for g in longest:
            mid = (g_start[g] + g_end[g]) / 2
            cover = np.flatnonzero((c_start <= mid) & (c_end >= mid))
            stmt = next((name[cpu[i]][5:] for i in cover if spans[i]), "-")
            ops = [i for i in cover if not spans[i]]
            op = name[cpu[min(ops, key=lambda i: c_end[i] - c_start[i])]] \
                if ops else "python"
            gaps[f"{stmt} {op}"] += (g_end[g] - g_start[g]) / 1e6
        st.gaps_s = dict(gaps)
    return st


class Recorder:
    """The inputs of every ``sorted_probe`` launch the program's wrapper
    reports (``cuda_kernels.set_probe_recorder``), as shapes: no tensor
    is kept but a one-element count on the device, read after the
    stream."""

    def __init__(self):
        self.launches: Dict[str, list] = defaultdict(list)

    def probe(self, sorted_keys, probe_keys, n_valid):
        self.launches["sorted_probe"].append(
            {"cap": int(sorted_keys.shape[0]), "p": int(probe_keys.shape[0]),
             "n_valid": n_valid})

    def take(self) -> Dict[str, list]:
        out = {}
        for k, v in self.launches.items():
            for launch in v:
                nv = launch.get("n_valid")
                if nv is not None and not isinstance(nv, int):
                    launch["n_valid"] = int(nv.reshape(-1)[0])
            out[k] = v
        self.launches = defaultdict(list)
        return out


def profile_stream(run_stream, recorder: Recorder):
    """Run one stream (``run_stream()``) under its own profiler session;
    returns what ``summarize`` reads, once the window has closed."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_stream()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall, recorder.take()


def breakdown(streams: List[StreamTrace]) -> dict:
    """The device operations that took most time and the longest idle
    gaps by what the host was doing, over the traced streams."""
    ops: Dict[str, float] = defaultdict(float)
    gaps: Dict[str, float] = defaultdict(float)
    for st in streams:
        for k, v in st.kernel_device_s.items():
            ops[k[:160]] += v
        for k, v in st.gaps_s.items():
            gaps[k[:160]] += v
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}
