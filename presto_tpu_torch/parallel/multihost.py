"""Multi-process worlds: one process per rank, one process group.

Torch port of ``presto_tpu/parallel/multihost.py``.  The reference's
multi-node deployment plane (the coordinator/worker HTTP task protocol,
discovery, the cross-node exchange: ``server/remotetask/HttpRemoteTask.java``,
``metadata/DiscoveryNodeManager.java``, ``operator/ExchangeClient.java``)
collapses into SPMD over ``torch.distributed``: every rank plans the same
statement deterministically and runs it on its shard, the exchanges are
collectives (``parallel/distributed.py``), and "discovery" is
``init_process_group`` meeting at a TCP (or file) store.

``init_multihost`` joins this process to a world.  ``launch_world`` runs a
job list on a world of rank processes (``python -m
presto_tpu_torch.parallel.worker``), returns rank 0's results and guards
the world against hanging: its process group has a timeout, the launcher
waits with a deadline, and when a rank fails or the deadline passes every
rank is killed and the error carries each rank's last output.
"""

from __future__ import annotations

import datetime
import json
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WORKER = "presto_tpu_torch.parallel.worker"
TAIL_BYTES = 4000  # of each rank's output kept in a WorldFailed message


def init_multihost(rank: int, world: int,
                   coordinator: str = "tcp://localhost:29500",
                   backend: Optional[str] = None, timeout_s: float = 600.0,
                   device=None) -> None:
    """Join this process to a world of ``world`` ranks as ``rank``:
    ``init_process_group`` at ``coordinator`` (``tcp://host:port``, or
    ``file://path``) with the caller's ``timeout_s`` on every collective,
    so that a rank left waiting by a failed peer raises instead of
    hanging.  The backend follows this rank's device (``device``, else
    ``cuda:LOCAL_RANK``): NCCL for a card, whose device is set first,
    and gloo for ``"cpu"``."""
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', rank))}"
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=coordinator, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class WorldFailed(RuntimeError):
    """A rank of a world exited non-zero, the world outlived its
    deadline, or its watch stopped it; the message holds each rank's
    last output, and ``rank`` is the rank that exited first (None when
    no rank exited)."""

    def __init__(self, message: str, rank: Optional[int] = None):
        super().__init__(message)
        self.rank = rank


def _tail(path: str) -> str:
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        f.seek(max(f.tell() - TAIL_BYTES, 0))
        return f.read().decode("utf-8", "replace")


def launch_world(world: int, spec: dict, deadline_s: float, device=None,
                 timeout_s: Optional[float] = None,
                 watch: Optional[Callable[[], Optional[str]]] = None) -> dict:
    """Run the worker's job list ``spec`` (see ``parallel/worker.py``) on
    ``world`` rank processes meeting at a fresh localhost port, each on
    ``device`` (``"cpu"``, or by default its card ``cuda:LOCAL_RANK``),
    and return rank 0's results; with ``spec["tables"]`` they also hold
    ``"tables"``, rank 0's host ``Table`` (or the error it caught) of
    each statement job by name.  The process group's timeout is
    ``timeout_s`` (a little under the deadline by default).  When any
    rank exits non-zero, ``deadline_s`` passes, or ``watch`` (polled
    while the world runs) returns a reason, every rank still running is
    killed and ``WorldFailed`` raised with each rank's last output.  A
    rank's exit is timed by a thread waiting on it, so the rank blamed
    is the one that exited first, not a peer that its exit broke."""
    timeout_s = timeout_s or max(deadline_s - 5.0, 1.0)
    coordinator = f"tcp://127.0.0.1:{free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    with tempfile.TemporaryDirectory() as tmp:
        spec_path = os.path.join(tmp, "spec.json")
        out_path = os.path.join(tmp, "out.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        args = ["--timeout", str(timeout_s), "--spec", spec_path,
                "--out", out_path]
        if device is not None:
            args += ["--device", str(device)]
        logs = [os.path.join(tmp, f"rank{r}.log") for r in range(world)]
        procs = []
        try:
            for r in range(world):
                with open(logs[r], "wb") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", WORKER, "--rank", str(r),
                         "--world", str(world), "--coordinator", coordinator,
                         *args], cwd=REPO, env=dict(env, LOCAL_RANK=str(r)),
                        stdout=log, stderr=subprocess.STDOUT))
            exits: list = []  # ranks in the order they exited
            for r, p in enumerate(procs):
                threading.Thread(target=lambda r=r, p=p: (
                    p.wait(), exits.append(r)), daemon=True).start()
            end = time.monotonic() + deadline_s
            failed, first = None, None
            while True:
                done = list(exits)
                bad = [r for r in done if procs[r].returncode != 0]
                if bad:
                    first = bad[0]
                    failed = (f"rank {first} exited with "
                              f"{procs[first].returncode}")
                    break
                if len(done) == world:
                    break
                if time.monotonic() > end:
                    failed = f"the world outlived its {deadline_s:g} s deadline"
                    break
                reason = watch() if watch else None
                if reason:
                    failed = f"the world was stopped: {reason}"
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        if not failed:
            with open(out_path) as f:
                data = json.load(f)
            if spec.get("tables"):
                with open(out_path + ".tables", "rb") as f:
                    data["tables"] = pickle.load(f)  # our own rank wrote it
            return data
        outs = [_tail(path) for path in logs]
    lead = first or 0
    order = [lead] + [r for r in range(world) if r != lead]
    raise WorldFailed(failed + "".join(  # the rank that failed first leads
        f"\n--- rank {r} ---\n{outs[r]}" for r in order), first)
