"""Cluster supervision: heartbeats, admission gating, restart-on-failure —
wired into real query execution over worlds of rank processes.

Torch port of ``presto_tpu/parallel/cluster.py``, the single-controller
analogue of the reference's coordinator services:

- ``failuredetector/HeartbeatFailureDetector.java:78`` — every worker runs
  a heartbeat thread; the detector's decayed-ratio/staleness logic decides
  liveness (`parallel/failure.py`)
- ``execution/ClusterSizeMonitor.java`` — queries are admitted only while
  >= min_workers are alive
- v359 recovery model (no intra-query task retry): a worker death during a
  query invalidates the in-flight attempt; the query is deterministically
  replayed on the surviving workers (scans are generator row-ranges, so
  replay is exact) — ``RestartOnFailure``

The JAX package runs each attempt in its own process over a mesh of
virtual devices.  Here an attempt is a world of rank processes
(``multihost.launch_world``, one rank per participant, rank i =
participant i, each on its own card ``cuda:LOCAL_RANK`` or, with
``device="cpu"``, a gloo rank), and rank 0 hands back its host ``Table``.
A worker's death shows in two ways, and both replay on the survivors:

- its heartbeats stop (``kill_worker``; a host whose announcer died): the
  supervisor stops the world as soon as the detector marks the
  participant dead, and the completion barrier rejects a world that
  finished with a dead participant (``WorkerLostError``);
- its rank process exits non-zero, or the world outlives its deadline
  (``WorldFailed``): the rank that exited first is that participant's
  death, so its heartbeats are stopped too.

An error the statement raises on every rank (bad SQL, an unknown table,
a runtime error of the plan) is caught by each rank and re-raised here,
with its own class and message; it takes one attempt and never replays.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

import torch

from .failure import (ClusterSizeMonitor, HeartbeatFailureDetector,
                      RestartOnFailure)
from .multihost import WorldFailed, launch_world

STATEMENT = "statement"  # the attempt's statement job, rank 0's table


class WorkerLostError(RuntimeError):
    """An attempt's participant died mid-query; the result is lost."""

    def __init__(self, dead: List[str]):
        super().__init__(f"workers lost during query: {dead}")
        self.dead = dead


class SimulatedWorker:
    """Heartbeat source for one participant (stand-in for a host's
    announcer loop; ``server/Server.java:138``)."""

    def __init__(self, worker_id: str, detector: HeartbeatFailureDetector,
                 interval_s: float = 0.05):
        self.worker_id = worker_id
        self.detector = detector
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._beat, daemon=True,
                                        name=f"heartbeat-{worker_id}")

    def start(self):
        self.detector.register(self.worker_id)
        self._thread.start()

    def _beat(self):
        while not self._stop.is_set():
            self.detector.heartbeat(self.worker_id, ok=True)
            self._stop.wait(self.interval_s)

    def kill(self):
        """Host death: heartbeats stop; the detector marks the worker
        dead after the staleness timeout."""
        self._stop.set()

    @property
    def alive(self) -> bool:
        return not self._stop.is_set()


class ClusterSupervisor:
    """Runs queries under failure supervision, one world of rank
    processes per attempt.

    ``device``: the ranks' device, by default each rank's own card
    (``cuda:LOCAL_RANK``; ``n_workers`` defaults to the cards present and
    the constructor raises without one); ``"cpu"`` gives gloo ranks and
    needs ``n_workers``.  ``attempt_deadline_s`` bounds one attempt's
    world, its start and ingest included.  ``runner_opts`` go to every
    rank's ``DistributedRunner``."""

    def __init__(self, scale_factor: float, n_workers: Optional[int] = None,
                 min_workers: int = 1, heartbeat_timeout_s: float = 0.5,
                 heartbeat_interval_s: float = 0.05, max_attempts: int = 3,
                 admission_timeout_s: float = 5.0,
                 resource_groups=None, attempt_deadline_s: float = 300.0,
                 device=None, **runner_opts):
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda":
            cards = torch.cuda.device_count()
            if cards == 0:
                raise RuntimeError(
                    "no CUDA device: ClusterSupervisor runs its ranks on "
                    "the card unless device='cpu'")
            n = cards if n_workers is None else n_workers
            if n > (1 if dev.index is not None else cards):
                raise ValueError(f"{n} CUDA ranks need {n} cards, one "
                                 f"each ({cards} present, device={device})")
        elif n_workers is None:
            raise ValueError("CPU ranks need n_workers")
        else:
            n = n_workers
        # optional per-group admission (resource_groups.ResourceGroupManager)
        self.resource_groups = resource_groups
        self.sf = scale_factor
        self.device = device
        self.min_workers = min_workers
        self.max_attempts = max_attempts
        self.admission_timeout_s = admission_timeout_s
        self.attempt_deadline_s = attempt_deadline_s
        self.runner_opts = runner_opts
        self.detector = HeartbeatFailureDetector(
            heartbeat_timeout_s=heartbeat_timeout_s)
        self.monitor = ClusterSizeMonitor(self.detector, min_workers)
        self.workers = [SimulatedWorker(f"worker-{i}", self.detector,
                                        heartbeat_interval_s)
                        for i in range(n)]
        self._by_id: Dict[str, SimulatedWorker] = {
            w.worker_id: w for w in self.workers}
        for w in self.workers:
            w.start()
        self.attempts = 0          # total attempts across queries
        self.restarts = 0          # attempts invalidated by worker loss
        self.attempt_worlds: List[int] = []  # each attempt's world size
        self.last_world: Optional[dict] = None  # rank 0's record, last run
        # fault-injection hooks (reference tests inject at this level too,
        # e.g. StatefulSleepingSum): called with the participant list after
        # the attempt snapshot, i.e. logically mid-query
        self.on_attempt_start: List[Callable[[List[str]], None]] = []
        # called with the participants and the attempt's job list before
        # its world starts; a hook may add jobs that every rank runs first
        self.on_attempt_spec: List[Callable[[List[str], dict], None]] = []

    def kill_worker(self, i: int):
        self.workers[i].kill()

    def shutdown(self):
        """Stop all heartbeat threads (GracefulShutdownHandler analogue)."""
        for w in self.workers:
            w.kill()
        for w in self.workers:
            w._thread.join(timeout=1.0)

    def _await_admission(self):
        deadline = time.monotonic() + self.admission_timeout_s
        while not self.monitor.ready():
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    f"cluster below min_workers={self.min_workers} "
                    f"(active: {self.detector.active()})")
            time.sleep(0.01)

    def _mark_dead(self, worker_id: str):
        """A participant whose rank process died: stop its heartbeats and
        wait until the detector drops it, so the replay leaves it out."""
        self._by_id[worker_id].kill()
        deadline = time.monotonic() + self.detector.timeout + 5.0
        while self.detector.is_alive(worker_id):
            if time.monotonic() >= deadline:
                raise RuntimeError(f"{worker_id} never marked dead")
            time.sleep(0.01)

    def run_sql(self, sql: str, user: str = "presto"):
        """Admission gates (cluster size, then resource group) → attempt
        loop; a lost worker invalidates the attempt and replays on the
        surviving workers.  Returns rank 0's host ``Table``."""
        self._await_admission()
        if self.resource_groups is not None:
            with self.resource_groups.acquire(
                    user, timeout_s=self.admission_timeout_s):
                return self._run_attempts(sql)
        return self._run_attempts(sql)

    def _run_attempts(self, sql: str):
        def lost(participants: List[str]) -> List[str]:
            return [w for w in participants if not self.detector.is_alive(w)]

        def attempt(participants: List[str]):
            self.attempts += 1
            for hook in self.on_attempt_start:
                hook(list(participants))
            spec = {"sf": self.sf, "tables": True,
                    "runners": {"default": dict(self.runner_opts)},
                    "jobs": [{"name": STATEMENT, "sql": sql, "catch": True}]}
            for hook in self.on_attempt_spec:
                hook(list(participants), spec)
            self.attempt_worlds.append(len(participants))
            try:
                data = launch_world(
                    len(participants), spec, self.attempt_deadline_s,
                    device=self.device,
                    watch=lambda: lost(participants) and "workers lost")
            except WorldFailed as e:
                self.restarts += 1
                dead = lost(participants)
                if dead:
                    raise WorkerLostError(dead) from e
                if e.rank is not None:
                    self._mark_dead(participants[e.rank])
                raise
            result = data.pop("tables")[STATEMENT]
            if isinstance(result, Exception):
                raise result  # the statement's own error, on every rank
            # completion barrier: if any participant died while the
            # world ran, its shard outputs are untrustworthy
            dead = lost(participants)
            if dead:
                self.restarts += 1
                raise WorkerLostError(dead)
            self.last_world = data
            return result

        return RestartOnFailure(
            attempt, self.detector, max_attempts=self.max_attempts,
            retryable=lambda e: isinstance(e, (WorkerLostError, WorldFailed))
        ).execute()
