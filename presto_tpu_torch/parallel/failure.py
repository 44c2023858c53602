"""Failure detection + restart-on-failure recovery for multi-host runs.

Torch port's copy of ``presto_tpu/parallel/failure.py`` (jax-free: it
imports only ``math``, ``time``, ``dataclasses`` and ``typing``).

Models the reference's coordinator-side failure handling:
- ``failuredetector/HeartbeatFailureDetector.java:78`` — periodic pings,
  exponentially-decayed failure ratio vs threshold (:384), failed hosts
  removed from scheduling
- ``execution/ClusterSizeMonitor.java`` — gate queries on minimum workers
- v359's recovery model: a worker death fails in-flight queries; the query
  is deterministically re-run on the surviving set (our scans are
  deterministic generator splits, so replay is exact)

A virtual clock makes the detector unit-testable (the reference's
``TestingTicker`` pattern).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


class DecayedRatio:
    """Exponentially decayed success/failure ratio (airlift DecayCounter)."""

    def __init__(self, decay_seconds: float = 60.0):
        self.alpha = 1.0 / decay_seconds
        self.failures = 0.0
        self.total = 0.0
        self.last = 0.0

    def _decay(self, now: float):
        dt = max(now - self.last, 0.0)
        f = math.exp(-self.alpha * dt)
        self.failures *= f
        self.total *= f
        self.last = now

    def record(self, ok: bool, now: float):
        self._decay(now)
        self.total += 1.0
        if not ok:
            self.failures += 1.0

    def ratio(self, now: float) -> float:
        self._decay(now)
        return self.failures / self.total if self.total > 0 else 0.0


@dataclass
class WorkerState:
    worker_id: str
    ratio: DecayedRatio = field(default_factory=DecayedRatio)
    last_heartbeat: float = 0.0


class HeartbeatFailureDetector:
    """Tracks worker health; ``active()`` excludes hosts whose decayed
    failure ratio exceeds the threshold or whose heartbeat is stale."""

    def __init__(self, failure_ratio_threshold: float = 0.1,
                 heartbeat_timeout_s: float = 30.0,
                 clock: Optional[Callable[[], float]] = None):
        self.threshold = failure_ratio_threshold
        self.timeout = heartbeat_timeout_s
        self.clock = clock or time.monotonic
        self.workers: Dict[str, WorkerState] = {}

    def register(self, worker_id: str):
        now = self.clock()
        self.workers[worker_id] = WorkerState(worker_id, last_heartbeat=now)
        self.workers[worker_id].ratio.last = now

    def heartbeat(self, worker_id: str, ok: bool = True):
        now = self.clock()
        w = self.workers[worker_id]
        w.ratio.record(ok, now)
        if ok:
            w.last_heartbeat = now

    def is_alive(self, worker_id: str) -> bool:
        now = self.clock()
        w = self.workers[worker_id]
        if now - w.last_heartbeat > self.timeout:
            return False
        return w.ratio.ratio(now) <= self.threshold

    def active(self) -> List[str]:
        return [w for w in self.workers if self.is_alive(w)]


class ClusterSizeMonitor:
    """Blocks query admission until >= min workers are alive."""

    def __init__(self, detector: HeartbeatFailureDetector, min_workers: int):
        self.detector = detector
        self.min_workers = min_workers

    def ready(self) -> bool:
        return len(self.detector.active()) >= self.min_workers


class RestartOnFailure:
    """v359-style recovery: re-run the whole query on the surviving mesh.

    Deterministic generator splits make replay bit-exact: the runner simply
    re-plans with the new device count (splits re-derive from row ranges)."""

    def __init__(self, run: Callable[[List[str]], object],
                 detector: HeartbeatFailureDetector, max_attempts: int = 3,
                 retryable: Optional[Callable[[Exception], bool]] = None):
        self.run = run
        self.detector = detector
        self.max_attempts = max_attempts
        # only infrastructure failures replay; a user error (bad SQL,
        # unknown table) propagates immediately — the reference's split
        # between transport retries (RequestErrorTracker) and TrinoException
        self.retryable = retryable or (lambda e: True)

    def execute(self):
        last_err = None
        for _ in range(self.max_attempts):
            workers = self.detector.active()
            if not workers:
                raise RuntimeError("no active workers")
            try:
                return self.run(workers)
            except Exception as e:  # noqa: BLE001
                if not self.retryable(e):
                    raise
                last_err = e
        raise RuntimeError(
            f"query failed after {self.max_attempts} attempts") from last_err
