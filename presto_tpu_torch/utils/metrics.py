"""Metrics registry — the JMX-beans analogue.

The reference exposes airlift ``@Managed`` beans on every subsystem and a
``plugin/trino-jmx`` connector that makes them queryable via SQL
(``select * from jmx.current."..."``).  Here the registry is a process-
global table of named counters/gauges, and the engine exposes it as the
``system.metrics`` relation (``show metrics`` in the CLI / a normal scan
through the system connector), which is the same observable: every metric
reachable through the query language itself.

A copy of ``presto_tpu/utils/metrics.py`` (it imports no jax).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Tuple


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, Callable[[], float]] = {}
        self.created = time.time()

    def count(self, name: str, delta: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + delta

    def set_gauge(self, name: str, fn: Callable[[], float]) -> None:
        """Register a live gauge (sampled at read time)."""
        with self._lock:
            self._gauges[name] = fn

    def snapshot(self) -> List[Tuple[str, float]]:
        with self._lock:
            out = [(k, float(v)) for k, v in sorted(self._counters.items())]
            for k in sorted(self._gauges):
                try:
                    out.append((k, float(self._gauges[k]())))
                except Exception:  # noqa: BLE001 — a dead gauge never breaks reads
                    out.append((k, float("nan")))
        out.append(("uptime_s", time.time() - self.created))
        return sorted(out)


# process-global registry (the reference's MBean server role)
REGISTRY = Metrics()
