"""Query event listeners (reference: ``eventlistener/EventListenerManager``
+ ``event/QueryMonitor.java`` queryCreated/queryCompleted events).

A copy of ``presto_tpu/utils/events.py`` (it imports no jax).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional


@dataclass
class QueryCreatedEvent:
    query_id: str
    sql: str
    user: str


@dataclass
class QueryCompletedEvent:
    query_id: str
    sql: str
    user: str
    state: str              # FINISHED | FAILED
    elapsed_s: float
    rows: int
    error: Optional[str] = None


class EventListenerManager:
    """Dispatches query lifecycle events to registered listeners."""

    def __init__(self):
        self._created: List[Callable[[QueryCreatedEvent], None]] = []
        self._completed: List[Callable[[QueryCompletedEvent], None]] = []

    def on_query_created(self, fn):
        self._created.append(fn)
        return fn

    def on_query_completed(self, fn):
        self._completed.append(fn)
        return fn

    def query_created(self, ev: QueryCreatedEvent):
        for fn in self._created:
            try:
                fn(ev)
            except Exception:  # noqa: BLE001 - listeners must not break queries
                pass

    def query_completed(self, ev: QueryCompletedEvent):
        for fn in self._completed:
            try:
                fn(ev)
            except Exception:  # noqa: BLE001
                pass
