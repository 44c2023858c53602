"""Resource groups: hierarchical admission + scheduling policies.

The reference's ``execution/resourcegroups/InternalResourceGroup.java`` +
``dispatcher/DispatchManager`` admission step: named groups form a TREE;
a query is admitted to a leaf and consumes a running slot in the leaf
and every ancestor; when a slot frees, the tree picks the next queued
query by each node's scheduling policy over its children:

- ``fair``          round-robin across children (reference FAIR)
- ``weighted_fair`` least running/weight ratio first (WEIGHTED_FAIR)
- ``weighted``      weight-biased deterministic pick (WEIGHTED)
- ``query_priority``  highest query priority first (QUERY_PRIORITY)

Selector rules map (user) → leaf group
(``ResourceGroupConfigurationManager`` role).  CPU-time accounting per
group feeds a soft limit check.

A copy of ``presto_tpu/parallel/resource_groups.py`` (it imports no jax).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


class QueryQueueFullError(RuntimeError):
    """Group queue at max_queued (reference: QUERY_QUEUE_FULL)."""


class AdmissionTimeout(RuntimeError):
    pass


@dataclass
class ResourceGroup:
    """One admission group (``InternalResourceGroup`` node; queries queue
    at leaves, limits apply at every level)."""

    name: str
    hard_concurrency_limit: int = 4
    max_queued: int = 64
    soft_cpu_limit_s: Optional[float] = None  # penalize over-consumers
    parent: Optional[str] = None              # None = child of the root
    weight: int = 1                           # weighted/weighted_fair share
    # how THIS group picks among its children when a slot frees
    scheduling_policy: str = "fair"   # fair|weighted_fair|weighted|query_priority

    running: int = 0
    # (event, priority, seq) — priority only consulted by query_priority
    queued: "deque" = field(default_factory=deque)
    cpu_seconds: float = 0.0      # accumulated query wall (soft accounting)
    admitted: int = 0
    rejected: int = 0
    _rr_next: int = 0             # fair round-robin cursor

    def over_cpu(self) -> bool:
        return (self.soft_cpu_limit_s is not None
                and self.cpu_seconds > self.soft_cpu_limit_s)


class ResourceGroupManager:
    """Group tree + selector rules + policy-driven admission.

    ``selectors`` is an ordered list of (user_pattern, group_name); the
    first match wins, '*' matches anyone (the static-rule subset of the
    reference's configurable selectors)."""

    def __init__(self, groups: Optional[List[ResourceGroup]] = None,
                 selectors: Optional[List[Tuple[str, str]]] = None):
        gs = groups or [ResourceGroup("global")]
        self.groups: Dict[str, ResourceGroup] = {g.name: g for g in gs}
        self.children: Dict[Optional[str], List[str]] = {}
        for g in gs:
            self.children.setdefault(g.parent, []).append(g.name)
        # leaves = groups with no children
        self.selectors = selectors or [
            ("*", next(n for n in self.groups
                       if n not in self.children))]
        self._lock = threading.Lock()
        self._seq = itertools.count()

    # -- topology helpers
    def _path(self, g: ResourceGroup) -> List[ResourceGroup]:
        """leaf → root chain (inclusive)."""
        out = [g]
        while out[-1].parent is not None:
            out.append(self.groups[out[-1].parent])
        return out

    def _has_capacity(self, g: ResourceGroup) -> bool:
        return all(a.running < a.hard_concurrency_limit and not a.over_cpu()
                   for a in self._path(g))

    def select(self, user: str = "presto") -> ResourceGroup:
        for pattern, gname in self.selectors:
            if pattern == "*" or pattern == user:
                return self.groups[gname]
        return next(iter(self.groups.values()))

    def acquire(self, user: str = "presto", timeout_s: float = 30.0,
                priority: int = 0) -> "_Slot":
        """Block until the user's leaf group (and every ancestor) grants
        a run slot, raising QueryQueueFullError when the leaf queue is
        saturated.  ``priority`` participates under query_priority."""
        g = self.select(user)
        me: Optional[threading.Event] = None
        with self._lock:
            if not g.queued and self._has_capacity(g):
                self._start(g)
                return _Slot(self, g)
            if len(g.queued) >= g.max_queued:
                g.rejected += 1
                raise QueryQueueFullError(
                    f"group '{g.name}' queue full "
                    f"({len(g.queued)}/{g.max_queued})")
            me = threading.Event()
            g.queued.append((me, priority, next(self._seq)))
        if not me.wait(timeout_s):
            with self._lock:
                for item in list(g.queued):
                    if item[0] is me:
                        g.queued.remove(item)
                        break
                else:
                    # granted concurrently with the timeout: release it
                    self._finish(g, 0.0)
            raise AdmissionTimeout(
                f"group '{g.name}' admission timed out after {timeout_s}s")
        return _Slot(self, g)

    def _start(self, leaf: ResourceGroup) -> None:
        for a in self._path(leaf):
            a.running += 1
        leaf.admitted += 1

    def _eligible_leaves(self) -> List[ResourceGroup]:
        return [g for g in self.groups.values()
                if g.queued and g.name not in self.children
                and self._has_capacity(g)]

    def _pick(self, node_name: Optional[str]) -> Optional[ResourceGroup]:
        """Descend from ``node_name`` picking a child per the node's
        policy until a leaf with queued+eligible work is found."""
        kids = [self.groups[k] for k in self.children.get(node_name, [])]
        viable = []
        for k in kids:
            if k.name in self.children:        # internal node
                if self._subtree_has_work(k):
                    viable.append(k)
            elif k.queued and self._has_capacity(k):
                viable.append(k)
        if not viable:
            return None
        policy = (self.groups[node_name].scheduling_policy
                  if node_name is not None else
                  self._root_policy())
        if policy == "weighted_fair":
            chosen = min(viable, key=lambda k: (k.running / max(k.weight, 1),
                                                k.name))
        elif policy == "weighted":
            chosen = max(viable, key=lambda k: (max(k.weight, 1)
                                                - k.running, k.name))
        elif policy == "query_priority":
            def best_prio(k):
                if k.name in self.children:
                    return 0
                return max(p for _, p, _ in k.queued)
            chosen = max(viable, key=best_prio)
        else:  # fair: round-robin over the child list
            parent = self.groups.get(node_name)
            cursor = parent._rr_next if parent else self._rr_root
            order = kids[cursor:] + kids[:cursor]
            chosen = next(k for k in order if k in viable)
            nxt = (kids.index(chosen) + 1) % len(kids)
            if parent:
                parent._rr_next = nxt
            else:
                self._rr_root = nxt
        if chosen.name in self.children:
            return self._pick(chosen.name)
        return chosen

    _rr_root = 0

    def _root_policy(self) -> str:
        return "fair"

    def _subtree_has_work(self, node: ResourceGroup) -> bool:
        if not self._has_capacity(node):
            return False
        for k in self.children.get(node.name, []):
            kg = self.groups[k]
            if k in self.children:
                if self._subtree_has_work(kg):
                    return True
            elif kg.queued and self._has_capacity(kg):
                return True
        return False

    def _finish(self, leaf: ResourceGroup, cpu_s: float) -> None:
        for a in self._path(leaf):
            a.running -= 1
        leaf.cpu_seconds += cpu_s
        # wake as many queued queries as the freed capacity allows,
        # chosen per the tree's scheduling policies
        while True:
            nxt = self._pick(None)
            if nxt is None:
                return
            if nxt.scheduling_policy == "query_priority" or any(
                    p for _, p, _ in nxt.queued):
                item = max(nxt.queued, key=lambda it: (it[1], -it[2]))
                nxt.queued.remove(item)
            else:
                item = nxt.queued.popleft()
            self._start(nxt)
            item[0].set()

    def _release(self, g: ResourceGroup, cpu_s: float):
        with self._lock:
            self._finish(g, cpu_s)

    def info(self) -> List[dict]:
        """REST-shape group states (``ResourceGroupInfo`` role)."""
        with self._lock:
            return [{"name": g.name, "running": g.running,
                     "queued": len(g.queued), "admitted": g.admitted,
                     "rejected": g.rejected, "parent": g.parent,
                     "weight": g.weight, "policy": g.scheduling_policy,
                     "cpuSeconds": round(g.cpu_seconds, 3)}
                    for g in self.groups.values()]


class _Slot:
    """Held run slot; context manager releases + accounts wall time."""

    def __init__(self, mgr: ResourceGroupManager, group: ResourceGroup):
        self.mgr = mgr
        self.group = group
        self._t0 = time.monotonic()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.mgr._release(self.group, time.monotonic() - self._t0)
        return False
