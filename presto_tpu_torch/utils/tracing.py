"""Spans: the engine's own host time, named, on the profiler's clock.

A span is on exactly while a ``torch.profiler`` session records
(``torch.autograd.profiler._is_profiler_enabled``).  So an operator who
wants to know where a statement's time goes runs a profiler around the
statements, and each span lies in its timeline as a ``record_function``
range beside the device's kernels and copies: every idle gap of the
device falls under the innermost span open at that moment.  There is no
switch of its own and no exporter: the profiler writes the timeline.

Off, ``span`` costs one boolean check and hands back a null context
shared by every call of that name: no allocation, no lock, no
``record_function``.  On, a span also keeps a record (statement id, span
id, parent span id, name, start and end in ns) and adds to its name's
totals: count, inclusive ns, and self ns (inclusive less its child
spans).  The totals are the registry's ``span.<name>.count`` and
``span.<name>.ms`` (inclusive), which ``SHOW METRICS`` lists; the span
records of the last ``RING`` statements stay in a ring
(``statements()``).  The open statement and the innermost open span are
per thread, so concurrent clients never mix.

The spans, and where each opens:

- ``statement``: the root, once per statement at the outermost entry it
  passes: ``Cursor.execute`` through the built row tuples (the HTTP
  server calls it too), or ``LocalRunner.run_sql`` called directly.  Its
  id is the cursor's ``QueryInfo.query_id``.
- ``plan``: ``LocalRunner.plan_sql`` (parse, plan, optimise, prune): a
  plan-cache miss, or EXPLAIN.
- ``op:<Operator>``: ``exec/physical.py`` ``execute``, around each plan
  node (``op:HashJoin`` for ``PhysHashJoin``), in the wrapper that also
  serves EXPLAIN ANALYZE.
- ``host_read``: each counted device-to-host read (``host_read``).
- ``int128_div``: ``ops/int128.py`` ``udivmod`` and
  ``div_round_half_up``; only the outermost of nested ones opens.
- ``result_rows``: ``runner.materialize`` (host columns) and the
  cursor's ``to_pydict`` and row tuples.

No span name starts with ``stmt:``: a benchmark's own range holds that.
"""

from __future__ import annotations

import collections
import functools
import itertools
import threading
import time
import weakref
from typing import Dict, List, Tuple

import torch.autograd.profiler as _profiler

from .metrics import REGISTRY

RING = 256  # statements whose span records are kept

_ids = itertools.count(1)
_statement_ids = itertools.count(1)
_lock = threading.Lock()
# name -> [count, inclusive ns, self ns]
_totals: Dict[str, List[int]] = {}
# (statement id, [(statement id, span id, parent span id, name, start ns,
# end ns)]) of the last RING statements, oldest first
_ring: collections.deque = collections.deque(maxlen=RING)


class _Thread(threading.local):
    def __init__(self):
        self.open = None        # the innermost open _Span
        self.statement = None   # the id of the statement open here
        self.records = None     # that statement's span records
        self.reads = None       # weakref: the context counting reads


_thread = _Thread()


def _add(name: str, inclusive: int, own: int) -> None:
    with _lock:
        tot = _totals.get(name)
        first = tot is None
        if first:
            tot = _totals[name] = [0, 0, 0]
        tot[0] += 1
        tot[1] += inclusive
        tot[2] += own
    if first:
        REGISTRY.set_gauge(f"span.{name}.count", lambda: tot[0])
        REGISTRY.set_gauge(f"span.{name}.ms", lambda: tot[1] / 1e6)


def _wrap(name: str, outermost: bool, fn):
    @functools.wraps(fn)
    def spanned(*args, **kw):
        if not _profiler._is_profiler_enabled:
            return fn(*args, **kw)
        with _Span(name, outermost):
            return fn(*args, **kw)
    return spanned


class _Null:
    """A span while nothing records: enters and leaves doing nothing."""

    __slots__ = ("name", "outermost")

    def __init__(self, name: str, outermost: bool):
        self.name, self.outermost = name, outermost

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        return _wrap(self.name, self.outermost, fn)


# name -> its null context, by ``outermost``
_NULLS: Tuple[Dict[str, _Null], Dict[str, _Null]] = ({}, {})


class _Span:
    __slots__ = ("name", "outermost", "sid", "parent", "start", "child",
                 "rf")

    def __init__(self, name: str, outermost: bool = False):
        self.name, self.outermost = name, outermost

    def __call__(self, fn):
        return _wrap(self.name, self.outermost, fn)

    def __enter__(self):
        t = _thread
        self.rf = None
        if self.outermost:
            p = t.open
            while p is not None:
                if p.name == self.name:
                    return None  # counted once, by the enclosing one
                p = p.parent
        self.parent = t.open
        self.sid = next(_ids)
        self.child = 0
        self.rf = _profiler.record_function(self.name)
        self.rf.__enter__()
        t.open = self
        self.start = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        if self.rf is None:
            return False
        end = time.perf_counter_ns()
        t = _thread
        t.open = self.parent
        self.rf.__exit__(*exc)
        inclusive = end - self.start
        parent = self.parent
        if parent is not None:
            parent.child += inclusive
        _add(self.name, inclusive, inclusive - self.child)
        if t.records is not None:
            t.records.append((t.statement, self.sid,
                              None if parent is None else parent.sid,
                              self.name, self.start, end))
        return False


class _Statement(_Span):
    __slots__ = ("query_id",)

    def __init__(self, query_id):
        super().__init__("statement")
        self.query_id = query_id

    def __enter__(self):
        t = _thread
        t.statement = self.query_id or f"s_{next(_statement_ids)}"
        t.records = []
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        t = _thread
        with _lock:
            _ring.append((t.statement, t.records))
        t.statement = t.records = None
        return False


def _null(name: str, outermost: bool) -> _Null:
    with _lock:
        return _NULLS[outermost].setdefault(name, _Null(name, outermost))


def span(name: str, outermost: bool = False):
    """A context manager timing its block as the span ``name`` while a
    profiler records; ``@span(name)`` makes each call of a function one
    (the wrapper holds the call's arguments until it returns, so a
    function that frees an argument by rebinding it opens the span in
    its body instead).  With ``outermost``, a span opened inside one of
    the same name on this thread (a nested division) records nothing."""
    if not _profiler._is_profiler_enabled:
        null = _NULLS[outermost].get(name)
        return null if null is not None else _null(name, outermost)
    return _Span(name, outermost)


_NO_STATEMENT = _null("statement", True)


def statement(query_id=None):
    """The root span of one statement, ``query_id`` its id (one is made
    when None); inside an open statement on this thread, nothing."""
    if not _profiler._is_profiler_enabled or _thread.statement is not None:
        return _NO_STATEMENT
    return _Statement(query_id)


def count_reads(ctx) -> None:
    """Make ``ctx`` (anything with ``host_syncs``) the one that counts
    this thread's device-to-host reads made without a context at hand
    (expression evaluation).  Held weakly: a finished context counts
    nothing and keeps nothing alive."""
    _thread.reads = weakref.ref(ctx)


def host_read(ctx=None):
    """One device-to-host read, the host waiting for the device: adds one
    to ``ctx.host_syncs`` (by default the context ``count_reads`` named
    on this thread) and returns the ``host_read`` span to read in::

        with host_read(ctx):
            n = int(t.item())
    """
    if ctx is None:
        ref = _thread.reads
        ctx = None if ref is None else ref()
    if ctx is not None:
        ctx.host_syncs += 1
    return span("host_read")


def totals() -> Dict[str, Tuple[int, int, int]]:
    """Each span name's (count, inclusive ns, self ns) so far in this
    process: only what ran while a profiler recorded."""
    with _lock:
        return {k: tuple(v) for k, v in _totals.items()}


def statements() -> List[tuple]:
    """(statement id, its span records) of the last ``RING`` traced
    statements, oldest first; a record is (statement id, span id, parent
    span id or None, name, start ns, end ns), in the order the spans
    ended."""
    with _lock:
        return [(sid, list(recs)) for sid, recs in _ring]
