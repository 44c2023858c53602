"""The comparison that decides ``correct``: a statement's rows, as the
client received them, against the reference's, exactly.

Rows are compared in the query's order: the ordering columns of every
row must follow the reference's sequence, and the rows that tie on them
(the only freedom an ORDER BY leaves) must be the same multiset. Values
are compared exactly: decimals are unscaled integers, dates are days,
strings are strings. Tolerance 0.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple


def _key(row: tuple, idx: Sequence[int]) -> tuple:
    return tuple(row[i] for i in idx)


def _canon(rows) -> list:
    return sorted(rows, key=repr)


def compare(got: List[tuple], want: List[tuple], columns: List[str],
            order: Sequence[Tuple[str, str]]) -> Optional[str]:
    """None when ``got`` equals ``want``; else what differs."""
    if len(got) != len(want):
        return f"{len(got)} rows, the reference has {len(want)}"
    got = [tuple(r) for r in got]
    want = [tuple(r) for r in want]
    if any(len(r) != len(columns) for r in got):
        return f"rows of the wrong width, the reference has {len(columns)}"
    idx = [columns.index(c) for c, _ in order]
    if not idx:
        return None if _canon(got) == _canon(want) else \
            "rows differ (no ORDER BY: compared as multisets)"
    gk = [_key(r, idx) for r in got]
    if gk != [_key(r, idx) for r in want]:
        first = next(i for i, (a, b) in enumerate(
            zip(gk, [_key(r, idx) for r in want])) if a != b)
        return f"ordering columns differ from row {first}"
    lo = 0
    for hi in range(1, len(got) + 1):
        if hi == len(got) or gk[hi] != gk[lo]:
            if _canon(got[lo:hi]) != _canon(want[lo:hi]):
                return f"rows {lo}-{hi - 1} differ"
            lo = hi
    return None
