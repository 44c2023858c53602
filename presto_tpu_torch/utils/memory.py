"""Device-memory accounting + budget enforcement.

The single-host analogue of the reference's memory subsystem
(``lib/trino-memory-context`` LocalMemoryContext tree + ``memory/MemoryPool``
+ eviction pressure via ``MemoryRevokingScheduler``): reservations are
tracked per tag; exceeding the budget triggers the registered revoke
callbacks (LRU order) — here that means dropping cached device columns back
to the host tier (regenerate/reload on next touch), the HBM↔host analogue
of revocable memory."""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple


def col_bytes(col) -> int:
    """Device bytes of one DCol (torch tensors)."""
    n = col.values.numel() * col.values.element_size()
    if col.lengths is not None:
        n += col.lengths.numel() * col.lengths.element_size()
    if col.validity is not None:
        n += col.validity.numel()
    return n


def chunk_bytes(chunk) -> int:
    return sum(col_bytes(c) for c in chunk.cols.values()) \
        + chunk.mask.numel()


class MemoryPool:
    """Byte budget with LRU revocation (None budget = unbounded tracking).

    ``reserve(tag, nbytes, revoke)`` records a reservation; when the budget
    would be exceeded, least-recently-used revocable reservations are
    revoked (their callback runs, their bytes are freed) until it fits.
    Non-revocable reservations that cannot fit raise MemoryBudgetExceeded
    (the reference fails the query when the pool is exhausted and nothing
    can spill)."""

    def __init__(self, budget_bytes: Optional[int] = None):
        self.budget = budget_bytes
        self.reserved: "OrderedDict[object, Tuple[int, Optional[Callable]]]" \
            = OrderedDict()
        self.peak = 0

    @property
    def used(self) -> int:
        return sum(b for b, _ in self.reserved.values())

    def reserve(self, tag, nbytes: int,
                revoke: Optional[Callable[[], None]] = None):
        self.free(tag)
        if self.budget is not None:
            need = self.used + nbytes - self.budget
            if need > 0:
                for key in [k for k, (_, r) in self.reserved.items()
                            if r is not None]:
                    if need <= 0:
                        break
                    b, r = self.reserved.pop(key)
                    r()
                    need -= b
            if self.used + nbytes > self.budget:
                raise MemoryBudgetExceeded(
                    f"reservation {nbytes}B exceeds budget {self.budget}B "
                    f"(used {self.used}B, nothing left to revoke)")
        self.reserved[tag] = (nbytes, revoke)
        self.peak = max(self.peak, self.used)

    def touch(self, tag):
        """LRU refresh."""
        if tag in self.reserved:
            self.reserved.move_to_end(tag)

    def free(self, tag):
        self.reserved.pop(tag, None)


class MemoryBudgetExceeded(RuntimeError):
    pass
