"""String predicates and slices over fixed-width byte matrices.

Torch port of ``presto_tpu/ops/strings.py`` (the reference evaluates LIKE
through compiled regex automata per row, ``operator/scalar/``).  A BYTES
column is a ``[N, W]`` uint8 matrix plus int32 lengths; bytes at or past a
row's length are padding.  LIKE is a data-parallel window compare: each
``%``-split segment is found greedily at its leftmost position, all rows
advancing together, with no per-row branches.

``_find_from`` loops over the segment's ``m`` bytes, not over the
``W - m + 1`` offsets as the JAX function's ``fori_loop`` does: each step
ANDs one ``[N, W - m + 1]`` compare of a shifted column slice, so the work
is ``m`` passes over the matrix and no ``[N, W - m + 1, m]`` window tensor
is formed.  ASCII only, as in the reference.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

BIG = 1 << 30  # "no match" offset


def _find_from(values: torch.Tensor, lengths: torch.Tensor, seg: bytes,
               from_pos: torch.Tensor) -> torch.Tensor:
    """Earliest offset >= ``from_pos`` where ``seg`` lies wholly inside
    the row's length; BIG if none."""
    n, w = values.shape
    m = len(seg)
    if m == 0:
        return from_pos
    if m > w:
        return torch.full((n,), BIG, dtype=torch.int32, device=values.device)
    span = w - m + 1
    hit = values[:, :span] == seg[0]
    for k in range(1, m):
        hit &= values[:, k:k + span] == seg[k]
    off = torch.arange(span, dtype=torch.int32, device=values.device)
    ok = hit & (off >= from_pos[:, None]) & (off + m <= lengths[:, None])
    # argmax returns the first maximal index: the leftmost hit
    first = ok.to(torch.uint8).argmax(1).to(torch.int32)
    return torch.where(ok.any(1), first, BIG)


def parse_like(pattern: str) -> Tuple[bool, bool, List[bytes]]:
    """Split a LIKE pattern into (anchored_start, anchored_end, segments).

    Supports '%' wildcards only: '_' raises, as in the reference."""
    if "_" in pattern:
        raise NotImplementedError("LIKE '_' wildcard on a byte-string column")
    anchored_start = not pattern.startswith("%")
    anchored_end = not pattern.endswith("%")
    segs = [s.encode("ascii") for s in pattern.split("%") if s]
    return anchored_start, anchored_end, segs


def _seg_tensor(seg: bytes, device) -> torch.Tensor:
    return torch.frombuffer(bytearray(seg), dtype=torch.uint8).to(device)


def _prefix_eq(values: torch.Tensor, seg: bytes) -> torch.Tensor:
    """bool[N]: the first ``len(seg)`` bytes equal ``seg`` (len <= W)."""
    if not seg:
        return torch.ones((values.shape[0],), dtype=torch.bool,
                          device=values.device)
    return (values[:, :len(seg)] == _seg_tensor(seg, values.device)).all(1)


def like(values: torch.Tensor, lengths: torch.Tensor,
         pattern: str) -> torch.Tensor:
    """bool[N] mask of rows matching the LIKE pattern."""
    n, w = values.shape
    dev = values.device
    a_start, a_end, segs = parse_like(pattern)
    ok = torch.ones((n,), dtype=torch.bool, device=dev)
    if not segs:
        # a pattern of only '%'s matches everything; '' matches empty strings
        return ok if "%" in pattern else (lengths == 0)
    if a_start and a_end and len(segs) == 1:
        return eq_literal(values, lengths, segs[0].decode("ascii"))
    pos = torch.zeros((n,), dtype=torch.int32, device=dev)
    start = 0
    if a_start:
        m = len(segs[0])
        if m > w:
            return torch.zeros((n,), dtype=torch.bool, device=dev)
        ok = ok & _prefix_eq(values, segs[0]) & (lengths >= m)
        pos = torch.full((n,), m, dtype=torch.int32, device=dev)
        start = 1
    end = len(segs)
    last_seg = None
    if a_end and end > start:
        last_seg = segs[end - 1]
        end -= 1
    for seg in segs[start:end]:
        at = _find_from(values, lengths, seg, pos)
        ok = ok & (at != BIG)
        pos = torch.where(at == BIG, pos, at + len(seg))
    if last_seg is not None:
        m = len(last_seg)
        off = lengths.to(torch.int64) - m
        # the row's own last m bytes
        idx = (off[:, None] + torch.arange(m, device=dev)).clamp(0, w - 1)
        tail = torch.gather(values, 1, idx)
        ok = ok & (tail == _seg_tensor(last_seg, dev)).all(1) \
            & (off >= pos) & (lengths >= m)
    return ok


def eq_literal(values: torch.Tensor, lengths: torch.Tensor,
               lit: str) -> torch.Tensor:
    """bool[N]: the row equals the string ``lit``."""
    b = lit.encode("ascii")
    n, w = values.shape
    if len(b) > w:
        return torch.zeros((n,), dtype=torch.bool, device=values.device)
    return _prefix_eq(values, b) & (lengths == len(b))


def substring(values: torch.Tensor, lengths: torch.Tensor, start: int,
              size: int):
    """1-based SUBSTRING(col FROM start FOR size) → ([N, size] uint8,
    int32 lengths), bytes past the new length zeroed."""
    n, w = values.shape
    dev = values.device
    s0 = start - 1
    pos = torch.arange(size, device=dev)
    idx = (s0 + pos).clamp(0, w - 1).expand(n, size)
    out = torch.gather(values, 1, idx)
    new_len = (lengths.to(torch.int64) - s0).clamp(0, size)
    out = torch.where(pos < new_len[:, None], out, 0)
    return out, new_len.to(torch.int32)


def strpos(values: torch.Tensor, lengths: torch.Tensor,
           sub: str) -> torch.Tensor:
    """int64[N]: 1-based offset of ``sub``'s first occurrence inside each
    row, 0 where there is none (1 for the empty ``sub``), as Trino's
    ``strpos``."""
    at = _find_from(values, lengths, sub.encode("ascii"),
                    torch.zeros((values.shape[0],), dtype=torch.int32,
                                device=values.device))
    return torch.where(at == BIG, 0, at.to(torch.int64) + 1)
