"""Per-row operations on nested values: ``[N, W]`` tensors and lengths.

The JAX package keeps these inside ``presto_tpu/exec/expreval.py``
(``_pos_grid``, ``_array_member_mask``, ``_array_first_occurrence``,
``_array_select`` and the bodies of array_sort, array_distinct and
array_min/array_max).  Here they are plain tensor functions over an
ARRAY's element keys: ``k [N, W]`` is an int64 image of the elements in
which equal values are equal and the order is the values' order (a
string element's rank among its dictionary's strings, a DOUBLE's
order-preserving bits); positions at or past a row's length are padding
and never take part.  The caller gathers the elements themselves by the
positions these return.
"""

from __future__ import annotations

from typing import Tuple

import torch

I64_MAX = 2**63 - 1
I64_MIN = -2**63


def pos_grid(w: int, lengths: torch.Tensor) -> torch.Tensor:
    """bool [N, W]: position < the row's length (the element mask)."""
    return torch.arange(w, device=lengths.device)[None, :] < \
        lengths.to(torch.int64)[:, None]


def member_mask(ka: torch.Tensor, la: torch.Tensor, kb: torch.Tensor,
                lb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a's element mask, [N, Wa] bool: a's element appears among b's
    elements of the same row)."""
    ina = pos_grid(ka.shape[1], la)
    inb = pos_grid(kb.shape[1], lb)
    eq = (ka[:, :, None] == kb[:, None, :]) & inb[:, None, :]
    return ina, eq.any(2) & ina


def first_occurrence(k: torch.Tensor, within: torch.Tensor) -> torch.Tensor:
    """[N, W] bool: the element is within its row and the first of its
    value there (the keep mask of a distinct that keeps the first
    occurrences in order)."""
    w = k.shape[1]
    same = (k[:, :, None] == k[:, None, :]) & within[:, None, :] \
        & within[:, :, None]
    earlier = torch.ones((w, w), dtype=torch.bool,
                         device=k.device).tril(-1)[None]
    return within & ~(same & earlier).any(2)


def compact_order(keep: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(positions [N, W], new lengths [N] int32): each row's kept
    positions moved to the front in their order (stable), then the rest."""
    order = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
    return order, keep.sum(1).to(torch.int32)


def sort_order(k: torch.Tensor, lengths: torch.Tensor,
               descending: bool = False) -> torch.Tensor:
    """Positions [N, W] that order each row's elements by ``k`` (stable;
    equal keys keep their order), the padding after them."""
    p1 = torch.sort(~k if descending else k, dim=1, stable=True).indices
    pad = (~pos_grid(k.shape[1], lengths)).gather(1, p1).to(torch.int8)
    return p1.gather(1, torch.sort(pad, dim=1, stable=True).indices)


def distinct_order(k: torch.Tensor, lengths: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(positions, new lengths) of each row's distinct elements, the first
    occurrence of each value in the row's order (Trino's
    ``array_distinct``)."""
    return compact_order(first_occurrence(k, pos_grid(k.shape[1], lengths)))


def extreme_pos(k: torch.Tensor, lengths: torch.Tensor,
                largest: bool) -> torch.Tensor:
    """Position [N] of the first element of each row at its least (or
    greatest) key; 0 for an empty row."""
    n, w = k.shape
    if w == 0:
        return torch.zeros((n,), dtype=torch.int64, device=k.device)
    grid = pos_grid(w, lengths)
    if largest:
        return torch.where(grid, k, I64_MIN).argmax(1)
    return torch.where(grid, k, I64_MAX).argmin(1)


def take_rows(values: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``values[i, pos[i, j]]`` (positions of any width at most W)."""
    if values.shape[1] == 0:
        return torch.zeros(pos.shape, dtype=values.dtype,
                           device=values.device)
    return values.gather(1, pos.clamp(0, values.shape[1] - 1))


def zero_padding(values: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """``values`` with the padding past each row's length set to 0, so that
    equal arrays are equal rows."""
    return torch.where(pos_grid(values.shape[1], lengths), values,
                       torch.zeros((), dtype=values.dtype,
                                   device=values.device))


def pad_width(values: torch.Tensor, w: int) -> torch.Tensor:
    """``values`` padded with zeros on the right to width ``w``."""
    if values.shape[1] >= w:
        return values
    return torch.cat([values, torch.zeros(
        (values.shape[0], w - values.shape[1]), dtype=values.dtype,
        device=values.device)], 1)


def group_positions(slot: torch.Tensor, keep: torch.Tensor,
                    capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(position of each kept row within its group in row order, -1 for
    the others; rows per group [capacity]): one stable sort by group."""
    n = slot.shape[0]
    key = torch.where(keep, slot.to(torch.int64), capacity)
    perm = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=capacity + 1)[:capacity]
    start = torch.cumsum(counts, 0) - counts
    sk = key[perm]
    rank = torch.arange(n, device=slot.device) - start[
        sk.clamp(max=capacity - 1)]
    pos = torch.empty((n,), dtype=torch.int64, device=slot.device)
    pos[perm] = rank
    return torch.where(keep, pos, -1), counts


def group_pack(values: torch.Tensor, slot: torch.Tensor, pos: torch.Tensor,
               keep: torch.Tensor, capacity: int, width: int) -> torch.Tensor:
    """[capacity, width]: each kept row's value at (its group, its
    position); the rest 0."""
    out = torch.zeros((capacity * width + 1,), dtype=values.dtype,
                      device=values.device)
    at = torch.where(keep & (pos < width),
                     slot.to(torch.int64) * width + pos, capacity * width)
    out[at] = values
    return out[:capacity * width].reshape(capacity, width)
