"""Sort kernels: stable multi-key ordering over tensors.

Torch port of ``argsort_multi`` in ``presto_tpu/ops/sort.py`` (the
reference's ``operator/PagesIndex.java:389 sort()``): keys are integers
(descending via bitwise complement), strings are big-endian 8-byte packs
(``bytes_sort_keys``), and a multi-key order is a chain of stable sorts
from the least to the most significant key.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

I64_MAX = 2**63 - 1
I32_MAX = 2**31 - 1

_NARROW = (torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool)


def bytes_sort_keys(values: torch.Tensor,
                    lengths: torch.Tensor) -> List[torch.Tensor]:
    """A [N, W] ASCII byte matrix → ceil(W/8) big-endian int64 packs.

    Bytes at or past ``lengths`` are zeroed, so a shorter string sorts
    first, and packs compare in lexicographic order for ASCII (a byte
    >= 0x80 would turn a pack negative, as in the reference)."""
    n, w = values.shape
    w8 = (w + 7) // 8 * 8
    dev = values.device
    padded = torch.zeros((n, w8), dtype=torch.int64, device=dev)
    padded[:, :w] = values.to(torch.int64)
    keep = torch.arange(w8, device=dev)[None, :] < lengths.to(
        torch.int64)[:, None]
    padded = torch.where(keep, padded, 0)
    packs = []
    for c in range(w8 // 8):
        word = torch.zeros((n,), dtype=torch.int64, device=dev)
        for b in range(8):
            word = (word << 8) | padded[:, c * 8 + b]
        packs.append(word)
    return packs


def f64_sort_key(v: torch.Tensor) -> torch.Tensor:
    """float64 → int64 in the same order: the bits of a value >= 0 as they
    are, those of a negative value with all but the sign flipped; -0.0
    first becomes 0.0, so the two are one key."""
    bits = torch.where(v == 0, 0.0, v).to(torch.float64).contiguous().view(
        torch.int64)
    return torch.where(bits < 0, bits ^ I64_MAX, bits)


def argsort_multi(keys: Sequence[Tuple[torch.Tensor, bool]],
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stable argsort by multiple (int-normalised) keys.

    ``keys``: list of (tensor[N], descending) in major-to-minor order.
    Masked-out rows sort to the end.  Returns an int64 permutation.
    """
    n = keys[0][0].shape[0]
    perm = torch.arange(n, device=keys[0][0].device)
    for arr, desc in reversed(list(keys)):
        if arr.dtype in _NARROW:
            k, sentinel = arr.to(torch.int32), I32_MAX
        else:
            k, sentinel = arr.to(torch.int64), I64_MAX
        if desc:
            k = ~k
        if mask is not None:
            k = torch.where(mask, k, sentinel)  # invalid rows last
        perm = perm[torch.sort(k[perm], stable=True).indices]
    if mask is not None:
        # final pass: all valid rows before invalid, preserving key order
        valid = mask[perm]
        perm = perm[torch.sort((~valid).to(torch.int8), stable=True).indices]
    return perm
