"""Sort kernels: stable multi-key ordering over tensors.

Torch port of ``argsort_multi`` in ``presto_tpu/ops/sort.py`` (the
reference's ``operator/PagesIndex.java:389 sort()``): keys are integers
(descending via bitwise complement), and a multi-key order is a chain of
stable sorts from the least to the most significant key.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

I64_MAX = 2**63 - 1
I32_MAX = 2**31 - 1

_NARROW = (torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool)


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
