"""Bytes and operations of one ``sorted_probe`` launch, from its shapes.

The kernel finds the lower bound of each of ``p`` int64 probes in the
first ``n_valid`` keys of a sorted int64 column (``cap`` allocated) and
writes one int32 position per probe. Each input byte it needs is read
once and each output byte written once: ``n_valid * 8 + p * 8 + p * 4``
(``presto_tpu_torch/ops/cuda_kernels.py``: the int32 output). The work is
one comparison per probe per halving of the keys, ``p * ceil(log2(n + 1))``
integer operations, far below the card's integer rate: the bound is the
bytes.
"""

import math


def bytes_moved(cap: int, p: int, n_valid: int) -> int:
    n = max(0, min(n_valid, cap))
    return n * 8 + p * 8 + p * 4


def operations(cap: int, p: int, n_valid: int) -> int:
    n = max(0, min(n_valid, cap))
    return p * math.ceil(math.log2(n + 1))
