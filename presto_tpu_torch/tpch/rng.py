"""Vectorized reimplementation of the TPC-H dbgen random streams.

The reference consumes TPC-H data through the ``io.trino.tpch`` generator
(dep of ``plugin/trino-tpch``, see ``plugin/trino-tpch/pom.xml:21`` — the
generator source is not in the reference repo).  This module reimplements the
*public TPC-H dbgen specification* directly, vectorized with numpy:

- Base PRNG: multiplicative LCG ``seed' = seed * 16807 mod (2^31 - 1)``.
- Every column draws from its own stream with a fixed per-row usage count,
  which makes O(1) skip-ahead possible — and, for us, makes every stream a
  closed form ``seed0 * 16807^t mod M`` that vectorizes over all rows.
- ``bounded_int`` mirrors dbgen's UnifInt double-arithmetic exactly so keys,
  dates and prices are bit-identical with the official generator (validated
  against the golden SF1 rows bundled in the reference repo at
  ``plugin/trino-example-http/src/test/resources/example-data/``).
"""

from __future__ import annotations

import numpy as np

MULTIPLIER = 16807
MODULUS = 2147483647  # 2^31 - 1
_DM = float(MODULUS)

# 64-bit PCG-style stream used by dbgen for key columns when SF >= 30000.
MULTIPLIER_64 = 6364136223846793005
INCREMENT_64 = 1442695040888963407


def _pow_mod(base: int, exp: int, mod: int = MODULUS) -> int:
    return pow(base, exp, mod)


def lcg_powers(count: int) -> np.ndarray:
    """[16807^1, 16807^2, ..., 16807^count] mod M, via doubling (log steps)."""
    if count <= 0:
        return np.zeros(0, dtype=np.int64)
    p = np.array([MULTIPLIER], dtype=np.int64)
    while len(p) < count:
        p = np.concatenate([p, (p * p[-1]) % MODULUS])
    return p[:count]


class Stream:
    """One dbgen column stream: base seed + uses-per-row.

    ``values(n_rows, use_index)`` returns, for every row, the stream value at
    the ``use_index``-th draw within the row (1-based), i.e. the value dbgen's
    RANDOM() would produce for that column at that row.
    """

    def __init__(self, seed: int, uses_per_row: int):
        self.seed = seed
        self.uses_per_row = uses_per_row

    def row_start_exponents(self, n_rows: int, first_row: int = 0) -> np.ndarray:
        # exponent of 16807 already consumed before row i begins
        return (np.arange(first_row, first_row + n_rows, dtype=np.int64)
                * self.uses_per_row)

    def values(self, n_rows: int, use_index: int = 1, first_row: int = 0) -> np.ndarray:
        """Stream value for draw #use_index (1-based) of each row."""
        assert 1 <= use_index <= self.uses_per_row
        from .. import native
        nv = native.lcg_values(self.seed, self.uses_per_row, use_index,
                               first_row, n_rows)
        if nv is not None:
            return nv
        base = (self.seed * _pow_mod(MULTIPLIER, first_row * self.uses_per_row + use_index)) % MODULUS
        jump = _pow_mod(MULTIPLIER, self.uses_per_row)
        # seeds_i = base * jump^i mod M for i in [0, n_rows)
        jp = _jump_powers(jump, n_rows)
        return (base * jp) % MODULUS

    def all_values(self, n_rows: int, first_row: int = 0) -> np.ndarray:
        """[n_rows, uses_per_row] matrix of all draws per row."""
        from .. import native
        nv = native.lcg_matrix(self.seed, self.uses_per_row, first_row,
                               n_rows)
        if nv is not None:
            return nv
        cols = [self.values(n_rows, u, first_row) for u in range(1, self.uses_per_row + 1)]
        return np.stack(cols, axis=1)


def _jump_powers(jump: int, count: int) -> np.ndarray:
    """[jump^0, ..., jump^(count-1)] mod M via doubling."""
    if count <= 0:
        return np.zeros(0, dtype=np.int64)
    p = np.array([1], dtype=np.int64)
    j = jump % MODULUS
    while len(p) < count:
        step = (p[-1] * j) % MODULUS  # jump^len
        p = np.concatenate([p, (p * step) % MODULUS])
    return p[:count]


def bounded_int(raw: np.ndarray, low: int, high: int) -> np.ndarray:
    """dbgen UnifInt: low + (int)((seed / 2147483647.0) * (high - low + 1)).

    Mirrors the exact double-precision arithmetic of the C and Java
    generators (divide first, then scale, then truncate toward zero).
    """
    rng = float(high - low + 1)
    return (low + ((raw.astype(np.float64) / _DM) * rng).astype(np.int64))


def stream_bounded(stream: Stream, n_rows: int, low: int, high: int,
                   use_index: int = 1, first_row: int = 0) -> np.ndarray:
    return bounded_int(stream.values(n_rows, use_index, first_row), low, high)


class ScalarStream:
    """Sequential (non-vectorized) view of a stream — used by the text-pool
    builder, which is inherently sequential grammar expansion."""

    def __init__(self, seed: int):
        self.value = seed

    def next_raw(self) -> int:
        self.value = (self.value * MULTIPLIER) % MODULUS
        return self.value

    def bounded(self, low: int, high: int) -> int:
        v = self.next_raw()
        return int(low + ((v / _DM) * (high - low + 1)))
