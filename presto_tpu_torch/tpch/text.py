"""TPC-H grammar text pool + vectorized comment-column extraction.

The spec (4.2.2.10) defines free text as grammar-generated sentences; dbgen
materializes one large text pool once and serves every comment column as a
random substring of it.  We do the same: the pool is built once per process
(grammar expansion, deterministic), and comment columns are produced as a
vectorized gather of (offset, length) substrings — no per-row Python.

Reference behavior consumed via ``plugin/trino-tpch`` (generator dep,
``plugin/trino-tpch/pom.xml:21``); reimplemented from the public spec.
"""

from __future__ import annotations

import numpy as np

from . import words
from .rng import ScalarStream

DEFAULT_POOL_SIZE = 8 * 1024 * 1024  # smaller than dbgen's 300MB; configurable

_POOL_CACHE: dict = {}


def _build_pool(pool_size: int, seed: int = 933588178) -> np.ndarray:
    """Grammar-expand sentences until the pool reaches ``pool_size`` bytes."""
    rng = ScalarStream(seed)
    nouns, verbs, adjs, advs = words.NOUNS, words.VERBS, words.ADJECTIVES, words.ADVERBS
    preps, auxes, terms, arts = (
        words.PREPOSITIONS, words.AUXILIARIES, words.TERMINATORS, words.ARTICLES,
    )

    def pick(lst):
        return lst[rng.bounded(0, len(lst) - 1)]

    def noun_phrase():
        k = rng.bounded(0, 3)
        if k == 0:
            return pick(nouns)
        if k == 1:
            return pick(adjs) + " " + pick(nouns)
        if k == 2:
            return pick(adjs) + ", " + pick(adjs) + " " + pick(nouns)
        return pick(arts) + " " + pick(adjs) + " " + pick(nouns)

    def verb_phrase():
        k = rng.bounded(0, 3)
        if k == 0:
            return pick(verbs)
        if k == 1:
            return pick(auxes) + " " + pick(verbs)
        if k == 2:
            return pick(verbs) + " " + pick(advs)
        return pick(auxes) + " " + pick(verbs) + " " + pick(advs)

    def sentence():
        k = rng.bounded(0, 4)
        if k == 0:
            s = noun_phrase() + " " + verb_phrase()
        elif k == 1:
            s = noun_phrase() + " " + verb_phrase() + " " + pick(preps) + " " + noun_phrase()
        elif k == 2:
            s = noun_phrase() + " " + verb_phrase() + " " + noun_phrase()
        elif k == 3:
            s = noun_phrase() + " " + pick(preps) + " " + verb_phrase() + " " + noun_phrase()
        else:
            s = noun_phrase() + " " + pick(preps) + " " + verb_phrase() + " " + pick(preps) + " " + noun_phrase()
        return s + pick(terms)

    chunks = []
    size = 0
    while size < pool_size:
        s = sentence() + " "
        chunks.append(s)
        size += len(s)
    pool = "".join(chunks)[:pool_size]
    return np.frombuffer(pool.encode("ascii"), dtype=np.uint8)


def get_pool(pool_size: int = DEFAULT_POOL_SIZE) -> np.ndarray:
    if pool_size not in _POOL_CACHE:
        _POOL_CACHE[pool_size] = _load_or_build(pool_size)
    return _POOL_CACHE[pool_size]


def _load_or_build(pool_size: int) -> np.ndarray:
    """Disk-cache the pool (grammar expansion is ~2s of pure Python;
    dbgen amortizes the same way by building its pool once)."""
    import os
    import tempfile
    cache = os.path.join(tempfile.gettempdir(),
                         f"presto_tpu_textpool_{pool_size}.bin")
    try:
        if os.path.exists(cache) and os.path.getsize(cache) == pool_size:
            return np.fromfile(cache, dtype=np.uint8)
    except OSError:
        pass
    pool = _build_pool(pool_size)
    try:
        tmp = cache + f".tmp{os.getpid()}"
        pool.tofile(tmp)
        os.replace(tmp, cache)
    except OSError:
        pass
    return pool


def substrings(offsets: np.ndarray, lengths: np.ndarray, max_len: int,
               pool: np.ndarray = None):
    """Vectorized substring gather: returns (values[N, max_len], lengths[N])."""
    if pool is None:
        pool = get_pool()
    offsets = offsets % (len(pool) - max_len)
    from .. import native
    nv = native.gather_substrings(pool, offsets.astype(np.int64),
                                  lengths.astype(np.int64), max_len)
    if nv is not None:
        return nv, lengths.astype(np.int32)
    idx = offsets[:, None] + np.arange(max_len, dtype=np.int64)[None, :]
    vals = pool[idx]
    mask = np.arange(max_len)[None, :] < lengths[:, None]
    vals = np.where(mask, vals, np.uint8(0))
    return vals.astype(np.uint8), lengths.astype(np.int32)
