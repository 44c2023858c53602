"""The TPC-H free-text pool (spec 4.2.2.10), frozen from the program's
generator: grammar-expanded sentences from one LCG stream, built once and
served to every comment column as a substring.

The pool is 8 MiB of pure-Python grammar expansion (about 2 s), so it is
kept in ``build/perfbench/`` inside the checkout after the first build.
"""

from __future__ import annotations

import os

import numpy as np

from . import words

POOL_SIZE = 8 * 1024 * 1024
POOL_SEED = 933588178
MODULUS = 2147483647
MULTIPLIER = 16807

_CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "build", "perfbench")


class _ScalarStream:
    """dbgen's LCG drawn one value at a time (UnifInt bounds)."""

    def __init__(self, seed: int):
        self.value = seed

    def bounded(self, low: int, high: int) -> int:
        self.value = (self.value * MULTIPLIER) % MODULUS
        return int(low + ((self.value / float(MODULUS)) * (high - low + 1)))


def build_pool(pool_size: int = POOL_SIZE, seed: int = POOL_SEED) -> np.ndarray:
    """Grammar-expand sentences until the pool holds ``pool_size`` bytes."""
    rng = _ScalarStream(seed)
    nouns, verbs, adjs, advs = (words.NOUNS, words.VERBS, words.ADJECTIVES,
                                words.ADVERBS)
    preps, auxes, terms, arts = (words.PREPOSITIONS, words.AUXILIARIES,
                                 words.TERMINATORS, words.ARTICLES)

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
            s = (noun_phrase() + " " + verb_phrase() + " " + pick(preps)
                 + " " + noun_phrase())
        elif k == 2:
            s = noun_phrase() + " " + verb_phrase() + " " + noun_phrase()
        elif k == 3:
            s = (noun_phrase() + " " + pick(preps) + " " + verb_phrase()
                 + " " + noun_phrase())
        else:
            s = (noun_phrase() + " " + pick(preps) + " " + verb_phrase()
                 + " " + pick(preps) + " " + noun_phrase())
        return s + pick(terms)

    chunks, size = [], 0
    while size < pool_size:
        s = sentence() + " "
        chunks.append(s)
        size += len(s)
    return np.frombuffer("".join(chunks)[:pool_size].encode("ascii"),
                         dtype=np.uint8)


def get_pool(pool_size: int = POOL_SIZE) -> np.ndarray:
    """The pool, from ``build/perfbench/`` when an earlier run left it
    there whole."""
    path = os.path.join(_CACHE_DIR, f"textpool_{pool_size}.bin")
    if os.path.exists(path) and os.path.getsize(path) == pool_size:
        return np.fromfile(path, dtype=np.uint8)
    pool = build_pool(pool_size)
    os.makedirs(_CACHE_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    pool.tofile(tmp)
    os.replace(tmp, path)
    return pool
