"""The port's MATCH_RECOGNIZE on the CPU at SF0.01, against the JAX
package and a regex oracle.

- the five tests of ``tests/test_match_recognize.py`` through the port,
  with their own checks, but for ``match_number()``, which the port
  counts within each partition (Trino's definition) and the JAX package
  across the whole input: the port's numbers are held to a per-partition
  regex oracle, and shown beside the JAX package's;
- ``MR_SQL`` (ONE ROW PER MATCH) and ``MR_ALL_SQL`` (ALL ROWS PER MATCH)
  equal to the JAX package column by column, ``mno`` aside;
- ``ops/pattern.py``: the DFA tables, ``match_lengths`` and
  ``select_matches`` equal to the JAX functions over seeded codes and
  partitions (one long partition, partitions of one row, random sizes).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_match_recognize as TM
import tpch_oracle as O
from presto_tpu.exec.runner import LocalRunner as JaxRunner
from presto_tpu.ops import pattern as JP
from presto_tpu_torch.exec.runner import LocalRunner
from presto_tpu_torch.ops import pattern as TP

SF = 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch's CPU ops on one thread while this module runs: beside the
    other test workers, each on its own cores, a pool of threads per
    worker spins and slows the whole run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def port() -> LocalRunner:
    return LocalRunner(scale_factor=SF, device="cpu")


@functools.lru_cache(maxsize=None)
def ref() -> JaxRunner:
    return JaxRunner(scale_factor=SF)


@functools.lru_cache(maxsize=None)
def run(engine: str, sql: str) -> dict:
    r = port() if engine == "port" else ref()
    return {n: c.to_pylist() for n, c in r.run_sql(sql).columns.items()}


# ---------------------------------------------------------------- SQL

@pytest.mark.parametrize("name", ["test_quantifiers_and_alternation",
                                  "test_matches_stay_inside_partitions",
                                  "test_explain_renders",
                                  "test_all_rows_per_match"])
def test_match_recognize_checks(name):
    """``tests/test_match_recognize.py``'s test, its own checks, run
    through the port."""
    getattr(TM, name)(port())


def test_v_shape_vs_regex_oracle():
    """``test_match_recognize.test_v_shape_vs_regex_oracle``'s checks, with
    ``match_number()`` held to the oracle's per-partition numbering (the
    JAX package's test asserts one increasing sequence over all
    partitions)."""
    got = run("port", TM.MR_SQL)
    o = O.load("orders", SF)
    want = TM._oracle_matches(o[o.o_custkey <= 10_000], r"D+U+")
    assert len(got["c"]) == len(want)
    assert sorted(zip(got["c"], got["mlen"], got["fp"], got["lp"])) == \
        sorted((w["c"], w["len"], w["fp"], w["lp"]) for w in want)
    numbered, seen = [], {}
    for w in want:  # the oracle's matches: by partition, in order
        seen[w["c"]] = seen.get(w["c"], 0) + 1
        numbered.append((w["c"], seen[w["c"]], w["fp"], w["lp"]))
    assert sorted(zip(got["c"], got["mno"], got["fp"], got["lp"])) == \
        sorted(numbered)
    assert min(got["mno"]) == 1


def _numbered_per_partition(got: dict, want: dict) -> None:
    """The port numbers each partition's matches from 1; the JAX package
    numbers every match of the input in one sequence (``jnp.cumsum`` over
    all rows), so its number is the port's plus the matches of the
    partitions before."""
    before, last, prev_c = 0, 0, None
    for c, mine, theirs in zip(got["c"], got["mno"], want["mno"]):
        if c != prev_c:
            before += last
            prev_c, last = c, 0
        last = max(last, mine)
        assert theirs == before + mine
    assert max(want["mno"]) > max(got["mno"])


@pytest.mark.parametrize("sql", ["MR_SQL", "MR_ALL_SQL"])
def test_equals_jax_but_match_number(sql):
    got = run("port", getattr(TM, sql))
    want = run("jax", getattr(TM, sql))
    assert list(got) == list(want)
    for c in got:
        if c != "mno":
            assert got[c] == want[c], c
    _numbered_per_partition(got, want)


def test_match_number_per_partition():
    """ONE ROW PER MATCH: customer 1's matches are numbered 1, 2, ... by
    the port and by the JAX package; every later customer's start again
    from 1 in the port and go on counting in the JAX package."""
    got = run("port", TM.MR_SQL)
    want = run("jax", TM.MR_SQL)
    _numbered_per_partition(got, want)
    firsts = [m for c, m, p in zip(got["c"], got["mno"],
                                   [None] + got["c"][:-1]) if c != p]
    assert set(firsts) == {1} and len(firsts) > 1
    assert want["mno"] == list(range(1, len(want["mno"]) + 1))


# ---------------------------------------------------------------- ops

PATTERNS = {
    "v_shape": (JP.Seq((JP.Quant(JP.Sym("d"), "+"),
                        JP.Quant(JP.Sym("u"), "+"))), ["d", "u"]),
    "alternation": (JP.Alt((JP.Seq((JP.Sym("d"), JP.Sym("u"))),
                            JP.Seq((JP.Sym("d"), JP.Sym("d"))))),
                    ["d", "u"]),
    "optional_star": (JP.Seq((JP.Sym("a"), JP.Quant(JP.Sym("b"), "?"),
                              JP.Quant(JP.Sym("c"), "*"))), ["a", "b", "c"]),
}
N = 400
WINDOW = 32


def _port_node(node):
    """A JAX package pattern AST as the port's (same classes, fields)."""
    if isinstance(node, JP.Sym):
        return TP.Sym(node.name)
    if isinstance(node, JP.Seq):
        return TP.Seq(tuple(_port_node(p) for p in node.parts))
    if isinstance(node, JP.Alt):
        return TP.Alt(tuple(_port_node(p) for p in node.options))
    return TP.Quant(_port_node(node.arg), node.kind)


def _layout(kind: str, rng) -> np.ndarray:
    """new_part flags: one partition, N partitions of one row, or random
    partition sizes 1-30."""
    new = np.zeros(N, bool)
    new[0] = True
    if kind == "singletons":
        new[:] = True
    elif kind == "random":
        cuts = np.cumsum(rng.integers(1, 31, N))
        new[cuts[cuts < N]] = True
    return new


LAYOUTS = ["one_long", "singletons", "random"]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_match_and_select_equal_jax(pattern, layout):
    node, symbols = PATTERNS[pattern]
    rng = np.random.default_rng(
        10 * list(PATTERNS).index(pattern) + LAYOUTS.index(layout))
    new_part = _layout(layout, rng)
    # the symbols' predicates hold often enough for long runs
    codes = rng.integers(0, 1 << len(symbols), N).astype(np.int32)
    mask = np.ones(N, bool)
    mask[N - rng.integers(0, 20):] = False  # masked-out rows sort last
    codes[~mask] = -1
    jpat = JP.compile_pattern(node, symbols)
    tpat = TP.compile_pattern(_port_node(node), symbols)
    np.testing.assert_array_equal(jpat.table, tpat.table)
    np.testing.assert_array_equal(jpat.accepting, tpat.accepting)
    want = np.asarray(JP.match_lengths(jnp.asarray(codes),
                                       jnp.asarray(new_part), jpat, WINDOW))
    got = TP.match_lengths(torch.from_numpy(codes),
                           torch.from_numpy(new_part), tpat, WINDOW)
    np.testing.assert_array_equal(got.numpy(), want)
    # a one-row partition holds no match of two rows or more
    assert want.max() <= 1 if layout == "singletons" else want.max() > 0
    sel_want = np.asarray(JP.select_matches(jnp.asarray(want),
                                            jnp.asarray(mask)))
    sel = TP.select_matches(got, torch.from_numpy(mask),
                            torch.from_numpy(new_part))
    np.testing.assert_array_equal(sel.numpy(), sel_want)


def test_match_lengths_stop_early_with_the_same_lengths():
    """Every DFA copy dies within a few rows here, so the steps stop long
    before the window, with the lengths of all ``window`` steps."""
    node, symbols = PATTERNS["v_shape"]
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, N).astype(np.int32)
    new_part = _layout("random", rng)
    pat = TP.compile_pattern(_port_node(node), symbols)
    reads = []

    def read(t):
        reads.append(1)
        return int(t.item())
    got = TP.match_lengths(torch.from_numpy(codes),
                           torch.from_numpy(new_part), pat, 256, read)
    want = JP.match_lengths(jnp.asarray(codes), jnp.asarray(new_part),
                            JP.compile_pattern(node, symbols), 256)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 1 <= len(reads) < 256 // TP.STEPS_PER_CHECK
