"""The port's nested values on the CPU at SF0.01: ARRAY, MAP and ROW
columns, UNNEST, array_agg/map_agg/histogram and min(x, n)/max(x, n).

- ``ops/arrays.py`` against the JAX package's helpers over seeded numpy
  ``[N, W]`` inputs (W up to 8, lengths 0..W, NULL rows);
- each array function through the port's ``eval_expr`` against the JAX
  package's, over the same seeded numeric columns (``dcol_from_arrays``);
- the reference's own batteries through the port's runner, with their
  own asserts: the ARRAYS entries of ``tests/test_function_matrix.py``,
  ``tests/test_arrays.py``, ``tests/test_row_type.py``, the RLE engine
  test and ``tests/test_regressions_r3.py``'s nested tests;
- the JAX package's nested-value faults the port does not copy (a-h),
  each held to Python or Trino's documented result with the JAX
  package's value asserted beside it;
- the layout plumbing: UNION ALL, joins, LIMIT, GROUPING SETS, memory
  tables and the byte count carrying nested columns; a nested key
  refused;
- a budget small enough to partition and the streamed path equal to the
  free path, and the card's ``nested`` statements equal to their oracle.

Tolerance 0 throughout.  Each JAX statement runs once.
"""

import functools
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_arrays as TA
import test_function_matrix as FM
import test_regressions_r3 as R3
import test_rle as RLE
import test_row_type as TR
from presto_tpu.data import types as JT
from presto_tpu.exec import columns as JC
from presto_tpu.exec import expreval as JE
from presto_tpu.exec import physical as JP
from presto_tpu.sql import ir as JIR
from presto_tpu_torch.data import types as T
from presto_tpu_torch.data.column import (ARRAY, MAP, Column, rle_column)
from presto_tpu_torch.data.table import Table
from presto_tpu_torch.exec import columns as C
from presto_tpu_torch.exec import expreval as E
from presto_tpu_torch.exec.runner import LocalRunner
from presto_tpu_torch.ops import arrays as AR
from presto_tpu_torch.sql import ir
from presto_tpu_torch.utils.memory import col_bytes
from test_torch_aggregates import _cols, _one_torch_thread, port, ref  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import np_tpch_oracle as NO  # noqa: E402

SF = 0.01


def _one(sql: str, runner=None):
    """The first row of a statement through the port, by column."""
    d = (runner or port()).run_sql(sql).to_pydict()
    return {k: v[0] for k, v in d.items()}


# ---------------------------------------------------------------- inputs

N, W = 96, 8


def _arrays(seed: int, hi: int = 10, w: int = W):
    """Seeded [N, w] int64 elements in [0, hi), lengths 0..w (padding
    filled with noise), a validity with NULL rows."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, hi, (N, w), dtype=np.int64)
    lens = rng.integers(0, w + 1, N).astype(np.int32)
    valid = rng.random(N) > 0.15
    return vals, lens, valid


def _ns(vals, lens, valid=None):
    return types.SimpleNamespace(values=vals, lengths=lens, validity=valid)


def _rows(vals, lens):
    return [list(v[:n]) for v, n in zip(vals.tolist(), lens.tolist())]


# ---------------------------------------------------------------- ops

@pytest.mark.parametrize("seed", [1, 2])
def test_pos_grid_and_member_mask_equal_jax(seed):
    va, la, _ = _arrays(seed)
    vb, lb, _ = _arrays(seed + 10, w=5)
    np.testing.assert_array_equal(
        AR.pos_grid(W, torch.from_numpy(la)).numpy(),
        np.asarray(JE._pos_grid(W, jnp.asarray(la))))
    ina, mem = AR.member_mask(*map(torch.from_numpy, (va, la, vb, lb)))
    jina, jmem = JE._array_member_mask(
        _ns(jnp.asarray(va), jnp.asarray(la)),
        _ns(jnp.asarray(vb), jnp.asarray(lb)))
    np.testing.assert_array_equal(ina.numpy(), np.asarray(jina))
    np.testing.assert_array_equal(mem.numpy(), np.asarray(jmem))


def test_first_occurrence_and_compaction_equal_jax():
    vals, lens, valid = _arrays(3, hi=4)
    within = AR.pos_grid(W, torch.from_numpy(lens))
    first = AR.first_occurrence(torch.from_numpy(vals), within)
    jfirst = JE._array_first_occurrence(jnp.asarray(vals),
                                        jnp.asarray(within.numpy()))
    np.testing.assert_array_equal(first.numpy(), np.asarray(jfirst))
    pos, ln = AR.compact_order(first)
    got = AR.take_rows(torch.from_numpy(vals), pos).numpy()
    jsel = JE._array_select(
        JC.DCol(JT.array(JT.BIGINT), "array", jnp.asarray(vals),
                jnp.asarray(lens)), jfirst, JT.array(JT.BIGINT))
    np.testing.assert_array_equal(ln.numpy(), np.asarray(jsel.lengths))
    assert _rows(got, ln.numpy()) == _rows(np.asarray(jsel.values),
                                           np.asarray(jsel.lengths))
    # the first occurrences, in order
    assert _rows(got, ln.numpy()) == [list(dict.fromkeys(r))
                                      for r in _rows(vals, lens)]


def test_sort_distinct_extreme_against_python():
    vals, lens, _ = _arrays(4, hi=6)
    k, ln = torch.from_numpy(vals), torch.from_numpy(lens)
    rows = _rows(vals, lens)
    for desc in (False, True):
        got = AR.take_rows(k, AR.sort_order(k, ln, desc)).numpy()
        assert _rows(got, lens) == [sorted(r, reverse=desc) for r in rows]
    pos, dl = AR.distinct_order(k, ln)
    assert _rows(AR.take_rows(k, pos).numpy(), dl.numpy()) == \
        [list(dict.fromkeys(r)) for r in rows]
    for largest, f in ((False, min), (True, max)):
        p = AR.extreme_pos(k, ln, largest).numpy()
        assert [r[i] if r else None for r, i in zip(rows, p)] == \
            [f(r) if r else None for r in rows]
        # the first element at the extreme
        assert all(r.index(r[i]) == i for r, i in zip(rows, p) if r)


def test_group_positions_and_pack_equal_jax():
    rng = np.random.default_rng(5)
    n, cap = 300, 40
    slot = rng.integers(-1, cap, n).astype(np.int32)
    keep = (rng.random(n) > 0.2) & (slot >= 0)
    vals = rng.integers(-10**12, 10**12, n)
    pos, counts = AR.group_positions(torch.from_numpy(slot),
                                     torch.from_numpy(keep), cap)
    jpos, jcounts = JP._group_positions(jnp.asarray(slot), jnp.asarray(keep),
                                        cap)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(pos.numpy()[keep], np.asarray(jpos)[keep])
    width = int(counts.max())
    got = AR.group_pack(torch.from_numpy(vals), torch.from_numpy(slot), pos,
                        torch.from_numpy(keep), cap, width).numpy()
    want = np.asarray(JP._group_pack_kernel(
        jnp.asarray(vals), jnp.asarray(slot), jpos, jnp.asarray(keep), cap,
        width))
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------ the evaluator
# against the JAX package's, over the same seeded numeric arrays

def _jax_array(vals, lens, valid, t=JT.BIGINT):
    return JC.DCol(JT.array(t), "array", jnp.asarray(vals), jnp.asarray(lens),
                   jnp.asarray(valid))


def _host(c) -> list:
    """Each row's value of a result column of either package (None where
    NULL): lists for ARRAY, dicts for MAP, strings for DICT."""
    n = int(np.asarray(c.values).shape[0])
    valid = np.ones(n, bool) if c.validity is None else \
        np.asarray(c.validity).astype(bool)
    vals = np.asarray(c.values)
    if c.kind in (ARRAY, MAP):
        lens = np.asarray(c.lengths)
        rows = _rows(vals, lens)
        if c.kind == MAP:
            rows = [dict(zip(k, v)) for k, v in
                    zip(rows, _rows(np.asarray(c.values2), lens))]
    elif c.kind == "dict":
        rows = [str(c.dictionary.strings[x]) for x in vals]
    else:
        rows = vals.tolist()
    return [r if ok else None for r, ok in zip(rows, valid)]


@functools.lru_cache(maxsize=None)
def _eval_inputs():
    """Both packages' chunks over the same columns: arrays a and b, an
    index column i (0 and out-of-range included), a probe x."""
    va, la, ka = _arrays(6)
    vb, lb, kb = _arrays(7, w=5)
    rng = np.random.default_rng(8)
    idx = rng.integers(-W - 2, W + 3, N)
    x = rng.integers(0, 10, N)
    xv = rng.random(N) > 0.1
    jcols = {"a": _jax_array(va, la, ka), "b": _jax_array(vb, lb, kb),
             "i": JC.DCol(JT.BIGINT, "plain", jnp.asarray(idx)),
             "x": JC.DCol(JT.BIGINT, "plain", jnp.asarray(x),
                          validity=jnp.asarray(xv))}
    jchunk = JC.Chunk(jcols, jnp.ones((N,), bool))
    tchunk = C.Chunk({k: C.dcol_from_arrays(v, "cpu")
                      for k, v in jcols.items()},
                     torch.ones((N,), dtype=torch.bool))
    return jchunk, tchunk


def _both(name, args, jt, tt, lits=()):
    """One function over the chunk's columns in both packages: (port's
    rows, JAX's rows)."""
    jchunk, tchunk = _eval_inputs()
    types_ = {"a": (JT.array(JT.BIGINT), T.array(T.BIGINT)),
              "b": (JT.array(JT.BIGINT), T.array(T.BIGINT)),
              "i": (JT.BIGINT, T.BIGINT), "x": (JT.BIGINT, T.BIGINT)}
    jargs = tuple(JIR.ColumnRef(a, types_[a][0]) for a in args) + tuple(
        JIR.Literal(v, t) for v, t, _ in lits)
    targs = tuple(ir.ColumnRef(a, types_[a][1]) for a in args) + tuple(
        ir.Literal(v, t) for v, _, t in lits)
    got = E.eval_expr(ir.Func(name, targs, tt), tchunk)
    want = JE.eval_expr(JIR.Func(name, jargs, jt), jchunk)
    return _host(got), _host(want)


ARR = (JT.array(JT.BIGINT), T.array(T.BIGINT))
EVAL = {
    "cardinality": (("a",), (JT.BIGINT, T.BIGINT), ()),
    "element_at": (("a", "i"), (JT.BIGINT, T.BIGINT), ()),
    "contains": (("a", "x"), (JT.BOOLEAN, T.BOOLEAN), ()),
    "array_position": (("a", "x"), (JT.BIGINT, T.BIGINT), ()),
    "array_min": (("a",), (JT.BIGINT, T.BIGINT), ()),
    "array_max": (("a",), (JT.BIGINT, T.BIGINT), ()),
    "array_sort": (("a",), ARR, ()),
    "arrays_overlap": (("a", "b"), (JT.BOOLEAN, T.BOOLEAN), ()),
    "array_except": (("a", "b"), ARR, ()),
    "array_intersect": (("a", "b"), ARR, ()),
    "array_union": (("a", "b"), ARR, ()),
    "slice": (("a",), ARR, ((2, JT.BIGINT, T.BIGINT),
                            (3, JT.BIGINT, T.BIGINT))),
    "array_join": (("a",), (JT.VARCHAR, T.VARCHAR),
                   (("+", JT.VARCHAR, T.VARCHAR),)),
    "repeat": (("x",), ARR, ((3, JT.BIGINT, T.BIGINT),)),
    "map_pack": (("a", "b"), (JT.map_(JT.BIGINT, JT.BIGINT),
                              T.map_(T.BIGINT, T.BIGINT)), ()),
}


@pytest.mark.parametrize("name", EVAL)
def test_array_function_equals_jax(name):
    args, (jt, tt), lits = EVAL[name]
    got, want = _both(name, args, jt, tt, lits)
    if name in ("array_except", "array_intersect"):
        # a NULL second argument makes the result NULL (Trino); the JAX
        # package keeps the first argument's validity alone
        b = _host(_eval_inputs()[0].cols["b"])
        assert all(g is None for g, y in zip(got, b) if y is None)
        got, want = ([v for v, y in zip(r, b) if y is not None]
                     for r in (got, want))
    assert got == want


def test_array_distinct_against_python_and_jax():
    """Numbers too: the port keeps the first occurrences in order
    (Trino), the JAX package returns them sorted (fault a)."""
    got, want = _both("array_distinct", ("a",), *ARR, ())
    jchunk, _ = _eval_inputs()
    rows = _host(jchunk.cols["a"])
    assert got == [None if r is None else list(dict.fromkeys(r))
                   for r in rows]
    assert want == [None if r is None else sorted(set(r)) for r in rows]


def test_map_functions_equal_jax():
    """map_keys, map_values and map_element_at over the MAP of (a, b)
    keys and values (a repeated key answers its first value)."""
    jchunk, tchunk = _eval_inputs()
    mt = (JT.map_(JT.BIGINT, JT.BIGINT), T.map_(T.BIGINT, T.BIGINT))
    jm = JE.eval_expr(JIR.Func("map_pack", (
        JIR.ColumnRef("a", ARR[0]), JIR.ColumnRef("b", ARR[0])), mt[0]),
        jchunk)
    tm = E.eval_expr(ir.Func("map_pack", (
        ir.ColumnRef("a", ARR[1]), ir.ColumnRef("b", ARR[1])), mt[1]),
        tchunk)
    jchunk = JC.Chunk(dict(jchunk.cols, m=jm), jchunk.mask)
    tchunk = C.Chunk(dict(tchunk.cols, m=tm), tchunk.mask)
    for name, extra, (jt, tt) in (
            ("map_keys", (), ARR), ("map_values", (), ARR),
            ("map_element_at", ("x",), (JT.BIGINT, T.BIGINT))):
        jargs = (JIR.ColumnRef("m", mt[0]),) + tuple(
            JIR.ColumnRef(a, JT.BIGINT) for a in extra)
        targs = (ir.ColumnRef("m", mt[1]),) + tuple(
            ir.ColumnRef(a, T.BIGINT) for a in extra)
        assert _host(E.eval_expr(ir.Func(name, targs, tt), tchunk)) == \
            _host(JE.eval_expr(JIR.Func(name, jargs, jt), jchunk)), name


def test_sequence_equals_jax():
    got, want = _both("sequence", (), *ARR, ((3, JT.BIGINT, T.BIGINT),
                                             (17, JT.BIGINT, T.BIGINT),
                                             (4, JT.BIGINT, T.BIGINT)))
    assert got == want == [[3, 7, 11, 15]] * N


def test_string_array_functions_against_python():
    """String elements are compared and ordered by string, across the
    dictionaries of the two operands (``split`` over r_name against a
    literal array): each result against Python."""
    names = port().run_sql("select r_name from region order by r_name"
                           ).to_pydict()["r_name"]
    got = port().run_sql(
        "select r_name, split(r_name, 'A') s, "
        "array_sort(split(r_name, 'A')) o, "
        "array_distinct(split(r_name, 'E')) d, "
        "array_min(split(r_name, 'I')) mn, array_max(split(r_name, 'I')) mx, "
        "contains(split(r_name, 'A'), 'SI') c, "
        "array_position(split(r_name, 'E'), 'UROP') p, "
        "array_intersect(split(r_name, 'A'), array['FRIC', 'SI', '']) i, "
        "array_except(split(r_name, 'A'), array['FRIC', '']) e, "
        "array_union(array['ST', 'Z'], split(r_name, 'A')) u, "
        "arrays_overlap(split(r_name, 'A'), array['MERIC', 'ST']) ov "
        "from region order by r_name").to_pydict()
    assert got["r_name"] == names
    for i, nm in enumerate(names):
        a, e, s = nm.split("A"), nm.split("E"), nm.split("I")
        assert got["s"][i] == a
        assert got["o"][i] == sorted(a)
        assert got["d"][i] == list(dict.fromkeys(e))
        assert (got["mn"][i], got["mx"][i]) == (min(s), max(s))
        assert got["c"][i] == ("SI" in a)
        assert got["p"][i] == (e.index("UROP") + 1 if "UROP" in e else 0)
        da = list(dict.fromkeys(a))
        assert got["i"][i] == [x for x in da if x in ("FRIC", "SI", "")]
        assert got["e"][i] == [x for x in da if x not in ("FRIC", "")]
        assert got["u"][i] == list(dict.fromkeys(["ST", "Z"] + a))
        assert got["ov"][i] == bool({"MERIC", "ST"} & set(a))


def test_split_of_bytes_and_dict_columns_against_python():
    """The byte-matrix split (one-byte delimiter, on the device) and the
    host split (a longer delimiter, a dictionary column) against
    ``str.split``, empty parts included."""
    got = port().run_sql(
        "select o_comment c, split(o_comment, ' ') a, split(o_comment, 'y ')"
        " b, o_orderpriority p, split(o_orderpriority, '-') d from orders "
        "where o_orderkey < 200 order by o_orderkey").to_pydict()
    assert got["a"] == [c.split(" ") for c in got["c"]]
    assert got["b"] == [c.split("y ") for c in got["c"]]
    assert got["d"] == [p.split("-") for p in got["p"]]
    assert _one("select split('', ',') a, split(',a,,', ',') b "
                "from region") == {"a": [""], "b": ["", "a", "", ""]}


def test_negative_slice_start_raises():
    with pytest.raises(NotImplementedError, match="slice"):
        _one("select slice(array[1, 2, 3], -2, 2) s from region")


# ------------------------------------------------------ the reference's
# batteries, their own asserts, through the port

@pytest.mark.parametrize("sql,want", FM.ARRAYS,
                         ids=[e for e, _ in FM.ARRAYS])
def test_function_matrix_arrays(sql, want):
    assert _one(f"select {sql} as v from region limit 1")["v"] == want


ARRAY_TESTS = [n for n in dir(TA) if n.startswith("test_")]
ROW_TESTS = [n for n in dir(TR) if n.startswith("test_")]
R3_TESTS = ["test_map_string_values_decode_through_value_dict",
            "test_map_agg_varchar_varchar",
            "test_unnest_null_array_emits_no_rows"]


@pytest.mark.parametrize("name", ARRAY_TESTS)
def test_arrays_battery(name):
    getattr(TA, name)(port())


@pytest.mark.parametrize("name", ROW_TESTS)
def test_row_type_battery(name):
    getattr(TR, name)(port())


@pytest.mark.parametrize("name", R3_TESTS)
def test_regressions_r3_nested(name):
    getattr(R3, name)(port())


def test_rle_queryable_through_engine(monkeypatch):
    """``tests/test_rle.py``'s engine test, its statements and asserts, on
    the port's runner, types and columns."""
    for attr, obj in (("LocalRunner", lambda scale_factor: port()),
                      ("T", T), ("Column", Column), ("Table", Table),
                      ("rle_column", rle_column)):
        monkeypatch.setattr(RLE, attr, obj)
    RLE.test_rle_queryable_through_engine()


# ------------------------------------------------------ the JAX package's
# faults, not copied: each held to Python / Trino, the JAX value beside

FAULTS = {
    # a. first occurrences in order, not sorted
    "distinct_order": ("select array_distinct(array[3, 1, 3, 2]) v "
                       "from region limit 1", [[3, 1, 2]], [[1, 2, 3]]),
    # b. strings sorted by string, not by insertion code
    "sort_strings": ("select array_sort(array['b', 'a', 'c']) v "
                     "from region limit 1", [["a", "b", "c"]],
                     [["b", "a", "c"]]),
    # c. the least string, not its code
    "min_string": ("select array_min(array['b', 'a', 'c']) v "
                   "from region limit 1", ["a"], [0]),
    # d. string elements compared by string across dictionaries
    "contains_across": ("select contains(array['b', 'a'], r_name) v "
                        "from region order by r_name", [False] * 5,
                        [True, True, False, False, False]),
    "union_across": ("select array_union(array['x', 'y'], array['y', 'z']) v"
                     " from region limit 1", [["x", "y", "z"]],
                     [["x", "y"]]),
    "overlap_across": ("select arrays_overlap(array['a'], split(r_name, 'A')) "
                       "v from region order by r_name", [False] * 5,
                       [True, True, True, False, False]),
    # e. max(x, n) of strings by string, not by code
    "max_n_strings": ("select max(n_name, 2) v from nation "
                      "group by n_regionkey order by n_regionkey",
                      [["MOZAMBIQUE", "MOROCCO"], ["UNITED STATES", "PERU"],
                       ["VIETNAM", "JAPAN"], ["UNITED KINGDOM", "RUSSIA"],
                       ["SAUDI ARABIA", "JORDAN"]],
                      [["MOZAMBIQUE", "MOROCCO"], ["UNITED STATES", "PERU"],
                       ["VIETNAM", "CHINA"], ["UNITED KINGDOM", "RUSSIA"],
                       ["SAUDI ARABIA", "JORDAN"]]),
}


@pytest.mark.parametrize("name", FAULTS)
def test_reference_fault_not_copied(name):
    sql, want, jax_value = FAULTS[name]
    assert port().run_sql(sql).to_pydict()["v"] == want
    assert ref().run_sql(sql).to_pydict()["v"] == jax_value


def test_max_n_strings_against_python():
    """Fault e's answer from Python over the nation names."""
    d = port().run_sql("select n_regionkey, n_name from nation").to_pydict()
    want = {}
    for k, nm in zip(d["n_regionkey"], d["n_name"]):
        want.setdefault(k, []).append(nm)
    got = port().run_sql("select n_regionkey k, max(n_name, 2) v, "
                         "min(n_name, 3) w from nation group by 1").to_pydict()
    for k, v, w in zip(got["k"], got["v"], got["w"]):
        assert v == sorted(want[k], reverse=True)[:2]
        assert w == sorted(want[k])[:3]


def test_union_all_pads_array_widths():
    """f. UNION ALL of arrays of different widths pads them (the JAX
    package's concat raises ``TypeError``)."""
    sql = ("select array[1, 2] a, map(array['k'], array['v']) m "
           "from region where r_regionkey = 0 union all "
           "select array[3, 4, 5] a, map(array['x', 'y'], array['vx', 'vy']) "
           "m from region where r_regionkey = 1")
    got = port().run_sql(sql).to_pydict()
    assert sorted(got["a"]) == [[1, 2], [3, 4, 5]]
    assert sorted(got["m"], key=len) == [{"k": "v"}, {"x": "vx", "y": "vy"}]
    with pytest.raises(TypeError):
        ref().run_sql(sql)


def test_nested_values_over_http():
    """g. The statement protocol renders an ARRAY as a JSON array, a MAP
    as an object keyed by text and a ROW as an array of its fields (the
    JAX package's ``_json_value`` raises on a list); the CLI prints
    them."""
    from presto_tpu.client.server import _json_value as jax_json
    from presto_tpu_torch.client import cli
    from presto_tpu_torch.client.api import connect
    from presto_tpu_torch.client.server import HttpClient, StatementServer
    sql = ("select array[1.5, 2.25] a, map(array[1, 2], array['x', 'y']) m,"
           " cast(row(7, 'q') as row(k bigint, s varchar)) r "
           "from region limit 1")
    srv = StatementServer(connect(scale_factor=SF, device="cpu"))
    try:
        cols, rows = HttpClient(srv.url).execute(sql)
    finally:
        srv.close()
    assert [c["name"] for c in cols] == ["a", "m", "r"]
    assert rows == [[["1.50", "2.25"], {"1": "x", "2": "y"}, [7, "q"]]]
    with pytest.raises(TypeError):
        jax_json([1, 2], "array(bigint)")
    assert cli._fmt({"k": 7, "s": "q"}, "row(k bigint,s varchar)") == \
        "{k=7, s=q}"
    assert cli._fmt({1: "x"}, "map(bigint,varchar(1))") == "{1=x}"


def test_dotted_alias_and_row_columns():
    """h. Only the planner's shredded ROW outputs fold: a dotted alias
    stays one column (the JAX package folds it into a ROW ``a``)."""
    sql = 'select r_regionkey as "a.b", r_name from region order by 1'
    assert list(port().run_sql(sql).columns) == ["a.b", "r_name"]
    assert list(ref().run_sql(sql).columns) == ["a", "r_name"]
    got = port().run_sql("select r_regionkey as \"x.y\", cast(row(r_regionkey,"
                         " r_name) as row(k bigint, n varchar)) r from region "
                         "order by 1").to_pydict()
    assert got["x.y"] == [0, 1, 2, 3, 4]
    assert [r["k"] for r in got["r"]] == got["x.y"]


# ------------------------------------------------------ layout plumbing

def test_nested_columns_through_joins_limits_and_tables():
    """An ARRAY and a MAP column as a join's payload, under LIMIT, stored
    in a memory table (uploaded again) and read back, and ``arbitrary``
    of a nested column, grouped and global."""
    r = port()
    by_region = r.run_sql(
        "select n_name, k, a from nation, (select r_regionkey k, "
        "split(r_name, 'A') a from region) q where n_regionkey = k "
        "order by n_name limit 7").to_pydict()
    regions = r.run_sql("select r_regionkey, r_name from region").to_pydict()
    name_of = dict(zip(regions["r_regionkey"], regions["r_name"]))
    assert len(by_region["a"]) == 7
    assert by_region["a"] == [name_of[k].split("A") for k in by_region["k"]]
    r.run_sql("drop table if exists nest_t")
    r.run_sql("create table nest_t as select r_regionkey k, "
              "split(r_name, 'A') a, map(array[r_regionkey], array[r_name]) m"
              " from region")
    try:
        got = r.run_sql("select k, cardinality(a) c, a, m[k] v, "
                        "element_at(a, 1) f from nest_t order by k").to_pydict()
        assert got["a"] == [name_of[k].split("A") for k in got["k"]]
        assert got["c"] == [len(x) for x in got["a"]]
        assert got["v"] == [name_of[k] for k in got["k"]]
        assert got["f"] == [x[0] for x in got["a"]]
        arb = r.run_sql("select k, arbitrary(a) x from nest_t group by k "
                        "order by k").to_pydict()
        assert arb["x"] == got["a"]
        one = _one("select arbitrary(m) x, count(*) n from nest_t "
                   "where k = 3", r)
        assert one == {"x": {3: name_of[3]}, "n": 1}
    finally:
        r.run_sql("drop table nest_t")


def test_grouping_sets_and_case_carry_nested_values():
    got = port().run_sql(
        "select n_regionkey k, array_agg(n_nationkey) a, "
        "case when n_regionkey = 1 then array_agg(n_name) "
        "else array['none'] end c from nation "
        "group by rollup(n_regionkey) order by k").to_pydict()
    nat = port().run_sql("select n_regionkey, n_nationkey, n_name "
                         "from nation").to_pydict()
    for k, a, c in zip(got["k"], got["a"], got["c"]):
        rows = [i for i, g in enumerate(nat["n_regionkey"])
                if k is None or g == k]
        assert a == [nat["n_nationkey"][i] for i in rows]
        assert c == ([nat["n_name"][i] for i in rows] if k == 1
                     else ["none"])


def test_nested_key_raises_naming_it():
    for sql in ("select split(r_name, 'A') s, count(*) c from region "
                "group by 1",
                "select r_name from region order by split(r_name, 'A')"):
        with pytest.raises(NotImplementedError, match="array"):
            port().run_sql(sql)


def test_map_agg_of_a_null_value_raises():
    """A MAP holds no NULL element: a NULL map_agg value raises rather than
    being stored as some value."""
    got = _one("select map_agg(r_regionkey, r_name) m from region "
               "where r_name <> 'ASIA'")
    assert sorted(got["m"]) == [0, 1, 3, 4]
    with pytest.raises(NotImplementedError, match="map_agg"):
        port().run_sql("select map_agg(r_regionkey, nullif(r_name, 'ASIA'))"
                       " m from region")


def test_col_bytes_counts_lengths_and_values2():
    m = C.DCol(T.map_(T.BIGINT, T.BIGINT), MAP,
               torch.zeros((10, 4), dtype=torch.int64),
               torch.zeros((10,), dtype=torch.int32),
               torch.ones((10,), dtype=torch.bool), None,
               torch.zeros((10, 4), dtype=torch.int64))
    assert col_bytes(m) == 320 + 40 + 10 + 320


# ------------------------------------------------------ tiers, streaming

BUDGETED = ("select o_custkey, array_agg(o_orderkey) a, "
            "histogram(o_orderpriority) h, max(o_totalprice, 2) m "
            "from orders group by o_custkey order by o_custkey")


def test_budgeted_equals_free():
    """Under a budget small enough to partition, the grouped nested
    aggregates run one hash partition at a time; each partition's widths
    differ, and the concatenation pads them: equal to the free path."""
    r = LocalRunner(scale_factor=SF, device="cpu",
                    device_budget_bytes=512 << 10)
    got = _cols(r.run_sql(BUDGETED))
    assert r.last_spill_partitions > 1
    assert got == _cols(port().run_sql(BUDGETED))


def test_streamed_nested_aggregate_runs_whole():
    """A nested aggregate has no mergeable state: a streamed plan holding
    one runs whole (``last_streamed`` False), equal to ``run_sql``."""
    sql = ("select o_orderpriority, histogram(o_orderstatus) h, "
           "min(o_orderdate, 2) d, count(*) c from orders group by 1 "
           "order by 1")
    r = port()
    got = _cols(r.run_sql_streaming(sql, slice_rows=5000))
    assert r.last_streamed is False
    assert got == _cols(r.run_sql(sql))


# ------------------------------------------------------ the slice as a
# whole: the card's ``nested`` statements at SF0.01

@functools.lru_cache(maxsize=None)
def _slice_oracle() -> dict:
    return NO.nested(NO.Tables(port().datasource))


@pytest.mark.parametrize("name", NO.NESTED)
def test_chip_statement_equals_its_oracle(name):
    assert _cols(port().run_sql(NO.NESTED[name])) == _slice_oracle()[name]
