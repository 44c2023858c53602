"""The port's string functions against the JAX package, SQLite's and
Trino's documented semantics, on the CPU at SF0.01.

- every STRING entry of ``tests/test_function_matrix.py`` (one case per
  expression) and the string tests of ``tests/test_functions.py``, run
  through the port's ``LocalRunner``;
- each function through both packages' ``eval_expr`` over the same
  seeded strings, in a DICT and in a BYTES layout (leading and trailing
  blanks, empty strings, NULLs, repeated dictionary entries, garbage past
  each byte row's length): the same strings byte for byte, the same
  integers, NULLs in the same rows;
- the JAX package's wrong answers that the port does not copy, each held
  to Trino's documented result, with the JAX package's value asserted
  beside it;
- ``split`` with a limit or an empty delimiter still raising
  ``NotImplementedError`` (the two-argument form returns an ARRAY).
"""

import functools
import string

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_function_matrix as FM
import test_functions as TF
from presto_tpu.data import types as JT
from presto_tpu.exec import columns as JC
from presto_tpu.exec import expreval as JE
from presto_tpu.sql import ir as JIR
from presto_tpu_torch.data import types as T
from presto_tpu_torch.exec import columns as TC
from presto_tpu_torch.exec import expreval as TE
from presto_tpu_torch.exec.runner import LocalRunner
from presto_tpu_torch.sql import ir

SF = 0.01


@functools.lru_cache(maxsize=None)
def port() -> LocalRunner:
    return LocalRunner(scale_factor=SF, device="cpu")


# ------------------------------------------------------ the SQL batteries

@pytest.mark.parametrize("sql,want", FM.STRING, ids=[s for s, _ in FM.STRING])
def test_function_matrix_entry(sql, want):
    FM._run_batch(port(), [(sql, want)])


@pytest.mark.parametrize("name", [
    "test_regex_like_extract_replace", "test_string_helpers",
    "test_json_extract_scalar"])
def test_scalar_breadth(name):
    getattr(TF.TestScalarBreadth(), name)(port())


def test_url_hex_base64_pad_functions():
    TF.test_url_hex_base64_pad_functions(port())


def test_split_part_of_a_column():
    """The ``split_part`` half of ``test_split_and_split_part`` (``split``
    waits for ARRAY columns), against the table's own value."""
    got = port().run_sql(
        "select o_orderpriority p, split_part(o_orderpriority, '-', 2) x "
        "from orders where o_orderkey = 1").to_pydict()
    assert got["x"] == [got["p"][0].split("-")[1]]


def test_split_still_raises():
    """``split`` returns an ARRAY now (nested values,
    ``tests/test_torch_nested.py``); its forms the JAX package lacks, a
    limit and an empty delimiter, still raise."""
    got = port().run_sql("select o_orderpriority p, split(o_orderpriority, "
                         "'-') a from orders where o_orderkey = 1"
                         ).to_pydict()
    assert got["a"] == [got["p"][0].split("-")]
    for sql in ("select split(o_orderpriority, '-', 2) a from orders",
                "select split(o_orderpriority, '') a from orders"):
        with pytest.raises(NotImplementedError, match="split"):
            port().run_sql(sql)


# ------------------------------------------------------ against the JAX
# package's evaluator, over the same seeded strings

def _strings(seed: int, n: int = 400):
    """Seeded ASCII strings with blanks at both ends, tabs and the
    separators Python strips, empty strings, repeats, commas, dashes and
    digits; and a NULL mask."""
    rng = np.random.default_rng(seed)
    alphabet = list(string.ascii_letters + string.digits + ",-_. ")
    base = ["".join(rng.choice(alphabet, rng.integers(0, 14)))
            for _ in range(60)]
    base += ["", " ", "  a b  ", "\tx\n", "\x1cy\x1f", "a,b,,c", "1-URGENT",
             "the theme", "abcabc", "ABC", "a"]
    strs = [base[i] if rng.random() < 0.6 else
            " " * rng.integers(0, 3) + base[i] + " " * rng.integers(0, 3)
            for i in rng.integers(0, len(base), n)]
    nulls = rng.random(n) < 0.1
    return strs, nulls


def _layout(mod, cmod, arr, strs, nulls, kind: str, dtype):
    """The strings as a DICT column over a dictionary with repeated
    entries, or a BYTES matrix with garbage past each row's length."""
    n = len(strs)
    valid = arr(~nulls)
    if kind == "dict":
        uniq = sorted(set(strs))
        dictionary = np.array(uniq + uniq[:5], dtype=object)  # repeats
        pos = {s: i for i, s in enumerate(uniq)}
        codes = np.array([pos[s] + (len(uniq) if pos[s] < 5 and i % 2 else 0)
                          for i, s in enumerate(strs)], dtype=np.int32)
        return cmod.DCol(dtype, "dict", arr(codes), validity=valid,
                         dictionary=cmod.Dictionary(dictionary))
    w = max(len(s) for s in strs) + 3
    rng = np.random.default_rng(n)
    vals = rng.integers(97, 123, (n, w)).astype(np.uint8)
    for i, s in enumerate(strs):
        vals[i, :len(s)] = np.frombuffer(s.encode(), np.uint8)
    lens = np.array([len(s) for s in strs], dtype=np.int32)
    return cmod.DCol(dtype, "bytes", arr(vals), arr(lens), valid)


def _decode(out, n: int):
    """(Python values, validity) of an evaluated column."""
    valid = np.ones(n, bool) if out.validity is None \
        else np.asarray(out.validity).astype(bool)
    vals = np.asarray(out.values)
    if out.kind == "dict":
        got = [str(out.dictionary.strings[c]) for c in vals]
    elif out.kind == "bytes":
        lens = np.asarray(out.lengths)
        got = [bytes(vals[i, :lens[i]]).decode("ascii") for i in range(n)]
    else:
        got = vals.tolist()
    return got, valid


def _both(name, rtype, lits=(), kind="dict", seed=3, data=None, cols=1):
    """``name(s[, s2], lits...)`` through both packages' evaluators over the
    same strings in layout ``kind``; ((JAX values, validity), (port
    values, validity))."""
    strs, nulls = data or _strings(seed)
    others = [_strings(seed + 10 + k) for k in range(cols - 1)]
    n = len(strs)

    def run(mod, irm, cmod, arr, ev):
        vt = mod.VARCHAR
        chunk = cmod.Chunk({"s": _layout(mod, cmod, arr, strs, nulls, kind,
                                         vt)}, arr(np.ones(n, bool)))
        for k, (s2, n2) in enumerate(others):
            chunk.cols[f"s{k + 2}"] = _layout(mod, cmod, arr, s2[:n], n2[:n],
                                              kind, vt)
        refs = [irm.ColumnRef("s", vt)] + [irm.ColumnRef(f"s{k + 2}", vt)
                                           for k in range(cols - 1)]
        refs += [irm.Literal(v, vt if isinstance(v, str) else mod.BIGINT)
                 for v in lits]
        rt = {"VARCHAR": vt, "BIGINT": mod.BIGINT,
              "BOOLEAN": mod.BOOLEAN}[rtype]
        return _decode(ev(irm.Func(name, tuple(refs), rt), chunk), n)

    return (run(JT, JIR, JC, jnp.asarray, JE.eval_expr),
            run(T, ir, TC, torch.from_numpy, TE.eval_expr))


CASES = {
    "trim": ("VARCHAR", ()), "ltrim": ("VARCHAR", ()),
    "rtrim": ("VARCHAR", ()), "reverse": ("VARCHAR", ()),
    "lpad": ("VARCHAR", (9, "*-")), "rpad": ("VARCHAR", (6, "xy")),
    "lpad_cut": ("VARCHAR", (3, "0")), "rpad_blank": ("VARCHAR", (12,)),
    "rpad_zero": ("VARCHAR", (0, "z")),
    "starts_with": ("BOOLEAN", ("a",)), "ends_with": ("BOOLEAN", ("c ",)),
    "starts_with_empty": ("BOOLEAN", ("",)),
    "ends_with_long": ("BOOLEAN", ("x" * 40,)),
    "strpos": ("BIGINT", ("b",)), "position": ("BIGINT", ("the",)),
    "strpos_empty": ("BIGINT", ("",)), "codepoint": ("BIGINT", ()),
    "replace": ("VARCHAR", ("a", "XY")), "replace_drop": ("VARCHAR", (" ",)),
    "translate": ("VARCHAR", ("abc", "x")),
    "split_part": ("VARCHAR", (",", 1)),
    "regexp_like": ("BOOLEAN", ("[0-9]{2}",)),
    "regexp_replace": ("VARCHAR", ("([a-c])([0-9])", "$2$1")),
    "to_hex": ("VARCHAR", ()), "to_base64": ("VARCHAR", ()),
    "url_encode": ("VARCHAR", ()), "normalize_space": ("VARCHAR", ()),
    "upper": ("VARCHAR", ()), "lower": ("VARCHAR", ()),
    "length": ("BIGINT", ()),
}


@pytest.mark.parametrize("kind", ["dict", "bytes"])
@pytest.mark.parametrize("case", CASES)
def test_function_equals_jax(case, kind):
    rtype, lits = CASES[case]
    name = case if case in TE._FUNCS else case.rsplit("_", 1)[0]
    (jv, jok), (tv, tok) = _both(name, rtype, lits, kind)
    assert np.array_equal(jok, tok)
    assert [v for v, ok in zip(jv, jok) if ok] == \
        [v for v, ok in zip(tv, tok) if ok]


@pytest.mark.parametrize("kind", ["dict", "bytes"])
def test_distances_equal_jax(kind):
    for name in ("levenshtein_distance", "hamming_distance"):
        (jv, jok), (tv, tok) = _both(name, "BIGINT", kind=kind, cols=2)
        assert np.array_equal(jok, tok), name
        assert np.array_equal(np.array(jv)[jok], np.array(tv)[tok]), name


@pytest.mark.parametrize("kind", ["dict", "bytes"])
def test_format_equals_jax(kind):
    strs, nulls = _strings(4)
    jr, tr = _format_both("<%s|%s>", strs, nulls, kind)
    assert jr == tr and sum(v is None for v in tr) == nulls.sum()


def _format_both(fmt, strs, nulls, kind):
    """``format(fmt, s, s)`` (the format string a literal, placed first)
    through both evaluators."""
    n = len(strs)

    def run(mod, irm, cmod, arr, ev):
        vt = mod.VARCHAR
        chunk = cmod.Chunk({"s": _layout(mod, cmod, arr, strs, nulls, kind,
                                         vt)}, arr(np.ones(n, bool)))
        e = irm.Func("format", (irm.Literal(fmt, vt), irm.ColumnRef("s", vt),
                                irm.ColumnRef("s", vt)), vt)
        v, ok = _decode(ev(e, chunk), n)
        return [x if k else None for x, k in zip(v, ok)]

    return (run(JT, JIR, JC, jnp.asarray, JE.eval_expr),
            run(T, ir, TC, torch.from_numpy, TE.eval_expr))


def test_codecs_round_trip_equal_jax():
    """``from_hex`` / ``from_base64`` of encoded strings, and the URL
    parts of seeded URLs, through both evaluators."""
    strs, nulls = _strings(5)
    for enc, dec in (("to_hex", "from_hex"), ("to_base64", "from_base64"),
                     ("url_encode", "url_decode")):
        (ev, eok), _ = _both(enc, "VARCHAR", data=(strs, nulls))
        coded = [v if ok else "" for v, ok in zip(ev, eok)]
        (jv, jok), (tv, tok) = _both(dec, "VARCHAR", data=(coded, nulls))
        assert np.array_equal(jok, tok) and jv == tv
        assert [v for v, ok in zip(tv, tok) if ok] == \
            [s for s, x in zip(strs, nulls) if not x]
    rng = np.random.default_rng(6)
    urls = [f"{rng.choice(['http', 'https', 'ftp'])}://h{rng.integers(9)}"
            f".example.com{':' + str(rng.integers(1, 9000)) if i % 3 else ''}"
            f"/p/{rng.integers(99)}{'?q=' + str(i) if i % 2 else ''}"
            for i in range(200)] + ["no-scheme", ""]
    unulls = np.zeros(len(urls), bool)
    for part in ("protocol", "host", "path", "query", "port"):
        rt = "BIGINT" if part == "port" else "VARCHAR"
        for kind in ("dict", "bytes"):
            (jv, jok), (tv, tok) = _both(f"url_extract_{part}", rt,
                                         kind=kind, data=(urls, unulls))
            assert np.array_equal(jok, tok), part
            assert [v for v, ok in zip(jv, jok) if ok] == \
                [v for v, ok in zip(tv, tok) if ok], part


def test_json_extract_scalar_equals_jax_where_present():
    """Where the path holds a scalar both packages give it; where it
    holds nothing, JSON null or an object, the port gives NULL and the
    JAX package ''."""
    rng = np.random.default_rng(8)
    docs = []
    for i in range(300):
        k = rng.integers(0, 6)
        docs.append(['{"a": {"b": [%d, "x%d"]}}' % (i, i),
                     '{"a": {"b": []}}', '{"a": null}', '{"a": {"b": {}}}',
                     '{"a": {"b": [true, 1.5]}}', "not json"][k])
    nulls = rng.random(len(docs)) < 0.1
    for kind in ("dict", "bytes"):
        (jv, jok), (tv, tok) = _both("json_extract_scalar", "VARCHAR",
                                     ("$.a.b[1]",), kind=kind,
                                     data=(docs, nulls))
        assert np.array_equal(tok, jok & np.array(
            [d.startswith('{"a": {"b": [') and "[]" not in d for d in docs]))
        assert [v for v, ok in zip(jv, tok) if ok] == \
            [v for v, ok in zip(tv, tok) if ok]
        assert {v for v, ok, pok in zip(jv, jok, tok) if ok and not pok} \
            == {""}


@pytest.mark.parametrize("kind", ["dict", "bytes"])
def test_split_part_and_regexp_extract_past_the_end_are_null(kind):
    """The JAX package gives '' where the port gives NULL; elsewhere the
    two are equal."""
    for name, lits in (("split_part", (",", 3)),
                       ("regexp_extract", ("([a-c])([0-9])", 2))):
        (jv, jok), (tv, tok) = _both(name, "VARCHAR", lits, kind)
        assert not (tok & ~jok).any()
        assert [v for v, ok in zip(jv, tok) if ok] == \
            [v for v, ok in zip(tv, tok) if ok]
        assert {v for v, ok, pok in zip(jv, jok, tok) if ok and not pok} \
            == {""}
        assert (jok & ~tok).any()


@pytest.mark.parametrize("kind", ["dict", "bytes"])
def test_concat_ws_skips_nulls(kind):
    """Trino skips a NULL argument of ``concat_ws`` (the JAX package makes
    the row NULL); where no argument is NULL the two agree."""
    strs, nulls = _strings(9)
    s2, n2 = _strings(19)

    def run(mod, irm, cmod, arr, ev):
        vt = mod.VARCHAR
        n = len(strs)
        chunk = cmod.Chunk({
            "a": _layout(mod, cmod, arr, strs, nulls, kind, vt),
            "b": _layout(mod, cmod, arr, s2, n2, kind, vt)},
            arr(np.ones(n, bool)))
        e = irm.Func("concat_ws", (irm.Literal("|", vt),
                                   irm.ColumnRef("a", vt),
                                   irm.ColumnRef("b", vt)), vt)
        return _decode(ev(e, chunk), n)

    jv, jok = run(JT, JIR, JC, jnp.asarray, JE.eval_expr)
    tv, tok = run(T, ir, TC, torch.from_numpy, TE.eval_expr)
    assert tok.all()
    want = ["|".join(x for x, null in ((a, na), (b, nb)) if not null)
            for a, na, b, nb in zip(strs, nulls, s2, n2)]
    assert tv == want
    assert np.array_equal(jok, ~nulls & ~n2)
    assert [v for v, ok in zip(jv, jok) if ok] == \
        [v for v, ok in zip(tv, jok) if ok]


def test_chr_equals_jax():
    codes = np.concatenate([np.arange(0, 128),
                            np.random.default_rng(2).integers(32, 127, 200)])

    def run(mod, irm, cmod, arr, ev):
        chunk = cmod.Chunk({"i": cmod.DCol(mod.BIGINT, "plain",
                                           arr(codes.astype(np.int64)))},
                           arr(np.ones(len(codes), bool)))
        out = ev(irm.Func("chr", (irm.ColumnRef("i", mod.BIGINT),),
                          mod.VARCHAR), chunk)
        return np.asarray(out.values), np.asarray(out.lengths)

    jv, jl = run(JT, JIR, JC, jnp.asarray, JE.eval_expr)
    tv, tl = run(T, ir, TC, torch.from_numpy, TE.eval_expr)
    assert np.array_equal(jv, tv) and np.array_equal(jl, tl)
    assert tv[:, 0].tolist() == codes.tolist()


def test_trim_of_a_dictionary_reuniques_its_entries():
    """``trim`` maps 'a ' and ' a' to one entry, so a GROUP BY over it
    counts them as one group."""
    got = port().run_sql(
        "select trim(x) t, count(*) c from (select case when n_nationkey "
        "< 10 then 'a ' else ' a' end x from nation) y group by 1")
    assert got.to_pydict() == {"t": ["a"], "c": [25]}


# ------------------------------------------------------ reference faults
# not copied: Trino's documented result (v359 ``StringFunctions``,
# ``JoniRegexpFunctions``, ``JsonFunctions``) through the port's SQL, the
# JAX package's differing value through its evaluator

def _one(sql_expr: str):
    return port().run_sql(
        f"select {sql_expr} v from region limit 1").to_pydict()["v"][0]


def _jax_value(name: str, *args):
    vt = JT.VARCHAR
    refs = tuple(JIR.Literal(a, vt if isinstance(a, str) else JT.BIGINT)
                 for a in args)
    out = JE.eval_expr(JIR.Func(name, refs, vt),
                       JC.Chunk({}, jnp.ones((1,), jnp.bool_)))
    v, ok = _decode(out, 1)
    return v[0] if ok[0] else None


@pytest.mark.parametrize("sql,args,trino,jax", [
    ("split_part('a,b', ',', 5)", ("split_part", "a,b", ",", 5), None, ""),
    ("regexp_extract('abc', '[0-9]+')", ("regexp_extract", "abc", "[0-9]+"),
     None, ""),
    ("json_extract_scalar('{\"k\": 7}', '$.z')",
     ("json_extract_scalar", '{"k": 7}', "$.z"), None, ""),
    ("translate('abc', 'bb', 'xy')", ("translate", "abc", "bb", "xy"),
     "axc", "ayc"),
])
def test_reference_fault_not_copied(sql, args, trino, jax):
    assert _one(sql) == trino
    assert _jax_value(*args) == jax
