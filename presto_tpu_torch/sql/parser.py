"""SQL lexer + recursive-descent parser for the analytic subset.

The reference parses with an ANTLR grammar
(``core/trino-parser/src/main/antlr4/io/trino/sql/parser/SqlBase.g4``); this
hand-written recursive-descent/precedence-climbing parser covers the subset
the engine executes (full TPC-H + general SELECT analytics).
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

from . import ast

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+|--[^\n]*|/\*.*?\*/)
  | (?P<number>(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?)
  | (?P<qident>"[^"]*")
  | (?P<string>'(?:[^']|'')*')
  | (?P<name>[A-Za-z_][A-Za-z0-9_$]*)
  | (?P<op><>|!=|>=|<=|\|\||[-+*/(),.;=<>?|\[\]])
""", re.X | re.S)

KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "as", "and", "or", "not", "in", "exists", "between", "like", "is",
    "null", "case", "when", "then", "else", "end", "cast", "date",
    "interval", "extract", "substring", "distinct", "asc", "desc", "join",
    "inner", "left", "right", "outer", "cross", "on", "with", "for", "union",
    "all", "year", "month", "day", "true", "false", "over", "partition",
    "rows", "range", "groups", "unbounded", "preceding", "following",
    "current", "row", "except", "intersect", "timestamp", "ignore",
    "respect", "nulls",
}


class Token:
    __slots__ = ("kind", "value", "pos")

    def __init__(self, kind, value, pos):
        self.kind = kind          # number|string|name|kw|op|qident
        self.value = value
        self.pos = pos

    def __repr__(self):
        return f"{self.kind}:{self.value}"


def tokenize(sql: str) -> List[Token]:
    out = []
    pos = 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            raise SyntaxError(f"cannot tokenize at {sql[pos:pos+30]!r}")
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        text = m.group()
        if m.lastgroup == "name":
            low = text.lower()
            out.append(Token("kw" if low in KEYWORDS else "name", low, m.start()))
        elif m.lastgroup == "qident":
            out.append(Token("name", text[1:-1], m.start()))
        elif m.lastgroup == "string":
            out.append(Token("string", text[1:-1].replace("''", "'"), m.start()))
        elif m.lastgroup == "number":
            out.append(Token("number", text, m.start()))
        else:
            out.append(Token("op", text, m.start()))
    out.append(Token("eof", "", len(sql)))
    return out


class Parser:
    def __init__(self, sql: str):
        self.toks = tokenize(sql)
        self.i = 0

    # --- token helpers ---

    def peek(self, k=0) -> Token:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, kind, value=None) -> Optional[Token]:
        t = self.peek()
        if t.kind == kind and (value is None or t.value == value):
            return self.next()
        return None

    def expect(self, kind, value=None) -> Token:
        t = self.accept(kind, value)
        if t is None:
            raise SyntaxError(
                f"expected {value or kind}, got {self.peek()!r} at "
                f"pos {self.peek().pos}")
        return t

    def at_kw(self, *kws) -> bool:
        t = self.peek()
        return t.kind == "kw" and t.value in kws

    # --- entry ---

    def parse(self):
        sel = self.parse_query()
        self.accept("op", ";")
        self.expect("eof")
        return sel

    def parse_query(self):
        """select_core ((UNION|INTERSECT|EXCEPT) [ALL] select_core)*
        with trailing ORDER BY/LIMIT attached to the whole set op.
        Operands may be parenthesized queries: ``(q1) except (q2)``."""
        left = self._parse_setop_operand()
        while self.at_kw("union", "intersect", "except"):
            op = self.next().value
            all_ = bool(self.accept("kw", "all"))
            self.accept("kw", "distinct")
            right = self._parse_setop_operand()
            # ORDER BY / LIMIT greedily parsed into the right arm belong to
            # the set operation as a whole — but a PARENTHESIZED operand
            # keeps its own (``(q1) union all (q2 limit 1)``)
            order_by, limit = [], None
            if not getattr(right, "_paren", False):
                order_by, limit = getattr(right, "order_by", []), \
                    getattr(right, "limit", None)
                if order_by or limit:
                    right.order_by, right.limit = [], None
            left = ast.SetOp(left, right, op, all_, order_by, limit)
        return left

    def _parse_setop_operand(self):
        t = self.peek()
        if t.kind == "op" and t.value == "(":
            # lookahead: a parenthesized QUERY (not a scalar expression)
            save = self.i
            self.next()
            if self.at_kw("select", "with") or (
                    self.peek().kind == "op" and self.peek().value == "("):
                q = self.parse_query()
                self.expect("op", ")")
                q._paren = True
                return q
            self.i = save
        return self.parse_select()

    def parse_select(self) -> ast.Select:
        ctes: List[Tuple[str, ast.Select]] = []
        if self.accept("kw", "with"):
            while True:
                name = self.expect("name").value
                self.expect("kw", "as")
                self.expect("op", "(")
                q = self.parse_query()
                self.expect("op", ")")
                ctes.append((name, q))
                if not self.accept("op", ","):
                    break
        self.expect("kw", "select")
        distinct = bool(self.accept("kw", "distinct"))
        self.accept("kw", "all")
        items = [self.parse_select_item()]
        while self.accept("op", ","):
            items.append(self.parse_select_item())
        from_: List[ast.Node] = []
        if self.accept("kw", "from"):
            from_.append(self.parse_relation())
            while self.accept("op", ","):
                from_.append(self.parse_relation())
        where = self.parse_expr() if self.accept("kw", "where") else None
        group_by: List[ast.Node] = []
        if self.accept("kw", "group"):
            self.expect("kw", "by")
            gs = self._maybe_grouping_sets()
            if gs is not None:
                group_by.append(gs)
            else:
                group_by.append(self.parse_expr())
                while self.accept("op", ","):
                    group_by.append(self.parse_expr())
        having = self.parse_expr() if self.accept("kw", "having") else None
        order_by: List[ast.OrderItem] = []
        if self.accept("kw", "order"):
            self.expect("kw", "by")
            while True:
                e = self.parse_expr()
                desc = False
                if self.accept("kw", "desc"):
                    desc = True
                elif self.accept("kw", "asc"):
                    pass
                order_by.append(ast.OrderItem(e, desc))
                if not self.accept("op", ","):
                    break
        limit = None
        if self.accept("kw", "limit"):
            limit = int(self.expect("number").value)
        return ast.Select(items, from_, where, group_by, having, order_by,
                          limit, distinct, ctes)

    def _maybe_grouping_sets(self):
        t = self.peek()
        if t.kind != "name" or t.value not in ("grouping", "rollup", "cube"):
            return None
        if t.value == "grouping":
            if self.peek(1).kind != "name" or self.peek(1).value != "sets":
                return None
            self.next(); self.next()
            self.expect("op", "(")
            sets = []
            while True:
                if self.accept("op", "("):
                    one = []
                    if not self.accept("op", ")"):
                        one.append(self.parse_expr())
                        while self.accept("op", ","):
                            one.append(self.parse_expr())
                        self.expect("op", ")")
                    sets.append(one)
                else:
                    sets.append([self.parse_expr()])
                if not self.accept("op", ","):
                    break
            self.expect("op", ")")
            return ast.GroupingSets(sets)
        kind = self.next().value
        self.expect("op", "(")
        keys = [self.parse_expr()]
        while self.accept("op", ","):
            keys.append(self.parse_expr())
        self.expect("op", ")")
        if kind == "rollup":
            sets = [keys[:i] for i in range(len(keys), -1, -1)]
        else:  # cube: all subsets
            sets = []
            for m in range(1 << len(keys)):
                sets.append([k for i, k in enumerate(keys) if m >> i & 1])
            sets.sort(key=len, reverse=True)
        return ast.GroupingSets(sets)

    def parse_select_item(self) -> ast.SelectItem:
        if self.accept("op", "*"):
            return ast.SelectItem(ast.Star())
        e = self.parse_expr()
        alias = None
        if self.accept("kw", "as"):
            alias = self.expect("name").value
        elif self.peek().kind == "name":
            alias = self.next().value
        return ast.SelectItem(e, alias)

    # --- relations ---

    def parse_relation(self) -> ast.Node:
        rel = self.parse_relation_primary()
        while True:
            kind = None
            if self.accept("kw", "cross"):
                self.expect("kw", "join")
                kind = "cross"
            elif self.at_kw("join", "inner", "left", "right") or \
                    (self.peek().kind == "name" and
                     self.peek().value == "full"):
                if self.accept("kw", "left"):
                    self.accept("kw", "outer")
                    kind = "left"
                elif self.accept("kw", "right"):
                    self.accept("kw", "outer")
                    kind = "right"
                elif self.accept("name", "full"):
                    self.accept("kw", "outer")
                    kind = "full"
                else:
                    self.accept("kw", "inner")
                    kind = "inner"
                self.expect("kw", "join")
            else:
                break
            right = self.parse_relation_primary()
            on = None
            if kind != "cross":
                self.expect("kw", "on")
                on = self.parse_expr()
            rel = ast.JoinRef(rel, right, kind, on)
        return rel

    def parse_relation_primary(self) -> ast.Node:
        if self.accept("op", "("):
            q = self.parse_query()
            self.expect("op", ")")
            self.accept("kw", "as")
            alias = self.expect("name").value
            if self.accept("op", "("):   # AS name (col1, col2, ...)
                col_aliases = [self.expect("name").value]
                while self.accept("op", ","):
                    col_aliases.append(self.expect("name").value)
                self.expect("op", ")")
                # rename query outputs positionally
                assert isinstance(q, ast.Select), \
                    "column aliases on set operations unsupported"
                assert len(col_aliases) == len(q.items), \
                    "column alias count mismatch"
                q = ast.Select(
                    [ast.SelectItem(it.expr, a)
                     for it, a in zip(q.items, col_aliases)],
                    q.from_, q.where, q.group_by, q.having, q.order_by,
                    q.limit, q.distinct, q.with_ctes)
            return ast.SubqueryRef(q, alias)
        if self.peek().kind == "name" and self.peek().value == "unnest" \
                and self.peek(1).kind == "op" and self.peek(1).value == "(":
            self.next()
            self.expect("op", "(")
            exprs = [self.parse_expr()]
            while self.accept("op", ","):
                exprs.append(self.parse_expr())
            self.expect("op", ")")
            ordinality = False
            if self.accept("kw", "with"):
                tok = self.next()
                assert tok.value == "ordinality", "expected ORDINALITY"
                ordinality = True
            alias, col_aliases = None, []
            if self.accept("kw", "as"):
                alias = self.expect("name").value
            elif self.peek().kind == "name":
                alias = self.next().value
            if alias is not None and self.accept("op", "("):
                col_aliases.append(self.expect("name").value)
                while self.accept("op", ","):
                    col_aliases.append(self.expect("name").value)
                self.expect("op", ")")
            return ast.UnnestRef(exprs, alias, col_aliases, ordinality)
        parts = [self.expect("name").value]
        while self.accept("op", "."):
            parts.append(self.expect("name").value)
        if self.peek().kind == "name" \
                and self.peek().value == "match_recognize":
            self.next()
            return self._parse_match_recognize(
                ast.TableRef(tuple(parts), None))
        alias = None
        if self.accept("kw", "as"):
            alias = self.expect("name").value
        elif self.peek().kind == "name" and self.peek().value != "full":
            # `full` opens a FULL [OUTER] JOIN, never an implicit alias
            alias = self.next().value
        return ast.TableRef(tuple(parts), alias)

    def _name(self, value) -> bool:
        return self.peek().kind == "name" and self.peek().value == value

    def _parse_match_recognize(self, source):
        """MATCH_RECOGNIZE clause (reference grammar: SqlBase.g4
        patternRecognition; subset — ONE ROW PER MATCH, AFTER MATCH SKIP
        PAST LAST ROW, concatenation/alternation/+*? quantifiers)."""
        self.expect("op", "(")
        partition, order, measures, defines = [], [], [], []
        if self.accept("kw", "partition"):
            self.expect("kw", "by")
            partition.append(self.parse_expr())
            while self.accept("op", ","):
                partition.append(self.parse_expr())
        if self.accept("kw", "order"):
            self.expect("kw", "by")
            while True:
                e = self.parse_expr()
                desc = bool(self.accept("kw", "desc"))
                if not desc:
                    self.accept("kw", "asc")
                order.append(ast.OrderItem(e, desc))
                if not self.accept("op", ","):
                    break
        if self._name("measures"):
            self.next()
            while True:
                e = self.parse_expr()
                self.expect("kw", "as")
                measures.append((e, self.expect("name").value))
                if not self.accept("op", ","):
                    break
        all_rows = False
        if self._name("one"):           # ONE ROW PER MATCH (the default)
            self.next()
            self.expect("kw", "row")
            for w in ("per", "match"):
                tok = self.next()
                assert tok.value == w, f"expected {w.upper()}"
        elif self.at_kw("all"):         # ALL ROWS PER MATCH
            self.next()
            for w in ("rows", "per", "match"):
                tok = self.next()
                assert tok.value == w, f"expected {w.upper()}"
            all_rows = True
        if self._name("after"):         # AFTER MATCH SKIP PAST LAST ROW
            self.next()
            for w in ("match", "skip", "past"):
                tok = self.next()
                assert tok.value == w, f"expected {w.upper()}"
            tok = self.next()           # LAST (kw or name)
            assert tok.value == "last", "only SKIP PAST LAST ROW supported"
            self.expect("kw", "row")
        assert self._name("pattern"), "PATTERN clause required"
        self.next()
        self.expect("op", "(")
        pattern = self._parse_pattern_alt()
        self.expect("op", ")")
        assert self._name("define"), "DEFINE clause required"
        self.next()
        while True:
            sym = self.expect("name").value
            self.expect("kw", "as")
            defines.append((sym, self.parse_expr()))
            if not self.accept("op", ","):
                break
        self.expect("op", ")")
        alias = None
        if self.accept("kw", "as"):
            alias = self.expect("name").value
        elif self.peek().kind == "name":
            alias = self.next().value
        return ast.MatchRecognizeRef(source, partition, order, measures,
                                     pattern, defines, alias,
                                     all_rows=all_rows)

    def _parse_pattern_alt(self):
        """alternation → sequence → quantified factor (row-pattern
        grammar; nodes from ops/pattern.py)."""
        from ..ops import pattern as PT

        def factor():
            if self.accept("op", "("):
                node = self._parse_pattern_alt()
                self.expect("op", ")")
            else:
                node = PT.Sym(self.expect("name").value)
            while self.peek().kind == "op" \
                    and self.peek().value in ("+", "*", "?"):
                node = PT.Quant(node, self.next().value)
            return node

        def seq():
            parts = [factor()]
            while self.peek().kind == "name" \
                    or (self.peek().kind == "op"
                        and self.peek().value == "("):
                parts.append(factor())
            return parts[0] if len(parts) == 1 else PT.Seq(tuple(parts))

        options = [seq()]
        while self.accept("op", "|"):
            options.append(seq())
        return options[0] if len(options) == 1 else PT.Alt(tuple(options))

    # --- expressions (precedence climbing) ---

    # --- expressions (precedence climbing) ---

    def _parse_type_name(self) -> str:
        """Type name in CAST: simple (``bigint``), parameterized
        (``decimal(12,2)``), or nested (``array(integer)``,
        ``map(varchar, bigint)``) — rendered back to its canonical
        string for the analyzer (reference grammar rule ``type`` in
        ``SqlBase.g4``)."""
        tn = self.next().value
        if tn == "row" and self.accept("op", "("):
            # ROW(name type, ...) — named fields (``spi/type/RowType``)
            fields = []
            while True:
                fname = self.next().value
                fields.append(f"{fname} {self._parse_type_name()}")
                if not self.accept("op", ","):
                    break
            self.expect("op", ")")
            return f"row({','.join(fields)})"
        if self.accept("op", "("):
            args = []
            while True:
                if self.peek().kind == "number":
                    args.append(self.next().value)
                else:
                    args.append(self._parse_type_name())
                if not self.accept("op", ","):
                    break
            self.expect("op", ")")
            tn = f"{tn}({','.join(args)})"
        if (self.at_kw("with") and self.peek(1).value == "time"
                and self.peek(2).value == "zone"):
            self.next(), self.next(), self.next()
            tn = f"{tn} with time zone"
        return tn

    def parse_expr(self) -> ast.Node:
        return self.parse_or()

    def parse_or(self) -> ast.Node:
        e = self.parse_and()
        while self.accept("kw", "or"):
            e = ast.BinaryOp("or", e, self.parse_and())
        return e

    def parse_and(self) -> ast.Node:
        e = self.parse_not()
        while self.accept("kw", "and"):
            e = ast.BinaryOp("and", e, self.parse_not())
        return e

    def parse_not(self) -> ast.Node:
        if self.accept("kw", "not"):
            return ast.UnaryOp("not", self.parse_not())
        return self.parse_predicate()

    def parse_predicate(self) -> ast.Node:
        e = self.parse_additive()
        while True:
            negated = False
            save = self.i
            if self.accept("kw", "not"):
                negated = True
            if self.accept("kw", "between"):
                lo = self.parse_additive()
                self.expect("kw", "and")
                hi = self.parse_additive()
                e = ast.BetweenExpr(e, lo, hi, negated)
                continue
            if self.accept("kw", "like"):
                pat = self.expect("string").value
                e = ast.LikeExpr(e, pat, negated)
                continue
            if self.accept("kw", "in"):
                self.expect("op", "(")
                if self.at_kw("select", "with"):
                    q = self.parse_select()
                    self.expect("op", ")")
                    e = ast.InSubquery(e, q, negated)
                else:
                    vals = [self.parse_additive()]
                    while self.accept("op", ","):
                        vals.append(self.parse_additive())
                    self.expect("op", ")")
                    e = ast.InListExpr(e, vals, negated)
                continue
            if negated:
                self.i = save
                break
            if self.accept("kw", "is"):
                neg = bool(self.accept("kw", "not"))
                self.expect("kw", "null")
                e = ast.IsNullExpr(e, neg)
                continue
            t = self.peek()
            if t.kind == "op" and t.value in ("=", "<>", "!=", "<", "<=", ">", ">="):
                self.next()
                op = "<>" if t.value == "!=" else t.value
                e = ast.BinaryOp(op, e, self.parse_additive())
                continue
            break
        return e

    def parse_additive(self) -> ast.Node:
        e = self.parse_multiplicative()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("+", "-", "||"):
                self.next()
                e = ast.BinaryOp(t.value, e, self.parse_multiplicative())
            else:
                break
        return e

    def parse_multiplicative(self) -> ast.Node:
        e = self.parse_unary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("*", "/"):
                self.next()
                e = ast.BinaryOp(t.value, e, self.parse_unary())
            else:
                break
        return e

    def parse_unary(self) -> ast.Node:
        if self.accept("op", "-"):
            return ast.UnaryOp("-", self.parse_unary())
        if self.accept("op", "+"):
            return self.parse_unary()
        e = self.parse_primary()
        while self.accept("op", "["):      # subscript: arr[i] (1-based)
            idx = self.parse_expr()
            self.expect("op", "]")
            e = ast.Subscript(e, idx)
        while (self.peek().value == "at" and self.peek(1).value == "time"
               and self.peek(2).value == "zone"):
            # postfix AT TIME ZONE (reference grammar: valueExpression AT
            # timeZoneSpecifier, ``sql/tree/AtTimeZone.java``)
            self.next(), self.next(), self.next()
            e = ast.FuncCall("at_timezone", [e, self.parse_primary()])
        return e

    def parse_primary(self) -> ast.Node:
        t = self.peek()
        if self.accept("op", "("):
            if self.at_kw("select", "with"):
                q = self.parse_select()
                self.expect("op", ")")
                return ast.ScalarSubquery(q)
            e = self.parse_expr()
            if self.accept("op", ","):
                # parenthesized list = ROW constructor (reference:
                # ``sql/tree/Row.java``; also the implicit form in tuple
                # comparisons and multi-column IN)
                items = [e, self.parse_expr()]
                while self.accept("op", ","):
                    items.append(self.parse_expr())
                self.expect("op", ")")
                return ast.FuncCall("row", items)
            self.expect("op", ")")
            return e
        if t.kind == "number":
            self.next()
            return ast.NumberLit(t.value)
        if t.kind == "string":
            self.next()
            return ast.StringLit(t.value)
        if t.kind == "kw":
            if self.accept("kw", "timestamp"):
                if self.accept("op", "("):
                    v = self.expect("string").value
                    self.expect("op", ")")
                else:
                    v = self.expect("string").value
                return ast.TimestampLit(v)
            if self.accept("kw", "date"):
                if self.accept("op", "("):    # date('yyyy-mm-dd') form
                    v = self.expect("string").value
                    self.expect("op", ")")
                    return ast.DateLit(v)
                return ast.DateLit(self.expect("string").value)
            if self.accept("kw", "interval"):
                v = int(self.expect("string").value)
                tok = self.next()          # unit: kw (day/month/year) or
                unit = tok.value.rstrip("s")   # name (hour/minute/second)
                if unit not in ("day", "month", "year", "hour", "minute",
                                "second", "week"):
                    raise SyntaxError(f"bad interval unit {unit}")
                return ast.IntervalLit(v, unit)
            if self.accept("kw", "case"):
                # simple CASE (`CASE e WHEN v THEN r ...`) desugars into
                # the searched form with `e = v` conditions
                operand = None
                if not self.at_kw("when"):
                    operand = self.parse_expr()
                whens = []
                default = None
                while self.accept("kw", "when"):
                    c = self.parse_expr()
                    self.expect("kw", "then")
                    v = self.parse_expr()
                    whens.append((c, v))
                if self.accept("kw", "else"):
                    default = self.parse_expr()
                self.expect("kw", "end")
                if operand is not None:
                    whens = [(ast.BinaryOp("=", operand, c), v)
                             for c, v in whens]
                return ast.CaseExpr(whens, default)
            if self.at_kw("row") and self.peek(1).value == "(":
                # explicit ROW constructor (``sql/tree/Row.java``)
                self.next(), self.next()
                items = [self.parse_expr()]
                while self.accept("op", ","):
                    items.append(self.parse_expr())
                self.expect("op", ")")
                return ast.FuncCall("row", items)
            if self.accept("kw", "cast"):
                self.expect("op", "(")
                e = self.parse_expr()
                self.expect("kw", "as")
                tn = self._parse_type_name()
                self.expect("op", ")")
                return ast.CastExpr(e, tn)
            if self.accept("kw", "extract"):
                self.expect("op", "(")
                # the field is a keyword (YEAR/MONTH/DAY) or a plain
                # identifier (HOUR, MINUTE, DOW, ...)
                what = (self.accept("kw") or self.expect("name")).value
                self.expect("kw", "from")
                e = self.parse_expr()
                self.expect("op", ")")
                return ast.ExtractExpr(what, e)
            if self.accept("kw", "substring"):
                self.expect("op", "(")
                e = self.parse_expr()
                if self.accept("kw", "from"):
                    start = self.parse_expr()
                    length = None
                    if self.accept("kw", "for"):
                        length = self.parse_expr()
                else:
                    self.expect("op", ",")
                    start = self.parse_expr()
                    length = None
                    if self.accept("op", ","):
                        length = self.parse_expr()
                self.expect("op", ")")
                return ast.SubstringExpr(e, start, length)
            if self.accept("kw", "exists"):
                self.expect("op", "(")
                q = self.parse_select()
                self.expect("op", ")")
                return ast.ExistsExpr(q)
            if t.value in ("year", "month", "day") and \
                    self.peek(1).kind == "op" and self.peek(1).value == "(":
                self.next()
                self.expect("op", "(")
                arg = self.parse_expr()
                self.expect("op", ")")
                return ast.FuncCall(t.value, [arg])
            if self.accept("kw", "not"):
                return ast.UnaryOp("not", self.parse_not())
            if self.accept("kw", "true"):
                return ast.NumberLit("1")   # folded later
            if self.accept("kw", "false"):
                return ast.NumberLit("0")
            if self.accept("kw", "null"):
                return ast.Ident(("null",))
        if t.kind == "name":
            self.next()
            if t.value == "array" and self.accept("op", "["):
                items = []
                if not self.accept("op", "]"):
                    items.append(self.parse_expr())
                    while self.accept("op", ","):
                        items.append(self.parse_expr())
                    self.expect("op", "]")
                return ast.ArrayLit(items)
            if self.accept("op", "("):
                # function call
                if self.accept("op", "*"):
                    self.expect("op", ")")
                    return self._maybe_window(ast.FuncCall(t.value, [ast.Star()]))
                distinct = bool(self.accept("kw", "distinct"))
                args = []
                if not self.accept("op", ")"):
                    if t.value == "position":
                        # first arg stops BEFORE a possible IN (the
                        # SQL-standard position(needle IN haystack) form;
                        # parse_expr would swallow it as an IN-list)
                        args.append(self.parse_additive())
                        if self.accept("kw", "in"):
                            hay = self.parse_expr()
                            self.expect("op", ")")
                            return ast.FuncCall("strpos", [hay, args[0]])
                    else:
                        args.append(self.parse_expr())
                    while self.accept("op", ","):
                        args.append(self.parse_expr())
                    self.expect("op", ")")
                call = ast.FuncCall(t.value, args, distinct)
                return self._maybe_window(call)
            parts = [t.value]
            while self.accept("op", "."):
                parts.append(self.expect("name").value)
            return ast.Ident(tuple(parts))
        raise SyntaxError(f"unexpected token {t!r}")


def parse(sql: str) -> ast.Select:
    return Parser(sql).parse()


def _install_window_parsing():
    def _maybe_window(self, call):
        # null-treatment clause (reference: SqlBase.g4 nullTreatment —
        # lead/lag/first/last/nth_value IGNORE NULLS)
        ignore_nulls = False
        if self.accept("kw", "ignore"):
            self.expect("kw", "nulls")
            ignore_nulls = True
        elif self.accept("kw", "respect"):
            self.expect("kw", "nulls")
        if not self.accept("kw", "over"):
            if ignore_nulls:
                raise ValueError("IGNORE NULLS requires an OVER clause")
            return call
        self.expect("op", "(")
        partition = []
        order = []
        if self.accept("kw", "partition"):
            self.expect("kw", "by")
            partition.append(self.parse_expr())
            while self.accept("op", ","):
                partition.append(self.parse_expr())
        if self.accept("kw", "order"):
            self.expect("kw", "by")
            while True:
                e = self.parse_expr()
                desc = False
                if self.accept("kw", "desc"):
                    desc = True
                elif self.accept("kw", "asc"):
                    pass
                order.append(ast.OrderItem(e, desc))
                if not self.accept("op", ","):
                    break
        frame = None
        if self.at_kw("rows", "range", "groups"):
            kind = self.next().value

            def bound():
                if self.accept("kw", "unbounded"):
                    which = self.next().value  # preceding|following
                    return (f"unbounded_{which}", 0)
                if self.accept("kw", "current"):
                    self.expect("kw", "row")
                    return ("current", 0)
                k = int(self.expect("number").value)
                which = self.next().value      # preceding|following
                return (which, k)

            if self.accept("kw", "between"):
                start = bound()
                self.expect("kw", "and")
                end = bound()
            else:
                start = bound()
                end = ("current", 0)
            frame = ast.WindowFrame(kind, start, end)
        self.expect("op", ")")
        return ast.WindowExpr(call, partition, order, frame, ignore_nulls)

    Parser._maybe_window = _maybe_window


_install_window_parsing()
