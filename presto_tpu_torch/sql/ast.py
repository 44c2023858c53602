"""Raw (untyped) SQL AST.

The analogue of the reference's parse tree (``core/trino-parser/.../sql/tree/``,
223 node classes) reduced to the analytic-SQL subset the engine executes:
SELECT-FROM-WHERE-GROUP-HAVING-ORDER-LIMIT, explicit/implicit joins, derived
tables, WITH, scalar/IN/EXISTS subqueries, CASE, BETWEEN, LIKE, IN,
EXTRACT, SUBSTRING, date/interval literals.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple


# --- expressions ---

class Node:
    pass


@dataclass
class Ident(Node):
    parts: Tuple[str, ...]          # possibly qualified: ("l", "shipdate")


@dataclass
class NumberLit(Node):
    text: str                        # preserve text: decimal scale matters


@dataclass
class StringLit(Node):
    value: str


@dataclass
class DateLit(Node):
    value: str                       # ISO yyyy-mm-dd


@dataclass
class TimestampLit(Node):
    value: str                       # 'yyyy-mm-dd[ hh:mm:ss[.ffffff]]' 


@dataclass
class IntervalLit(Node):
    value: int
    unit: str                        # day | month | year


@dataclass
class Star(Node):
    pass


@dataclass
class FuncCall(Node):
    name: str
    args: List[Node]
    distinct: bool = False


@dataclass
class WindowFrame(Node):
    kind: str                        # rows (range frames: default only)
    start: Tuple[str, int]           # ("unbounded"|"preceding"|"current"|
    end: Tuple[str, int]             #  "following", k)


@dataclass
class WindowExpr(Node):
    func: "FuncCall"
    partition_by: List[Node]
    order_by: List["OrderItem"]
    frame: Optional["WindowFrame"] = None
    ignore_nulls: bool = False       # lead/lag/first/last/nth IGNORE NULLS


@dataclass
class BinaryOp(Node):
    op: str                          # + - * / and or = <> < <= > >= ||
    left: Node
    right: Node


@dataclass
class UnaryOp(Node):
    op: str                          # - not
    arg: Node


@dataclass
class CaseExpr(Node):
    whens: List[Tuple[Node, Node]]
    default: Optional[Node]


@dataclass
class BetweenExpr(Node):
    arg: Node
    lo: Node
    hi: Node
    negated: bool = False


@dataclass
class InListExpr(Node):
    arg: Node
    values: List[Node]
    negated: bool = False


@dataclass
class InSubquery(Node):
    arg: Node
    query: "Select"
    negated: bool = False


@dataclass
class ExistsExpr(Node):
    query: "Select"
    negated: bool = False


@dataclass
class ScalarSubquery(Node):
    query: "Select"


@dataclass
class LikeExpr(Node):
    arg: Node
    pattern: str
    negated: bool = False


@dataclass
class ExtractExpr(Node):
    what: str                        # year | month | day
    arg: Node


@dataclass
class SubstringExpr(Node):
    arg: Node
    start: Node
    length: Optional[Node]


@dataclass
class CastExpr(Node):
    arg: Node
    type_name: str                   # e.g. "decimal(12,2)", "double"


@dataclass
class IsNullExpr(Node):
    arg: Node
    negated: bool = False


@dataclass
class GroupingSets(Node):
    sets: List[List[Node]]           # from GROUPING SETS / ROLLUP / CUBE


@dataclass
class TypedNull(Node):
    of: Node                         # NULL typed like this expression


@dataclass
class ArrayLit(Node):
    items: List[Node]                # ARRAY[e1, e2, ...]


@dataclass
class Subscript(Node):
    base: Node                       # arr[i] (1-based, SQL semantics)
    index: Node


# --- relations ---

@dataclass
class TableRef(Node):
    catalog_parts: Tuple[str, ...]   # last element is the table name
    alias: Optional[str] = None


@dataclass
class SubqueryRef(Node):
    query: "Select"
    alias: str


@dataclass
class JoinRef(Node):
    left: Node
    right: Node
    kind: str                        # inner | left | right | cross
    on: Optional[Node]


@dataclass
class UnnestRef(Node):
    """CROSS JOIN UNNEST(arr[, ...]) [WITH ORDINALITY] AS a(x[, ...]) —
    lateral expansion of array/map expressions (reference:
    ``sql/tree/Unnest.java`` + ``operator/unnest/UnnestOperator.java``)."""

    exprs: List[Node]
    alias: Optional[str] = None
    col_aliases: List[str] = field(default_factory=list)
    ordinality: bool = False


@dataclass
class MatchRecognizeRef(Node):
    """FROM t MATCH_RECOGNIZE (...) — row-pattern recognition
    (reference: ``sql/tree/PatternRecognitionRelation.java``)."""

    source: Node                             # TableRef
    partition_by: List[Node]
    order_by: List["OrderItem"]
    measures: List[Tuple[Node, str]]         # (expr, output name)
    pattern: object                          # ops.pattern Sym/Seq/Alt/Quant
    defines: List[Tuple[str, Node]]          # (symbol, predicate)
    alias: Optional[str] = None
    all_rows: bool = False                   # ALL ROWS PER MATCH


# --- query ---

@dataclass
class SelectItem(Node):
    expr: Node
    alias: Optional[str] = None


@dataclass
class OrderItem(Node):
    expr: Node
    descending: bool = False


@dataclass
class SetOp(Node):
    left: Node                       # Select | SetOp
    right: Node
    op: str                          # union | intersect | except
    all: bool = False
    order_by: List["OrderItem"] = field(default_factory=list)
    limit: Optional[int] = None


@dataclass
class Select(Node):
    items: List[SelectItem]
    from_: List[Node]                # TableRef | SubqueryRef | JoinRef
    where: Optional[Node] = None
    group_by: List[Node] = field(default_factory=list)
    having: Optional[Node] = None
    order_by: List[OrderItem] = field(default_factory=list)
    limit: Optional[int] = None
    distinct: bool = False
    with_ctes: List[Tuple[str, "Select"]] = field(default_factory=list)
