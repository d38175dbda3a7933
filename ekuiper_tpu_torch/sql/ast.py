"""SQL AST — analogue of eKuiper's pkg/ast (statement.go, expr.go).

Node shapes mirror the reference semantically (window types and their
Length/Interval/Delay/TimeUnit fields match pkg/ast/statement.go:183-230;
operator precedence matches pkg/ast/token.go:303-318) so rule definitions
written for the reference parse to the same meaning here.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Iterator, List, Optional

from ..data.types import DataType


# ---------------------------------------------------------------- expressions
class Expr:
    def children(self) -> List["Expr"]:
        return []


@dataclass
class IntegerLiteral(Expr):
    val: int


@dataclass
class NumberLiteral(Expr):
    val: float


@dataclass
class StringLiteral(Expr):
    val: str


@dataclass
class BooleanLiteral(Expr):
    val: bool


@dataclass
class TimeLiteral(Expr):
    """Window time-unit token: DD/HH/MI/SS/MS."""

    val: str


@dataclass
class Wildcard(Expr):
    """`*` — optionally qualified (stream.*) or with eKuiper's
    EXCEPT(...)/REPLACE(...) modifiers."""

    stream: str = ""
    except_names: List[str] = field(default_factory=list)
    replaces: List["Field"] = field(default_factory=list)


@dataclass
class FieldRef(Expr):
    """Column reference, optionally qualified: `stream.name` or `name`."""

    name: str
    stream: str = ""


@dataclass
class MetaRef(Expr):
    """meta(key) / mqtt(topic) style metadata reference."""

    name: str
    stream: str = ""


@dataclass
class BinaryExpr(Expr):
    op: str  # one of OPERATORS below
    lhs: Expr
    rhs: Expr

    def children(self) -> List[Expr]:
        return [self.lhs, self.rhs]


@dataclass
class UnaryExpr(Expr):
    op: str  # '-' | 'NOT'
    expr: Expr

    def children(self) -> List[Expr]:
        return [self.expr]


@dataclass
class BetweenExpr(Expr):
    value: Expr
    lo: Expr
    hi: Expr
    negate: bool = False

    def children(self) -> List[Expr]:
        return [self.value, self.lo, self.hi]


@dataclass
class InExpr(Expr):
    value: Expr
    values: List[Expr]
    negate: bool = False

    def children(self) -> List[Expr]:
        return [self.value] + list(self.values)


@dataclass
class LikeExpr(Expr):
    value: Expr
    pattern: Expr
    negate: bool = False

    def children(self) -> List[Expr]:
        return [self.value, self.pattern]


@dataclass
class CaseExpr(Expr):
    """CASE [value] WHEN cond THEN res ... [ELSE default] END."""

    value: Optional[Expr]
    whens: List["WhenClause"] = field(default_factory=list)
    else_expr: Optional[Expr] = None

    def children(self) -> List[Expr]:
        out: List[Expr] = []
        if self.value is not None:
            out.append(self.value)
        for w in self.whens:
            out.extend([w.cond, w.result])
        if self.else_expr is not None:
            out.append(self.else_expr)
        return out


@dataclass
class WhenClause:
    cond: Expr
    result: Expr


@dataclass
class IndexExpr(Expr):
    """`a[i]` element access or `a[lo:hi]` slice (json path ops)."""

    value: Expr
    index: Optional[Expr] = None
    lo: Optional[Expr] = None
    hi: Optional[Expr] = None
    is_slice: bool = False

    def children(self) -> List[Expr]:
        return [c for c in (self.value, self.index, self.lo, self.hi) if c is not None]


@dataclass
class ArrowExpr(Expr):
    """`a->b` nested struct field access."""

    value: Expr
    name: str

    def children(self) -> List[Expr]:
        return [self.value]


@dataclass
class Call(Expr):
    """Function call. `func_id` distinguishes multiple instances of a stateful
    function in one statement (reference: internal/xsql func_invoker)."""

    name: str
    args: List[Expr] = field(default_factory=list)
    func_id: int = 0
    # FILTER(WHERE cond) on aggregate calls
    filter: Optional[Expr] = None
    # OVER (PARTITION BY ... [WHEN cond]) on analytic calls
    partition: List[Expr] = field(default_factory=list)
    when: Optional[Expr] = None

    def children(self) -> List[Expr]:
        out = list(self.args)
        if self.filter is not None:
            out.append(self.filter)
        out.extend(self.partition)
        if self.when is not None:
            out.append(self.when)
        return out


OPERATORS = {
    "+", "-", "*", "/", "%", "&", "|", "^",
    "AND", "OR", "=", "!=", "<", "<=", ">", ">=",
}

# precedence mirrors pkg/ast/token.go:303-318 (higher binds tighter)
PRECEDENCE = {
    "OR": 1,
    "AND": 2,
    "=": 3, "!=": 3, "<": 3, "<=": 3, ">": 3, ">=": 3,
    "IN": 3, "NOT IN": 3, "BETWEEN": 3, "NOT BETWEEN": 3,
    "LIKE": 3, "NOT LIKE": 3,
    "+": 4, "-": 4, "|": 4, "^": 4,
    "*": 5, "/": 5, "%": 5, "&": 5, "[]": 5, "->": 5, ".": 5,
}


def walk(expr: Optional[Expr]) -> Iterator[Expr]:
    """Pre-order traversal of an expression tree."""
    if expr is None:
        return
    stack = [expr]
    while stack:
        node = stack.pop()
        yield node
        stack.extend(reversed(node.children()))


# ------------------------------------------------------------------ statements
class WindowType(str, Enum):
    NOT_WINDOW = "NOT_WINDOW"
    TUMBLING_WINDOW = "TUMBLING_WINDOW"
    HOPPING_WINDOW = "HOPPING_WINDOW"
    SLIDING_WINDOW = "SLIDING_WINDOW"
    SESSION_WINDOW = "SESSION_WINDOW"
    COUNT_WINDOW = "COUNT_WINDOW"
    STATE_WINDOW = "STATE_WINDOW"


@dataclass
class Window:
    """Window spec (reference: pkg/ast/statement.go:213-230).
    Length/Interval in units of `time_unit` except COUNT (row counts)."""

    window_type: WindowType
    time_unit: Optional[str] = None  # DD/HH/MI/SS/MS
    length: Optional[int] = None
    interval: Optional[int] = None
    delay: int = 0
    filter: Optional[Expr] = None  # FILTER(WHERE ...) on the window
    trigger_condition: Optional[Expr] = None  # sliding OVER(WHEN ...)
    begin_condition: Optional[Expr] = None  # state window
    emit_condition: Optional[Expr] = None  # state window

    def length_ms(self) -> int:
        from ..utils.timex import unit_to_ms

        return (self.length or 0) * unit_to_ms(self.time_unit or "ms")

    def interval_ms(self) -> int:
        from ..utils.timex import unit_to_ms

        if not self.interval:
            return 0
        return self.interval * unit_to_ms(self.time_unit or "ms")

    def delay_ms(self) -> int:
        from ..utils.timex import unit_to_ms

        return (self.delay or 0) * unit_to_ms(self.time_unit or "ms")


@dataclass
class Field:
    """SELECT field: expression + output name (+ AS alias flag)."""

    expr: Expr
    name: str = ""
    alias: str = ""
    invisible: bool = False

    @property
    def output_name(self) -> str:
        return self.alias or self.name


@dataclass
class Table:
    name: str
    alias: str = ""

    @property
    def ref_name(self) -> str:
        return self.alias or self.name


class JoinType(str, Enum):
    INNER = "INNER"
    LEFT = "LEFT"
    RIGHT = "RIGHT"
    FULL = "FULL"
    CROSS = "CROSS"


@dataclass
class Join:
    table: Table
    join_type: JoinType
    on: Optional[Expr] = None


@dataclass
class Dimension:
    expr: Expr


@dataclass
class SortField:
    name: str
    stream: str = ""
    ascending: bool = True
    expr: Optional[Expr] = None


@dataclass
class SelectStatement:
    fields: List[Field] = field(default_factory=list)
    sources: List[Table] = field(default_factory=list)
    joins: List[Join] = field(default_factory=list)
    condition: Optional[Expr] = None  # WHERE
    dimensions: List[Dimension] = field(default_factory=list)  # GROUP BY (non-window)
    window: Optional[Window] = None
    having: Optional[Expr] = None
    sorts: List[SortField] = field(default_factory=list)
    limit: Optional[int] = None

    def expressions(self) -> Iterator[Expr]:
        """All expression roots of the statement."""
        for f in self.fields:
            yield f.expr
        if self.condition is not None:
            yield self.condition
        for d in self.dimensions:
            yield d.expr
        if self.window is not None:
            for e in (
                self.window.filter,
                self.window.trigger_condition,
                self.window.begin_condition,
                self.window.emit_condition,
            ):
                if e is not None:
                    yield e
        for j in self.joins:
            if j.on is not None:
                yield j.on
        if self.having is not None:
            yield self.having
        for s in self.sorts:
            if s.expr is not None:
                yield s.expr


# -------------------------------------------------------------------- stream DDL
@dataclass
class StreamField:
    name: str
    type: DataType
    elem_type: Optional[DataType] = None
    fields: List["StreamField"] = field(default_factory=list)


@dataclass
class StreamOptions:
    """WITH (...) options (reference: pkg/ast/sourceStmt.go StreamTokens)."""

    datasource: str = ""
    key: str = ""
    format: str = "json"
    conf_key: str = ""
    type: str = ""  # source connector type; default mqtt in reference
    strict_validation: bool = False
    timestamp: str = ""  # event-time column
    timestamp_format: str = ""
    retain_size: int = 0
    shared: bool = False
    schemaid: str = ""
    kind: str = ""
    delimiter: str = ""

    def to_dict(self) -> dict:
        return {k: v for k, v in self.__dict__.items()}


@dataclass
class StreamStmt:
    name: str
    fields: List[StreamField] = field(default_factory=list)
    options: StreamOptions = field(default_factory=StreamOptions)
    is_table: bool = False


@dataclass
class ShowStmt:
    target: str  # STREAMS | TABLES


@dataclass
class DescribeStmt:
    target: str  # STREAM | TABLE
    name: str


@dataclass
class DropStmt:
    target: str
    name: str


@dataclass
class ExplainStmt:
    target: str
    name: str


Statement = Any  # SelectStatement | StreamStmt | ShowStmt | ...


def is_aggregate_call(name: str) -> bool:
    from ..functions import registry

    return registry.is_aggregate(name)


def has_aggregate(expr: Optional[Expr]) -> bool:
    """Does this expression contain an aggregate function call
    (reference: internal/xsql/checkAgg.go)?"""
    for node in walk(expr):
        if isinstance(node, Call) and is_aggregate_call(node.name):
            return True
    return False
