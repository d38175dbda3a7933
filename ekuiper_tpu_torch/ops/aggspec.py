"""Aggregate kernel specs — which aggregates of a SELECT fold into the
group-by kernels, and what partial-state components each needs
(counterpart of ekuiper_tpu/ops/aggspec.py, scalar kinds only).

Device-eligible aggregates fold into (n, s1, s2, mn, mx) partials — count,
sum, sum of squares, min, max — the layout the reference uses, so state
and checkpoints cross between the two packages. The sketch aggregates
(hll, percentile_approx, heavy_hitters) are not ported yet and are refused
with NotImplementedError rather than planned some other way.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from ..sql import ast, expr_ir
from ..sql.compiler import CompiledExpr
from ..sql.expr_ir import NotVectorizable

# aggregate name -> components needed by finalize
DEVICE_AGGS: Dict[str, Set[str]] = {
    "count": {"n"},
    "sum": {"n", "s1"},
    "avg": {"n", "s1"},
    "min": {"mn", "n"},
    "max": {"mx", "n"},
    "stddev": {"n", "s1", "s2"},
    "stddevs": {"n", "s1", "s2"},
    "var": {"n", "s1", "s2"},
    "vars": {"n", "s1", "s2"},
    # inc_ forms share the same partials
    "inc_count": {"n"},
    "inc_sum": {"n", "s1"},
    "inc_avg": {"n", "s1"},
    "inc_min": {"mn", "n"},
    "inc_max": {"mx", "n"},
    "inc_stddev": {"n", "s1", "s2"},
    "inc_stddevs": {"n", "s1", "s2"},
}

#: device aggregates of the reference whose wide sketch components are
#: not ported yet
SKETCH_AGGS = ("hll", "distinct_count_approx", "percentile_approx",
               "heavy_hitters")

ALL_COMPONENTS = ("n", "s1", "s2", "mn", "mx")


@dataclass
class AggSpec:
    """One device-foldable aggregate call."""

    call: ast.Call
    kind: str  # count/sum/avg/min/max/stddev/stddevs/var/vars
    components: Set[str]
    arg: Optional[CompiledExpr]  # device closure for the argument (None = count(*))
    filter: Optional[CompiledExpr]  # FILTER(WHERE ...) device closure
    int_input: bool = False  # observed integer input → integer avg/sum results

    @property
    def is_star(self) -> bool:
        return self.arg is None


@dataclass
class KernelPlan:
    """Everything the fused window→aggregate kernels need."""

    specs: List[AggSpec]
    filter: Optional[CompiledExpr]  # WHERE clause (device)
    columns: Set[str] = field(default_factory=set)  # float32 columns to upload


def _compile_device(expr: ast.Expr, want: str
                    ) -> Optional[expr_ir.CompiledIR]:
    try:
        return expr_ir.compile_expr_ir(expr, want=want)
    except NotVectorizable:
        return None


def extract_kernel_plan(stmt: ast.SelectStatement) -> Optional[KernelPlan]:
    """Build a fully-fused device plan for the statement's aggregates.

    Returns None if any aggregate (or its argument expression) is not
    device-eligible; raises NotImplementedError for a sketch aggregate the
    reference would fold but the port does not yet.
    """
    calls = _collect_agg_calls(stmt)
    if not calls:
        return None
    for call in calls:
        if call.name in SKETCH_AGGS:
            raise NotImplementedError(
                f"aggregate {call.name}() is not ported yet")
    specs: List[AggSpec] = []
    columns: Set[str] = set()
    for call in calls:
        kind = call.name[4:] if call.name.startswith("inc_") else call.name
        if call.name not in DEVICE_AGGS:
            return None
        if call.partition or call.when is not None:
            return None
        arg_ce: Optional[CompiledExpr] = None
        if call.args and not isinstance(call.args[0], ast.Wildcard):
            if len(call.args) != 1:
                return None
            arg_ce = _compile_device(call.args[0], "number")
            if arg_ce is None:
                return None
            columns |= arg_ce.columns
        filter_ce: Optional[CompiledExpr] = None
        if call.filter is not None:
            filter_ce = _compile_device(call.filter, "bool")
            if filter_ce is None:
                return None
            columns |= filter_ce.columns
        specs.append(AggSpec(call=call, kind=kind,
                             components=set(DEVICE_AGGS[call.name]),
                             arg=arg_ce, filter=filter_ce))
    where_ce: Optional[CompiledExpr] = None
    if stmt.condition is not None:
        where_ce = _compile_device(stmt.condition, "bool")
        if where_ce is None:
            return None
        columns |= where_ce.columns
    return KernelPlan(specs=specs, filter=where_ce, columns=columns)


def _collect_agg_calls(stmt: ast.SelectStatement) -> List[ast.Call]:
    """All aggregate calls in SELECT fields + HAVING, deduplicated by
    (name, arg-tree repr) so avg(x) in both places folds once."""
    from ..functions import registry

    seen: Dict[str, ast.Call] = {}
    roots = [f.expr for f in stmt.fields]
    if stmt.having is not None:
        roots.append(stmt.having)
    for sf in stmt.sorts:
        if sf.expr is not None:
            roots.append(sf.expr)
    for root in roots:
        for node in ast.walk(root):
            if isinstance(node, ast.Call) and registry.is_aggregate(node.name):
                seen.setdefault(_call_key(node), node)
    return list(seen.values())


def _call_key(call: ast.Call) -> str:
    return f"{call.name}({','.join(map(_expr_key, call.args))})" + (
        f"|f:{_expr_key(call.filter)}" if call.filter is not None else ""
    )


def _expr_key(e: Optional[ast.Expr]) -> str:
    if e is None:
        return ""
    if isinstance(e, ast.FieldRef):
        return f"{e.stream}.{e.name}"
    if isinstance(e, ast.Call):
        return _call_key(e)
    if isinstance(e, (ast.IntegerLiteral, ast.NumberLiteral, ast.StringLiteral, ast.BooleanLiteral)):
        return repr(e.val)
    if isinstance(e, ast.BinaryExpr):
        return f"({_expr_key(e.lhs)}{e.op}{_expr_key(e.rhs)})"
    if isinstance(e, ast.UnaryExpr):
        return f"({e.op}{_expr_key(e.expr)})"
    if isinstance(e, ast.BetweenExpr):
        neg = "!" if e.negate else ""
        return (f"({_expr_key(e.value)} {neg}BETWEEN "
                f"{_expr_key(e.lo)},{_expr_key(e.hi)})")
    if isinstance(e, ast.InExpr):
        neg = "!" if e.negate else ""
        return (f"({_expr_key(e.value)} {neg}IN "
                f"[{','.join(_expr_key(v) for v in e.values)}])")
    if isinstance(e, ast.LikeExpr):
        neg = "!" if e.negate else ""
        return f"({_expr_key(e.value)} {neg}LIKE {_expr_key(e.pattern)})"
    if isinstance(e, ast.CaseExpr):
        base = _expr_key(e.value) if e.value is not None else ""
        whens = ";".join(f"{_expr_key(w.cond)}->{_expr_key(w.result)}"
                         for w in e.whens)
        els = _expr_key(e.else_expr) if e.else_expr is not None else ""
        return f"CASE({base};{whens};{els})"
    if isinstance(e, ast.Wildcard):
        return "*"
    return repr(e)
