"""Built-in function table (subset of ekuiper_tpu/functions/registry.py).

The port's slice compiles expressions, it never executes functions row by
row, so this table holds only what the SQL front end and the expression
compilers ask of a function: its kind. Every aggregate name of the full
engine is listed, so `is_aggregate` answers exactly as the reference does
and an aggregate the port cannot fold is recognised (and refused) rather
than mistaken for a scalar; the scalars are the device-math and temporal
functions the expression IR lowers itself.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

SCALAR = "scalar"
AGGREGATE = "aggregate"

_AGGREGATES = (
    "avg", "collect", "count", "deduplicate", "distinct_count_approx",
    "heavy_hitters", "hll", "inc_avg", "inc_collect", "inc_count",
    "inc_last_value", "inc_max", "inc_merge_agg", "inc_min", "inc_stddev",
    "inc_stddevs", "inc_sum", "last_agg_hit_count", "last_agg_hit_time",
    "last_value", "max", "median", "merge_agg", "min", "percentile_approx",
    "percentile_cont", "percentile_disc", "stddev", "stddevs", "sum", "var",
    "vars",
)

_SCALARS = (
    # device math (sql/expr_ir.py _MATH_UNARY/_MATH_BINARY + specials)
    "abs", "acos", "asin", "atan", "cos", "cosh", "sin", "sinh", "tan",
    "tanh", "exp", "ln", "sqrt", "ceil", "ceiling", "floor", "round", "sign",
    "radians", "degrees", "atan2", "power", "pow", "mod", "bitand", "bitor",
    "bitxor", "cot", "bitnot", "pi", "log", "trunc",
    # temporal extraction (sql/expr_ir.py TEMPORAL_FUNCS) and window bounds
    "hour", "minute", "second", "day", "day_of_month", "day_of_week",
    "month", "year", "window_start", "window_end",
)


@dataclass(frozen=True)
class FunctionDef:
    name: str
    ftype: str
    stateful: bool = False
    #: vectorized host implementation; none of the port's scalars has one
    #: (the compilers lower them directly)
    vexec: Optional[Callable] = None
    #: parse-time argument validator; the reference's validators belong to
    #: functions the port does not run, so none is set
    val: Optional[Callable] = None


_registry = {n: FunctionDef(n, AGGREGATE) for n in _AGGREGATES}
_registry.update({n: FunctionDef(n, SCALAR) for n in _SCALARS})


def lookup(name: str) -> Optional[FunctionDef]:
    return _registry.get(name.lower())


def is_aggregate(name: str) -> bool:
    fd = lookup(name)
    return fd is not None and fd.ftype == AGGREGATE
