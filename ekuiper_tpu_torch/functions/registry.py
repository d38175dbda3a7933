"""Built-in function table (subset of ekuiper_tpu/functions/registry.py).

Most of the port compiles expressions and never executes a function row by
row, so this table holds mainly what the SQL front end and the expression
compilers ask of a function: its kind. Every aggregate name of the full
engine is listed, so `is_aggregate` answers exactly as the reference does
and an aggregate the port cannot fold is recognised (and refused) rather
than mistaken for a scalar; the scalars are the device-math and temporal
functions the expression IR lowers itself. The analytic and window
functions are listed likewise (`is_analytic`, WINDOW_FUNC), and the host
row evaluator (sql/eval.py) runs the `exec` of the few that have one:
`lag` (funcs_analytic.py), `row_number` (funcs_window.py) and `isnull`
(funcs_misc.py); rank,
dense_rank and lead are computed by the window-function node and their
exec only refuses a direct call.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

SCALAR = "scalar"
AGGREGATE = "aggregate"
ANALYTIC = "analytic"
WINDOW_FUNC = "window"

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
    #: row-path implementation (sql/eval.py); None where the port has none
    exec: Optional[Callable] = None


#: the reference's analytic functions (funcs_analytic.py); only lag runs
_ANALYTICS = ("lag", "latest", "changed_col", "had_changed")

_registry = {n: FunctionDef(n, AGGREGATE) for n in _AGGREGATES}
_registry.update({n: FunctionDef(n, SCALAR) for n in _SCALARS})
_registry.update({n: FunctionDef(n, ANALYTIC, stateful=True)
                  for n in _ANALYTICS})


def register(name: str, ftype: str = SCALAR, stateful: bool = False
             ) -> Callable[[Callable], Callable]:
    """Give a function its row-path implementation."""

    def wrap(fn: Callable) -> Callable:
        _registry[name.lower()] = FunctionDef(name.lower(), ftype,
                                              stateful=stateful, exec=fn)
        return fn

    return wrap


def lookup(name: str) -> Optional[FunctionDef]:
    _ensure_loaded()
    return _registry.get(name.lower())


def is_analytic(name: str) -> bool:
    fd = lookup(name)
    return fd is not None and fd.ftype == ANALYTIC


_loaded = False


def _ensure_loaded() -> None:
    """Import the function modules on first lookup (they self-register)."""
    global _loaded
    if _loaded:
        return
    _loaded = True
    from . import funcs_analytic, funcs_misc, funcs_window  # noqa: F401


def is_aggregate(name: str) -> bool:
    fd = lookup(name)
    return fd is not None and fd.ftype == AGGREGATE
