"""Row-path expression evaluator (cut down from ekuiper_tpu/sql/eval.py —
analogue of eKuiper's ValuerEval tree interpreter, internal/xsql/valuer.go:289
Eval, :574 evalBinaryExpr).

The host operator chain (runtime/nodes_ops.py, nodes_join.py,
nodes_window.py, nodes_relational.py) evaluates its expressions one row at a
time with it: literals, field references (qualified `stream.col` over a
join row, or unqualified), arithmetic, comparisons, AND / OR / NOT, and the
calls this slice runs: `lag` (its state per call instance in
`func_states`), `row_number`, `isnull` (the engine's IS NULL), and the
cached results of the analytic and window-function nodes
(`__analytic_<func_id>` cal-cols). NULL semantics are the reference's:
`NULL = NULL` is true and `NULL = x` false, an ordered comparison with NULL
is false, AND/OR are three-valued, arithmetic on NULL is NULL, and
`eval_condition` keeps a row only for a result that is exactly True.

Any other function or expression (`*`, BETWEEN, IN, CASE, LIKE, bitwise
operators, meta, index and arrow expressions) raises NotImplementedError:
its row path belongs to the host operator path still to port (ROADMAP
Queue 1 item 5).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from ..data import cast
from ..data.rows import Row
from ..functions import registry
from ..functions.context import FunctionContext
from . import ast

_NOT_PORTED = "not ported yet (ROADMAP Queue 1 item 5)"


class EvalError(RuntimeError):
    pass


class Evaluator:
    """Evaluates expressions against a single Row.

    `func_states` maps func_id -> per-instance state dict (stateful funcs);
    owned by the operator so state survives across rows/batches and is
    checkpointable.
    """

    def __init__(self) -> None:
        self.func_states: Dict[int, Dict[str, Any]] = {}

    # ------------------------------------------------------------------ core
    def eval(self, expr: ast.Expr, row: Optional[Row]) -> Any:
        m = getattr(self, "_eval_" + type(expr).__name__, None)
        if m is None:
            raise NotImplementedError(
                f"row evaluation of {type(expr).__name__} is {_NOT_PORTED}")
        return m(expr, row)

    def eval_condition(self, expr: ast.Expr, row: Optional[Row]) -> bool:
        return self.eval(expr, row) is True

    # --------------------------------------------------------------- literals
    def _eval_IntegerLiteral(self, e, row) -> Any:
        return e.val

    _eval_NumberLiteral = _eval_IntegerLiteral
    _eval_StringLiteral = _eval_IntegerLiteral
    _eval_BooleanLiteral = _eval_IntegerLiteral

    # ------------------------------------------------------------- references
    def _eval_FieldRef(self, e: ast.FieldRef, row) -> Any:
        if row is None:
            return None
        v, _ = row.value(e.name, e.stream)
        return v

    # -------------------------------------------------------------- operators
    def _eval_UnaryExpr(self, e: ast.UnaryExpr, row) -> Any:
        v = self.eval(e.expr, row)
        if e.op == "NOT":
            if v is None:
                return None
            return not cast.to_bool(v)
        if e.op == "-":
            if v is None:
                return None
            return -v
        raise EvalError(f"unknown unary operator {e.op}")

    def _eval_BinaryExpr(self, e: ast.BinaryExpr, row) -> Any:
        op = e.op
        if op == "AND":
            lhs = self.eval(e.lhs, row)
            if lhs is False:
                return False
            rhs = self.eval(e.rhs, row)
            if rhs is False:
                return False
            if lhs is None or rhs is None:
                return None
            return cast.to_bool(lhs) and cast.to_bool(rhs)
        if op == "OR":
            lhs = self.eval(e.lhs, row)
            if lhs is True:
                return True
            rhs = self.eval(e.rhs, row)
            if rhs is True:
                return True
            if lhs is None or rhs is None:
                return None
            return cast.to_bool(lhs) or cast.to_bool(rhs)

        lhs = self.eval(e.lhs, row)
        rhs = self.eval(e.rhs, row)
        if op in ("=", "!="):
            if lhs is None or rhs is None:
                # reference: null = null is true, null = x is false
                eq = lhs is None and rhs is None
                return eq if op == "=" else not eq
            c = cast.compare(lhs, rhs)
            eq = lhs == rhs if c is None else c == 0
            return eq if op == "=" else not eq
        if op in ("<", "<=", ">", ">="):
            c = cast.compare(lhs, rhs)
            if c is None:
                return False
            return {"<": c < 0, "<=": c <= 0, ">": c > 0, ">=": c >= 0}[op]
        if lhs is None or rhs is None:
            return None
        if op in ("+", "-", "*", "/", "%"):
            return self._arith(op, lhs, rhs)
        raise NotImplementedError(
            f"row evaluation of the {op} operator is {_NOT_PORTED}")

    @staticmethod
    def _arith(op: str, lhs: Any, rhs: Any) -> Any:
        if isinstance(lhs, str) or isinstance(rhs, str):
            raise EvalError(
                f"invalid operation string {op} — use concat() for strings")
        both_int = (
            isinstance(lhs, int) and isinstance(rhs, int)
            and not isinstance(lhs, bool) and not isinstance(rhs, bool))
        a = cast.to_float(lhs) if not both_int else lhs
        b = cast.to_float(rhs) if not both_int else rhs
        if op == "+":
            return a + b
        if op == "-":
            return a - b
        if op == "*":
            return a * b
        if op in ("/", "%") and b == 0:
            raise EvalError("division by zero")
        if op == "/":
            return a // b if both_int else a / b
        return a % b

    # ---------------------------------------------------------------- calls
    def _eval_Call(self, e: ast.Call, row) -> Any:
        fd = registry.lookup(e.name)
        if fd is None:
            raise EvalError(f"function {e.name} not found")
        if fd.ftype in (registry.ANALYTIC, registry.WINDOW_FUNC):
            # AnalyticNode/WindowFuncNode pre-compute and cache on the row
            if row is not None:
                cached, ok = row.value(f"__analytic_{e.func_id}")
                if ok:
                    return cached
        if fd.exec is None:
            raise NotImplementedError(
                f"the row path of {e.name}() is {_NOT_PORTED}")
        ctx = FunctionContext(state=self.func_states.setdefault(e.func_id,
                                                                {}))
        if fd.ftype == registry.WINDOW_FUNC:
            return fd.exec([self.eval(a, row) for a in e.args], ctx)
        if fd.ftype == registry.ANALYTIC:
            partition = ""
            if e.partition:
                partition = "#".join(
                    cast.to_string(self.eval(p, row)) for p in e.partition)
            # OVER(WHEN false): peek state, don't update (reference validData=false)
            update = e.when is None or self.eval(e.when, row) is True
            args = [self.eval(a, row) for a in e.args]
            try:
                return fd.exec(args, ctx, partition, update)
            except EvalError:
                raise
            except Exception as ex:
                raise EvalError(f"call {e.name} error: {ex}") from ex
        if e.filter is not None or e.partition or e.when is not None:
            raise EvalError(f"FILTER/PARTITION BY/OVER not supported on "
                            f"scalar function {e.name}")
        return fd.exec([self.eval(a, row) for a in e.args], ctx)
