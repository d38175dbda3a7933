"""Expression → vectorized batch compiler for host-side tails (subset of
ekuiper_tpu/sql/compiler.py).

`compile_expr(expr)` returns a closure evaluating the expression over a
whole columns dict at once with numpy — the direct-emit tail (ops/emit.py)
compiles HAVING / ORDER BY / projection expressions over the finalize
arrays with it. The reference's device mode is the port's typed
expression IR (sql/expr_ir.py), whose closures run on torch tensors.

Nodes with no vectorized form raise NotVectorizable at compile time; the
port's planner then refuses the rule (the row interpreter is not ported).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Set

import numpy as np

from ..functions import registry
from . import ast
from .expr_ir import NotVectorizable  # shared exception (structured reason)

Cols = Dict[str, Any]


# device-safe function table: name -> builder(xp, *arg_closures) -> closure
def _u(fname: str):
    """Unary elementwise: xp.<fname>."""

    def build(xp, a):
        fn = getattr(xp, fname)
        return lambda cols: fn(a(cols))

    return build


def _b(fname: str):
    def build(xp, a, b):
        fn = getattr(xp, fname)
        return lambda cols: fn(a(cols), b(cols))

    return build


_DEVICE_FUNCS: Dict[str, Callable] = {
    "abs": _u("abs"),
    "acos": _u("arccos"), "asin": _u("arcsin"), "atan": _u("arctan"),
    "cos": _u("cos"), "cosh": _u("cosh"), "sin": _u("sin"), "sinh": _u("sinh"),
    "tan": _u("tan"), "tanh": _u("tanh"), "exp": _u("exp"), "ln": _u("log"),
    "sqrt": _u("sqrt"), "ceil": _u("ceil"), "ceiling": _u("ceil"),
    "floor": _u("floor"), "round": _u("round"), "sign": _u("sign"),
    "radians": _u("radians"), "degrees": _u("degrees"),
    "atan2": _b("arctan2"), "power": _b("power"), "pow": _b("power"),
    "mod": _b("mod"),
    "bitand": _b("bitwise_and"), "bitor": _b("bitwise_or"),
    "bitxor": _b("bitwise_xor"),
}


def _device_func(name: str, xp, arg_closures):
    if name == "cot":
        a = arg_closures[0]
        return lambda cols: 1.0 / xp.tan(a(cols))
    if name == "bitnot":
        a = arg_closures[0]
        return lambda cols: xp.invert(a(cols))
    if name == "pi":
        return lambda cols: xp.asarray(np.pi, dtype=xp.float32)
    if name == "log":
        if len(arg_closures) == 1:
            a = arg_closures[0]
            return lambda cols: xp.log10(a(cols))
        b_, x_ = arg_closures
        return lambda cols: xp.log(x_(cols)) / xp.log(b_(cols))
    if name == "trunc":
        a, d = arg_closures
        return lambda cols: xp.trunc(a(cols) * 10.0 ** d(cols)) / 10.0 ** d(cols)
    builder = _DEVICE_FUNCS.get(name)
    if builder is None:
        return None
    return builder(xp, *arg_closures)


class Compiler:
    def __init__(self) -> None:
        self.xp = np
        self.referenced: Set[str] = set()

    # ---------------------------------------------------------------- compile
    def compile(self, expr: ast.Expr) -> Callable[[Cols], Any]:
        m = getattr(self, "_c_" + type(expr).__name__, None)
        if m is None:
            raise NotVectorizable(type(expr).__name__)
        return m(expr)

    def _c_IntegerLiteral(self, e):
        v = e.val
        return lambda cols: v

    def _c_NumberLiteral(self, e):
        v = e.val
        return lambda cols: v

    def _c_BooleanLiteral(self, e):
        v = e.val
        return lambda cols: v

    def _c_StringLiteral(self, e):
        v = e.val
        return lambda cols: v

    def _c_FieldRef(self, e):
        name = e.name
        self.referenced.add(name)

        def get(cols):
            if name not in cols:
                raise NotVectorizable(f"column {name} missing")
            return cols[name]

        return get

    def _c_UnaryExpr(self, e):
        a = self.compile(e.expr)
        xp = self.xp
        if e.op == "-":
            return lambda cols: -a(cols)
        if e.op == "NOT":
            return lambda cols: xp.logical_not(a(cols))
        raise NotVectorizable(f"unary {e.op}")

    _CMP = {
        "=": "equal", "!=": "not_equal", "<": "less", "<=": "less_equal",
        ">": "greater", ">=": "greater_equal",
    }

    def _c_BinaryExpr(self, e):
        a = self.compile(e.lhs)
        b = self.compile(e.rhs)
        xp = self.xp
        op = e.op
        if op in self._CMP:
            fn = getattr(xp, self._CMP[op])
            return lambda cols: fn(a(cols), b(cols))
        if op == "AND":
            return lambda cols: xp.logical_and(a(cols), b(cols))
        if op == "OR":
            return lambda cols: xp.logical_or(a(cols), b(cols))
        if op == "+":
            return lambda cols: a(cols) + b(cols)
        if op == "-":
            return lambda cols: a(cols) - b(cols)
        if op == "*":
            return lambda cols: a(cols) * b(cols)
        if op == "/":
            def div(cols):
                x, y = a(cols), b(cols)
                if _is_int(x) and _is_int(y):
                    return x // y
                return x / y

            return div
        if op == "%":
            return lambda cols: xp.mod(a(cols), b(cols))
        if op in ("&", "|", "^"):
            fn = {
                "&": xp.bitwise_and, "|": xp.bitwise_or, "^": xp.bitwise_xor
            }[op]
            return lambda cols: fn(a(cols), b(cols))
        raise NotVectorizable(f"binary {op}")

    def _c_BetweenExpr(self, e):
        v = self.compile(e.value)
        lo = self.compile(e.lo)
        hi = self.compile(e.hi)
        xp = self.xp
        neg = e.negate

        def run(cols):
            x = v(cols)
            r = xp.logical_and(x >= lo(cols), x <= hi(cols))
            return xp.logical_not(r) if neg else r

        return run

    def _c_InExpr(self, e):
        v = self.compile(e.value)
        items = [self.compile(x) for x in e.values]
        xp = self.xp
        neg = e.negate

        def run(cols):
            x = v(cols)
            r = None
            for item in items:
                eq = x == item(cols)
                r = eq if r is None else xp.logical_or(r, eq)
            if r is None:
                r = xp.zeros(getattr(x, "shape", ()), dtype=bool)
            return xp.logical_not(r) if neg else r

        return run

    def _c_CaseExpr(self, e):
        xp = self.xp
        else_fn = self.compile(e.else_expr) if e.else_expr is not None else None
        # NULL else branch becomes NaN in vectorized numerics
        null = np.nan
        base = self.compile(e.value) if e.value is not None else None
        conds = [(self.compile(w.cond), self.compile(w.result)) for w in e.whens]

        def run(cols):
            out = else_fn(cols) if else_fn is not None else null
            if base is not None:
                x = base(cols)
                for cond, res in reversed(conds):
                    out = xp.where(x == cond(cols), res(cols), out)
            else:
                for cond, res in reversed(conds):
                    out = xp.where(cond(cols), res(cols), out)
            return out

        return run

    def _c_Call(self, e):
        fd = registry.lookup(e.name)
        if fd is None:
            raise NotVectorizable(f"unknown function {e.name}")
        if fd.ftype != registry.SCALAR or fd.stateful:
            raise NotVectorizable(f"{e.name} is not a pure scalar function")
        if e.filter is not None or e.partition or e.when is not None:
            raise NotVectorizable("call clauses")
        args = [self.compile(a) for a in e.args]
        dev = _device_func(e.name, self.xp, args)
        if dev is not None:
            return dev
        if fd.vexec is not None:
            vex = fd.vexec
            return lambda cols: vex(*[a(cols) for a in args])
        raise NotVectorizable(f"no vectorized impl for {e.name}")

    def _c_Wildcard(self, e):
        raise NotVectorizable("wildcard")

    def _c_IndexExpr(self, e):
        raise NotVectorizable("index access")

    def _c_ArrowExpr(self, e):
        raise NotVectorizable("arrow access")

    def _c_LikeExpr(self, e):
        raise NotVectorizable("LIKE is not ported yet")


class CompiledExpr:
    """Compiled expression + metadata."""

    def __init__(self, fn: Callable[[Cols], Any], columns: Set[str]) -> None:
        self.fn = fn
        self.columns = columns

    def __call__(self, cols: Cols) -> Any:
        return self.fn(cols)


def compile_expr(expr: ast.Expr) -> CompiledExpr:
    c = Compiler()
    fn = c.compile(expr)
    return CompiledExpr(fn, c.referenced)


def try_compile(expr: ast.Expr) -> Optional[CompiledExpr]:
    try:
        return compile_expr(expr)
    except NotVectorizable:
        return None


def _is_int(x) -> bool:
    dt = getattr(x, "dtype", None)
    if dt is not None:
        return np.issubdtype(dt, np.integer)
    return isinstance(x, int) and not isinstance(x, bool)
