"""Columnar expression IR — WHERE / FILTER / aggregate-argument expressions
compiled to vectorized closures (counterpart of ekuiper_tpu/sql/expr_ir.py,
cut down to numeric and boolean expressions; the lowering, type inference
and null discipline are the reference's).

- **Lowering** (`Lowerer`): ast.Expr → typed IR (NUM / BOOL) over float32
  columns: literals, arithmetic and bitwise operators, comparisons,
  AND/OR/NOT, BETWEEN, IN, CASE and the math functions.
- **Not ported yet**: the reference's string-dictionary columns (a column
  compared with a string literal) and event-time columns (a column fed to
  `hour()`/`year()`... or compared with an epoch-ms literal), with their
  host-derived `__sd_*`/`__ts32_*` device columns. The reference's type
  inference still decides which columns those are, and lowering refuses
  them with NotVectorizable(reason="not-ported") instead of guessing.
- **Null discipline**: every IR node evaluates to `(value, null_mask)`
  with the row interpreter's semantics: Kleene AND/OR/NOT, `NULL = NULL`
  true / `NULL = x` false, ordered comparisons with NULL are false,
  arithmetic/BETWEEN/IN propagate NULL, and a WHERE that evaluates to
  NULL drops the row.

The device closures bind the torch namespace of `sql/xp.py` (where the
reference binds jax.numpy): they run on the columns' device, before the
fold kernel launches. The host twins (`mode="host"`) bind its numpy
namespace over the same lowering: the window tail's shadow fold evaluates
them over host columns.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Set

import numpy as np
import torch

from . import ast
from .xp import NUMPY, TORCH

# ------------------------------------------------------------------ errors


class NotVectorizable(Exception):
    """Expression (or sub-expression) has no vectorized compilation.

    `reason` is a stable slug (the reference's slugs, plus "not-ported"
    for the string and event-time classes the port does not lower yet);
    the message stays human-oriented.
    """

    def __init__(self, msg: str, reason: str = "other") -> None:
        super().__init__(msg)
        self.reason = reason


def _not_ported(what: str) -> NotVectorizable:
    return NotVectorizable(f"{what} is not ported yet", reason="not-ported")


# ------------------------------------------------------------- type lattice
NUM = "num"      # float32 device column / python number
BOOL = "bool"
#: column types of the reference's inference that the port refuses
STR = "str"      # the reference's dictionary-encoded string column
TS = "ts"        # the reference's rebased event-time column

#: integer literals at/above this magnitude are epoch-ms times in the
#: reference (they cannot survive the float32 upload)
TS_LITERAL_MIN = 2 ** 31

#: IN constant vectors pad to the smallest fitting rung of this pow-2
#: ladder with a never-matching sentinel (kept from the reference so the
#: IR keys of both packages agree); wider lists are not vectorizable
IN_PAD_LADDER = (4, 8, 16, 32, 64, 128, 256)

# device-safe elementwise function tables
_MATH_UNARY = {
    "abs": "abs",
    "acos": "arccos", "asin": "arcsin", "atan": "arctan",
    "cos": "cos", "cosh": "cosh", "sin": "sin", "sinh": "sinh",
    "tan": "tan", "tanh": "tanh", "exp": "exp", "ln": "log",
    "sqrt": "sqrt", "ceil": "ceil", "ceiling": "ceil",
    "floor": "floor", "round": "round", "sign": "sign",
    "radians": "radians", "degrees": "degrees",
}
_MATH_BINARY = {
    "atan2": "arctan2", "power": "power", "pow": "power", "mod": "mod",
}

#: the reference's temporal extraction functions (event time: not ported)
TEMPORAL_FUNCS = ("hour", "minute", "second", "day", "day_of_month",
                  "day_of_week", "month", "year")


# ------------------------------------------------------------- typed value
class _V:
    """A lowered (typed) IR node: canonical key + per-backend builder.

    `build(xp)` returns `fn(cols) -> (value, null)` where `null` is
    None (never null), a bool array, or a python bool scalar; `lit`
    holds the python value for literal nodes.
    """

    __slots__ = ("ty", "key", "build", "lit")

    def __init__(self, ty: str, key: str,
                 build: Callable[[Any], Callable], lit=None) -> None:
        self.ty = ty
        self.key = key
        self.build = build
        self.lit = lit


def _const(ty: str, key: str, value, lit=None) -> _V:
    return _V(ty, key, lambda xp: lambda cols: (value, None), lit=lit)


def _or_null(xp, a, b):
    if a is None:
        return b
    if b is None:
        return a
    return xp.logical_or(a, b)


def _drop_null(xp, val, n):
    """val AND NOT null — the 'NULL compares false' rule."""
    if n is None:
        return val
    return xp.logical_and(val, xp.logical_not(n))


def _is_floating(v) -> bool:
    dt = getattr(v, "dtype", None)
    if dt is None:
        return isinstance(v, float)
    if isinstance(dt, torch.dtype):
        return dt.is_floating_point
    try:
        return np.issubdtype(np.dtype(str(dt)), np.floating)
    except TypeError:
        return False


def _is_int_like(x) -> bool:
    dt = getattr(x, "dtype", None)
    if dt is not None:
        if isinstance(dt, torch.dtype):
            return not (dt.is_floating_point or dt.is_complex
                        or dt == torch.bool)
        try:
            return np.issubdtype(np.dtype(str(dt)), np.integer)
        except TypeError:
            return False
    return isinstance(x, int) and not isinstance(x, bool)


# ------------------------------------------------------------ type inference
def _is_ts_literal(e: ast.Expr) -> bool:
    if isinstance(e, ast.IntegerLiteral):
        return abs(e.val) >= TS_LITERAL_MIN
    if isinstance(e, ast.NumberLiteral):
        return abs(e.val) >= TS_LITERAL_MIN and float(e.val).is_integer()
    return False


def _literal_ty(e: ast.Expr) -> Optional[str]:
    if isinstance(e, ast.StringLiteral):
        return STR
    if _is_ts_literal(e):
        return TS
    if isinstance(e, (ast.IntegerLiteral, ast.NumberLiteral)):
        return NUM
    if isinstance(e, ast.BooleanLiteral):
        return BOOL
    return None


def infer_column_types(expr: ast.Expr) -> Dict[str, str]:
    """Usage-driven column typing, iterated to fixpoint. Unification
    groups are comparison/IN/BETWEEN/CASE-match operand sets (a STR or
    TS member types every bare column in the group); temporal function
    arguments force TS; math-function arguments force NUM. Conflicting
    facts raise NotVectorizable("mixed-type-column") — never a guess."""
    types: Dict[str, str] = {}

    def assign(name: str, ty: str) -> bool:
        cur = types.get(name)
        if cur is None:
            types[name] = ty
            return True
        if cur != ty:
            raise NotVectorizable(
                f"column {name} used as both {cur} and {ty}",
                reason="mixed-type-column")
        return False

    def group_ty(exprs: List[ast.Expr]) -> Optional[str]:
        tys = set()
        for e in exprs:
            t = _literal_ty(e)
            if t is None and isinstance(e, ast.FieldRef):
                t = types.get(e.name)
            if t is not None:
                tys.add(t)
        if STR in tys:
            # a STR member only types the group when nothing numeric
            # contradicts it — `a IN (10, 'ok')` must NOT make `a` a
            # string column (the row interpreter just skips the
            # type-mismatched item)
            return STR if not ({NUM, TS} & tys) else None
        if TS in tys:
            return TS
        return None

    def unify(exprs: List[ast.Expr]) -> bool:
        ty = group_ty(exprs)
        if ty not in (STR, TS):
            return False
        changed = False
        for e in exprs:
            if isinstance(e, ast.FieldRef):
                changed |= assign(e.name, ty)
        return changed

    def visit(e: ast.Expr) -> bool:
        changed = False
        if isinstance(e, ast.BinaryExpr) and e.op in (
                "=", "!=", "<", "<=", ">", ">="):
            changed |= unify([e.lhs, e.rhs])
        elif isinstance(e, ast.BinaryExpr) and e.op in ("+", "-"):
            # absolute-time arithmetic: `ts - 1700000000000` types the
            # bare column TS (STR never propagates through arithmetic)
            if group_ty([e.lhs, e.rhs]) == TS:
                changed |= unify([e.lhs, e.rhs])
        elif isinstance(e, ast.InExpr):
            changed |= unify([e.value] + list(e.values))
        elif isinstance(e, ast.BetweenExpr):
            changed |= unify([e.value, e.lo, e.hi])
        elif isinstance(e, ast.CaseExpr) and e.value is not None:
            changed |= unify([e.value] + [w.cond for w in e.whens])
        elif isinstance(e, ast.Call):
            if e.name in TEMPORAL_FUNCS and e.args and \
                    isinstance(e.args[0], ast.FieldRef):
                changed |= assign(e.args[0].name, TS)
            elif e.name in _MATH_UNARY or e.name in _MATH_BINARY or \
                    e.name in ("cot", "bitnot", "log", "trunc"):
                for a in e.args:
                    if isinstance(a, ast.FieldRef):
                        # raises mixed-type-column when the column is
                        # already STR/TS elsewhere — never a guess
                        changed |= assign(a.name, NUM)
        for c in e.children():
            changed |= visit(c)
        return changed

    for _ in range(8):  # fixpoint: type facts only ever narrow
        if not visit(expr):
            break
    return types


# ---------------------------------------------------------------- lowering
class _LowerCtx:
    def __init__(self, types: Dict[str, str]) -> None:
        self.types = types
        self.referenced: Set[str] = set()


class Lowerer:
    """ast.Expr → typed IR closures. One instance per compiled
    expression."""

    def __init__(self, ctx: _LowerCtx) -> None:
        self.ctx = ctx

    # -- dispatch ----------------------------------------------------------
    def lower(self, e: ast.Expr) -> _V:
        m = getattr(self, "_l_" + type(e).__name__, None)
        if m is None:
            raise NotVectorizable(
                type(e).__name__,
                reason=_REASON_BY_NODE.get(type(e).__name__, "other"))
        return m(e)

    # -- literals ----------------------------------------------------------
    def _l_IntegerLiteral(self, e):
        if _is_ts_literal(e):
            raise _not_ported("an epoch-ms time literal (event time)")
        return _const(NUM, repr(e.val), e.val, lit=e.val)

    def _l_NumberLiteral(self, e):
        if _is_ts_literal(e):
            raise _not_ported("an epoch-ms time literal (event time)")
        return _const(NUM, repr(e.val), e.val, lit=e.val)

    def _l_BooleanLiteral(self, e):
        return _const(BOOL, repr(bool(e.val)), bool(e.val), lit=bool(e.val))

    def _l_StringLiteral(self, e):
        # a bare string value (projection result, concat operand) has no
        # device representation; comparisons handle their literals
        raise NotVectorizable("bare string value on device",
                              reason="string-value")

    # -- columns -----------------------------------------------------------
    def _l_FieldRef(self, e):
        name = e.name
        ty = self.ctx.types.get(name, NUM)
        if ty == STR:
            raise _not_ported(f"string column {name} (dictionary codes)")
        if ty == TS:
            raise _not_ported(f"event-time column {name}")
        self.ctx.referenced.add(name)

        def build(xp, _n=name):
            def f(cols):
                if _n not in cols:
                    raise NotVectorizable(f"column {_n} missing",
                                          reason="missing-column")
                v = cols[_n]
                null = xp.isnan(v) if _is_floating(v) else None
                vm = cols.get("__valid_" + _n)
                if vm is not None:
                    null = _or_null(xp, null, xp.logical_not(vm))
                return v, null

            return f

        return _V(NUM, f"col:{name}", build)

    # -- unary -------------------------------------------------------------
    def _l_UnaryExpr(self, e):
        a = self.lower(e.expr)
        if e.op == "-":
            if a.ty != NUM:
                raise NotVectorizable(f"unary - on {a.ty}",
                                      reason="type-mismatch")

            def build_n(xp, _a=a):
                fa = _a.build(xp)

                def f(cols):
                    v, n = fa(cols)
                    return -v, n

                return f

            return _V(NUM, f"(-{a.key})", build_n)
        if e.op == "NOT":
            if a.ty != BOOL:
                raise NotVectorizable("NOT on non-boolean",
                                      reason="type-mismatch")

            def build(xp, _a=a):
                fa = _a.build(xp)

                def f(cols):
                    v, n = fa(cols)
                    return xp.logical_not(v), n  # Kleene: NOT NULL = NULL

                return f

            return _V(BOOL, f"(NOT {a.key})", build)
        raise NotVectorizable(f"unary {e.op}", reason="operator")

    # -- AND / OR ----------------------------------------------------------
    def _logic(self, e):
        a, b = self.lower(e.lhs), self.lower(e.rhs)
        for s in (a, b):
            if s.ty != BOOL:
                raise NotVectorizable(f"{e.op} on non-boolean {s.ty}",
                                      reason="type-mismatch")
        is_and = e.op == "AND"

        def build(xp, _a=a, _b=b, _and=is_and):
            fa, fb = _a.build(xp), _b.build(xp)

            def f(cols):
                av, an = fa(cols)
                bv, bn = fb(cols)
                at = _drop_null(xp, av, an)       # definitely true
                bt = _drop_null(xp, bv, bn)
                either = _or_null(xp, an, bn)
                if _and:
                    val = xp.logical_and(at, bt)
                    if either is None:
                        return val, None
                    # false wins over null: null only where neither side
                    # is definitely false
                    af = _drop_null(xp, xp.logical_not(av), an)
                    bf = _drop_null(xp, xp.logical_not(bv), bn)
                    null = xp.logical_and(
                        either,
                        xp.logical_not(xp.logical_or(af, bf)))
                    return val, null
                val = xp.logical_or(at, bt)
                if either is None:
                    return val, None
                # true wins over null
                null = xp.logical_and(either, xp.logical_not(val))
                return val, null

            return f

        return _V(BOOL, f"({a.key} {e.op} {b.key})", build)

    # -- comparisons -------------------------------------------------------
    _CMP = {"=": "equal", "!=": "not_equal", "<": "less",
            "<=": "less_equal", ">": "greater", ">=": "greater_equal"}

    def _l_BinaryExpr(self, e):
        if e.op in ("AND", "OR"):
            return self._logic(e)
        if e.op in self._CMP:
            return self._cmp(e.op, e.lhs, e.rhs)
        return self._arith(e)

    def _cmp(self, op: str, lhs_e: ast.Expr, rhs_e: ast.Expr) -> _V:
        l_str = isinstance(lhs_e, ast.StringLiteral)
        r_str = isinstance(rhs_e, ast.StringLiteral)
        if l_str and r_str:
            if op in ("=", "!="):
                eq = (lhs_e.val == rhs_e.val) == (op == "=")
                return _const(BOOL, f"{lhs_e.val!r}{op}{rhs_e.val!r}", eq)
            raise NotVectorizable("ordered comparison of string literals",
                                  reason="string-order-compare")
        if l_str or r_str:
            other_e = rhs_e if l_str else lhs_e
            if op not in ("=", "!=") and isinstance(other_e, ast.FieldRef) \
                    and self.ctx.types.get(other_e.name) == STR:
                raise NotVectorizable(
                    "ordered comparison on dictionary-encoded strings",
                    reason="string-order-compare")
            # lowering refuses a string column, so what lowers here is no
            # string and the comparison is type-mismatched
            return self._cmp_mismatch(op, self.lower(other_e), None)
        a, b = self.lower(lhs_e), self.lower(rhs_e)
        if BOOL in (a.ty, b.ty) and a.ty != b.ty:
            return self._cmp_mismatch(op, a, b)
        return self._cmp_plain(op, a, b)

    def _cmp_plain(self, op: str, a: _V, b: _V) -> _V:
        fn_name = self._CMP[op]

        def build(xp, _a=a, _b=b, _op=op, _fn=fn_name):
            fa, fb = _a.build(xp), _b.build(xp)
            cmp_fn = getattr(xp, _fn)

            def f(cols):
                av, an = fa(cols)
                bv, bn = fb(cols)
                either = _or_null(xp, an, bn)
                raw = cmp_fn(av, bv)
                if _op not in ("=", "!="):
                    # NULL orders false (sql/eval.py cast.compare)
                    return _drop_null(xp, raw, either), None
                if either is None:
                    return raw, None
                both = (xp.logical_and(an, bn)
                        if an is not None and bn is not None else False)
                eq = _drop_null(xp, raw, either)
                if both is not False:
                    eq = xp.logical_or(eq, both)      # NULL = NULL is true
                if _op == "=":
                    return eq, None
                one = (xp.logical_and(either, xp.logical_not(both))
                       if both is not False else either)
                neq = _drop_null(xp, raw, either)
                return xp.logical_or(neq, one), None  # NULL != x is true

            return f

        return _V(BOOL, f"({a.key}{op}{b.key})", build)

    def _cmp_mismatch(self, op: str, a: _V, b: Optional[_V]) -> _V:
        """Type-mismatched comparison, reference semantics: '=' is true
        only when BOTH sides are NULL, '!=' is its negation, ordered
        comparisons are false (sql/eval.py: cast.compare -> None)."""
        if op not in ("=", "!="):
            key = f"(mismatch {op} {a.key})"
            return _const(BOOL, key, False)
        sides = [s for s in (a, b) if s is not None]

        def build(xp, _sides=tuple(sides), _op=op):
            fns = [s.build(xp) for s in _sides]
            n_sides = len(_sides)

            def f(cols):
                nulls = [fn(cols)[1] for fn in fns]
                if n_sides < 2 or any(n is None for n in nulls):
                    both = False  # a literal side is never null
                else:
                    both = xp.logical_and(nulls[0], nulls[1])
                if _op == "=":
                    return both, None
                return (xp.logical_not(both)
                        if both is not False else True), None

            return f

        keys = "/".join(s.key for s in sides)
        return _V(BOOL, f"(mismatch {op} {keys})", build)

    # -- arithmetic --------------------------------------------------------
    def _arith(self, e):
        a, b = self.lower(e.lhs), self.lower(e.rhs)
        op = e.op
        if a.ty != NUM or b.ty != NUM:
            raise NotVectorizable(f"arithmetic {op} on {a.ty}/{b.ty}",
                                  reason="type-mismatch")

        def build(xp, _a=a, _b=b, _op=op):
            fa, fb = _a.build(xp), _b.build(xp)

            def f(cols):
                av, an = fa(cols)
                bv, bn = fb(cols)
                null = _or_null(xp, an, bn)
                if _op == "+":
                    v = av + bv
                elif _op == "-":
                    v = av - bv
                elif _op == "*":
                    v = av * bv
                elif _op == "/":
                    if _is_int_like(av) and _is_int_like(bv):
                        v = av // bv
                    else:
                        v = av / bv
                elif _op == "%":
                    v = xp.mod(av, bv)
                else:
                    fn = {"&": xp.bitwise_and, "|": xp.bitwise_or,
                          "^": xp.bitwise_xor}[_op]
                    v = fn(_as_int(xp, av), _as_int(xp, bv))
                return v, null

            return f

        return _V(NUM, f"({a.key}{op}{b.key})", build)

    # -- BETWEEN / IN ------------------------------------------------------
    def _l_BetweenExpr(self, e):
        v = self.lower(e.value)
        lo = self.lower(e.lo)
        hi = self.lower(e.hi)
        for s in (v, lo, hi):
            if s.ty != NUM:
                raise NotVectorizable("BETWEEN on non-numeric",
                                      reason="type-mismatch")
        neg = bool(e.negate)

        def build(xp, _v=v, _lo=lo, _hi=hi, _neg=neg):
            fv, fl, fh = _v.build(xp), _lo.build(xp), _hi.build(xp)

            def f(cols):
                vv, vn = fv(cols)
                lv, ln = fl(cols)
                hv, hn = fh(cols)
                null = _or_null(xp, _or_null(xp, vn, ln), hn)
                raw = xp.logical_and(vv >= lv, vv <= hv)
                if _neg:
                    raw = xp.logical_not(raw)
                return _drop_null(xp, raw, null), null

            return f

        tag = "NOT BETWEEN" if neg else "BETWEEN"
        return _V(BOOL, f"({v.key} {tag} {lo.key},{hi.key})", build)

    def _l_InExpr(self, e):
        v = self.lower(e.value)
        all_literal = all(_literal_ty(x) is not None for x in e.values)
        if not all_literal:
            return self._in_dynamic(e, v)
        if len(e.values) > IN_PAD_LADDER[-1]:
            raise NotVectorizable(
                f"IN list wider than the {IN_PAD_LADDER[-1]} pad cap",
                reason="in-too-wide")
        neg = bool(e.negate)
        # numeric operand: only numeric constants can match (string items
        # compare None in the row interpreter — skipped)
        consts: List[float] = [
            float(x.val) for x in e.values
            if isinstance(x, (ast.IntegerLiteral, ast.NumberLiteral,
                              ast.BooleanLiteral))]
        padded = _pad_consts(consts, np.nan, np.float32)

        def build(xp, _v=v, _c=padded, _neg=neg):
            fv = _v.build(xp)

            def f(cols):
                vv, vn = fv(cols)
                hit = xp.any(
                    xp.expand_dims(vv, -1) == xp.const_like(_c, vv), -1)
                if _neg:
                    hit = xp.logical_not(hit)
                return _drop_null(xp, hit, vn), vn

            return f

        tag = "NOT IN" if neg else "IN"
        return _V(BOOL, f"({v.key} {tag} {padded.tolist()})", build)

    def _in_dynamic(self, e, v: _V) -> _V:
        """IN with non-literal items: OR-chain of equalities, with the
        IN null rule (a NULL operand is NULL regardless of the items)."""
        items = [self._cmp("=", e.value, x) for x in e.values]
        neg = bool(e.negate)

        def build(xp, _v=v, _items=tuple(items), _neg=neg):
            fv = _v.build(xp)
            fns = [i.build(xp) for i in _items]

            def f(cols):
                _, vn = fv(cols)
                hit = False
                for fn in fns:
                    iv, _ = fn(cols)
                    hit = iv if hit is False else xp.logical_or(hit, iv)
                if _neg:
                    hit = xp.logical_not(hit)
                return _drop_null(xp, hit, vn), vn

            return f

        tag = "NOT IN" if neg else "IN"
        return _V(BOOL, f"({v.key} {tag} dyn[{len(items)}])", build)

    # -- CASE --------------------------------------------------------------
    def _l_CaseExpr(self, e):
        if e.value is not None:
            whens = [(self._cmp("=", e.value, w.cond),
                      self.lower(w.result)) for w in e.whens]
        else:
            whens = [(self.lower(w.cond), self.lower(w.result))
                     for w in e.whens]
        for cond, res in whens:
            if cond.ty != BOOL:
                raise NotVectorizable("CASE condition is not boolean",
                                      reason="type-mismatch")
            if res.ty != NUM:
                raise NotVectorizable(
                    f"CASE result of type {res.ty} on device",
                    reason="type-mismatch")
        els = self.lower(e.else_expr) if e.else_expr is not None else None
        if els is not None and els.ty != NUM:
            raise NotVectorizable("CASE else of unsupported type",
                                  reason="type-mismatch")

        def build(xp, _whens=tuple(whens), _els=els):
            fws = [(c.build(xp), r.build(xp)) for c, r in _whens]
            fe = _els.build(xp) if _els is not None else None

            def f(cols):
                if fe is not None:
                    val, null = fe(cols)
                    null = False if null is None else null
                else:
                    val, null = np.float32(np.nan), True
                for fc, fr in reversed(fws):
                    cv, cn = fc(cols)
                    take = _drop_null(xp, cv, cn)
                    rv, rn = fr(cols)
                    val = xp.where(take, rv, val)
                    null = xp.where(take, False if rn is None else rn,
                                    null)
                if null is False:
                    null = None
                return val, null

            return f

        key = "CASE(" + ";".join(f"{c.key}->{r.key}" for c, r in whens) \
            + (f";else {els.key}" if els is not None else "") + ")"
        return _V(NUM, key, build)

    # -- calls -------------------------------------------------------------
    def _l_Call(self, e):
        if e.filter is not None or e.partition or e.when is not None:
            raise NotVectorizable("call clauses", reason="call-clause")
        if e.name in TEMPORAL_FUNCS:
            raise _not_ported(f"{e.name}() (event time)")
        if e.name == "pi":
            return _const(NUM, "pi", float(np.pi))
        args = [self.lower(a) for a in e.args]
        for a in args:
            if a.ty != NUM:
                raise NotVectorizable(f"{e.name} argument of type {a.ty}",
                                      reason="type-mismatch")
        builder = self._math_builder(e.name, len(args))
        if builder is None:
            from ..functions import registry

            fd = registry.lookup(e.name)
            if fd is None:
                raise NotVectorizable(f"unknown function {e.name}",
                                      reason="unknown-func")
            reason = ("stateful-func" if getattr(fd, "stateful", False)
                      or fd.ftype != registry.SCALAR
                      else "unvectorized-func")
            raise NotVectorizable(f"no device impl for {e.name}",
                                  reason=reason)

        def build(xp, _args=tuple(args), _b=builder):
            fns = [a.build(xp) for a in _args]
            impl = _b(xp)

            def f(cols):
                pairs = [fn(cols) for fn in fns]
                null = None
                for _, n in pairs:
                    null = _or_null(xp, null, n)
                return impl(*[v for v, _ in pairs]), null

            return f

        key = f"{e.name}({','.join(a.key for a in args)})"
        return _V(NUM, key, build)

    @staticmethod
    def _math_builder(name: str, arity: int):
        if name in _MATH_UNARY and arity == 1:
            fname = _MATH_UNARY[name]
            return lambda xp: getattr(xp, fname)
        if name in _MATH_BINARY and arity == 2:
            fname = _MATH_BINARY[name]
            return lambda xp: getattr(xp, fname)
        if name in ("bitand", "bitor", "bitxor") and arity == 2:
            fname = {"bitand": "bitwise_and", "bitor": "bitwise_or",
                     "bitxor": "bitwise_xor"}[name]
            return lambda xp: (lambda a, b: getattr(xp, fname)(
                _as_int(xp, a), _as_int(xp, b)))
        if name == "cot" and arity == 1:
            return lambda xp: (lambda a: 1.0 / xp.tan(a))
        if name == "bitnot" and arity == 1:
            return lambda xp: (lambda a: xp.invert(_as_int(xp, a)))
        if name == "log":
            if arity == 1:
                return lambda xp: xp.log10
            if arity == 2:
                return lambda xp: (lambda b, x: xp.log(x) / xp.log(b))
        if name == "trunc" and arity == 2:
            return lambda xp: (
                lambda a, d: xp.trunc(a * 10.0 ** d) / 10.0 ** d)
        return None

    # -- unsupported node classes (structured reasons) ---------------------
    def _l_LikeExpr(self, e):
        raise NotVectorizable("LIKE on device", reason="like")

    def _l_Wildcard(self, e):
        raise NotVectorizable("wildcard", reason="wildcard")

    def _l_IndexExpr(self, e):
        raise NotVectorizable("index access", reason="json-path")

    def _l_ArrowExpr(self, e):
        raise NotVectorizable("arrow access", reason="json-path")

    def _l_MetaRef(self, e):
        raise NotVectorizable("meta reference", reason="meta-ref")


_REASON_BY_NODE = {
    "LikeExpr": "like", "IndexExpr": "json-path", "ArrowExpr": "json-path",
    "Wildcard": "wildcard", "MetaRef": "meta-ref",
}


def _pad_consts(values, pad_val, dtype) -> np.ndarray:
    """Pad an IN constant list to the pow-2 ladder with a sentinel that
    can never match a real operand value (bucketed operand shapes)."""
    n = max(len(values), 1)
    b = IN_PAD_LADDER[-1]
    for b in IN_PAD_LADDER:
        if b >= n:
            break
    out = np.full(b, pad_val, dtype=dtype)
    if values:
        out[:len(values)] = np.asarray(values, dtype=dtype)
    return out


def _as_int(xp, v):
    if _is_int_like(v):
        return v
    if hasattr(v, "dtype"):
        return xp.astype(v, np.int32)
    return int(v)


# --------------------------------------------------------------- compiled
class CompiledIR:
    """One compiled expression: a backend closure plus the plan facts
    the kernel integration needs (device columns, canonical IR key).
    Call-compatible with sql/compiler.CompiledExpr (fn/columns/
    __call__)."""

    def __init__(self, fn, columns: Set[str], *, ir_key: str,
                 ty: str) -> None:
        self.fn = fn
        self.columns = columns
        self.ir_key = ir_key
        self.ty = ty

    def __call__(self, cols) -> Any:
        return self.fn(cols)


def compile_expr_ir(expr: ast.Expr, mode: str = "device",
                    want: str = "auto") -> CompiledIR:
    """Lower + compile one expression for `mode` ("device" → closures over
    torch tensors, "host" → the numpy twin). `want`:
      "bool"   — a WHERE/FILTER mask: NULL and non-boolean drop the row
                 (sql/eval.py eval_condition's `v is True`).
      "number" — a float32 value column with NaN at NULLs (agg args).
      "auto"   — the node's own value (bool: NULL→False; num: NULL→NaN).
    Raises NotVectorizable (with a structured `reason`) when any node
    has no vectorized form.
    """
    types = infer_column_types(expr)
    ctx = _LowerCtx(types)
    root = Lowerer(ctx).lower(expr)
    xp = TORCH if mode == "device" else NUMPY
    inner = root.build(xp)
    ty = root.ty

    if want == "bool":
        if ty != BOOL:
            # a non-boolean WHERE never equals True in the row
            # interpreter — every row drops; keep that exact contract
            def fn(cols):
                return False
        else:
            def fn(cols):
                v, n = inner(cols)
                return _drop_null(xp, v, n)
    elif want == "number":
        if ty == BOOL:
            def fn(cols):
                v, n = inner(cols)
                out = xp.where(v, np.float32(1.0), np.float32(0.0))
                if n is not None:
                    out = xp.where(n, np.float32(np.nan), out)
                return out
        else:
            def fn(cols):
                v, n = inner(cols)
                if hasattr(v, "dtype"):
                    v = xp.astype(v, np.float32)
                if n is not None:
                    v = xp.where(n, np.float32(np.nan), v)
                return v
    else:
        def fn(cols):
            v, n = inner(cols)
            if n is None:
                return v
            if ty == BOOL:
                return _drop_null(xp, v, n)
            return xp.where(n, np.float32(np.nan), v)

    return CompiledIR(fn, set(ctx.referenced),
                      ir_key=f"{root.key}|want={want}", ty=ty)


def try_compile_ir(expr: ast.Expr, mode: str = "device",
                   want: str = "auto") -> Optional[CompiledIR]:
    try:
        return compile_expr_ir(expr, mode=mode, want=want)
    except NotVectorizable:
        return None
