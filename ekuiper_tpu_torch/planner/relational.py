"""Relational-tier lowering: stream-stream joins and analytic/window
functions onto the device kernels (ops/joinring.py, ops/segscan.py) —
counterpart of ekuiper_tpu/planner/relational.py.

The lowering is a classifier over plan text: every decision either produces
a device plan or raises NotVectorizable with a structured `join_*` /
`analytic_*` reason slug, recorded through sql/compiler.record_host_fallback
by the planner, so a rule that stays on the host nested loop is
attributable, never silent.

Join ON clauses split into AND conjuncts and classify three ways:

  equi     l.k = r.k            -> KeyTable slot equality (composite OK)
  band     l.ts - r.ts REL c    -> int32 banded gather bounds (affine
                                   forms over +/- and integer literals)
  residual anything else        -> expr-IR three-valued ON residual,
                                   compiled for device AND host from the
                                   same renamed tree (__jl_*/__jr_*)

Anything outside that grammar (non-integral band literals, unqualified
refs, IR-rejected residuals) falls back with its named reason. The port's
expression IR does not lower the reference's string-dictionary and
event-time classes yet (sql/expr_ir.py), so a residual comparing a column
with a string literal, or an event-time residual, raises reason
`join_on_residual` here where the reference lowers it: that rule runs the
host nested loop (runtime/nodes_join.py), whose rows equal the reference's
(ROADMAP Queue 1 item 6). The host nested loop stays bit-identical because
the mask only decides PAIRING — emitted tuples are the original host rows
in the reference emission order.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..utils.device import Device

from ..sql import ast
from ..sql.expr_ir import NotVectorizable, compile_expr_ir

_REL_OPS = {"<", "<=", ">", ">=", "="}

#: window functions computed collection-wide by the vector path
#: (runtime/nodes_relational.py); row_number keeps its per-row exec
VECTOR_WINDOW_FUNCS = {"rank", "dense_rank", "lead"}


def _nv(msg: str, reason: str) -> NotVectorizable:
    return NotVectorizable(msg, reason=reason)


# ------------------------------------------------------------------ joins
@dataclass
class JoinLowering:
    """Device plan for one stream-stream join step."""

    join_type: ast.JoinType
    left: str
    right: str
    key_l: List[str] = field(default_factory=list)
    key_r: List[str] = field(default_factory=list)
    band_l: Optional[str] = None
    band_r: Optional[str] = None
    lo: Optional[int] = None
    hi: Optional[int] = None
    residual_dev: Any = None
    residual_host: Any = None
    raw_l: List[str] = field(default_factory=list)  # __jl_* raw columns
    raw_r: List[str] = field(default_factory=list)  # __jr_* raw columns

    def build_ring(self, bucket_ms: int = 1000, device: Device = None):
        from ..ops.joinring import JoinRing

        return JoinRing(
            n_key_cols=len(self.key_l),
            band=self.band_l is not None,
            lo=self.lo, hi=self.hi,
            residual=self.residual_dev,
            residual_host=self.residual_host,
            bucket_ms=bucket_ms, device=device)


def _conjuncts(e: Optional[ast.Expr]) -> List[ast.Expr]:
    if e is None:
        return []
    if isinstance(e, ast.BinaryExpr) and e.op == "AND":
        return _conjuncts(e.lhs) + _conjuncts(e.rhs)
    return [e]


def _side_of(ref: ast.FieldRef, left: str, right: str) -> str:
    if ref.stream == left:
        return "l"
    if ref.stream == right:
        return "r"
    if not ref.stream:
        raise _nv(f"unqualified column {ref.name!r} in join ON "
                  "(qualify with the stream name)",
                  "join_on_unqualified")
    raise _nv(f"column {ref.stream}.{ref.name} references neither join "
              "side", "join_on_unqualified")


def _affine(e: ast.Expr, left: str, right: str
            ) -> Optional[Tuple[Dict[Tuple[str, str], int], int]]:
    """Affine form of an expression over qualified FieldRefs, `+`, `-`
    and integer literals: ({(side, col): coeff}, const). None = not
    affine (classify as residual). Non-integral literals inside an
    otherwise-affine form are a named fallback — a fractional band
    cannot be exact int32 index arithmetic."""
    if isinstance(e, ast.IntegerLiteral):
        return {}, int(e.val)
    if isinstance(e, ast.NumberLiteral):
        if float(e.val).is_integer():
            return {}, int(e.val)
        raise _nv(f"non-integral literal {e.val!r} in temporal band",
                  "join_band_literal")
    if isinstance(e, ast.FieldRef):
        return {(_side_of(e, left, right), e.name): 1}, 0
    if isinstance(e, ast.UnaryExpr) and e.op == "-":
        inner = _affine(e.expr, left, right)
        if inner is None:
            return None
        return {k: -v for k, v in inner[0].items()}, -inner[1]
    if isinstance(e, ast.BinaryExpr) and e.op in ("+", "-"):
        a = _affine(e.lhs, left, right)
        b = _affine(e.rhs, left, right)
        if a is None or b is None:
            return None
        sign = 1 if e.op == "+" else -1
        cols = dict(a[0])
        for k, v in b[0].items():
            cols[k] = cols.get(k, 0) + sign * v
        return ({k: v for k, v in cols.items() if v},
                a[1] + sign * b[1])
    return None


def _rename_residual(e: ast.Expr, left: str, right: str) -> ast.Expr:
    """Deep-copy a residual conjunct with each qualified FieldRef
    renamed to its device column (__jl_<col> / __jr_<col>) — left and
    right column namespaces must not collide inside one IR tree."""
    e = copy.deepcopy(e)
    for node in ast.walk(e):
        if isinstance(node, ast.FieldRef):
            side = _side_of(node, left, right)
            node.name = f"__j{side}_{node.name}"
            node.stream = ""
    return e


def _and_tree(parts: List[ast.Expr]) -> ast.Expr:
    out = parts[0]
    for p in parts[1:]:
        out = ast.BinaryExpr(op="AND", lhs=out, rhs=p)
    return out


def lower_join(stmt: ast.SelectStatement, joins: List[ast.Join]
               ) -> JoinLowering:
    """Lower the stream-stream join step to a JoinRing plan or raise
    NotVectorizable with a `join_*` reason slug."""
    if len(joins) != 1:
        raise _nv(f"{len(joins)}-way stream join (device tier lowers "
                  "exactly one stream-stream step)", "join_multiway")
    join = joins[0]
    left = stmt.sources[0].ref_name
    right = join.table.ref_name
    low = JoinLowering(join_type=join.join_type, left=left, right=right)
    if join.join_type == ast.JoinType.CROSS:
        return low
    if join.on is None:
        raise _nv("stream join without ON clause", "join_no_on")

    residual_parts: List[ast.Expr] = []
    band_pair: Optional[Tuple[str, str]] = None
    lo: Optional[int] = None
    hi: Optional[int] = None

    def tighten(rel: str, v: int) -> None:
        nonlocal lo, hi
        if rel == ">=":
            lo = v if lo is None else max(lo, v)
        elif rel == ">":
            tighten(">=", v + 1)
        elif rel == "<=":
            hi = v if hi is None else min(hi, v)
        elif rel == "<":
            tighten("<=", v - 1)
        elif rel == "=":
            tighten(">=", v)
            tighten("<=", v)

    _FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "="}
    for c in _conjuncts(join.on):
        # equi-key: plain cross-stream column equality
        if (isinstance(c, ast.BinaryExpr) and c.op == "="
                and isinstance(c.lhs, ast.FieldRef)
                and isinstance(c.rhs, ast.FieldRef)):
            sl = _side_of(c.lhs, left, right)
            sr = _side_of(c.rhs, left, right)
            if sl != sr:
                a, b = ((c.lhs, c.rhs) if sl == "l" else (c.rhs, c.lhs))
                low.key_l.append(a.name)
                low.key_r.append(b.name)
                continue
            # same-side equality: residual filter
        # temporal band: affine comparison touching both streams
        if isinstance(c, ast.BinaryExpr) and c.op in _REL_OPS:
            fa = _affine(c.lhs, left, right)
            fb = _affine(c.rhs, left, right)
            if fa is not None and fb is not None:
                cols = dict(fa[0])
                for k, v in fb[0].items():
                    cols[k] = cols.get(k, 0) - v
                cols = {k: v for k, v in cols.items() if v}
                const = fa[1] - fb[1]
                sides = {k[0] for k in cols}
                if sides == {"l", "r"}:
                    lcols = [k for k in cols if k[0] == "l"]
                    rcols = [k for k in cols if k[0] == "r"]
                    if (len(lcols) != 1 or len(rcols) != 1
                            or abs(cols[lcols[0]]) != 1
                            or cols[lcols[0]] != -cols[rcols[0]]):
                        # not l.ts - r.ts REL c shaped: residual lane
                        residual_parts.append(c)
                        continue
                    pair = (lcols[0][1], rcols[0][1])
                    if band_pair is not None and band_pair != pair:
                        # one dt lane: first pair keeps it, later pairs
                        # ride the residual (float32 compare)
                        residual_parts.append(c)
                        continue
                    band_pair = pair
                    # diff = s*dt + const REL 0, s = sign of the l coeff
                    s = cols[lcols[0]]
                    rel = c.op if s > 0 else _FLIP[c.op]
                    tighten(rel, -const if s > 0 else const)
                    continue
                if not sides:
                    # constant comparison — fold host-side as residual
                    pass
        residual_parts.append(c)

    if band_pair is not None:
        low.band_l, low.band_r = band_pair
        low.lo, low.hi = lo, hi
    if residual_parts:
        renamed = _and_tree([_rename_residual(p, left, right)
                             for p in residual_parts])
        try:
            low.residual_dev = compile_expr_ir(renamed, mode="device",
                                               want="bool")
            low.residual_host = compile_expr_ir(renamed, mode="host",
                                                want="bool")
        except NotVectorizable as exc:
            raise _nv(f"ON residual not device-compilable: {exc}",
                      "join_on_residual") from exc
        raws = sorted(low.residual_dev.columns)
        low.raw_l = [c for c in raws if c.startswith("__jl_")]
        low.raw_r = [c for c in raws if c.startswith("__jr_")]
    if not low.key_l and low.band_l is None and low.residual_dev is None:
        raise _nv("join ON has no device-lowerable conjunct",
                  "join_no_equi_key")
    return low


# -------------------------------------------------------------- analytics
_LITERALS = (ast.IntegerLiteral, ast.NumberLiteral, ast.StringLiteral)


def _literal_value(e: ast.Expr) -> Any:
    return e.val


@dataclass
class AnalyticCallPlan:
    """One lifted lag() instance: read `col`, partition by `partition`
    columns, default when the partition is fresh."""

    call: ast.Call
    col: str
    partition: List[ast.FieldRef] = field(default_factory=list)
    default: Any = None


@dataclass
class AnalyticLowering:
    calls: List[AnalyticCallPlan] = field(default_factory=list)


def lower_analytics(calls: List[ast.Call]) -> AnalyticLowering:
    """Lower AnalyticNode's pre-computed calls to the segscan shift
    kernel. All calls must lift (state ordering is shared), else the
    whole node stays host with the FIRST blocking reason."""
    low = AnalyticLowering()
    for call in calls:
        if call.name != "lag":
            raise _nv(f"analytic function {call.name}() has no device "
                      "lowering", "analytic_func")
        if call.when is not None:
            raise _nv("lag() OVER(WHEN ...) gates state updates per "
                      "row", "analytic_when")
        if not call.args or not isinstance(call.args[0], ast.FieldRef):
            raise _nv("lag() first argument must be a plain column",
                      "analytic_args")
        if len(call.args) > 1:
            idx = call.args[1]
            if not (isinstance(idx, ast.IntegerLiteral)
                    and int(idx.val) == 1):
                raise _nv("lag() with index != 1 (device carry holds "
                          "one value per partition)", "analytic_args")
        default = None
        if len(call.args) > 2:
            if not isinstance(call.args[2], _LITERALS):
                raise _nv("lag() default must be a literal",
                          "analytic_args")
            default = _literal_value(call.args[2])
        if len(call.args) > 3:
            raise _nv("lag() takes at most 3 arguments", "analytic_args")
        part: List[ast.FieldRef] = []
        for p in call.partition:
            if not isinstance(p, ast.FieldRef):
                raise _nv("PARTITION BY must list plain columns",
                          "analytic_partition")
            part.append(p)
        low.calls.append(AnalyticCallPlan(
            call=call, col=call.args[0].name, partition=part,
            default=default))
    return low


@dataclass
class WindowFuncCallPlan:
    call: ast.Call
    name: str
    col: Optional[str] = None          # None for row_number
    partition: List[ast.FieldRef] = field(default_factory=list)
    offset: int = 1                    # lead
    default: Any = None                # lead


@dataclass
class WindowFuncLowering:
    calls: List[WindowFuncCallPlan] = field(default_factory=list)

    def device_eligible(self) -> bool:
        """rank/dense_rank/row_number emit exact int32 ranks — the
        segscan sort kernel serves them; lead's value assignment is an
        exact host shift either way."""
        return any(c.name in ("rank", "dense_rank") for c in self.calls)


def lower_window_funcs(calls: List[ast.Call]) -> WindowFuncLowering:
    """Lower WindowFuncNode's calls to the collection-wide vector path
    (segscan sort kernel for the numeric rank family)."""
    low = WindowFuncLowering()
    for call in calls:
        if call.name not in ("row_number", "rank", "dense_rank", "lead"):
            raise _nv(f"window function {call.name}() has no device "
                      "lowering", "analytic_func")
        part: List[ast.FieldRef] = []
        for p in call.partition:
            if not isinstance(p, ast.FieldRef):
                raise _nv("PARTITION BY must list plain columns",
                          "analytic_partition")
            part.append(p)
        plan = WindowFuncCallPlan(call=call, name=call.name,
                                  partition=part)
        if call.name == "row_number":
            if call.args:
                raise _nv("row_number() takes no arguments",
                          "analytic_args")
        else:
            if not call.args or not isinstance(call.args[0],
                                               ast.FieldRef):
                raise _nv(f"{call.name}() first argument must be a "
                          "plain column", "analytic_args")
            plan.col = call.args[0].name
            if call.name == "lead":
                if len(call.args) > 1:
                    if not isinstance(call.args[1], ast.IntegerLiteral):
                        raise _nv("lead() offset must be an integer "
                                  "literal", "analytic_args")
                    plan.offset = int(call.args[1].val)
                if len(call.args) > 2:
                    if not isinstance(call.args[2], _LITERALS):
                        raise _nv("lead() default must be a literal",
                                  "analytic_args")
                    plan.default = _literal_value(call.args[2])
            elif len(call.args) > 1:
                raise _nv(f"{call.name}() takes one argument",
                          "analytic_args")
        low.calls.append(plan)
    return low


# ---------------------------------------------------------------- explain
def explain_relational(stmt: ast.SelectStatement,
                       stream_joins: Optional[List[ast.Join]] = None
                       ) -> List[Dict[str, Any]]:
    """Extra "expressions" pieces for /rules/{id}/explain: the join and
    analytic/window-function lowering verdicts with their structured
    reasons. Read-only probe — never registers fallback counters."""
    pieces: List[Dict[str, Any]] = []

    def probe(kind: str, detail: str, fn) -> None:
        entry: Dict[str, Any] = {"kind": kind, "expr": detail}
        try:
            fn()
            entry["path"] = "device"
        except NotVectorizable as exc:
            entry["path"] = "host"
            entry["reason"] = getattr(exc, "reason", "other")
            entry["detail"] = str(exc)
        pieces.append(entry)

    joins = stmt.joins if stream_joins is None else stream_joins
    if joins:
        probe("join", " ".join(j.join_type.value for j in joins),
              lambda: lower_join(stmt, joins))
    an = [n for f_ in stmt.fields for n in ast.walk(f_.expr)
          if isinstance(n, ast.Call)]
    if stmt.condition is not None:
        an += [n for n in ast.walk(stmt.condition)
               if isinstance(n, ast.Call)]
    from ..functions import registry as freg

    acalls = [c for c in an if freg.is_analytic(c.name)]
    wcalls = [c for c in an
              if (fd := freg.lookup(c.name)) is not None
              and fd.ftype == freg.WINDOW_FUNC]
    if acalls:
        probe("analytic", ",".join(sorted({c.name for c in acalls})),
              lambda: lower_analytics(acalls))
    if wcalls:
        probe("window_func", ",".join(sorted({c.name for c in wcalls})),
              lambda: lower_window_funcs(wcalls))
    return pieces
