"""Aggregate kernel specs — which aggregates of a SELECT fold into the
group-by kernels, and what partial-state components each needs
(counterpart of ekuiper_tpu/ops/aggspec.py).

Device-eligible aggregates fold into (n, s1, s2, mn, mx) partials — count,
sum, sum of squares, min, max — and the sketch aggregates into the wide
components hll (HyperLogLog registers), hist (signed log-histogram) and
hh (heavy-hitters counters): the layout the reference uses, so state and
checkpoints cross between the two packages.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set

import numpy as np

from ..sql import ast, expr_ir
from ..sql.compiler import CompiledExpr
from ..sql.expr_ir import NotVectorizable
from .sketches import HH_DEPTH, HH_MAX_CODES, HH_WIDTH

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
    # sketch aggregates — wide device components
    "hll": {"hll"},
    "distinct_count_approx": {"hll"},
    "percentile_approx": {"hist"},
    "heavy_hitters": {"hh"},
}

ALL_COMPONENTS = ("n", "s1", "s2", "mn", "mx")
# components with a trailing register axis (n_panes, capacity, k, W)
WIDE_COMPONENTS = {"hll", "hist", "hh"}

# Derived-column prefix: hll over a bare column reads a dedicated hashed
# copy (strings crc32-hashed, numerics passed through) so the raw column
# stays numeric for every other spec / WHERE / FILTER sharing it.
HLL_COL_PREFIX = "__hll__"

# Derived-column prefix for heavy_hitters: the raw column dictionary-encodes
# to dense integer codes (< sketches.HH_MAX_CODES) that the bit-recovery
# sketch can reconstruct; codes decode back to the original values at emit.
HH_COL_PREFIX = "__hhc__"

# values below this are exactly representable in float32 and pass through;
# larger integral values hash their decimal repr so the float32 cast cannot
# collapse distinct IDs
_HLL_SMALL = 2 ** 24


def _hll_encode_value(v) -> float:
    """Distinct-preserving float32 encoding of one value for hll. The SAME
    rule applies whether the value arrives in an object, integer, or float
    batch, so a logical value always folds to the same register."""
    if isinstance(v, bool):
        return float(v)
    if isinstance(v, (int, np.integer)):
        iv = int(v)
        if abs(iv) < _HLL_SMALL:
            return float(iv)
        return float(zlib.crc32(str(iv).encode()))
    if isinstance(v, (float, np.floating)):
        fv = float(v)
        if np.isfinite(fv) and fv.is_integer() and abs(fv) >= _HLL_SMALL:
            return float(zlib.crc32(str(int(fv)).encode()))
        return fv
    return float(zlib.crc32(str(v).encode()))


def hash_column_for_hll(col) -> np.ndarray:
    """Distinct-preserving stable encoding of a mixed/object column into
    float32 for hll (see _hll_encode_value). crc32 is stable across
    processes so checkpointed registers stay consistent after restore.
    None -> NaN (masked, matching SQL null-skipping aggregates)."""
    out = np.empty(len(col), dtype=np.float32)
    memo: dict = {}
    for i, v in enumerate(col):
        if v is None:
            out[i] = np.nan
            continue
        try:
            h = memo.get(v)
        except TypeError:  # unhashable (dict/list)
            out[i] = _hll_encode_value(v)
            continue
        if h is None:
            h = _hll_encode_value(v)
            memo[v] = h
        out[i] = h
    return out


def _hll_encode_numeric(raw: np.ndarray) -> np.ndarray:
    """Vectorized hll encoding of a numeric-dtype column: float32 passthrough
    with the (rare) large integral values deferred to _hll_encode_value so
    the result matches the object-column path exactly."""
    if np.issubdtype(raw.dtype, np.integer):
        arr = raw.astype(np.int64)
        out = arr.astype(np.float32)
        big = np.abs(arr) >= _HLL_SMALL
        for i in np.nonzero(big)[0]:
            out[i] = _hll_encode_value(int(arr[i]))
        return out
    f = np.asarray(raw, dtype=np.float64)
    out = f.astype(np.float32)
    with np.errstate(invalid="ignore"):
        big = np.isfinite(f) & (np.abs(f) >= _HLL_SMALL) & (f == np.floor(f))
    for i in np.nonzero(big)[0]:
        out[i] = _hll_encode_value(float(f[i]))
    return out


def encode_hll_column(col: Optional[np.ndarray], n: int) -> np.ndarray:
    """The __hll__ derived column of a raw column (NaN where absent)."""
    if col is None:
        return np.full(n, np.nan, dtype=np.float32)
    if col.dtype == np.object_:
        return hash_column_for_hll(col)
    return _hll_encode_numeric(np.asarray(col))


class ValueDict:
    """Reversible dictionary encoding for a heavy_hitters column: values map
    to dense integer codes (< sketches.HH_MAX_CODES) that fit the sketch's
    bit recovery; codes decode back to the ORIGINAL values (any type,
    strings included) at emit. Codes only grow, so they stay stable across
    the window, across panes, and across checkpoint restore (the fused node
    persists the value list). Values past the code budget encode as NaN
    (masked — invisible to the sketch); heavy hitters by definition appear
    early and often, so they claim low codes long before overflow."""

    def __init__(self) -> None:
        self._ids: Dict[Any, int] = {}
        self._values: List[Any] = []
        self.overflowed = False

    def _code(self, v) -> float:
        ids = self._ids
        c = ids.get(v)
        if c is None:
            if len(self._values) >= HH_MAX_CODES:
                self.overflowed = True
                return np.nan
            c = len(self._values)
            ids[v] = c
            self._values.append(v)
        return float(c)

    def encode(self, col: np.ndarray) -> np.ndarray:
        """Column -> float32 codes (NaN for None/overflow)."""
        n = len(col)
        out = np.empty(n, dtype=np.float32)
        if col.dtype == np.object_:
            for i, v in enumerate(col.tolist()):
                if v is None:
                    out[i] = np.nan
                    continue
                try:
                    out[i] = self._code(v)
                except TypeError:  # unhashable (list/dict): stringify
                    out[i] = self._code(repr(v))
            return out
        arr = np.asarray(col)
        if np.issubdtype(arr.dtype, np.floating):
            nan = np.isnan(arr)
        else:
            nan = np.zeros(n, dtype=bool)
        out = np.full(n, np.nan, dtype=np.float32)
        clean = arr[~nan] if nan.any() else arr
        if len(clean):
            uniq, inverse = np.unique(clean, return_inverse=True)
            ucodes = np.array(
                [self._code(u.item()) for u in uniq], dtype=np.float32
            )
            out[~nan] = ucodes[inverse]
        return out

    def decode(self, code: int):
        return self._values[code] if 0 <= code < len(self._values) else None

    def snapshot(self) -> List[Any]:
        return list(self._values)

    def restore(self, values: List[Any]) -> None:
        self._values = list(values)
        self._ids = {}
        for i, v in enumerate(self._values):
            try:
                self._ids[v] = i
            except TypeError:
                pass  # unhashable snapshot value (encode stored repr anyway)


def materialize_hll_columns(plan_columns, cols: Dict[str, np.ndarray],
                            n: int) -> Dict[str, np.ndarray]:
    """Fill in any missing __hll__<col> derived columns from the raw column.
    Returns a new dict when a derivation was needed; callers that already
    materialized them (the fused node, with validity masks) pass through."""
    out = None
    for name in plan_columns:
        if not name.startswith(HLL_COL_PREFIX) or name in cols:
            continue
        if out is None:
            out = dict(cols)
        out[name] = encode_hll_column(cols.get(name[len(HLL_COL_PREFIX):]), n)
    return out if out is not None else cols


@dataclass
class AggSpec:
    """One device-foldable aggregate call."""

    call: ast.Call
    kind: str  # count/sum/avg/min/max/stddev/.../hll/percentile_approx
    components: Set[str]
    arg: Optional[CompiledExpr]  # device closure for the argument (None = count(*))
    filter: Optional[CompiledExpr]  # FILTER(WHERE ...) device closure
    int_input: bool = False  # observed integer input → integer avg/sum results
    frac: float = 0.5  # percentile_approx quantile (2nd literal arg)
    topk: int = 3  # heavy_hitters k (2nd literal arg)
    # numpy twins of arg/filter, used by the window tail's shadow fold
    # (ops/prefinalize.py); None when the expr only compiles for the device
    arg_host: Optional[CompiledExpr] = None
    filter_host: Optional[CompiledExpr] = None

    @property
    def is_star(self) -> bool:
        return self.arg is None


@dataclass
class KernelPlan:
    """Everything the fused window→aggregate kernels need."""

    specs: List[AggSpec]
    filter: Optional[CompiledExpr]  # WHERE clause (device)
    columns: Set[str] = field(default_factory=set)  # float32 columns to upload
    filter_host: Optional[CompiledExpr] = None  # numpy twin of `filter`

    @property
    def host_foldable(self) -> bool:
        """True when every closure has a numpy twin, so a tail of rows can be
        folded on the host by the latency-hiding emit."""
        if self.filter is not None and self.filter_host is None:
            return False
        for s in self.specs:
            if s.arg is not None and s.arg_host is None:
                return False
            if s.filter is not None and s.filter_host is None:
                return False
        return True


def _compile_device(expr: ast.Expr, want: str
                    ) -> Optional[expr_ir.CompiledIR]:
    try:
        return expr_ir.compile_expr_ir(expr, want=want)
    except NotVectorizable:
        return None


def extract_kernel_plan(stmt: ast.SelectStatement) -> Optional[KernelPlan]:
    """Build a fully-fused device plan for the statement's aggregates.

    Returns None if any aggregate (or its argument expression) is not
    device-eligible.
    """
    calls = _collect_agg_calls(stmt)
    if not calls:
        return None
    specs: List[AggSpec] = []
    columns: Set[str] = set()
    for call in calls:
        kind = call.name[4:] if call.name.startswith("inc_") else call.name
        if call.name not in DEVICE_AGGS:
            return None
        if call.partition or call.when is not None:
            return None
        frac = 0.5
        topk = 3
        arg_ce: Optional[CompiledExpr] = None
        arg_host: Optional[CompiledExpr] = None
        if call.args and not isinstance(call.args[0], ast.Wildcard):
            if call.name == "heavy_hitters":
                # heavy_hitters(col, k): bare column + literal k only — the
                # column dictionary-encodes through a per-node ValueDict.
                # k is bounded by half the candidate pool (the recovery
                # keeps 2k of HH_DEPTH*HH_WIDTH candidates)
                if (
                    len(call.args) != 2
                    or not isinstance(call.args[0], ast.FieldRef)
                    or not isinstance(call.args[1], ast.IntegerLiteral)
                    or not 0 < call.args[1].val <= HH_DEPTH * HH_WIDTH // 2
                ):
                    return None
                topk = int(call.args[1].val)
            elif call.name == "percentile_approx":
                if len(call.args) != 2 or not isinstance(
                    call.args[1], (ast.NumberLiteral, ast.IntegerLiteral)
                ):
                    return None
                frac = float(call.args[1].val)
                if not 0.0 <= frac <= 1.0:
                    return None
            elif len(call.args) != 1:
                return None
            if kind == "heavy_hitters":
                arg_ce = arg_host = _derived_column(
                    HH_COL_PREFIX + call.args[0].name)
            elif kind in ("hll", "distinct_count_approx") and isinstance(
                call.args[0], ast.FieldRef
            ):
                arg_ce = arg_host = _derived_column(
                    HLL_COL_PREFIX + call.args[0].name)
            else:
                arg_ce = _compile_device(call.args[0], "number")
                if arg_ce is None:
                    return None
                arg_host = expr_ir.try_compile_ir(call.args[0], mode="host",
                                                  want="number")
            columns |= arg_ce.columns
        filter_ce: Optional[CompiledExpr] = None
        filter_host: Optional[CompiledExpr] = None
        if call.filter is not None:
            filter_ce = _compile_device(call.filter, "bool")
            if filter_ce is None:
                return None
            filter_host = expr_ir.try_compile_ir(call.filter, mode="host",
                                                 want="bool")
            columns |= filter_ce.columns
        specs.append(AggSpec(
            call=call, kind="hll" if kind == "distinct_count_approx" else kind,
            components=set(DEVICE_AGGS[call.name]), arg=arg_ce,
            filter=filter_ce, frac=frac, topk=topk, arg_host=arg_host,
            filter_host=filter_host))
    where_ce: Optional[CompiledExpr] = None
    where_host: Optional[CompiledExpr] = None
    if stmt.condition is not None:
        where_ce = _compile_device(stmt.condition, "bool")
        if where_ce is None:
            return None
        where_host = expr_ir.try_compile_ir(stmt.condition, mode="host",
                                            want="bool")
        columns |= where_ce.columns
    return KernelPlan(specs=specs, filter=where_ce, columns=columns,
                      filter_host=where_host)


def _derived_column(name: str) -> CompiledExpr:
    """The argument closure of a sketch over a derived column (the hll
    encoding or the heavy-hitters codes, built on the host per batch); it
    reads a torch or a numpy column alike, so it is its own host twin."""
    return CompiledExpr(lambda cols, _n=name: cols[_n], {name})


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
