"""Analytic functions (subset of ekuiper_tpu/functions/funcs_analytic.py —
analogue of internal/binder/function/funcs_analytic.go): `lag`, stateful per
call instance and per partition (the `partition by` extra args, reference:
internal/xsql/valuer.go:447). latest, changed_col and had_changed are
listed in the registry as analytic but have no row path in the port (ROADMAP
Queue 1 item 5).

State layout: ctx.state["p:" + partition] holds the per-partition value,
where partition is "" when no PARTITION BY is present; the device analytic
node writes the same layout when it migrates to host state
(runtime/nodes_relational.py), so checkpoints cross both packages.
"""
from __future__ import annotations

from .registry import ANALYTIC, register


def _pstate(ctx, partition: str) -> dict:
    st = ctx.get_state("p:" + partition)
    if st is None:
        st = {}
        ctx.put_state("p:" + partition, st)
    return st


@register("lag", ANALYTIC, stateful=True)
def f_lag(args, ctx, partition: str = "", update: bool = True):
    """lag(col[, index[, default]]) — value from `index` rows ago.
    update=False (OVER WHEN false): peek without recording the row."""
    val = args[0]
    index = int(args[1]) if len(args) > 1 and args[1] is not None else 1
    default = args[2] if len(args) > 2 else None
    st = _pstate(ctx, partition)
    hist = st.setdefault("hist", [])
    out = hist[-index] if len(hist) >= index else default
    if update:
        hist.append(val)
        if len(hist) > index:
            del hist[: len(hist) - index]
    return out
