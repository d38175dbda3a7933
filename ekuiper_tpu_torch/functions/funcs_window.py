"""SQL window functions (counterpart of ekuiper_tpu/functions/funcs_window.py
— analogue of internal/binder/function/funcs_window.go), applied after the
window by the window-function node (runtime/nodes_ops.py WindowFuncNode,
runtime/nodes_relational.py VectorWindowFuncNode)."""
from __future__ import annotations

from .registry import WINDOW_FUNC, register


@register("row_number", WINDOW_FUNC, stateful=True)
def f_row_number(args, ctx):
    n = ctx.get_state("row_number", 0) + 1
    ctx.put_state("row_number", n)
    return n


def _collection_only(name: str):
    # rank/dense_rank/lead are whole-collection functions: a per-row exec
    # cannot see the value order, so the window-func operator precomputes
    # them as __analytic_* cal-cols and the evaluator reads the cache.
    # Reaching this exec means the call bypassed the operator.
    def f(args, ctx):
        raise RuntimeError(
            f"{name}() is computed by the window-func operator, "
            "not per-row")

    return f


register("rank", WINDOW_FUNC, stateful=True)(_collection_only("rank"))
register("dense_rank", WINDOW_FUNC, stateful=True)(
    _collection_only("dense_rank"))
register("lead", WINDOW_FUNC, stateful=True)(_collection_only("lead"))
