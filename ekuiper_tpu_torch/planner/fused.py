"""The port's entry point for a windowed GROUP BY rule: SQL → kernel plan →
direct-emit tail → fused node (counterpart of the fused-node construction
in ekuiper_tpu/planner/planner.py `_build_device_chain`).
"""
from __future__ import annotations

from ..ops.aggspec import extract_kernel_plan
from ..ops.emit import build_direct_emit
from ..runtime.nodes_fused import FusedWindowAggNode
from ..sql.parser import parse_select
from ..utils.device import Device, resolve_device
from ..utils.infra import PlanError


def plan_fused_rule(sql: str, key_slots: int = 16384,
                    micro_batch: int = 65536,
                    device: Device = None) -> FusedWindowAggNode:
    """Plan a `SELECT dims, aggs FROM s GROUP BY dims, TUMBLINGWINDOW(...)`
    (or HOPPINGWINDOW) rule onto a fused node on `device`.

    The node folds ColumnBatches given to `process` and emits one
    ColumnBatch per window at each `on_trigger`. Raises PlanError for a statement that is not a
    windowed aggregate, NotImplementedError for a shape the port does not
    run yet (the reference's host fallback paths are not ported).
    """
    dev = resolve_device(device)
    stmt = parse_select(sql)
    if stmt.window is None:
        raise PlanError("plan_fused_rule needs a GROUP BY window")
    plan = extract_kernel_plan(stmt)
    if plan is None:
        raise NotImplementedError(
            "rule does not fold on the device; the host path is not "
            "ported yet")
    dims = [d.expr for d in stmt.dimensions]
    direct = build_direct_emit(stmt, plan, [d.name for d in dims])
    if direct is None:
        raise NotImplementedError(
            "rule's output tail does not vectorize; the row-path emit is "
            "not ported yet")
    return FusedWindowAggNode(
        "window_agg", stmt.window, plan, dims, capacity=key_slots,
        micro_batch=micro_batch, direct_emit=direct, emit_columnar=True,
        device=dev)
