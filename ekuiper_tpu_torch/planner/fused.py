"""The port's entry point for a windowed GROUP BY rule: SQL → kernel plan →
direct-emit tail → fused node (counterpart of the fused-node construction
in ekuiper_tpu/planner/planner.py `_build_device_chain`).
"""
from __future__ import annotations

from typing import Mapping, Optional

from ..ops.aggspec import extract_kernel_plan
from ..ops.emit import build_direct_emit
from ..runtime.nodes_fused import FusedWindowAggNode
from ..sql.parser import parse_select
from ..utils.device import Device, resolve_device
from ..utils.infra import PlanError


#: the rule options the port takes (the reference's names,
#: ekuiper_tpu/planner/planner.py:172-173) and their defaults
#: (ekuiper_tpu/utils/config.py:97, 101)
RULE_OPTIONS = {"prefinalizeLeadMs": 250, "tailMode": "device"}


def plan_fused_rule(sql: str, key_slots: int = 16384,
                    micro_batch: int = 65536, device: Device = None,
                    options: Optional[Mapping[str, object]] = None
                    ) -> FusedWindowAggNode:
    """Plan a `SELECT dims, aggs FROM s GROUP BY dims, TUMBLINGWINDOW(...)`
    (or HOPPINGWINDOW) rule onto a fused node on `device`.

    The node folds ColumnBatches given to `process` and emits one
    ColumnBatch per window at each boundary: on its own timers once
    `on_open()` has armed them on the engine clock (utils/timex.py), or
    at each `on_trigger` its caller makes. `options` takes the rule
    options `prefinalizeLeadMs` (ms before a boundary at which its
    components fetch is pre-issued; 0 finalizes each boundary
    synchronously) and `tailMode` ("device" or "host"), with the
    reference's defaults (250, "device").

    Raises PlanError for a statement that is not a windowed aggregate or
    an option value it cannot take, NotImplementedError for a shape or an
    option the port does not run yet (the reference's host fallback paths
    are not ported).
    """
    dev = resolve_device(device)
    opts = dict(RULE_OPTIONS)
    for key, value in (options or {}).items():
        if key not in RULE_OPTIONS:
            raise NotImplementedError(f"rule option {key!r} is not ported yet")
        opts[key] = value
    lead = opts["prefinalizeLeadMs"]
    if isinstance(lead, bool) or not isinstance(lead, int) or lead < 0:
        raise PlanError(f"prefinalizeLeadMs must be a non-negative int of "
                        f"ms, got {lead!r}")
    if opts["tailMode"] not in ("device", "host"):
        raise PlanError(f"tailMode must be 'device' or 'host', got "
                        f"{opts['tailMode']!r}")
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
        device=dev, prefinalize_lead_ms=lead, tail_mode=opts["tailMode"])
