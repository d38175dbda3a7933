"""The port's entry point for a windowed GROUP BY rule: SQL → kernel plan →
direct-emit tail → fused node (counterpart of the fused-node construction
in ekuiper_tpu/planner/planner.py `_build_device_chain`).
"""
from __future__ import annotations

from typing import Mapping, Optional

from ..ops.aggspec import extract_kernel_plan
from ..ops.emit import build_direct_emit
from ..ops.slidingring import ring_layout_for
from ..runtime.nodes_fused import FusedWindowAggNode
from ..sql import ast
from ..sql.compiler import try_compile
from ..sql.parser import parse_select
from ..utils.device import Device, resolve_device
from ..utils.infra import PlanError


#: the rule options the port takes (the reference's names,
#: ekuiper_tpu/planner/planner.py:172-173, 178-179) and their defaults
#: (ekuiper_tpu/utils/config.py:68, 72, 97, 101)
RULE_OPTIONS = {"prefinalizeLeadMs": 250, "tailMode": "device",
                "slidingDevRingMb": 256, "slidingImpl": "daba"}


def plan_fused_rule(sql: str, key_slots: int = 16384,
                    micro_batch: int = 65536, device: Device = None,
                    options: Optional[Mapping[str, object]] = None
                    ) -> FusedWindowAggNode:
    """Plan a `SELECT dims, aggs FROM s GROUP BY dims, TUMBLINGWINDOW(...)`
    (or HOPPINGWINDOW, or SLIDINGWINDOW(...) OVER (WHEN cond)) rule onto a
    fused node on `device`.

    The node folds ColumnBatches given to `process` and emits one
    ColumnBatch per window at each boundary: on its own timers once
    `on_open()` has armed them on the engine clock (utils/timex.py), or
    at each `on_trigger` its caller makes. A sliding rule emits one
    window per trigger row (rows matching `cond`, by their timestamps),
    through its emit worker (`node._drain_async_emits()` waits for it;
    a heavy_hitters rule's refold path emits synchronously);
    a delayed sliding window fires on the engine clock. `options` takes
    the rule options `prefinalizeLeadMs` (ms before a boundary at which
    its components fetch is pre-issued; 0 finalizes each boundary
    synchronously), `tailMode` ("device" or "host"), `slidingDevRingMb`
    (the sliding ring's budget, which coarsens its buckets, and the refold
    path's device batch cache's) and `slidingImpl` ("daba", or "refold":
    the reference's refold path, which a heavy_hitters rule or a ring over
    its budget also takes; the node's `sliding_impl` says which runs),
    with the reference's defaults (250, "device", 256, "daba").

    Raises PlanError for a statement that is not a windowed aggregate or
    an option value it cannot take, NotImplementedError for a shape or an
    option the port does not run yet (the reference's host fallback paths
    are not ported).
    """
    dev = resolve_device(device)
    opts = rule_options(options)
    stmt = parse_select(sql)
    if stmt.window is None:
        raise PlanError("plan_fused_rule needs a GROUP BY window")
    plan = extract_kernel_plan(stmt)
    if plan is None:
        raise NotImplementedError(
            "rule does not fold on the device; the host path is not "
            "ported yet")
    sliding = stmt.window.window_type == ast.WindowType.SLIDING_WINDOW
    ring_layout = None
    if sliding:
        # the reference's device eligibility (planner.py:316-327): a
        # processing-time sliding window gated by a trigger condition that
        # compiles on the host; the rest is its host window path
        cond = stmt.window.trigger_condition
        if cond is None or try_compile(cond) is None:
            raise NotImplementedError(
                "sliding rule without a host-compilable OVER (WHEN ...) "
                "condition runs on the host path, which is not ported yet")
        # ring geometry is a plan-time choice: buckets coarsen until the
        # ring's static footprint fits slidingDevRingMb
        ring_layout = ring_layout_for(stmt.window, plan, capacity=key_slots,
                                      budget_mb=opts["slidingDevRingMb"])
    dims = [d.expr for d in stmt.dimensions]
    direct = build_direct_emit(stmt, plan, [d.name for d in dims])
    if direct is None:
        raise NotImplementedError(
            "rule's output tail does not vectorize; the row-path emit is "
            "not ported yet")
    return FusedWindowAggNode(
        "window_agg", stmt.window, plan, dims, capacity=key_slots,
        micro_batch=micro_batch, direct_emit=direct, emit_columnar=True,
        device=dev, prefinalize_lead_ms=opts["prefinalizeLeadMs"],
        tail_mode=opts["tailMode"],
        dev_ring_budget_mb=opts["slidingDevRingMb"],
        sliding_impl=opts["slidingImpl"], ring_layout=ring_layout)


def rule_options(options: Optional[Mapping[str, object]]) -> dict:
    """RULE_OPTIONS with `options` applied, each value checked: PlanError
    for a value the option cannot take, NotImplementedError for an option
    the port does not take."""
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
    ring_mb = opts["slidingDevRingMb"]
    if isinstance(ring_mb, bool) or not isinstance(ring_mb, int) \
            or ring_mb < 0:
        raise PlanError(f"slidingDevRingMb must be a non-negative int of "
                        f"MB, got {ring_mb!r}")
    if opts["slidingImpl"] not in ("daba", "refold"):
        raise PlanError(f"slidingImpl must be 'daba' or 'refold', got "
                        f"{opts['slidingImpl']!r}")
    return opts
