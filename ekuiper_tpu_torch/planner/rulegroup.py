"""The port's entry point for a rule group: N homogeneous windowed GROUP BY
rules planned as ONE node (counterpart of ekuiper_tpu/planner/planner.py
`plan_rule_group`).
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

from ..ops.emit import build_direct_emit
from ..parallel.multirule import build_rule_batch
from ..runtime.nodes_multirule import MultiRuleFusedNode
from ..sql import ast
from ..sql.parser import parse_select
from ..utils.device import Device, resolve_device
from ..utils.infra import PlanError
from .fused import rule_options


def plan_rule_group(rule_ids: Sequence[str], sqls: Sequence[str],
                    key_slots: int = 16384, micro_batch: int = 65536,
                    device: Device = None,
                    options: Optional[Mapping[str, object]] = None
                    ) -> MultiRuleFusedNode:
    """Plan N rules that are identical up to the numeric literals of their
    WHERE (`sqls[i]` is rule `rule_ids[i]`) onto one MultiRuleFusedNode on
    `device`: one key encode, one upload and one fold launch per batch,
    one finalize launch and one copy per window for the whole group.

    The caller attaches each rule's downstream node with
    `node.add_rule_output(rule_id, entry)`; a rule's windows (one
    ColumnBatch each, its keys that had rows passing its WHERE) go to its
    entry only. A tumbling group emits on its emit worker
    (`node._drain_async_emits()` waits for it); a hopping group at each
    boundary, and a count, state or session group at its window's edge
    (as plan_fused_rule's node finds them), synchronously. The group's
    sketch aggregates (hll, percentile_approx) fold and finalize in one
    launch each for every rule, as its scalar ones do. `options` is
    checked as
    plan_fused_rule checks it; a group's boundary takes no pre-issue (the
    reference's), so `prefinalizeLeadMs` and `tailMode` do not change it.

    The reference's group planner applies none of the single-rule
    window gates (plan_fused_rule's row_window_gate): a count window with
    a WHERE counts the rows before the WHERE, and a state window's
    conditions toggle on them, as the reference's group does.

    Raises PlanError where the reference's planner does (an empty group,
    more than one source, statements that are not homogeneous or not
    device-eligible, heavy_hitters, a tail that does not vectorize) and
    NotImplementedError for a group the port does not run yet: a sliding
    window.
    """
    dev = resolve_device(device)
    rule_options(options)
    if not sqls:
        raise PlanError("empty rule group")
    if len(rule_ids) != len(sqls):
        raise PlanError(f"{len(rule_ids)} rule ids for {len(sqls)} "
                        "statements")
    stmts = [parse_select(sql) for sql in sqls]
    srcs = {tuple(t.name for t in s.sources) for s in stmts}
    if len(srcs) != 1 or len(stmts[0].sources) != 1:
        raise PlanError("rule group must share exactly one source stream")
    try:
        spec = build_rule_batch(list(rule_ids), stmts)
    except ValueError as exc:
        raise PlanError(str(exc))
    stmt = spec.stmt
    if stmt.window is None or \
            stmt.window.window_type == ast.WindowType.SLIDING_WINDOW:
        raise NotImplementedError(
            "a rule group needs a processing-time TUMBLINGWINDOW, "
            "HOPPINGWINDOW, COUNTWINDOW, SESSIONWINDOW or STATEWINDOW; "
            "sliding groups are not ported")
    dims = [d.expr for d in stmt.dimensions]
    direct = build_direct_emit(stmt, spec.plan, [d.name for d in dims])
    if direct is None:
        raise PlanError("rule group tail is not vectorizable")
    return MultiRuleFusedNode(
        "group_agg", stmt.window, spec, dims, capacity=key_slots,
        micro_batch=micro_batch, direct_emit=direct, emit_columnar=True,
        device=dev)
