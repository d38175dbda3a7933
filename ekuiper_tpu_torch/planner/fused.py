"""The port's entry point for a windowed GROUP BY rule: SQL → kernel plan →
direct-emit tail → fused node (counterpart of the fused-node construction
in ekuiper_tpu/planner/planner.py `_build_device_chain`).
"""
from __future__ import annotations

from typing import Mapping, Optional

from ..ops.aggspec import extract_kernel_plan
from ..ops.emit import build_direct_emit
from ..ops.slidingring import ring_layout_for
from ..ops.tierstore import env_hbm_budget_mb
from ..runtime.nodes_fused import FusedWindowAggNode
from ..sql import ast
from ..sql.compiler import try_compile
from ..sql.parser import parse_select
from ..utils.device import Device, resolve_device
from ..utils.infra import PlanError


#: the rule options the port takes (the reference's names,
#: ekuiper_tpu/planner/planner.py:172-173, 178-179, 183-185) and their
#: defaults (ekuiper_tpu/utils/config.py:68, 72, 88-93, 97, 101)
RULE_OPTIONS = {"prefinalizeLeadMs": 250, "tailMode": "device",
                "slidingDevRingMb": 256, "slidingImpl": "daba",
                "tierStore": "auto", "tierHotMb": 0, "tierScanMs": 0}


def plan_fused_rule(sql: str, key_slots: int = 16384,
                    micro_batch: int = 65536, device: Device = None,
                    options: Optional[Mapping[str, object]] = None
                    ) -> FusedWindowAggNode:
    """Plan a `SELECT dims, aggs FROM s GROUP BY dims, TUMBLINGWINDOW(...)`
    (or HOPPINGWINDOW, SLIDINGWINDOW(...) OVER (WHEN cond), COUNTWINDOW(n),
    SESSIONWINDOW(unit, length, gap) or STATEWINDOW(begin, emit)) rule
    onto a fused node on `device`.

    The node folds ColumnBatches given to `process` and emits one
    ColumnBatch per window at each boundary: on its own timers once
    `on_open()` has armed them on the engine clock (utils/timex.py), or
    at each `on_trigger` its caller makes. A sliding rule emits one
    window per trigger row (rows matching `cond`, by their timestamps),
    through its emit worker (`node._drain_async_emits()` waits for it;
    a heavy_hitters rule's refold path emits synchronously);
    a delayed sliding window fires on the engine clock. A count window
    emits at its n-th row (on the emit worker under the default boundary,
    synchronously with `prefinalizeLeadMs` 0), a state window at its emit
    row, a session on its gap or length timer (both synchronously).
    `options` takes
    the rule options `prefinalizeLeadMs` (ms before a boundary at which
    its components fetch is pre-issued; 0 finalizes each boundary
    synchronously), `tailMode` ("device" or "host"), `slidingDevRingMb`
    (the sliding ring's budget, which coarsens its buckets, and the refold
    path's device batch cache's), `slidingImpl` ("daba", or "refold":
    the reference's refold path, which a heavy_hitters rule or a ring over
    its budget also takes; the node's `sliding_impl` says which runs),
    and the tiered key state's `tierStore` ("auto", "on" or "off"),
    `tierHotMb` (the hot tier's budget in MB; 0 takes KUIPER_HBM_BUDGET_MB)
    and `tierScanMs` (the placement policy's cadence; 0 derives it from
    the window), with the reference's defaults (250, "device", 256,
    "daba", "auto", 0, 0). The tier engages where the budget is under four
    times `key_slots`' state (the node's `tier` is then its TierManager);
    a tiered sliding rule raises NotImplementedError.

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
    row_window_gate(stmt)
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
    # tiered key state: the budget resolved at plan time, gated off where
    # ORDER BY / LIMIT would order across the device and spilled groups
    # (the reference's planner.py:991-999; the node gates the window kind
    # and heavy_hitters)
    tier_budget_mb = resolve_tier_budget_mb(opts)
    if tier_budget_mb and (stmt.sorts or stmt.limit is not None):
        tier_budget_mb = 0.0
    return FusedWindowAggNode(
        "window_agg", stmt.window, plan, dims, capacity=key_slots,
        micro_batch=micro_batch, direct_emit=direct, emit_columnar=True,
        device=dev, prefinalize_lead_ms=opts["prefinalizeLeadMs"],
        tail_mode=opts["tailMode"],
        dev_ring_budget_mb=opts["slidingDevRingMb"],
        sliding_impl=opts["slidingImpl"], ring_layout=ring_layout,
        tier_budget_mb=tier_budget_mb, tier_scan_ms=opts["tierScanMs"])


def row_window_gate(stmt: ast.SelectStatement) -> None:
    """The reference's device eligibility of the count and state windows
    (planner.py:297-312, 348-355); a processing-time session window is
    always eligible. Raises NotImplementedError for the shapes that take
    the reference's host window path, which is not ported: a count window
    with an interval (overlapping windows) or a WHERE (its length counts
    rows past the WHERE there), a state window with a WHERE (a filtered
    row must not toggle it) or a begin / emit condition that does not
    compile on the host."""
    w = stmt.window
    if w.window_type == ast.WindowType.COUNT_WINDOW:
        if w.interval:
            raise NotImplementedError(
                "COUNTWINDOW with an interval (overlapping count windows) "
                "runs on the host path, which is not ported yet")
        if stmt.condition is not None:
            raise NotImplementedError(
                "COUNTWINDOW with WHERE counts rows past the WHERE on the "
                "host path, which is not ported yet")
    elif w.window_type == ast.WindowType.STATE_WINDOW:
        if stmt.condition is not None:
            raise NotImplementedError(
                "STATEWINDOW with WHERE runs on the host path (a filtered "
                "row must not toggle the window), which is not ported yet")
        if try_compile(w.begin_condition) is None or \
                try_compile(w.emit_condition) is None:
            raise NotImplementedError(
                "STATEWINDOW whose begin or emit condition does not compile "
                "on the host runs on the host path, which is not ported "
                "yet")


def resolve_tier_budget_mb(opts: Mapping[str, object]) -> float:
    """The budget (MB) of a rule's tiered key state (the reference's
    planner.py:75-95): `tierHotMb` when set, else KUIPER_HBM_BUDGET_MB; 0
    disables, and tierStore "off" always does. "on" without a budget is a
    PlanError: a forced tier with no budget has no hot target."""
    mode = opts["tierStore"]
    if mode == "off":
        return 0.0
    budget = float(opts["tierHotMb"])
    if budget <= 0:
        budget = env_hbm_budget_mb()
    if mode == "on" and budget <= 0:
        raise PlanError("tierStore=on needs a budget: set tierHotMb or "
                        "KUIPER_HBM_BUDGET_MB")
    return max(budget, 0.0)


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
    mode = opts["tierStore"]
    if not isinstance(mode, str) or mode.lower() not in ("auto", "on",
                                                          "off"):
        raise PlanError(f"tierStore must be 'auto', 'on' or 'off', got "
                        f"{mode!r}")
    opts["tierStore"] = mode.lower()
    for key, unit in (("tierHotMb", "MB"), ("tierScanMs", "ms")):
        v = opts[key]
        if isinstance(v, bool) or not isinstance(v, int) or v < 0:
            raise PlanError(f"{key} must be a non-negative int of {unit}, "
                            f"got {v!r}")
    return opts
