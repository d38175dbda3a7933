"""The port's entry point for a windowed GROUP BY rule: SQL → kernel plan →
direct-emit tail → fused node (counterpart of the fused-node construction
in ekuiper_tpu/planner/planner.py `_build_device_chain`).
"""
from __future__ import annotations

import logging
from typing import Any, Dict, Mapping, Optional, Tuple

from ..ops.aggspec import extract_kernel_plan
from ..ops.emit import build_direct_emit
from ..ops.slidingring import ring_layout_for
from ..ops.tierstore import env_hbm_budget_mb
from ..parallel.mesh import (Mesh, mesh_cfg_from_env, mesh_from_options,
                             resolve_auto_cfg)
from ..runtime.nodes_fused import (MAX_EVENT_PANES, FusedWindowAggNode,
                                   event_time_panes)
from ..runtime.nodes_window import WatermarkNode
from ..sql import ast
from ..sql.compiler import try_compile
from ..sql.parser import parse_select
from ..utils.cron import parse_duration_ms
from ..utils.device import Device, resolve_device
from ..utils.infra import PlanError

logger = logging.getLogger(__name__)


#: the rule options the port takes (the reference's names,
#: ekuiper_tpu/planner/planner.py:163-164, 172-173, 178-185) and their
#: defaults (ekuiper_tpu/utils/config.py:26-27, 68, 72, 76, 80, 88-93, 97,
#: 101, 114-117); joinImpl and analyticImpl choose the relational nodes of
#: a host chain (planner/planner.py); planOptimizeStrategy takes the
#: reference's mesh keys, "mesh" and "shards" (planner.py:96-156)
RULE_OPTIONS = {"prefinalizeLeadMs": 250, "tailMode": "device",
                "slidingDevRingMb": 256, "slidingImpl": "daba",
                "tierStore": "auto", "tierHotMb": 0, "tierScanMs": 0,
                "isEventTime": False, "lateTolerance": 1000,
                "joinImpl": "device", "analyticImpl": "device",
                "planOptimizeStrategy": {}}


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
    a sliding rule tiers in quiescent-only mode (a key leaves the card
    only once idle past the ring's whole retention), on the DABA ring and
    the refold path, which it chooses at the tier-capped capacity. A
    heavy_hitters rule stays untiered.

    Event time (`isEventTime` true; `lateTolerance`, an int of ms or a
    Go-style duration such as "1s", default 1000): the returned fused
    node has its WatermarkNode connected ahead of it, as
    `node.watermark`. Feed the batches to `node.watermark.process(batch)`
    (rows need `timestamps`, int64 ms): it drops the rows later than the
    tolerance behind the newest timestamp (`node.watermark.dropped`),
    orders the batch by time, passes it on, and then sends the watermark
    that makes the fused node emit every window it has passed (a session
    window: every session it has closed), synchronously. EOF given to
    `node.watermark.put_control(EOF())` flushes the rest. An event-time
    sliding window, a shape needing more than 255 panes (the window's
    buckets and the tolerance's) and a hopping interval that does not
    divide the length raise NotImplementedError (the reference runs them
    on its host window path). A processing-time rule has no watermark
    node (`node.watermark` is None).

    Sharding (`planOptimizeStrategy`, the reference's resolution order):
    `{"mesh": {"rows": R, "keys": K}}` places the state on an R x K mesh
    (a ShardedGroupBy; a PlanError when the device list holds fewer than
    R·K devices); else `{"shards": "auto" | K | "off"}` (auto: KUIPER_MESH
    when set, else every device on the keys axis; K: K key shards; off:
    single-chip); else the KUIPER_MESH env ("RxK", "K" or "auto"). An
    auto, shards or env mesh that cannot be built, or a heavy_hitters
    rule under one, plans single-chip with its reason; a heavy_hitters
    rule under an explicit mesh raises NotImplementedError (the
    reference runs it on its host path). `node.shard_info` records the
    decision. `device` may be a list of devices, the mesh's pool (the
    reference's jax.devices()): None gives every visible card, and one
    device may repeat, ["cpu"] * 8 or ["cuda:0"] * 8 being the
    counterpart of the reference's 8-device virtual mesh; the state
    lives on the first. A list of two different cards raises
    NotImplementedError (a mesh across cards is not ported yet). A
    sharded rule's boundaries are synchronous, its state is never
    tiered, and a sliding one takes the refold path.

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
    if opts["isEventTime"]:
        event_time_gate(stmt.window, opts["lateTolerance"])
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
    mesh, shard_info = build_mesh(opts, plan, device)
    # tiered key state: the budget resolved at plan time, gated off where
    # ORDER BY / LIMIT would order across the device and spilled groups
    # and for a sharded state (the reference's planner.py:991-999; the
    # node gates the window kind and heavy_hitters)
    tier_budget_mb = resolve_tier_budget_mb(opts)
    if tier_budget_mb and (stmt.sorts or stmt.limit is not None
                           or mesh is not None):
        tier_budget_mb = 0.0
    node = FusedWindowAggNode(
        "window_agg", stmt.window, plan, dims, capacity=key_slots,
        micro_batch=micro_batch, direct_emit=direct, emit_columnar=True,
        device=dev, prefinalize_lead_ms=opts["prefinalizeLeadMs"],
        tail_mode=opts["tailMode"],
        dev_ring_budget_mb=opts["slidingDevRingMb"],
        sliding_impl=opts["slidingImpl"], ring_layout=ring_layout,
        tier_budget_mb=tier_budget_mb, tier_scan_ms=opts["tierScanMs"],
        is_event_time=opts["isEventTime"],
        late_tolerance_ms=opts["lateTolerance"], mesh=mesh)
    node.shard_info = shard_info
    # the reference's chain (planner.py:1037-1045): source → watermark →
    # fused node; the port has no topology, so the node carries its entry
    if opts["isEventTime"]:
        node.watermark = WatermarkNode(
            "watermark", late_tolerance_ms=opts["lateTolerance"])
        node.watermark.connect(node)
    return node


def mesh_request(opts: Mapping[str, object], plan=None) -> Dict[str, Any]:
    """The sharding decision for one rule, without building a mesh (the
    reference's planner.py:96-156): an explicit planOptimizeStrategy.mesh
    first, then planOptimizeStrategy.shards, then KUIPER_MESH. Returns
    {"mode": "sharded" | "single-chip", "cfg": dict | None, "source",
    "reason"}; a shards / env choice for a heavy_hitters plan is
    single-chip (its value dictionary is node-local)."""
    strategy = opts.get("planOptimizeStrategy") or {}
    explicit = strategy.get("mesh")
    if explicit:
        return {"mode": "sharded", "cfg": dict(explicit),
                "source": "planOptimizeStrategy.mesh",
                "reason": "explicit mesh geometry"}
    shards = strategy.get("shards")
    cfg, source = None, None
    if shards is not None:
        s = str(shards).strip().lower()
        if s in ("0", "off", "none", "false", "1"):
            return {"mode": "single-chip", "cfg": None,
                    "source": f"shards={shards}",
                    "reason": "sharding disabled by rule option"}
        if s == "auto":
            cfg = mesh_cfg_from_env() or {"auto": True}
            source = "shards=auto"
        else:
            try:
                k = int(s)
            except ValueError:
                raise PlanError(
                    f"invalid shards option {shards!r}: use 'auto', "
                    "'off', or a shard count")
            cfg = {"rows": 1, "keys": k}
            source = f"shards={k}"
    else:
        cfg = mesh_cfg_from_env()
        if cfg is not None:
            source = "KUIPER_MESH"
    if cfg is None:
        return {"mode": "single-chip", "cfg": None, "source": None,
                "reason": "no mesh requested"}
    if plan is not None and any(
            s.kind == "heavy_hitters" for s in plan.specs):
        return {"mode": "single-chip", "cfg": None, "source": source,
                "reason": "heavy_hitters state is node-local (value "
                          "dictionary) — single-chip kernel"}
    return {"mode": "sharded", "cfg": cfg, "source": source,
            "reason": "key-range-partitioned GROUP BY state across the "
                      "device mesh"}


def build_mesh(opts: Mapping[str, object], plan, devices: Device
               ) -> Tuple[Optional[Mesh], Dict[str, Any]]:
    """(mesh or None, shard_info) of a rule (the reference's
    planner.py:951-977), over the device list `devices`. An explicit mesh
    that cannot be built raises PlanError, and one over a heavy_hitters
    plan NotImplementedError (the reference's eligibility sends it to the
    host path, planner.py:411); an auto, shards or env mesh that cannot be
    built plans single-chip, the reason recorded."""
    req = mesh_request(opts, plan)
    info: Dict[str, Any] = {k: req.get(k) for k in ("mode", "source",
                                                    "reason")}
    if req["mode"] != "sharded":
        return None, info
    explicit = req["source"] == "planOptimizeStrategy.mesh"
    if explicit and any(s.kind == "heavy_hitters" for s in plan.specs):
        raise NotImplementedError(
            "a heavy_hitters rule under an explicit mesh runs on the host "
            "path, which is not ported yet")
    cfg = req["cfg"]
    try:
        resolved = resolve_auto_cfg(cfg, devices)
        if resolved is None:
            raise ValueError("fewer than 2 devices visible")
        mesh = mesh_from_options(resolved, devices)
    except NotImplementedError:  # a list of different cards: never skipped
        raise
    except (ValueError, RuntimeError, TypeError) as exc:
        if explicit:
            raise PlanError(f"cannot build device mesh {cfg}: {exc}") from exc
        info = {"mode": "single-chip", "source": req["source"],
                "reason": f"mesh unavailable ({exc}) — single-chip "
                          "fallback"}
        logger.info("%s", info["reason"])
        return None, info
    info["mesh"] = dict(resolved)
    info["shards"] = int(resolved["keys"])
    return mesh, info


def event_time_gate(window: ast.Window, late_tolerance_ms: int) -> None:
    """The reference's event-time device eligibility (planner.py:324-325,
    336-360). Raises NotImplementedError for the shapes its host window
    path runs, which is not ported: a sliding window, a tumbling or
    hopping window whose live buckets (the window's span, the tolerance's
    buckets and two of slack) need more than 255 panes, a hopping interval
    that does not divide the length."""
    wt = window.window_type
    if wt == ast.WindowType.SLIDING_WINDOW:
        raise NotImplementedError(
            "an event-time sliding window runs on the host window path, "
            "which is not ported yet")
    if wt not in (ast.WindowType.TUMBLING_WINDOW,
                  ast.WindowType.HOPPING_WINDOW):
        return
    length, interval = window.length_ms(), window.interval_ms()
    if wt == ast.WindowType.HOPPING_WINDOW and (
            interval <= 0 or interval > length or length % interval):
        raise NotImplementedError(
            "a hopping window whose interval does not divide its length "
            "runs on the host window path, which is not ported yet")
    n_panes = event_time_panes(window, late_tolerance_ms)[2]
    if n_panes > MAX_EVENT_PANES:
        raise NotImplementedError(
            f"an event-time window needing {n_panes} panes (max "
            f"{MAX_EVENT_PANES}) runs on the host window path, which is "
            "not ported yet")


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
    for key in ("joinImpl", "analyticImpl"):
        if opts[key] not in ("device", "host"):
            raise PlanError(f"{key} must be 'device' or 'host', got "
                            f"{opts[key]!r}")
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
    v = opts["isEventTime"]
    if isinstance(v, str):  # the reference's reading of a boolean option
        if v.strip().lower() not in ("true", "1", "false", "0"):
            raise PlanError(f"isEventTime must be a boolean, got {v!r}")
        v = v.strip().lower() in ("true", "1")
    opts["isEventTime"] = bool(v)
    v = opts["lateTolerance"]
    try:
        # int ms or a Go-style duration; '' and bools would read as a
        # degenerate 0 or 1 ms
        if isinstance(v, bool) or (isinstance(v, str) and not v.strip()):
            raise ValueError("not a duration")
        ms = parse_duration_ms(v)
    except Exception as exc:
        raise PlanError(f"lateTolerance must be an int of ms or a duration, "
                        f"got {v!r}") from exc
    if ms < 0:
        raise PlanError(f"lateTolerance must not be negative, got {v!r}")
    opts["lateTolerance"] = ms
    strategy = opts["planOptimizeStrategy"]
    if not isinstance(strategy, Mapping):
        raise PlanError(f"planOptimizeStrategy must be an object, got "
                        f"{strategy!r}")
    for key in strategy:
        if key not in ("mesh", "shards"):
            raise NotImplementedError(
                f"planOptimizeStrategy.{key} is not ported yet")
    mesh = strategy.get("mesh")
    if mesh and not isinstance(mesh, Mapping):
        raise PlanError(f"planOptimizeStrategy.mesh must be an object of "
                        f"rows and keys, got {mesh!r}")
    return opts
