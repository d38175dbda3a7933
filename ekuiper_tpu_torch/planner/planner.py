"""The port's entry point for host-chain rules: stream-stream interval joins,
lag() and the window functions (counterpart of the host half of
ekuiper_tpu/planner/planner.py: `plan_rule` → `_build_host_chain`, cut down
to window → filter → analytic → join → window function → project, with
`_make_join_node` / `_make_analytic_node` / `_make_window_func_node`).

The join, analytic and window-function nodes take the card where the
reference's do: the relational lowering (planner/relational.py) decides, and
the rule options `joinImpl` and `analyticImpl` ("device", the default, or
"host") choose as in the reference (utils/config.py:76,80). A rule the
lowering refuses runs that node on the host with the refusal's reason
recorded (sql/compiler.record_host_fallback), exactly where the reference's
does.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional

from ..functions import registry
from ..runtime.node import Node
from ..runtime.nodes_join import JoinNode
from ..runtime.nodes_ops import (AnalyticNode, FilterNode, ProjectNode,
                                 WindowFuncNode)
from ..runtime.nodes_relational import (DeviceAnalyticNode, DeviceJoinNode,
                                        VectorWindowFuncNode)
from ..runtime.nodes_source import EntryNode
from ..runtime.nodes_window import WindowNode
from ..sql import ast
from ..sql.compiler import record_host_fallback
from ..sql.expr_ir import NotVectorizable
from ..sql.parser import parse_select
from ..utils.device import Device, resolve_device
from ..utils.infra import PlanError
from . import relational
from .fused import rule_options

_ITEM5 = "(ROADMAP Queue 1 item 5)"

#: functions the host chain runs: lag on the analytic node, the window
#: functions on the window-function node, isnull in the row evaluator
_ROW_FUNCS = {"lag", "row_number", "rank", "dense_rank", "lead", "isnull"}
#: the expression nodes and operators the row evaluator (sql/eval.py) runs
_ROW_NODES = (ast.IntegerLiteral, ast.NumberLiteral, ast.StringLiteral,
              ast.BooleanLiteral, ast.FieldRef, ast.UnaryExpr,
              ast.BinaryExpr, ast.Call)
_ROW_OPS = {"NOT", "AND", "OR", "=", "!=", "<", "<=", ">", ">=", "+", "-",
            "*", "/", "%"}


@dataclass
class HostRule:
    """A planned host-chain rule. Feed each stream's rows to its entry
    (`entries[name].process(batch)`, the name the statement gives the
    stream: its alias in a join); connect a sink Node to `tail`. `nodes`
    holds the chain by node name, entries first (each node's
    `snapshot_state` / `restore_state` keep the reference's formats).
    `on_open` arms the window node's timers on the engine clock
    (utils/timex.py), `on_close` stops them."""

    entries: Dict[str, EntryNode]
    tail: Node
    nodes: Dict[str, Node] = field(default_factory=dict)

    def on_open(self) -> None:
        for n in self.nodes.values():
            n.on_open()

    def on_close(self) -> None:
        for n in self.nodes.values():
            n.on_close()


def plan_host_rule(sql: str, device: Device = None,
                   options: Optional[Mapping[str, object]] = None
                   ) -> HostRule:
    """Plan a rule of the host operator chain on `device` (CUDA unless the
    caller passes device="cpu"; without a card it raises): a stream-stream
    JOIN over a processing-time TUMBLING or HOPPING window (the device
    join ring where the ON clause lowers), lag() OVER (PARTITION BY ...)
    (the segscan shift kernel), rank / dense_rank / lead (the segscan sort
    kernel where every value is float32-exact), row_number, WHERE, and the
    projection.

    Raises PlanError for a stream-stream join without a window (as the
    reference does) and for an option value it cannot take, and
    NotImplementedError for what the host path still to port runs
    (ROADMAP Queue 1 item 5): aggregates, GROUP BY dimensions, HAVING,
    ORDER BY, set-returning functions, event time, a window other than
    processing-time tumbling or hopping, functions other than lag,
    row_number, rank, dense_rank, lead and isnull, and expressions the row
    evaluator does not run (`*`, BETWEEN, IN, CASE, LIKE, bitwise
    operators, meta, index and arrow expressions).
    """
    dev = resolve_device(device)
    opts = rule_options(options)
    stmt = parse_select(sql)
    _gate(stmt, opts)
    if stmt.joins and stmt.window is None:
        # same contract as the reference: stream-stream joins pair rows
        # WITHIN a window collection (join_operator.go)
        raise PlanError("stream-stream JOIN requires a window")
    tbls = list(stmt.sources) + [j.table for j in stmt.joins]
    multi = len(tbls) > 1 or bool(stmt.joins)
    entries = {}
    for t in tbls:
        name = t.ref_name if multi else t.name
        entries[name] = EntryNode(name)
    rule = HostRule(entries=entries, tail=None, nodes=dict(entries))
    chain: List[Node] = list(entries.values())

    def attach(node: Node) -> Node:
        rule.nodes[node.name] = node
        for t in chain:
            t.connect(node)
        chain[:] = [node]
        return node

    analytic = analytic_calls(stmt)
    if analytic:
        attach(_make_analytic_node(analytic, opts, dev))
    # predicate pushdown: WHERE before the window when it has no analytic
    # refs (the reference's order)
    where_pushed = False
    if stmt.condition is not None and not analytic:
        attach(FilterNode("filter", stmt.condition))
        where_pushed = True
    if stmt.window is not None:
        attach(WindowNode("window", stmt.window))
    if stmt.condition is not None and not where_pushed:
        attach(FilterNode("filter", stmt.condition))
    if stmt.joins:
        attach(_make_join_node(stmt, opts, dev))
    wf = window_func_calls(stmt)
    if wf:
        attach(_make_window_func_node(wf, opts, dev))
    rule.tail = attach(ProjectNode("project", stmt.fields,
                                   limit=stmt.limit))
    return rule


def _gate(stmt: ast.SelectStatement, opts: dict) -> None:
    """NotImplementedError for the parts of the reference's host chain the
    port does not run yet."""
    what = None
    if opts["isEventTime"]:
        what = "an event-time host chain"
    elif stmt.dimensions:
        what = "GROUP BY dimensions (the aggregate node)"
    elif stmt.having is not None:
        what = "HAVING"
    elif stmt.sorts:
        what = "ORDER BY"
    elif any(ast.has_aggregate(e) for e in stmt.expressions()):
        what = "an aggregate on the host chain"
    if what is None:
        for root in stmt.expressions():
            for node in ast.walk(root):
                if isinstance(node, ast.Call) \
                        and node.name not in _ROW_FUNCS:
                    what = f"the row path of {node.name}()"
                elif not isinstance(node, _ROW_NODES) or \
                        getattr(node, "op", "NOT") not in _ROW_OPS:
                    what = (f"row evaluation of "
                            f"{getattr(node, 'op', type(node).__name__)}")
                if what:
                    break
            if what:
                break
    if what is not None:
        raise NotImplementedError(f"{what} is not ported yet {_ITEM5}")


def analytic_calls(stmt: ast.SelectStatement) -> List[ast.Call]:
    """The statement's analytic calls, each instance once (the reference's
    `_analytic_calls`)."""
    out, seen = [], set()
    for root in stmt.expressions():
        for node in ast.walk(root):
            if isinstance(node, ast.Call) and registry.is_analytic(node.name):
                if node.func_id not in seen:
                    seen.add(node.func_id)
                    out.append(node)
    return out


def window_func_calls(stmt: ast.SelectStatement) -> List[ast.Call]:
    """The statement's window-function calls (the reference's
    `_window_func_calls`)."""
    out = []
    for root in stmt.expressions():
        for node in ast.walk(root):
            if isinstance(node, ast.Call):
                fd = registry.lookup(node.name)
                if fd is not None and fd.ftype == registry.WINDOW_FUNC:
                    out.append(node)
    return out


def _make_join_node(stmt, opts: dict, dev) -> JoinNode:
    """The device ring when the ON clause lowers (planner/relational.py),
    else the host nested loop, with the reason recorded."""
    left = stmt.sources[0].ref_name
    if opts["joinImpl"] == "device":
        try:
            lowering = relational.lower_join(stmt, stmt.joins)
            return DeviceJoinNode("join", stmt.joins, left_name=left,
                                  lowering=lowering, device=dev)
        except NotVectorizable as nv:
            record_host_fallback(nv.reason)
    return JoinNode("join", stmt.joins, left_name=left)


def _make_analytic_node(analytic, opts: dict, dev) -> AnalyticNode:
    if opts["analyticImpl"] == "device":
        try:
            lowering = relational.lower_analytics(analytic)
            return DeviceAnalyticNode("analytic", analytic,
                                      lowering=lowering, device=dev)
        except NotVectorizable as nv:
            record_host_fallback(nv.reason)
    return AnalyticNode("analytic", analytic)


def _make_window_func_node(wf, opts: dict, dev) -> WindowFuncNode:
    """rank/dense_rank/lead are whole-collection functions — they always
    route through the vector node (a per-row exec cannot see the value
    order); `analyticImpl` only decides whether exact-float32 rank
    collections use the segscan sort kernel."""
    if not any(c.name in relational.VECTOR_WINDOW_FUNCS for c in wf):
        return WindowFuncNode("window_func", wf)
    use_device = False
    if opts["analyticImpl"] == "device":
        try:
            use_device = relational.lower_window_funcs(wf).device_eligible()
        except NotVectorizable as nv:
            record_host_fallback(nv.reason)
    return VectorWindowFuncNode("window_func", wf, use_device=use_device,
                                device=dev)
