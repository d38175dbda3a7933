"""Parity of the port's relational tier as a whole (ekuiper_tpu_torch/planner/
planner.py `plan_host_rule`, runtime/nodes_window.py WindowNode,
runtime/nodes_ops.py, runtime/nodes_relational.py DeviceAnalyticNode and
VectorWindowFuncNode, sql/eval.py; the kernels' plain PyTorch versions on
the CPU) against the JAX package.

- DeviceAnalyticNode (lag on the segscan shift) and the host AnalyticNode:
  equal lag values batch by batch; the one-way migration to host state on
  a non-numeric value, counted; checkpoints crossing both packages each
  way (and from the device node to the host one), the next batch equal.
- VectorWindowFuncNode: the device gate (every value numeric and
  float32-exact: the sort kernel) and the exact host path (a value that is
  not float32-exact, a string), rank / dense_rank / lead / row_number
  equal to the JAX node's.
- WindowNode checkpoints crossing both packages.
- The slice: the J2 join rule (INNER / LEFT / FULL, joinImpl device and
  host), a join whose ON residual compares with a string (the port's host
  nested loop against the reference's device ring), the K1 lag rule and
  the K2 rank / dense_rank / lead rule, run through the JAX package's
  `plan_rule` with the memory source and sink under the mock clock (as
  tests/test_join_e2e.py:30-60 does) and through `plan_host_rule` on the
  port's mock clock: equal rows, in equal order, window by window.
Every comparison is exact: the values pass through the same float32
columns in both packages.
"""
import gc
import json
import time

import numpy as np
import pytest

import ekuiper_tpu.io.memory as mem
from ekuiper_tpu.data.batch import ColumnBatch as JBatch
from ekuiper_tpu.data.rows import Tuple as JTuple
from ekuiper_tpu.data.rows import WindowRange as JRange
from ekuiper_tpu.data.rows import WindowTuples as JWindowTuples
from ekuiper_tpu.planner import relational as jrel
from ekuiper_tpu.planner.planner import RuleDef, plan_rule
from ekuiper_tpu.planner.planner import _analytic_calls as j_analytic_calls
from ekuiper_tpu.planner.planner import _window_func_calls as j_wf_calls
from ekuiper_tpu.runtime import nodes_ops as jops
from ekuiper_tpu.runtime import nodes_relational as jnr
from ekuiper_tpu.runtime import nodes_window as jwin
from ekuiper_tpu.server.processors import StreamProcessor
from ekuiper_tpu.sql.parser import parse_select as jparse
from ekuiper_tpu.store import kv
from ekuiper_tpu_torch.data.batch import ColumnBatch
from ekuiper_tpu_torch.data.rows import Tuple, WindowRange, WindowTuples
from ekuiper_tpu_torch.planner import planner as pp
from ekuiper_tpu_torch.planner import relational
from ekuiper_tpu_torch.runtime import nodes_ops, nodes_relational
from ekuiper_tpu_torch.runtime.events import EOF
from ekuiper_tpu_torch.runtime.node import Node
from ekuiper_tpu_torch.runtime.nodes_window import WindowNode
from ekuiper_tpu_torch.sql.compiler import (host_fallback_counts,
                                            reset_host_fallbacks)
from ekuiper_tpu_torch.sql.parser import parse_select
from ekuiper_tpu_torch.utils import timex
from ekuiper_tpu_torch.utils.infra import PlanError

LAG_SQL = ("SELECT deviceId, temperature, lag(temperature) OVER "
           "(PARTITION BY deviceId) AS prev FROM demo")
LAG3_SQL = ("SELECT deviceId, lag(temperature, 1, -1.0) OVER "
            "(PARTITION BY deviceId) AS p1, lag(temperature) AS p0 "
            "FROM demo")
RANK_SQL = ("SELECT deviceId, temperature, "
            "rank(temperature) OVER (PARTITION BY deviceId) AS rk, "
            "dense_rank(temperature) OVER (PARTITION BY deviceId) AS dr, "
            "lead(temperature) OVER (PARTITION BY deviceId) AS nx, "
            "row_number() OVER (PARTITION BY deviceId) AS rn "
            "FROM demo GROUP BY TUMBLINGWINDOW(ss, 10)")
J2 = ("SELECT l.v, r.w FROM l {jt} JOIN r ON l.k = r.k "
      "AND l.ts - r.ts >= -5000 AND l.ts - r.ts <= 5000 AND l.v > r.w "
      "GROUP BY TUMBLINGWINDOW(ss, 10)")
J_STR = ("SELECT l.k, l.v, r.w FROM l INNER JOIN r ON l.k = r.k "
         "AND r.tag = 'x' GROUP BY TUMBLINGWINDOW(ss, 10)")


@pytest.fixture(scope="module", autouse=True)
def _no_cyclic_gc_inside_jax_locks():
    """As in test_torch_event.py: the JAX package's devwatch registry
    deadlocks when a cyclic collection lands inside its weakref prune, so
    this module runs with the cyclic collector off and collects at end."""
    enabled = gc.isenabled()
    gc.disable()
    yield
    if enabled:
        gc.enable()
    gc.collect()


@pytest.fixture(autouse=True)
def _port_clock():
    """The port's engine clock is a mock one for each test, then real."""
    yield timex.set_mock_clock(0)
    timex.use_real_clock()


class _Sink(Node):
    def __init__(self):
        super().__init__("sink")
        self.got = []

    def process(self, item):
        if isinstance(item, (list, Tuple)):
            self.got.append(item)


def _messages(items):
    out = []
    for p in items:
        for t in (p if isinstance(p, list) else [p]):
            out.append(t if isinstance(t, dict) else t.message)
    return out


# ---------------------------------------------------------------- data
def _demo_columns(rng, n, keys=6):
    """deviceId / temperature columns: integers and halves (float32-exact),
    some NULL."""
    return {"deviceId": np.array([f"d{i}" for i in rng.integers(0, keys, n)],
                                 dtype=object),
            "temperature": (rng.integers(0, 40, n) / 2).astype(np.float32)}


def _pair_batches(cols, valid=None, ts=None):
    valid = valid or {}
    return (ColumnBatch(n=len(next(iter(cols.values()))), columns=cols,
                        valid=dict(valid), timestamps=ts, emitter="demo"),
            JBatch(n=len(next(iter(cols.values()))), columns=dict(cols),
                   valid=dict(valid), timestamps=ts, emitter="demo"))


# ------------------------------------------------------- analytic nodes
def _analytic_pair(sql, impl="device"):
    stmt, jstmt = parse_select(sql), jparse(sql)
    calls, jcalls = pp.analytic_calls(stmt), j_analytic_calls(jstmt)
    if impl == "device":
        port = nodes_relational.DeviceAnalyticNode(
            "analytic", calls, relational.lower_analytics(calls),
            device="cpu")
        jax = jnr.DeviceAnalyticNode("analytic", jcalls,
                                     jrel.lower_analytics(jcalls))
    else:
        port = nodes_ops.AnalyticNode("analytic", calls)
        jax = jops.AnalyticNode("analytic", jcalls)
    sink, jgot = _Sink(), []
    port.connect(sink)
    jax.emit = lambda item, count=1: jgot.append(item)
    return port, jax, sink.got, jgot, calls


def _cal_cols(rows, calls):
    return [[r.cal_cols.get(f"__analytic_{c.func_id}") for c in calls]
            for r in rows]


def _feed(port, jax, pg, jg, calls, cols, valid=None):
    del pg[:], jg[:]
    pb, jb = _pair_batches(cols, valid)
    port.process(pb)
    jax.process(jb)
    got, want = _cal_cols(pg, calls), _cal_cols(jg, calls)
    assert got == want
    return got


@pytest.mark.parametrize("impl", ["device", "host"])
@pytest.mark.parametrize("sql", [LAG_SQL, LAG3_SQL])
def test_analytic_node_matches_jax_across_batches(sql, impl):
    port, jax, pg, jg, calls = _analytic_pair(sql, impl)
    rng = np.random.default_rng(1)
    for i in range(5):
        cols = _demo_columns(rng, 200)
        valid = {"temperature": rng.random(200) > 0.1} if i % 2 else None
        _feed(port, jax, pg, jg, calls, cols, valid)
    if impl == "device":
        assert not port._migrated
        assert port._seg.rows_total == 1000 * len(calls)
        assert port._seg.spills_total == jax._seg.spills_total > 0
    # a single row (a Tuple, as a lookup join upstream would hand it)
    for node, T, out in ((port, Tuple, pg), (jax, JTuple, jg)):
        del out[:]
        node.process(T(emitter="demo", message={"deviceId": "d1",
                                                "temperature": 3.5}))
    assert _cal_cols(pg, calls) == _cal_cols(jg, calls)


def test_analytic_migrates_on_non_numeric_value():
    """A string value moves both nodes to host state for good; the carry's
    last values continue every partition; the migration is counted."""
    reset_host_fallbacks()
    port, jax, pg, jg, calls = _analytic_pair(LAG_SQL)
    rng = np.random.default_rng(2)
    for _ in range(2):
        _feed(port, jax, pg, jg, calls, _demo_columns(rng, 120))
    cols = _demo_columns(rng, 50)
    cols["temperature"] = cols["temperature"].astype(object)
    cols["temperature"][7] = "hot"
    _feed(port, jax, pg, jg, calls, cols)
    assert port._migrated and jax._migrated
    assert port.migrations == 1
    assert host_fallback_counts().get("analytic_runtime_type") == 1
    for _ in range(2):
        _feed(port, jax, pg, jg, calls, _demo_columns(rng, 80))
    assert port.snapshot_state() == jax.snapshot_state()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax",
                                       "device_to_host"])
def test_analytic_checkpoint_crosses_packages(direction):
    rng = np.random.default_rng(3)
    port, jax, pg, jg, calls = _analytic_pair(LAG_SQL)
    for _ in range(3):
        _feed(port, jax, pg, jg, calls, _demo_columns(rng, 150, keys=9))
    if direction == "device_to_host":
        # the reference's snapshot of a device node restores into a host
        # node of either package (its func_states hold no lag history yet:
        # both continue from the restored node's own state)
        snap = json.loads(json.dumps(jax.snapshot_state()))
        port, jax, pg, jg, calls = _analytic_pair(LAG_SQL, "host")
    else:
        src = jax if direction == "jax_to_port" else port
        snap = json.loads(json.dumps(src.snapshot_state()))
        assert set(snap) == {"func_states", "migrated", "segscan",
                             "part_keys"}
        port, jax, pg, jg, calls = _analytic_pair(LAG_SQL)
    # each node its own copy: a restored func_states is the node's own
    port.restore_state(json.loads(json.dumps(snap)))
    jax.restore_state(json.loads(json.dumps(snap)))
    for _ in range(2):
        got = _feed(port, jax, pg, jg, calls,
                    _demo_columns(rng, 150, keys=12))
        assert any(v[0] is not None for v in got)


def test_analytic_checkpoint_after_migration_crosses():
    rng = np.random.default_rng(4)
    port, jax, pg, jg, calls = _analytic_pair(LAG_SQL)
    _feed(port, jax, pg, jg, calls, _demo_columns(rng, 100))
    cols = _demo_columns(rng, 10)
    cols["temperature"] = cols["temperature"].astype(object)
    cols["temperature"][0] = "x"
    _feed(port, jax, pg, jg, calls, cols)
    snap = json.loads(json.dumps(port.snapshot_state()))
    assert snap == json.loads(json.dumps(jax.snapshot_state()))
    p2, j2, pg2, jg2, calls2 = _analytic_pair(LAG_SQL)
    p2.restore_state(json.loads(json.dumps(snap)))
    j2.restore_state(json.loads(json.dumps(snap)))
    assert p2._migrated and j2._migrated
    _feed(p2, j2, pg2, jg2, calls2, _demo_columns(rng, 60))


# ---------------------------------------------------- window functions
def _wf_pair(sql, use_device=True):
    stmt, jstmt = parse_select(sql), jparse(sql)
    wf, jwf = pp.window_func_calls(stmt), j_wf_calls(jstmt)
    port = nodes_relational.VectorWindowFuncNode(
        "window_func", wf, use_device=use_device, device="cpu")
    jax = jnr.VectorWindowFuncNode("window_func", jwf,
                                   use_device=use_device)
    sink, jgot = _Sink(), []
    port.connect(Node("x"))  # the collection passes on; rows are read below
    jax.emit = lambda item, count=1: jgot.append(item)
    return port, jax, wf


def _wf_rows(port, jax, wf, msgs):
    """One window of `msgs` through both nodes; their cal-cols."""
    prows = [Tuple(emitter="demo", message=dict(m)) for m in msgs]
    jrows = [JTuple(emitter="demo", message=dict(m)) for m in msgs]
    port.process(WindowTuples(content=prows,
                              window_range=WindowRange(0, 10)))
    jax.process(JWindowTuples(content=jrows, window_range=JRange(0, 10)))
    got, want = _cal_cols(prows, wf), _cal_cols(jrows, wf)
    assert got == want
    return got


@pytest.mark.parametrize("kind", ["float32_exact", "not_exact", "strings",
                                  "host_impl"])
def test_window_funcs_match_jax(kind):
    """The device gate (float32-exact numbers, sort kernel) and the exact
    host path (a float64 value float32 would round, strings, analyticImpl
    host), every function equal to the JAX node's."""
    port, jax, wf = _wf_pair(RANK_SQL, use_device=kind != "host_impl")
    rng = np.random.default_rng(5)
    for _ in range(3):
        n = 300
        vals = (rng.integers(0, 20, n) / 4).tolist()
        if kind == "not_exact":
            vals[5] = 0.1  # float32 would round it: the host path
        elif kind == "strings":
            vals = [f"s{int(v)}" for v in vals]
        msgs = [{"deviceId": f"d{k}", "temperature": v}
                for k, v in zip(rng.integers(0, 7, n), vals)]
        for i in rng.choice(n, 20, replace=False):
            msgs[i].pop("temperature")  # NULL
        _wf_rows(port, jax, wf, msgs)
    device = kind == "float32_exact"
    assert port.rank_paths == {"device": 6 if device else 0,
                               "host": 0 if device else 6}
    assert (port._seg is not None) == (jax._seg is not None) == device


# -------------------------------------------------------- window node
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_window_checkpoint_crosses_packages(direction):
    sql = ("SELECT l.v, r.w FROM l INNER JOIN r ON l.k = r.k "
           "GROUP BY HOPPINGWINDOW(ss, 10, 5)")
    stmt, jstmt = parse_select(sql), jparse(sql)
    port, jax = WindowNode("window", stmt.window), jwin.WindowNode(
        "window", jstmt.window)
    pout, jout = _Sink(), []
    port.outputs.append(pout)
    port.emit = lambda item, count=1: pout.got.append(item)
    jax.emit = lambda item, count=1: jout.append(item)
    rng = np.random.default_rng(6)
    src = jax if direction == "jax_to_port" else port
    for em in ("l", "r", "l"):
        cols = {"k": np.array(["a", "b", "c"], dtype=object),
                "v": (rng.integers(0, 9, 3) / 2).astype(np.float32)}
        ts = rng.integers(0, 10_000, 3).astype(np.int64)
        B = JBatch if src is jax else ColumnBatch
        src.process(B(n=3, columns=cols, timestamps=ts, emitter=em))
    snap = json.loads(json.dumps(src.snapshot_state()))
    port.restore_state(json.loads(json.dumps(snap)))
    jax.restore_state(json.loads(json.dumps(snap)))
    # a restore regroups the rows by emitter (one batch each), in both
    assert json.loads(json.dumps(port.snapshot_state())) == \
        json.loads(json.dumps(jax.snapshot_state()))
    from ekuiper_tpu.runtime.events import Trigger as JTrigger
    from ekuiper_tpu_torch.runtime.events import Trigger

    port.on_trigger(Trigger(ts=10_000))
    jax.on_trigger(JTrigger(ts=10_000))
    got = [(r.emitter, r.message, r.timestamp) for w in pout.got
           for r in w.rows()]
    want = [(r.emitter, r.message, r.timestamp) for w in jout
            for r in w.rows()]
    assert got == want and got


# -------------------------------------------------------------- planner
def test_plan_host_rule_refuses_join_without_window():
    with pytest.raises(PlanError, match="JOIN requires a window"):
        pp.plan_host_rule("SELECT ls.id FROM ls INNER JOIN rs "
                          "ON ls.id = rs.id", device="cpu")


@pytest.mark.parametrize("sql", [
    "SELECT deviceId, avg(temperature) FROM demo "
    "GROUP BY deviceId, TUMBLINGWINDOW(ss, 10)",
    "SELECT deviceId FROM demo ORDER BY deviceId",
    "SELECT latest(temperature) FROM demo",
    "SELECT abs(temperature) FROM demo",
    "SELECT l.v FROM l INNER JOIN r ON l.k = r.k "
    "GROUP BY COUNTWINDOW(10)",
    "SELECT * FROM demo",
    "SELECT deviceId FROM demo WHERE temperature BETWEEN 1 AND 2",
    "SELECT CASE WHEN temperature > 1 THEN 1 ELSE 0 END AS c FROM demo",
])
def test_plan_host_rule_refuses_the_rest_of_the_host_path(sql):
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        pp.plan_host_rule(sql, device="cpu")


def test_plan_host_rule_options():
    with pytest.raises(PlanError):
        pp.plan_host_rule(LAG_SQL, device="cpu",
                          options={"analyticImpl": "tpu"})
    with pytest.raises(NotImplementedError):
        pp.plan_host_rule(LAG_SQL, device="cpu",
                          options={"isEventTime": True})
    rule = pp.plan_host_rule(LAG_SQL, device="cpu",
                             options={"analyticImpl": "host"})
    assert type(rule.nodes["analytic"]) is nodes_ops.AnalyticNode


@pytest.mark.parametrize("sql,opts", [
    (J2.format(jt="INNER"), {}), (J2.format(jt="FULL"), {"joinImpl": "host"}),
    (LAG_SQL, {}), (LAG_SQL, {"analyticImpl": "host"}),
    ("SELECT deviceId, lag(temperature) OVER (WHEN temperature > 1) "
     "AS p FROM demo", {}),
    (RANK_SQL, {}), (RANK_SQL, {"analyticImpl": "host"}),
    ("SELECT deviceId, row_number() OVER (PARTITION BY deviceId) AS rn "
     "FROM demo GROUP BY TUMBLINGWINDOW(ss, 10)", {}),
])
def test_plan_host_rule_chooses_the_nodes_the_reference_chooses(sql, opts):
    """Node by node, the port's chain has the reference's classes (the
    JAX chain built by plan_rule over memory streams); the one exception,
    a string ON residual, has its own test below."""
    store = kv.get_store()
    _streams(store)
    topo = plan_rule(RuleDef(id="choice", sql=sql, actions=[{"log": {}}],
                             options=dict(opts)), store)
    want = [type(n).__name__ for n in topo.ops
            if type(n).__name__ in ("AnalyticNode", "DeviceAnalyticNode",
                                    "FilterNode", "WindowNode", "JoinNode",
                                    "DeviceJoinNode", "WindowFuncNode",
                                    "VectorWindowFuncNode", "ProjectNode")]
    rule = pp.plan_host_rule(sql, device="cpu", options=opts)
    got = [type(n).__name__ for n in rule.nodes.values()
           if n not in rule.entries.values()]
    assert got == want
    wf = rule.nodes.get("window_func")
    if isinstance(wf, nodes_relational.VectorWindowFuncNode):
        jwf = next(n for n in topo.ops if n.name == "window_func")
        assert wf.use_device == jwf.use_device


# ------------------------------------------------------------ the slice
def _streams(store):
    sp = StreamProcessor(store)
    for stmt in (
            'CREATE STREAM l (k STRING, ts BIGINT, v FLOAT) '
            'WITH (DATASOURCE="rel/l", TYPE="memory", FORMAT="JSON")',
            'CREATE STREAM r (k STRING, ts BIGINT, w FLOAT, tag STRING) '
            'WITH (DATASOURCE="rel/r", TYPE="memory", FORMAT="JSON")',
            'CREATE STREAM demo (deviceId STRING, temperature FLOAT) '
            'WITH (DATASOURCE="rel/demo", TYPE="memory", FORMAT="JSON")'):
        sp.exec_stmt(stmt)


_SCHEMA = {"k": object, "ts": np.int64, "v": np.float32, "w": np.float32,
           "tag": object, "deviceId": object, "temperature": np.float32}


def _batch_of(msgs):
    """The port's ColumnBatch of a stream's messages, typed as the JAX
    memory source types them by the stream's schema."""
    names = [k for k in _SCHEMA if k in msgs[0]]
    return ColumnBatch(n=len(msgs), columns={
        k: np.array([m[k] for m in msgs], dtype=_SCHEMA[k]) for k in names})


def _wait(got, n, deadline_s=8.0):
    deadline = time.time() + deadline_s
    while time.time() < deadline and len(got) < n:
        time.sleep(0.02)


class _Slice:
    """One rule through JAX plan_rule (threaded topology, memory source
    and sink, the JAX mock clock) and through plan_host_rule (the port's
    mock clock): `window(feeds)` publishes each stream's messages, moves
    both clocks past the next 10 s boundary, and returns both packages'
    rows of that window."""

    def __init__(self, sql, opts, jax_clock, port_clock, topic):
        store = kv.get_store()
        _streams(store)
        self.topo = plan_rule(RuleDef(
            id=topic, sql=sql, actions=[{"memory": {"topic": topic}}],
            options=dict(opts)), store)
        self.jgot = []
        mem.subscribe(topic, lambda t, p: self.jgot.append(p))
        self.rule = pp.plan_host_rule(sql, device="cpu", options=opts)
        self.sink = _Sink()
        self.rule.tail.connect(self.sink)
        self.jc, self.pc = jax_clock, port_clock
        self.topo.open()
        self.rule.on_open()
        self.now = 0

    def window(self, feeds, per_row=False):
        j0, p0 = len(self.jgot), len(self.sink.got)
        for stream, msgs in feeds.items():
            for m in msgs:
                mem.publish(f"rel/{stream}", dict(m))
            self.rule.entries[stream].process(_batch_of(msgs))
        self.jc.advance(20)
        assert self.topo.wait_idle(10)
        if not per_row:
            nxt = (self.now // 10_000 + 1) * 10_000
            self.jc.advance(nxt - self.now - 20)
            self.pc.advance(nxt - self.now)
            self.now = nxt
            _wait(self.jgot, j0 + 1)
            self.topo.wait_idle(10)
        else:
            self.pc.advance(20)
            self.now += 20
            _wait(self.jgot, j0 + sum(len(v) for v in feeds.values()))
        return (_messages(self.sink.got[p0:]), _messages(self.jgot[j0:]))

    def close(self):
        self.topo.close()
        self.rule.on_close()


def _join_feeds(rng, n=24, keys=5):
    def side(col):
        return [{"k": f"k{rng.integers(0, keys)}",
                 "ts": int(rng.integers(0, 20_000)),
                 col: float(rng.integers(0, 20) / 2),
                 **({"tag": "x" if rng.random() < 0.5 else "y"}
                    if col == "w" else {})} for _ in range(n)]
    return {"l": side("v"), "r": side("w")}


@pytest.mark.parametrize("jt,impl", [("INNER", "device"), ("LEFT", "device"),
                                     ("FULL", "device"), ("LEFT", "host")])
def test_slice_join_rule_matches_reference(jt, impl, mock_clock, _port_clock):
    s = _Slice(J2.format(jt=jt), {"joinImpl": impl}, mock_clock,
               _port_clock, f"rel_j2_{jt}_{impl}")
    try:
        rng = np.random.default_rng(7)
        for _ in range(3):
            got, want = s.window(_join_feeds(rng))
            assert got == want and got
        join = s.rule.nodes["join"]
        if impl == "device":
            assert join.ring.fallback_windows_total == 0
            assert join.ring.rows_total == {"l": 72, "r": 72}
    finally:
        s.close()


def test_slice_string_residual_runs_nested_loop(mock_clock, _port_clock):
    """The port's IR refuses the string residual (join_on_residual): the
    rule runs the host nested loop; its rows equal the reference's device
    ring's."""
    reset_host_fallbacks()
    s = _Slice(J_STR, {}, mock_clock, _port_clock, "rel_jstr")
    try:
        assert type(s.rule.nodes["join"]).__name__ == "JoinNode"
        assert host_fallback_counts() == {"join_on_residual": 1}
        assert type(next(n for n in s.topo.ops if n.name == "join")
                    ).__name__ == "DeviceJoinNode"
        rng = np.random.default_rng(8)
        for _ in range(2):
            got, want = s.window(_join_feeds(rng, keys=3))
            assert got == want and got
    finally:
        s.close()


def test_slice_lag_rule_matches_reference(mock_clock, _port_clock):
    s = _Slice(LAG_SQL, {}, mock_clock, _port_clock, "rel_k1")
    try:
        rng = np.random.default_rng(9)
        for _ in range(3):
            cols = _demo_columns(rng, 40)
            msgs = [{"deviceId": d, "temperature": float(t)}
                    for d, t in zip(cols["deviceId"], cols["temperature"])]
            got, want = s.window({"demo": msgs}, per_row=True)
            assert got == want and len(got) == 40
        assert s.rule.nodes["analytic"]._seg.spills_total > 0
    finally:
        s.close()


def test_slice_rank_rule_matches_reference(mock_clock, _port_clock):
    s = _Slice(RANK_SQL, {}, mock_clock, _port_clock, "rel_k2")
    try:
        rng = np.random.default_rng(10)
        for _ in range(2):
            cols = _demo_columns(rng, 60)
            msgs = [{"deviceId": d, "temperature": float(t)}
                    for d, t in zip(cols["deviceId"], cols["temperature"])]
            got, want = s.window({"demo": msgs})
            assert got == want and len(got) == 60
        assert s.rule.nodes["window_func"].rank_paths["device"] == 4
    finally:
        s.close()


def test_window_node_flushes_at_eof():
    rule = pp.plan_host_rule(RANK_SQL, device="cpu")
    sink = _Sink()
    rule.tail.connect(sink)
    rule.entries["demo"].process(_batch_of([{"deviceId": "a",
                                             "temperature": 1.0}]))
    rule.entries["demo"].put_control(EOF())
    assert _messages(sink.got) == [{"deviceId": "a", "temperature": 1.0,
                                    "rk": 1, "dr": 1, "nx": None, "rn": 1}]
