"""Parity of the port's event time (ekuiper_tpu_torch/runtime/nodes_window.py
WatermarkNode, the event-time branches of runtime/nodes_fused.py and
runtime/nodes_multirule.py, the rule group's per-row pane vector in
parallel/multirule.py and ops/kernels.py, planner/fused.py's isEventTime
and lateTolerance, planner/rulegroup.py's refusal), through the plain
PyTorch versions of the kernels on the CPU, against the JAX package's
WatermarkNode, FusedWindowAggNode(is_event_time=True), BatchedGroupBy and
MultiRuleFusedNode.

Inputs are made from a seed with numpy and given to both packages: rows
stamped batch i · 1000 ms plus U(-1200, 300) ms, 3 % of them a further
3,000 ms late, so that batches cross bucket edges (the pane vector) and
the watermark node drops rows. The port runs behind its WatermarkNode
entry (`plan_fused_rule(..., options={"isEventTime": True})` →
`node.watermark`); the JAX node behind its own WatermarkNode, whose
output the test hands to the JAX node as its topology would. Tests named
after a test of tests/test_event_fused.py (line given) check the same
behaviour on both packages. Tolerances of an emitted row against the
reference's, as tests/test_torch_windows.py states them:
- keys, count, max, the window's timestamps and the watermarks: exact;
- avg: rtol 1e-5 (float32 scatter-add order differs between XLA and
  torch);
- stddev: rtol 1e-4 plus the cancellation floor of s2/n - mean²;
- percentile_approx: the same bin centre, within 4 ulp;
- hll: within 1 (the port reads rho from the float exponent, the
  reference's jnp.log2 misses it at rare values);
- group state (the batched folds with a pane vector): counts, act, min,
  max, hist counters exact, s1 / s2 rtol 1e-5, hll registers exact
  outside the cells a jnp.log2 miss reaches.
"""
import gc
import json

import numpy as np
import pytest

from ekuiper_tpu.data.batch import ColumnBatch as JaxBatch
from ekuiper_tpu.ops.aggspec import extract_kernel_plan as jax_plan_of
from ekuiper_tpu.ops.emit import build_direct_emit as jax_direct_emit
from ekuiper_tpu.parallel.multirule import BatchedGroupBy as JaxBatched
from ekuiper_tpu.planner.planner import device_path_eligible
from ekuiper_tpu.runtime.events import EOF as JaxEOF
from ekuiper_tpu.runtime.events import Watermark as JaxWatermark
from ekuiper_tpu.runtime.nodes_fused import FusedWindowAggNode as JaxNode
from ekuiper_tpu.runtime.nodes_multirule import \
    MultiRuleFusedNode as JaxGroupNode
from ekuiper_tpu.runtime.nodes_window import WatermarkNode as JaxWatermarkNode
from ekuiper_tpu.sql.parser import parse_select as jax_parse
from ekuiper_tpu.utils.config import RuleOptionConfig
from ekuiper_tpu_torch.data.batch import ColumnBatch
from ekuiper_tpu_torch.data.rows import Tuple
from ekuiper_tpu_torch.ops import kernels
from ekuiper_tpu_torch.ops.aggspec import extract_kernel_plan
from ekuiper_tpu_torch.ops.emit import build_direct_emit
from ekuiper_tpu_torch.parallel.multirule import BatchedGroupBy
from ekuiper_tpu_torch.planner.fused import plan_fused_rule
from ekuiper_tpu_torch.planner.rulegroup import plan_rule_group
from ekuiper_tpu_torch.runtime.events import EOF, Watermark
from ekuiper_tpu_torch.runtime.node import Node
from ekuiper_tpu_torch.runtime.nodes_fused import FusedWindowAggNode
from ekuiper_tpu_torch.runtime.nodes_multirule import MultiRuleFusedNode
from ekuiper_tpu_torch.runtime.nodes_window import WatermarkNode
from ekuiper_tpu_torch.sql.parser import parse_select
from ekuiper_tpu_torch.utils import timex
from ekuiper_tpu_torch.utils.infra import PlanError
from test_torch_multirule import (_assert_outs, _assert_state,
                                  _assert_wide_outs, _assert_wide_state,
                                  _specs)

CAP, MB, KEYS, ROWS = 64, 64, 20, 60
TOL = 1000
EPS32 = float(np.finfo(np.float32).eps)
AGGS = ("count(*) AS c, avg(v) AS a, stddev(v) AS sd, max(v) AS mx, "
        "hll(v) AS u, percentile_approx(v, 0.9) AS p")
TUMBLING = f"SELECT k, {AGGS} FROM s GROUP BY k, TUMBLINGWINDOW(ss, 4)"
HOPPING = f"SELECT k, {AGGS} FROM s GROUP BY k, HOPPINGWINDOW(ss, 4, 1)"
SCALAR = ("SELECT k, count(*) AS c, avg(v) AS a, max(v) AS mx FROM s "
          "GROUP BY k, TUMBLINGWINDOW(ss, 10)")
#: tests/test_event_fused.py's rules and rows (its stream `ed`)
ED = "deviceId, count(*) AS c, avg(temperature) AS a"
SQL_SESS = f"SELECT {ED} FROM ed GROUP BY deviceId, SESSIONWINDOW(ss, 30, 5)"
SQL_COUNT = f"SELECT {ED} FROM ed GROUP BY deviceId, COUNTWINDOW(4)"
SQL_STATE = (f"SELECT {ED} FROM ed GROUP BY deviceId, "
             "STATEWINDOW(temperature > 25, temperature < 8)")
ED_ROWS = [("a", 10.0, 1_000), ("a", 20.0, 6_000), ("b", 5.0, 9_000),
           ("a", 30.0, 12_000), ("b", 7.0, 15_000)]
SESS_ROWS = [("a", 10.0, 1_000), ("a", 20.0, 4_000), ("b", 6.0, 2_500),
             ("a", 30.0, 12_000), ("b", 8.0, 13_000)]
STATE_ROWS = [("a", 30.0, 1_000), ("a", 15.0, 2_000), ("b", 5.0, 3_000),
              ("a", 40.0, 4_000), ("b", 2.0, 5_000)]
PUSHER = [("z", 0.0, 40_000)]


@pytest.fixture(scope="module", autouse=True)
def _no_cyclic_gc_inside_jax_locks():
    """As in test_torch_windows.py: the JAX package's devwatch registry
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


# ------------------------------------------------------------------ data
def _stream(seed, n_batches, rows=ROWS, keys=KEYS, late=0.03, start=3):
    """(cols, ts) of each batch: batch i stamped (start + i) · 1000 ms +
    U(-1200, 300), a `late` share of its rows 3,000 ms earlier still."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        ts = (start + i) * 1000 + rng.integers(-1200, 300, rows)
        ts = ts - np.where(rng.random(rows) < late, 3000, 0)
        out.append(({"k": np.array([f"d{j}" for j in
                                    rng.integers(0, keys, rows)],
                                   dtype=object),
                     "v": rng.normal(20, 5, rows).round(2)},
                    np.maximum(ts, 0).astype(np.int64)))
    return out


def _ed_cols(rows):
    return ({"deviceId": np.array([r[0] for r in rows], dtype=object),
             "temperature": np.array([r[1] for r in rows], np.float32)},
            np.array([r[2] for r in rows], np.int64))


def _windows(items):
    return [it for it in items if hasattr(it, "columns")]


def _kinds(items):
    """The emitted sequence: a window's end, a watermark's ts, or EOF."""
    out = []
    for it in items:
        name = type(it).__name__
        if name == "ColumnBatch":
            out.append(("w", int(np.asarray(it.timestamps)[0])))
        elif name == "Watermark":
            out.append(("wm", it.ts))
        else:
            out.append((name,))
    return out


def _assert_windows(got, ref):
    """Emitted windows equal within the module's tolerances."""
    got, ref = _windows(got), _windows(ref)
    assert len(got) == len(ref) > 0
    for g_item, r_item in zip(got, ref):
        assert list(g_item.columns) == list(r_item.columns)
        np.testing.assert_array_equal(g_item.timestamps, r_item.timestamps)
        col = {k: np.asarray(v) for k, v in r_item.columns.items()}
        for name, rv in col.items():
            gv = np.asarray(g_item.columns[name])
            assert gv.shape == rv.shape, name
            if name in ("k", "deviceId", "c", "mx"):
                np.testing.assert_array_equal(gv, rv, err_msg=name)
            elif name == "sd":
                floor = np.sqrt(16 * EPS32) * np.abs(col["a"])
                ok = (np.isnan(gv) & np.isnan(rv)) | (
                    np.abs(gv - rv) <= 1e-4 * np.abs(rv) + floor)
                assert ok.all(), name
            elif name == "p":
                np.testing.assert_allclose(gv, rv, rtol=4 * 2.0 ** -23,
                                           err_msg=name)
            elif name == "u":
                assert (np.abs(gv - rv) <= 1).all(), name
            else:
                np.testing.assert_allclose(gv, rv, rtol=1e-5, err_msg=name)


def _rows_of(items):
    return sum(int(np.asarray(it.columns["c"]).sum())
               for it in _windows(items))


# ------------------------------------------------------------ the pairs
class _Pair:
    """A JAX WatermarkNode → FusedWindowAggNode(is_event_time=True) chain
    and the port's planned event-time node behind its watermark entry,
    fed the same batches. The JAX watermark node's output goes to the JAX
    fused node as its topology would hand it (data to process, a
    watermark to on_watermark)."""

    def __init__(self, sql, tol=TOL, dims=("k",), cap=CAP, lead=250):
        stmt = jax_parse(sql)
        plan = jax_plan_of(stmt)
        self.jnode = JaxNode(
            "ref", stmt.window, plan, [d.expr for d in stmt.dimensions],
            capacity=cap, micro_batch=MB,
            direct_emit=jax_direct_emit(stmt, plan, list(dims)),
            emit_columnar=True, prefinalize_lead_ms=lead,
            is_event_time=True, late_tolerance_ms=tol)
        self.jnode.state = self.jnode.gb.init_state()
        self.jwm = JaxWatermarkNode("wm", late_tolerance_ms=tol)
        self.jwm.broadcast = self._to_jax
        self.tnode = plan_fused_rule(
            sql, key_slots=cap, micro_batch=MB, device="cpu",
            options={"isEventTime": True, "lateTolerance": tol,
                     "prefinalizeLeadMs": lead})
        self.jgot, self.tgot = [], []
        self.jnode.broadcast = self.jgot.append
        self.tnode.broadcast = self.tgot.append

    def _to_jax(self, item):
        if isinstance(item, JaxWatermark):
            self.jnode.on_watermark(item)
        else:
            self.jnode.process(item)

    def feed(self, cols, ts):
        n = len(ts)
        self.jwm.process(JaxBatch(n=n, columns=dict(cols), timestamps=ts,
                                  emitter="s"))
        self.tnode.watermark.process(ColumnBatch(
            n=n, columns=dict(cols), timestamps=ts, emitter="s"))

    def eof(self):
        self.jnode.on_eof(JaxEOF())
        self.tnode.watermark.put_control(EOF())

    def drain(self):
        self.jnode._drain_async_emits()
        self.tnode._drain_async_emits()

    def close(self):
        self.tnode.on_close()
        self.jnode.on_close()


@pytest.fixture
def pairs():
    """_Pair factory; every pair made is closed at teardown."""
    made = []

    def make(sql, **kw):
        made.append(_Pair(sql, **kw))
        return made[-1]

    yield make
    for p in made:
        p.close()
    made.clear()


def _direct_pair(sql, tol=0, dims=("k",)):
    """The two packages' event-time fused nodes, built directly as the
    reference's tests build them (no watermark node), outputs listed."""
    out = []
    for pkg in ("jax", "port"):
        stmt = (jax_parse if pkg == "jax" else parse_select)(sql)
        plan = (jax_plan_of if pkg == "jax" else extract_kernel_plan)(stmt)
        emit = (jax_direct_emit if pkg == "jax" else build_direct_emit)(
            stmt, plan, list(dims))
        cls = JaxNode if pkg == "jax" else FusedWindowAggNode
        kw = {} if pkg == "jax" else {"device": "cpu"}
        node = cls("t", stmt.window, plan, [d.expr for d in stmt.dimensions],
                   capacity=CAP, micro_batch=32, direct_emit=emit,
                   emit_columnar=True, is_event_time=True,
                   late_tolerance_ms=tol, **kw)
        node.state = node.gb.init_state()
        got = []
        node.broadcast = got.append
        out.append((node, got))
    return out


def _feed_direct(nodes, cols, ts):
    (jnode, _), (tnode, _) = nodes
    n = len(ts)
    jnode.process(JaxBatch(n=n, columns=dict(cols), timestamps=ts,
                           emitter="s"))
    tnode.process(ColumnBatch(n=n, columns=dict(cols), timestamps=ts,
                              emitter="s"))


def _watermark_direct(nodes, ts):
    (jnode, _), (tnode, _) = nodes
    jnode.on_watermark(JaxWatermark(ts=ts))
    tnode.on_watermark(Watermark(ts=ts))


# ------------------------------------------------- (a) the watermark node
@pytest.mark.parametrize("tol", [0, 1000, 2500])
def test_watermark_node_matches_reference(tol):
    """The port's WatermarkNode against the JAX one on a disordered stream
    with late rows: the kept rows, their order, the watermarks and the
    dropped count are the reference's, batch by batch; a batch without
    timestamps reads as all at 0."""
    ref = JaxWatermarkNode("wm", late_tolerance_ms=tol)
    got = WatermarkNode("wm", late_tolerance_ms=tol)
    jout, tout = [], []
    ref.broadcast = jout.append
    got.broadcast = tout.append
    stream = _stream(10 + tol, 12)
    stream.insert(5, ({"k": np.array(["d1", "d2"], dtype=object),
                       "v": np.array([1.0, 2.0])}, None))
    for cols, ts in stream:
        n = len(cols["v"])
        ref.process(JaxBatch(n=n, columns=dict(cols), timestamps=ts))
        got.process(ColumnBatch(n=n, columns=dict(cols), timestamps=ts))
        assert got.dropped == ref.dropped and got.max_ts == ref.max_ts
        assert got.watermark_ts() == ref.watermark_ts()
    assert got.dropped > 0 and len(tout) == len(jout)
    for t_item, j_item in zip(tout, jout):
        assert type(t_item).__name__ == type(j_item).__name__
        if isinstance(t_item, Watermark):
            assert t_item.ts == j_item.ts
            continue
        assert t_item.n == j_item.n
        if t_item.timestamps is not None:
            np.testing.assert_array_equal(t_item.timestamps,
                                          j_item.timestamps)
            assert (np.diff(t_item.timestamps) >= 0).all()
        for name in j_item.columns:
            np.testing.assert_array_equal(t_item.columns[name],
                                          j_item.columns[name])


def test_watermark_node_state_and_rows():
    """max_ts checkpoints cross both packages; the watermark is None until
    positive; a row tuple raises (the port's path is columnar)."""
    node = WatermarkNode("wm", late_tolerance_ms=5000)
    assert node.watermark_ts() is None
    node.process(ColumnBatch(n=1, columns={"v": np.array([1.0])},
                             timestamps=np.array([4000], np.int64)))
    assert node.watermark_ts() is None and node.max_ts == 4000
    ref = JaxWatermarkNode("wm", late_tolerance_ms=5000)
    ref.restore_state(json.loads(json.dumps(node.snapshot_state())))
    assert ref.max_ts == 4000
    ref.max_ts = 9000
    node.restore_state(ref.snapshot_state())
    assert node.watermark_ts() == 4000
    with pytest.raises(NotImplementedError):
        node.process(Tuple(emitter="s", message={"v": 1.0}, timestamp=1))


# ------------------------------------------------ (b) the fused node
@pytest.mark.parametrize("sql", [TUMBLING, HOPPING],
                         ids=["tumbling", "hopping"])
@pytest.mark.parametrize("seed", [1, 2])
def test_event_node_matches_reference(pairs, sql, seed):
    """plan_fused_rule's event-time node, fed through its watermark entry,
    against the JAX chain, window by window: every window, watermark and
    the EOF in the reference's order, the rows the watermark node and the
    fold dropped, the bucket bookkeeping; batches cross bucket edges (the
    pane vector) and the stream carries late rows."""
    p = pairs(sql)
    assert p.tnode.is_event_time and not p.tnode._prefinalize_ok
    assert p.tnode.n_panes == p.jnode.n_panes
    for cols, ts in _stream(seed, 24):
        p.feed(cols, ts)
        assert p.tnode._next_emit_bucket == p.jnode._next_emit_bucket
        assert p.tnode._dirty == p.jnode._dirty
    assert p.tnode.watermark.dropped == p.jwm.dropped > 0
    assert p.tnode.event_counts["vector_folds"] > 0
    assert p.tnode.event_counts["scalar_folds"] > 0 or sql == HOPPING
    p.eof()
    assert not p.tnode._dirty and not p.jnode._dirty
    assert _kinds(p.tgot) == _kinds(p.jgot)
    _assert_windows(p.tgot, p.jgot)
    assert p.tnode.last_emit_info["source"] == "sync"


def test_event_node_never_arms_boundary_timers(pairs):
    """Opened on the engine clock, an event-time node arms no boundary
    timer (its windows close on watermarks), and a trigger given by hand
    changes nothing."""
    from ekuiper_tpu_torch.runtime.events import Trigger

    p = pairs(SCALAR)
    p.tnode.on_open()
    assert p.tnode._timer is None and p.tnode._pre_timers == []
    for cols, ts in _stream(3, 4):
        p.feed(cols, ts)
    before = list(p.tgot)
    p.tnode.on_trigger(Trigger(ts=10_000))
    timex.get_mock_clock().advance(60_000)
    assert p.tgot == before


# ---------------------------------------------- (c) the node's mechanics
def test_pane_overflow_forces_emission():
    """tests/test_event_fused.py:310: a batch spanning more buckets than
    panes emits its oldest windows early (both packages alike) instead of
    folding into a pane still holding an unemitted window."""
    nodes = _direct_pair(SCALAR)
    n = nodes[1][0].n_panes + 3
    cols = {"k": np.array(["d"] * n, dtype=object),
            "v": np.arange(n, dtype=np.float64)}
    _feed_direct(nodes, cols, np.arange(n, dtype=np.int64) * 10_000 + 500)
    (jnode, jgot), (tnode, tgot) = nodes
    assert len(_windows(tgot)) >= 3 and tnode._next_emit_bucket > 0
    assert tnode._next_emit_bucket == jnode._next_emit_bucket
    assert tnode.event_counts["forced"] >= 3
    _assert_windows(tgot, jgot)


def test_time_gap_skips_empty_windows():
    """tests/test_event_fused.py:338: a gap of 100,000 buckets is jumped
    in O(1): two windows, at most four finalizes."""
    nodes = _direct_pair(SCALAR)
    tnode = nodes[1][0]
    calls = {"n": 0}
    orig = tnode.gb.finalize

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    tnode.gb.finalize = counting
    one = {"k": np.array(["d"], dtype=object), "v": np.array([1.0])}
    _feed_direct(nodes, one, np.array([1_000], np.int64))
    _watermark_direct(nodes, 15_000)
    _feed_direct(nodes, one, np.array([1_000_000_000], np.int64))
    _watermark_direct(nodes, 1_000_020_000)
    for _, got in nodes:
        assert len(_windows(got)) == 2
    assert calls["n"] <= 4, calls
    _assert_windows(nodes[1][1], nodes[0][1])


@pytest.mark.parametrize("sql", [SCALAR, HOPPING], ids=["tumbling",
                                                       "hopping"])
def test_eof_flushes_every_dirty_window(sql):
    """EOF emits every window that still holds data, walking the dirty
    buckets across a gap (never bucket by bucket), as the reference's."""
    nodes = _direct_pair(sql, tol=TOL)
    for cols, ts in _stream(5, 6):
        _feed_direct(nodes, cols, np.sort(ts))
    far = {"k": np.array(["d3"], dtype=object), "v": np.array([5.0])}
    _feed_direct(nodes, far, np.array([500_000], np.int64))
    for node, _ in nodes:
        node.on_eof((JaxEOF if node.__module__.startswith("ekuiper_tpu.")
                     else EOF)())
    (jnode, jgot), (tnode, tgot) = nodes
    assert not tnode._dirty and not jnode._dirty
    assert _kinds(tgot) == _kinds(jgot)
    assert _rows_of(tgot) == _rows_of(jgot) > 0
    _assert_windows(tgot, jgot)


# ------------------------------ (d) session, count and state on event time
def _ed_pair(pairs, sql, tol=TOL):
    return pairs(sql, tol=tol, dims=("deviceId",))


def _collect(items):
    out = {}
    for it in _windows(items):
        for key, c, a in zip(it.columns["deviceId"], it.columns["c"],
                             it.columns["a"]):
            if key != "z":
                out.setdefault(key, []).append((int(c), round(float(a), 4)))
    return {k: sorted(v) for k, v in out.items()}


def test_session_parity(pairs):
    """tests/test_event_fused.py:163: the out-of-order b row lands in the
    first session (a:{10, 20}, b:{6}); the second (a:{30}, b:{8}) opens
    past the 5 s gap; both close when the pusher's watermark passes their
    last row + gap, and EOF flushes the pusher's own session."""
    p = _ed_pair(pairs, SQL_SESS)
    p.feed(*_ed_cols(SESS_ROWS))
    # the batch's own watermark (13 s - 1 s) has passed 4 s + the gap
    assert len(_windows(p.tgot)) == len(_windows(p.jgot)) == 1
    p.feed(*_ed_cols(PUSHER))
    assert len(_windows(p.tgot)) == 2
    assert p.tnode.event_counts["sessions"] == 2
    p.eof()
    assert _collect(p.tgot) == _collect(p.jgot) == {
        "a": sorted([(2, 15.0), (1, 30.0)]), "b": sorted([(1, 6.0),
                                                         (1, 8.0)])}
    assert _kinds(p.tgot) == _kinds(p.jgot)
    _assert_windows(p.tgot, p.jgot)
    ends = [k[1] for k in _kinds(p.tgot) if k[0] == "w"]
    assert ends[:2] == [4_000 + 5_000, 13_000 + 5_000]


def test_incomplete_session_waits_for_watermark(pairs):
    """tests/test_event_fused.py:200: a session whose last row + gap the
    watermark has not passed does not emit; EOF emits the buffered rows
    once, as one window."""
    p = _ed_pair(pairs, SQL_SESS)
    p.feed(*_ed_cols([("a", 10.0, 1_000)]))
    p.feed(*_ed_cols([("z", 0.0, 5_500)]))
    assert _windows(p.tgot) == [] and _windows(p.jgot) == []
    p.eof()
    assert len(_windows(p.tgot)) == len(_windows(p.jgot)) == 1
    _assert_windows(p.tgot, p.jgot)


def test_event_count_window_parity(pairs):
    """tests/test_event_fused.py:433: COUNTWINDOW(4) behind the watermark
    node counts the ordered rows as processing time does; EOF flushes the
    rest."""
    p = _ed_pair(pairs, SQL_COUNT)
    p.feed(*_ed_cols(ED_ROWS + PUSHER))
    p.eof()
    p.drain()
    _assert_windows(p.tgot, p.jgot)
    assert [_rows_of([w]) for w in _windows(p.tgot)] == [4, 2]


def test_event_state_window_parity(pairs):
    """tests/test_event_fused.py:463: STATEWINDOW(temperature > 25,
    temperature < 8) toggles on the watermark-ordered rows: a:{30, 15} with
    b:{5}, then a:{40} with b:{2}."""
    p = _ed_pair(pairs, SQL_STATE)
    p.feed(*_ed_cols(STATE_ROWS))
    assert _collect(p.tgot) == _collect(p.jgot) == {
        "a": [(1, 40.0), (2, 22.5)], "b": [(1, 2.0), (1, 5.0)]}
    _assert_windows(p.tgot, p.jgot)


def test_event_state_open_span_flushes_at_eof():
    """tests/test_event_fused.py:497: an event-time state window still
    open at EOF flushes its span."""
    sql = ("SELECT deviceId, count(*) AS c, avg(v) AS a FROM s "
           "GROUP BY deviceId, STATEWINDOW(st = 1, st = 0)")
    nodes = _direct_pair(sql, dims=("deviceId",))
    cols = {"deviceId": np.array(["a", "a"], dtype=object),
            "v": np.asarray([1.0, 2.0], np.float32),
            "st": np.asarray([1, 5], np.int64)}
    _feed_direct(nodes, cols, np.asarray([1000, 2000], np.int64))
    nodes[0][0].on_eof(JaxEOF())
    nodes[1][0].on_eof(EOF())
    for _, got in nodes:
        w = _windows(got)
        assert len(w) == 1 and int(w[0].columns["c"][0]) == 2
        assert abs(float(w[0].columns["a"][0]) - 1.5) < 1e-6
    _assert_windows(nodes[1][1], nodes[0][1])


# ------------------------------------------------------------- (e) gates
def test_event_hopping_non_divisible_raises_on_node():
    """tests/test_event_fused.py:378: HOPPINGWINDOW(ss, 25, 10) on event
    time would aggregate 20 s of a 25 s window: both nodes raise."""
    sql = ("SELECT k, count(*) AS c FROM s "
           "GROUP BY k, HOPPINGWINDOW(ss, 25, 10)")
    for pkg in ("jax", "port"):
        stmt = (jax_parse if pkg == "jax" else parse_select)(sql)
        plan = (jax_plan_of if pkg == "jax" else extract_kernel_plan)(stmt)
        cls = JaxNode if pkg == "jax" else FusedWindowAggNode
        kw = {} if pkg == "jax" else {"device": "cpu"}
        with pytest.raises(ValueError, match="not a multiple"):
            cls("bad", stmt.window, plan, [d.expr for d in stmt.dimensions],
                capacity=CAP, micro_batch=32, is_event_time=True, **kw)


GATES = {
    "hop-not-dividing": ("HOPPINGWINDOW(ss, 25, 10)", 1000),
    "over-255-panes": ("TUMBLINGWINDOW(ss, 1)", 300_000),
    "sliding": ("SLIDINGWINDOW(ss, 10) OVER (WHEN v > 1)", 1000),
}


@pytest.mark.parametrize("case", list(GATES))
def test_event_time_gates_raise_where_reference_goes_host(case):
    """The shapes the reference's planner keeps off its device path under
    event time (device_path_eligible returns None) raise
    NotImplementedError in plan_fused_rule: its host window path is not
    ported."""
    window, tol = GATES[case]
    sql = f"SELECT k, count(*) AS c FROM s GROUP BY k, {window}"
    assert device_path_eligible(jax_parse(sql), RuleOptionConfig(
        is_event_time=True, late_tolerance_ms=tol)) is None
    with pytest.raises(NotImplementedError):
        plan_fused_rule(sql, key_slots=CAP, micro_batch=MB, device="cpu",
                        options={"isEventTime": True, "lateTolerance": tol})
    if case == "over-255-panes":
        stmt = parse_select(sql)
        with pytest.raises(ValueError, match="max 255"):
            FusedWindowAggNode("n", stmt.window, extract_kernel_plan(stmt),
                               [d.expr for d in stmt.dimensions],
                               capacity=CAP, device="cpu",
                               is_event_time=True, late_tolerance_ms=tol)


@pytest.mark.parametrize("opts,ms", [
    ({"isEventTime": True, "lateTolerance": "1s"}, 1000),
    ({"isEventTime": "true", "lateTolerance": "2m30s"}, 150_000),
    ({"isEventTime": True}, 1000),
    ({"isEventTime": False, "lateTolerance": 500}, None),
])
def test_event_time_options(opts, ms):
    """isEventTime and lateTolerance as the reference reads them (an int
    of ms or a Go-style duration; the default 1000 ms): the node's panes
    follow the tolerance, its watermark node the entry; a processing-time
    rule has none."""
    node = plan_fused_rule(SCALAR, key_slots=CAP, micro_batch=MB,
                           device="cpu", options=opts)
    if ms is None:
        assert node.watermark is None and not node.is_event_time
        return
    assert node.watermark.late_tolerance == ms
    assert node.watermark.outputs == [node]
    assert node.n_panes == max(1 + -(-ms // 10_000) + 2, 4)


@pytest.mark.parametrize("opts", [{"lateTolerance": "soon"},
                                  {"lateTolerance": True},
                                  {"lateTolerance": ""},
                                  {"lateTolerance": -5},
                                  {"isEventTime": "maybe"}])
def test_event_time_option_values_refused(opts):
    with pytest.raises(PlanError):
        plan_fused_rule(SCALAR, key_slots=CAP, micro_batch=MB, device="cpu",
                        options={"isEventTime": True, **opts})


# ------------------------------------- (f) checkpoints across packages
@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
@pytest.mark.parametrize("sql", [TUMBLING, HOPPING, SQL_SESS],
                         ids=["tumbling", "hopping", "session"])
def test_checkpoint_mid_stream_crosses_packages(pairs, sql, direction):
    """A snapshot of the watermark node and the fused node mid-stream
    (open windows, dirty buckets, the emission cursor; a session rule's
    buffered batches), taken by one package and carried through JSON,
    restores into a fresh chain of each package: both then emit what the
    uninterrupted chains emit."""
    dims = ("deviceId",) if sql == SQL_SESS else ("k",)
    stream = _stream(7, 16)
    if sql == SQL_SESS:
        # sessions of four batches, 8 s apart
        stream = [({"deviceId": c["k"], "temperature": c["v"]},
                   ts + 8000 * (i // 4))
                  for i, (c, ts) in enumerate(stream)]
    p = pairs(sql, dims=dims)
    for cols, ts in stream[:8]:
        p.feed(cols, ts)
    src = (p.tnode, p.tnode.watermark) if direction == "port-to-jax" \
        else (p.jnode, p.jwm)
    snap = json.loads(json.dumps([n.snapshot_state() for n in src]))
    assert snap[0]["dirty_buckets"] or snap[0].get("evs")
    n_before, jn_before = len(p.tgot), len(p.jgot)
    fresh = pairs(sql, dims=dims)
    fresh.tnode.restore_state(snap[0])
    fresh.tnode.watermark.restore_state(snap[1])
    fresh.jnode.restore_state(snap[0])
    fresh.jwm.restore_state(snap[1])
    for pair in (p, fresh):
        for cols, ts in stream[8:]:
            pair.feed(cols, ts)
        pair.eof()
    _assert_windows(fresh.tgot, fresh.jgot)
    _assert_windows(fresh.tgot, p.tgot[n_before:])
    _assert_windows(fresh.jgot, p.jgot[jn_before:])


# -------------------------------------------- (g) event-time tiered state
def test_event_time_tiered_parity():
    """tests/test_tierstore.py:425 on both packages: an event-time tumbling
    rule with tiering, two keys demoted after the first window, one of
    them back (the bucket-pane epochs gate the spilled partials), emits
    what the untiered node emits, and what the JAX tiered node emits;
    here the second batch crosses a bucket edge, so the fold takes the
    pane vector together with the touch column."""
    sql = ("SELECT deviceId, sum(v) AS s, count(*) AS c FROM demo "
           "GROUP BY deviceId, TUMBLINGWINDOW(ss, 1)")

    def mk(pkg, tier_mb):
        stmt = (jax_parse if pkg == "jax" else parse_select)(sql)
        plan = (jax_plan_of if pkg == "jax" else extract_kernel_plan)(stmt)
        emit = (jax_direct_emit if pkg == "jax" else build_direct_emit)(
            stmt, plan, ["deviceId"])
        cls = JaxNode if pkg == "jax" else FusedWindowAggNode
        kw = {} if pkg == "jax" else {"device": "cpu"}
        node = cls("evt", stmt.window, plan, [d.expr for d in stmt.dimensions],
                   capacity=64, micro_batch=128, prefinalize_lead_ms=0,
                   direct_emit=emit, emit_columnar=True, is_event_time=True,
                   tier_budget_mb=tier_mb, **kw)
        node.state = node.gb.init_state()
        out = []
        node.broadcast = out.append
        return node, out

    runs = {(pkg, mb): mk(pkg, mb) for pkg in ("jax", "port")
            for mb in (0.001, 0.0)}
    assert all(runs[(pkg, 0.001)][0].tier is not None
               for pkg in ("jax", "port"))

    def feed(ids, vals, tss):
        for (pkg, _), (node, _) in runs.items():
            cb = JaxBatch if pkg == "jax" else ColumnBatch
            node.process(cb(n=len(ids), columns={
                "deviceId": np.array(ids, dtype=object),
                "v": np.asarray(vals, np.float64)},
                timestamps=np.asarray(tss, np.int64), emitter="demo"))

    def watermark(ts):
        for (pkg, _), (node, _) in runs.items():
            node.on_watermark((JaxWatermark if pkg == "jax"
                               else Watermark)(ts=ts))

    feed(["a", "b", "c"], [1., 2., 3.], [100, 150, 200])
    watermark(1100)  # bucket 0 emits
    for pkg in ("jax", "port"):
        tiered = runs[(pkg, 0.001)][0]
        tiered.tier._plan = [0, 1]  # demote a, b (idle after the emit)
        tiered._tier_boundary()
    feed(["a", "d", "b"], [10., 20., 30.], [1300, 1400, 2100])
    assert runs[("port", 0.001)][0].event_counts["vector_folds"] == 1
    watermark(3500)
    for node, _ in runs.values():
        node._drain_async_emits()

    def flat(out):
        rows = {}
        for it in _windows(out):
            end = int(np.asarray(it.timestamps)[0])
            for key, s, c in zip(it.columns["deviceId"], it.columns["s"],
                                 it.columns["c"]):
                rows[(key, end)] = (round(float(s), 4), int(c))
        return rows

    ref = flat(runs[("jax", 0.0)][1])
    assert ref[("a", 2000)] == (10.0, 1) and ref[("b", 3000)] == (30.0, 1)
    for key, (_, out) in runs.items():
        assert flat(out) == ref, key
    assert runs[("port", 0.001)][0].tier.demoted_total == \
        runs[("jax", 0.001)][0].tier.demoted_total == 2


def test_touch_fold_takes_pane_vector():
    """The touch branch of the scalar fold with a per-row pane vector: the
    same touch counts as with scalar panes row by row, each row in its own
    pane (the plain version the card's kernel is held to)."""
    import torch

    rng = np.random.default_rng(3)
    P, C, n = 4, 16, 200
    slots = torch.as_tensor(rng.integers(0, C, n).astype(np.int32))
    pv = torch.as_tensor(rng.integers(0, P, n).astype(np.uint8))
    base = torch.as_tensor(rng.random(n) < 0.8)
    V = torch.as_tensor(rng.normal(0, 1, (1, n)).astype(np.float32))
    M = base[None, :].clone()
    colmap = kernels.column_map({"s1": [0]})

    def state():
        return {"s1": torch.zeros((P, C, 1)), "act": torch.zeros((P, C)),
                "touch": torch.zeros(C, dtype=torch.uint32)}

    a, b = state(), state()
    no_wide = np.zeros((0, 3), dtype=np.int32)
    kernels.groupby_fold(a, base, V, M, slots, 0, colmap, no_wide, pv)
    for p in range(P):
        rows = pv == p
        kernels.groupby_fold(b, base & rows, V, M & rows, slots, p, colmap,
                             no_wide)
    assert torch.equal(a["touch"], b["touch"])
    assert torch.equal(a["act"], b["act"])
    torch.testing.assert_close(a["s1"], b["s1"], rtol=1e-5, atol=1e-6)
    assert int(a["touch"].long().sum()) == int(base.sum())


# ------------------------------------------------------------- (h) groups
GROUP_SQL = ("SELECT k, count(*) AS c, avg(v) AS a, max(v) AS mx FROM s "
             "WHERE v > {x} GROUP BY k, {window}")
WIDE_GROUP = {
    "hll": ("SELECT k, hll(v) AS u, count(*) AS c FROM s WHERE v > {x} "
            "GROUP BY k, HOPPINGWINDOW(ss, 4, 1)"),
    "pct": ("SELECT k, avg(v) AS a, percentile_approx(v, 0.9) AS p FROM s "
            "WHERE v > {x} GROUP BY k, TUMBLINGWINDOW(ss, 4)"),
}
GR = 4  # rules a group


def _group_sqls(template, window="TUMBLINGWINDOW(ss, 4)"):
    return [template.format(x=14.0 + 2.5 * r, window=window)
            for r in range(GR)]


def _miss_cells_vec(tgb, cols, slots, pv):
    from test_torch_groupby import _hll_miss_cells

    cells = set()
    for p in np.unique(pv).tolist():
        rows = np.nonzero(pv == p)[0]
        cells |= _hll_miss_cells(tgb, {k: v[rows] for k, v in cols.items()},
                                 slots[rows], p)
    return cells


@pytest.mark.parametrize("kind", ["scalar", "hll", "pct"])
def test_batched_fold_pane_vector_matches_reference(kind):
    """The group's fold with a per-row uint8 pane vector (multirule_fold
    and multirule_fold_wide's plain versions) against the JAX
    BatchedGroupBy fold with the same vector, over chunks, then finalized
    over a two-pane window and reset: state and every rule's outputs
    within the module's bounds; a constant vector folds as the scalar
    pane does."""
    if kind == "scalar":
        sqls = [GROUP_SQL.format(x=14.0 + 2.5 * r,
                                 window="TUMBLINGWINDOW(ss, 4)")
                for r in range(GR)]
    else:
        sqls = [WIDE_GROUP[kind].format(x=14.0 + 2.5 * r)
                for r in range(GR)]
    spec, jspec = _specs(sqls)
    P = 5
    tgb = BatchedGroupBy(spec, capacity=CAP, n_panes=P, micro_batch=MB,
                         device="cpu")
    jgb = JaxBatched(jspec, capacity=CAP, n_panes=P, micro_batch=MB)
    rng = np.random.default_rng(11)
    ts, js, miss = tgb.init_state(), jgb.init_state(), set()
    for b in range(3):
        n = 150
        cols = {"v": rng.normal(20, 5, n).round(2)}
        slots = rng.integers(0, 40, n).astype(np.int32)
        pv = rng.integers(0, P, n).astype(np.uint8)
        ts = tgb.fold(ts, cols, slots, pane_idx=pv)
        js = jgb.fold(js, cols, slots, pane_idx=pv)
        if kind == "hll":
            miss |= _miss_cells_vec(tgb, cols, slots, pv)
    if kind == "scalar":
        _assert_state(tgb.state_to_host(ts), jgb.state_to_host(js))
    else:
        _assert_wide_state(tgb.state_to_host(ts), jgb.state_to_host(js),
                           miss)
    for panes in (None, [1, 2]):
        got, got_act = tgb.finalize(ts, 40, panes)
        ref, ref_act = jgb.finalize(js, 40, panes)
        np.testing.assert_array_equal(got_act, ref_act)
        (_assert_outs if kind == "scalar" else _assert_wide_outs)(
            tgb.plan.specs, got, ref)
    ts, js = tgb.reset_pane(ts, 3), jgb.reset_pane(js, 3)
    if kind == "scalar":
        _assert_state(tgb.state_to_host(ts), jgb.state_to_host(js))
    # a constant vector is the scalar pane
    cols = {"v": rng.normal(20, 5, 100).round(2)}
    slots = rng.integers(0, 40, 100).astype(np.int32)
    a = tgb.fold(tgb.init_state(), cols, slots,
                 pane_idx=np.full(100, 2, np.uint8))
    b = tgb.fold(tgb.init_state(), cols, slots, pane_idx=2)
    for comp in a:
        np.testing.assert_array_equal(a[comp].numpy(), b[comp].numpy())


def test_group_fold_refuses_pane_outside_state():
    """A pane vector entry at or above P is an error of the batched
    wrappers (before the plain version or the kernel), not a dropped
    row; so is a vector of another type or length."""
    import torch

    spec, _ = _specs(_group_sqls(GROUP_SQL))
    tgb = BatchedGroupBy(spec, capacity=CAP, n_panes=3, micro_batch=MB,
                         device="cpu")
    st = tgb.init_state()
    cols = {"v": torch.ones(4)}
    base, V, M = tgb.rule_inputs(cols, 4)
    slots = torch.zeros(4, dtype=torch.int32)
    for fn, cmap in ((kernels.multirule_fold, tgb._colmap),
                     (kernels.multirule_fold_wide,
                      np.zeros((0, 3), np.int32))):
        with pytest.raises(ValueError, match="outside"):
            fn(st, base, V, M, slots, 0, cmap,
               torch.tensor([0, 1, 3, 2], dtype=torch.uint8))
        with pytest.raises(TypeError):
            fn(st, base, V, M, slots, 0, cmap,
               torch.tensor([0, 1, 2, 2], dtype=torch.int32))
        with pytest.raises(ValueError):
            fn(st, base, V, M, slots, 0, cmap,
               torch.tensor([0, 1, 2], dtype=torch.uint8))
    assert float(st["act"].sum()) == 0.0


class _RuleSink(Node):
    def __init__(self, name):
        super().__init__(name)
        self.got = []

    def process(self, item):
        self.got.append(item)


def _event_group(sqls, tol=TOL):
    """An event-time MultiRuleFusedNode behind a WatermarkNode (the node-
    level entry), each rule to its own sink."""
    spec, _ = _specs(sqls)
    stmt = parse_select(sqls[0])
    node = MultiRuleFusedNode(
        "g", stmt.window, spec, [d.expr for d in stmt.dimensions],
        capacity=CAP, micro_batch=MB,
        direct_emit=build_direct_emit(spec.stmt, spec.plan, ["k"]),
        emit_columnar=True, device="cpu", is_event_time=True,
        late_tolerance_ms=tol)
    wm = WatermarkNode("wm", late_tolerance_ms=tol)
    wm.connect(node)
    sinks = {rid: _RuleSink(rid) for rid in spec.rule_ids}
    for rid, sink in sinks.items():
        node.add_rule_output(rid, sink)
    return wm, node, sinks


@pytest.mark.parametrize("case", ["scalar-tumbling", "scalar-hopping",
                                  "hll", "pct"])
def test_event_group_matches_single_rule_reference(pairs, case):
    """Each rule of an event-time group (one fold launch a batch, the pane
    vector across bucket edges; one stacked finalize a window) emits, to
    its own node, the windows of the JAX single-rule event-time node on
    that rule's SQL, fed the same stream."""
    if case.startswith("scalar"):
        window = ("HOPPINGWINDOW(ss, 4, 1)" if case.endswith("hopping")
                  else "TUMBLINGWINDOW(ss, 4)")
        sqls = _group_sqls(GROUP_SQL, window)
    else:
        sqls = [WIDE_GROUP[case].format(x=14.0 + 2.5 * r)
                for r in range(GR)]
    wm, node, sinks = _event_group(sqls)
    assert not node._async_mr
    refs = [pairs(q) for q in sqls]
    for cols, ts in _stream(21, 20):
        wm.process(ColumnBatch(n=len(ts), columns=dict(cols), timestamps=ts,
                               emitter="s"))
        for ref in refs:
            ref.feed(cols, ts)
    wm.put_control(EOF())
    for ref in refs:
        ref.eof()
    assert node.event_counts["vector_folds"] > 0
    for r, rid in enumerate(node.gb.rule_ids):
        got = sinks[rid].got
        assert isinstance(got[-1], EOF)
        _assert_windows(got, refs[r].jgot)
        # the port's single-rule node agrees too
        _assert_windows(got, refs[r].tgot)
    def groups_out(rid):
        return sum(w.n for w in _windows(sinks[rid].got))

    assert groups_out(node.gb.rule_ids[0]) > \
        groups_out(node.gb.rule_ids[-1]) > 0


def test_event_group_launches_and_checkpoint():
    """The group's folds take the pane vector (counted by the wrappers'
    ROW_PANE_LAUNCHES only on the card; here the node's own counts), its
    watermark-closed windows are one finalize over their panes, and a
    snapshot mid-stream restores into a fresh group that then emits what
    the uninterrupted one emits."""
    sqls = _group_sqls(GROUP_SQL, "HOPPINGWINDOW(ss, 4, 1)")
    stream = _stream(23, 16)
    wm, node, sinks = _event_group(sqls)
    calls = {"n": 0}
    orig = node.gb.finalize

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    node.gb.finalize = counting
    for cols, ts in stream[:8]:
        wm.process(ColumnBatch(n=len(ts), columns=dict(cols), timestamps=ts))
    n_windows = len(_windows(sinks[node.gb.rule_ids[0]].got))
    assert calls["n"] == n_windows > 0
    snap = json.loads(json.dumps([node.snapshot_state(),
                                  wm.snapshot_state()]))
    before = {rid: len(s.got) for rid, s in sinks.items()}
    wm2, node2, sinks2 = _event_group(sqls)
    node2.restore_state(snap[0])
    wm2.restore_state(snap[1])
    for w, cols_ts in ((wm, stream[8:]), (wm2, stream[8:])):
        for cols, ts in cols_ts:
            w.process(ColumnBatch(n=len(ts), columns=dict(cols),
                                  timestamps=ts))
        w.put_control(EOF())
    for rid in node.gb.rule_ids:
        _assert_windows(sinks2[rid].got, sinks[rid].got[before[rid]:])


def test_jax_event_group_emits_rule_indexed_garbage():
    """The reference's fault, shown as it stands (ROADMAP Queue 3): its
    event-time group inherits the single-rule _emit_event_bucket, which
    takes np.nonzero(act > 0) of the (R, n_keys) act as slots, so each
    window goes through `emit` to every output with keys picked by rule
    index and (R, n_keys) aggregate columns. The port sends each rule's
    own window to its own node."""
    sqls = [("SELECT k, avg(t) AS a, count(*) AS c FROM s WHERE t > "
             f"{x} GROUP BY k, TUMBLINGWINDOW(ss, 1)") for x in (0, 5, 100)]
    cols = {"k": np.array(["a", "b", "a", "b"], dtype=object),
            "t": np.array([1.0, 7.0, 9.0, 3.0], np.float32)}
    ts = np.array([100, 200, 1100, 1200], np.int64)
    _, jspec = _specs(sqls)
    stmt = jax_parse(sqls[0])
    jnode = JaxGroupNode(
        "g", stmt.window, jspec, [d.expr for d in stmt.dimensions],
        capacity=16, micro_batch=16,
        direct_emit=jax_direct_emit(jspec.stmt, jspec.plan, ["k"]),
        emit_columnar=True, is_event_time=True, late_tolerance_ms=0)
    jnode.state = jnode.gb.init_state()
    emitted = []
    jnode.broadcast = emitted.append
    jnode.process(JaxBatch(n=4, columns=dict(cols), timestamps=ts))
    jnode.on_watermark(JaxWatermark(ts=2500))
    windows = _windows(emitted)
    assert len(windows) == 2
    for w in windows:
        # three "groups": rule indices 0, 1, 2 read as slots of a, a, b
        assert list(w.columns["k"]) == ["a", "a", "b"]
        assert np.asarray(w.columns["c"]).shape == (3, 2)
    wm, node, sinks = _event_group(sqls, tol=0)
    wm.process(ColumnBatch(n=4, columns=dict(cols), timestamps=ts))
    node.on_watermark(Watermark(ts=2500))
    got = {rid: [(list(w.columns["k"]), list(w.columns["c"]))
                 for w in _windows(s.got)] for rid, s in sinks.items()}
    assert got == {
        "r0": [(["a", "b"], [1, 1]), (["a", "b"], [1, 1])],
        "r1": [(["b"], [1]), (["a"], [1])],
        "r2": []}


def test_plan_rule_group_refuses_event_time():
    """The reference's group planner drops isEventTime (its group would
    run on processing time); the port raises, naming the node-level
    entry."""
    sqls = _group_sqls(GROUP_SQL)
    with pytest.raises(NotImplementedError, match="is_event_time=True"):
        plan_rule_group([f"r{i}" for i in range(GR)], sqls, key_slots=CAP,
                        micro_batch=MB, device="cpu",
                        options={"isEventTime": True})
    node = plan_rule_group([f"r{i}" for i in range(GR)], sqls,
                           key_slots=CAP, micro_batch=MB, device="cpu",
                           options={"isEventTime": False})
    assert not node.is_event_time
