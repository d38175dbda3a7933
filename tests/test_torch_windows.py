"""Parity of the port's count, state and session windows
(ekuiper_tpu_torch/runtime/nodes_fused.py, planner/fused.py, through the
plain PyTorch versions of the kernels on the CPU) against the JAX
package's FusedWindowAggNode, window by window on the mock clock.

Inputs are made from a seed with numpy and given to both packages. A
port node and a JAX node of one rule get the same batches at the same
times (the JAX node's timers queue on its input queue, which `_Pair.at`
hands to its dispatch, as its worker thread would). Tolerances of an
emitted row against the reference's, the existing ones (ROADMAP Queue 3
"Numerical bounds", tests/test_torch_pipeline.py):
- keys, count, min, max and the window's timestamps: exact;
- avg: rtol 1e-5 (float32 scatter-add order differs between XLA and
  torch);
- stddev: rtol 1e-4 plus the cancellation floor of s2/n - mean²;
- percentile_approx: the same bin centre, within 4 ulp;
- hll: within 1 (the port reads rho from the float exponent, the
  reference's jnp.log2 misses it at rare values).
"""
import gc
import queue

import numpy as np
import pytest

from ekuiper_tpu.data.batch import ColumnBatch as JaxBatch
from ekuiper_tpu.ops.aggspec import extract_kernel_plan as jax_plan_of
from ekuiper_tpu.ops.emit import build_direct_emit as jax_direct_emit
from ekuiper_tpu.runtime.events import EOF as JaxEOF
from ekuiper_tpu.runtime.events import Trigger as JaxTrigger
from ekuiper_tpu.runtime.nodes_fused import FusedWindowAggNode as JaxNode
from ekuiper_tpu.sql.parser import parse_select as jax_parse
from ekuiper_tpu.utils import timex as jax_timex
from ekuiper_tpu_torch.data.batch import ColumnBatch
from ekuiper_tpu_torch.ops.aggspec import extract_kernel_plan
from ekuiper_tpu_torch.ops.emit import build_direct_emit
from ekuiper_tpu_torch.planner.fused import plan_fused_rule
from ekuiper_tpu_torch.runtime.events import EOF, Trigger
from ekuiper_tpu_torch.runtime.nodes_fused import FusedWindowAggNode
from ekuiper_tpu_torch.sql.parser import parse_select
from ekuiper_tpu_torch.utils import timex

CAP, MB, KEYS = 64, 64, 30
EPS32 = float(np.finfo(np.float32).eps)
AGGS = ("count(*) AS c, avg(v) AS a, stddev(v) AS sd, max(v) AS mx, "
        "hll(v) AS u, percentile_approx(v, 0.9) AS p")
COUNT = f"SELECT k, {AGGS} FROM s GROUP BY k, COUNTWINDOW(70)"
STATE = f"SELECT k, {AGGS} FROM s GROUP BY k, STATEWINDOW(st = 1, st = 0)"
#: a begin row can match the emit condition too (v > 25 matches both)
STATE_OVERLAP = (f"SELECT k, {AGGS} FROM s GROUP BY k, "
                 "STATEWINDOW(v > 20, v > 25)")
SESSION = f"SELECT k, {AGGS} FROM s GROUP BY k, SESSIONWINDOW(ss, 10, 2)"


@pytest.fixture(scope="module", autouse=True)
def _no_cyclic_gc_inside_jax_locks():
    """As in test_torch_pipeline.py: the JAX package's devwatch registry
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


class _Pair:
    """A JAX node and a port node of one rule, each on its own package's
    mock clock (the test's fixtures set both to 0)."""

    def __init__(self, sql, lead=250):
        stmt = jax_parse(sql)
        plan = jax_plan_of(stmt)
        self.jnode = JaxNode(
            "ref", stmt.window, plan, [d.expr for d in stmt.dimensions],
            capacity=CAP, micro_batch=MB,
            direct_emit=jax_direct_emit(stmt, plan, ["k"]),
            emit_columnar=True, prefinalize_lead_ms=lead)
        stmt = parse_select(sql)
        plan = extract_kernel_plan(stmt)
        self.tnode = FusedWindowAggNode(
            "port", stmt.window, plan, [d.expr for d in stmt.dimensions],
            capacity=CAP, micro_batch=MB,
            direct_emit=build_direct_emit(stmt, plan, ["k"]),
            emit_columnar=True, device="cpu", prefinalize_lead_ms=lead)
        self.jgot, self.tgot = [], []
        self.jnode.broadcast = self.jgot.append
        self.tnode.broadcast = self.tgot.append
        self.jclock = jax_timex.get_mock_clock()
        self.tclock = timex.get_mock_clock()
        self.jnode.on_open()
        self.tnode.on_open()

    def pump(self):
        while True:
            try:
                item = self.jnode.inq.get_nowait()
            except queue.Empty:
                return
            self.jnode._dispatch(item)
            self.jnode.inq.task_done()

    def at(self, t):
        self.jclock.set(t)
        self.pump()
        self.tclock.set(t)

    def feed(self, cols, valid=None):
        n = len(next(iter(cols.values())))
        self.jnode.process(JaxBatch(n=n, columns=dict(cols),
                                    valid=dict(valid or {}), emitter="s"))
        self.tnode.process(ColumnBatch(n=n, columns=dict(cols),
                                       valid=dict(valid or {}), emitter="s"))

    def trigger(self, tag, ts):
        """The same trigger, by hand, to both nodes."""
        self.jnode.on_trigger(JaxTrigger(ts=ts, tag=tag))
        self.tnode.on_trigger(Trigger(ts=ts, tag=tag))

    def eof(self):
        self.jnode.on_eof(JaxEOF())
        self.tnode.on_eof(EOF())

    def drain(self):
        self.jnode._drain_async_emits()
        self.tnode._drain_async_emits()

    def close(self):
        """Stop both nodes' timers and emit workers; move the JAX mock
        clock past its stopped timers, which it would keep (and the node
        with them) as long as it lives."""
        self.tnode.on_close()
        self.jnode.on_close()
        self.jclock.advance(60_000)


@pytest.fixture
def pairs():
    """_Pair factory; every pair made is closed at teardown."""
    made = []

    def make(sql, lead=250):
        made.append(_Pair(sql, lead))
        return made[-1]

    yield make
    for p in made:
        p.close()
    made.clear()


def _batch(rng, n, keys=KEYS, p_st=0.1, st=True):
    cols = {"k": np.array([f"d{i}" for i in rng.integers(0, keys, n)],
                          dtype=object),
            "v": rng.normal(20, 5, n).round(2)}
    if st:
        cols["st"] = (rng.random(n) < p_st).astype(np.int64)
    return cols


def _assert_windows(got, ref):
    """Emitted windows (ColumnBatches, then the EOF) equal within the
    module's tolerances."""
    assert len(got) == len(ref) > 0
    for g_item, r_item in zip(got, ref):
        assert type(g_item).__name__ == type(r_item).__name__
        if not hasattr(r_item, "columns"):
            continue
        assert list(g_item.columns) == list(r_item.columns)
        np.testing.assert_array_equal(g_item.timestamps, r_item.timestamps)
        col = {k: np.asarray(v) for k, v in r_item.columns.items()}
        for name, rv in col.items():
            gv = np.asarray(g_item.columns[name])
            assert gv.shape == rv.shape, name
            if name in ("k", "c", "mx"):
                np.testing.assert_array_equal(gv, rv, err_msg=name)
            elif name == "a":
                np.testing.assert_allclose(gv, rv, rtol=1e-5, err_msg=name)
            elif name == "sd":
                floor = np.sqrt(16 * EPS32) * np.abs(col["a"])
                ok = (np.isnan(gv) & np.isnan(rv)) | (
                    np.abs(gv - rv) <= 1e-4 * np.abs(rv) + floor)
                assert ok.all(), name
            elif name == "p":
                np.testing.assert_allclose(gv, rv, rtol=4 * 2.0 ** -23,
                                           err_msg=name)
            else:
                assert name == "u"
                assert (np.abs(gv - rv) <= 1).all(), name


def _rows_of(items):
    return sum(int(np.asarray(it.columns["c"]).sum()) for it in items
               if hasattr(it, "columns"))


# ------------------------------------------------------------- the planner
PLAN_CASES = {
    "count": (COUNT, None),
    "state": (STATE, None),
    "session": (SESSION, None),
    "count-interval": (COUNT.replace("COUNTWINDOW(70)", "COUNTWINDOW(70, 10)"),
                       NotImplementedError),
    "count-where": (COUNT.replace("FROM s", "FROM s WHERE v > 1"),
                    NotImplementedError),
    "state-where": (STATE.replace("FROM s", "FROM s WHERE v > 1"),
                    NotImplementedError),
    "state-host-only": (STATE.replace("st = 1,", "lower(k) = 'd1',"),
                        NotImplementedError),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_row_windows_as_reference(case):
    """plan_fused_rule plans the count, state and session windows the
    reference's device gate admits; the shapes it sends to its host path
    raise NotImplementedError (that path is not ported)."""
    sql, exc = PLAN_CASES[case]
    if exc is not None:
        with pytest.raises(exc):
            plan_fused_rule(sql, key_slots=CAP, micro_batch=MB, device="cpu")
        return
    node = plan_fused_rule(sql, key_slots=CAP, micro_batch=MB, device="cpu")
    assert node.n_panes == 1 and node.wt.name == case.upper() + "_WINDOW"


@pytest.mark.parametrize("sql", [COUNT, STATE, SESSION],
                         ids=["count", "state", "session"])
def test_row_windows_stay_untiered(sql):
    """Tiered key state takes tumbling, hopping and sliding rules only (the
    reference's gate, nodes_fused.py:285-288): a forced tier on a count,
    state or session rule leaves it untiered, at its full capacity."""
    node = plan_fused_rule(sql, key_slots=2048, micro_batch=MB, device="cpu",
                           options={"tierStore": "on", "tierHotMb": 1,
                                    "tierScanMs": 1})
    assert node.tier is None and node.gb.capacity == 2048


# ------------------------------------------------------------ count windows
@pytest.mark.parametrize("lead", [250, 0], ids=["async", "sync"])
def test_count_window_matches_reference(pairs, lead):
    """COUNTWINDOW(70) fed 50-row batches: every edge but one falls inside
    a batch. Under the default boundary both nodes deliver on the emit
    worker, with lead 0 synchronously; EOF flushes the open window."""
    p = pairs(COUNT, lead)
    assert p.tnode._async_count == p.jnode._async_count == (lead > 0)
    rng = np.random.default_rng(1)
    for b in range(9):
        p.at(100 * (b + 1))
        p.feed(_batch(rng, 50, st=False))
    p.drain()
    assert p.tnode.last_emit_info["source"] == (
        "device-async" if lead else "sync")
    assert p.tnode._rows_in_window == p.jnode._rows_in_window == 450 % 70
    p.eof()
    p.drain()
    _assert_windows(p.tgot, p.jgot)
    assert len(p.tgot) == 450 // 70 + 2  # the EOF flush, then the EOF
    assert [_rows_of([w]) for w in p.tgot[:-2]] == [70] * (450 // 70)


# ------------------------------------------------------------ state windows
def _state_stream(case, rng):
    """The batches of one state-window case."""
    if case == "one-batch":
        # opens and closes (more than once) inside each batch
        return [_batch(rng, 60, p_st=0.2) for _ in range(3)]
    if case == "spans":
        out = []
        for b in range(5):
            cols = _batch(rng, 40)
            cols["st"][:] = 7  # neither condition
            if b == 0:
                cols["st"][30] = 1  # opens in the first batch
            if b == 3:
                cols["st"][10] = 0  # closes in the fourth
            out.append(cols)
        return out
    if case == "missing-column":
        # a batch without `st` evaluates both conditions all-false: an
        # open window folds it whole, a closed one skips it
        out = []
        for b in range(6):
            cols = _batch(rng, 40, p_st=0.1)
            if b in (1, 2, 4):
                del cols["st"]
            out.append(cols)
        out[0]["st"][-1] = 1
        return out
    return [_batch(rng, 50) for _ in range(4)]  # begin-is-emit


@pytest.mark.parametrize("case", ["one-batch", "spans", "missing-column",
                                  "begin-is-emit"])
def test_state_window_matches_reference(pairs, case):
    """STATEWINDOW windows, each emitted at its emit row (inclusive), the
    opening row never closing its own window."""
    p = pairs(STATE_OVERLAP if case == "begin-is-emit" else STATE)
    rng = np.random.default_rng(2)
    for b, cols in enumerate(_state_stream(case, rng)):
        p.at(100 * (b + 1))
        p.feed(cols)
        assert p.tnode._state_open == p.jnode._state_open
    p.eof()
    _assert_windows(p.tgot, p.jgot)
    if case == "spans":
        # one window (rows 30.. of the first batch to row 10 of the
        # fourth), then the EOF: the EOF flush of the reset pane is empty
        assert len(p.tgot) == 2 and _rows_of(p.tgot) == 10 + 2 * 40 + 11
    assert p.tnode.last_emit_info["source"] == "sync"


def test_state_window_begin_row_does_not_close(pairs):
    """A row matching both conditions opens the window and stays in it;
    the next emit row closes it, inclusive."""
    p = pairs(STATE_OVERLAP)
    cols = {"k": np.array(["a"] * 5, dtype=object),
            "v": np.array([10.0, 30.0, 22.0, 26.0, 30.0])}
    p.feed(cols)
    assert len(p.tgot) == len(p.jgot) == 1
    assert _rows_of(p.tgot) == 3  # rows 1-3: opened by 30, closed by 26
    assert p.tnode._state_open and p.jnode._state_open  # 30 reopens
    _assert_windows(p.tgot, p.jgot)


# ---------------------------------------------------------- session windows
def test_session_gap_and_cap_match_reference(pairs):
    """SESSIONWINDOW(ss, 10, 2): a burst closed by a 2 s gap (the gap check
    re-arms while rows keep coming), then a burst of rows every second
    that runs into the 10 s length cap, its tail closed by a gap, and a
    last session closed at EOF."""
    p = pairs(SESSION)
    rng = np.random.default_rng(3)
    times = [100, 600, 1200, 1900] + [5000 + 1000 * i for i in range(13)]
    for t in times:
        p.at(t)
        p.feed(_batch(rng, 30, st=False))
    p.at(19_000)
    p.feed(_batch(rng, 30, st=False))
    p.eof()
    _assert_windows(p.tgot, p.jgot)
    ends = [int(w.timestamps[0]) for w in p.tgot[:-1]]
    # the gap (last row 1.9 s + 2 s), the cap (5 s + 10 s), the gap of the
    # session the cap left (17 s + 2 s), the EOF's close, then the EOF
    assert ends == [3900, 15_000, 19_000, 19_000]
    assert [_rows_of([w]) for w in p.tgot[:-1]] == [120, 300, 90, 30]


def test_session_stale_triggers_do_nothing(pairs):
    """A trigger of a closed session, and a gap check superseded by a newer
    one, change nothing in either package."""
    p = pairs(SESSION)
    rng = np.random.default_rng(4)
    p.at(100)
    p.feed(_batch(rng, 20, st=False))
    sid, gen = p.tnode._session_id, p.tnode._gap_gen
    assert (sid, gen) == (p.jnode._session_id, p.jnode._gap_gen)
    p.tnode._arm_gap_check(p.tnode.gap_ms)
    p.jnode._arm_gap_check(p.jnode.gap_ms)
    p.trigger(("session_gap", sid, gen), 2100)  # superseded
    assert p.tgot == p.jgot == []
    p.at(4000)
    assert len(p.tgot) == len(p.jgot) == 1  # closed by the newer check
    p.trigger(("session_cap", sid), 10_100)  # the closed session's cap
    p.trigger(("session_gap", sid, p.tnode._gap_gen), 10_100)
    assert len(p.tgot) == len(p.jgot) == 1
    _assert_windows(p.tgot, p.jgot)


def test_session_restore_mid_session(pairs):
    """A port snapshot taken inside a session restores into a fresh port
    node and a fresh JAX node: each re-opens the session with fresh timers
    (the gap restarts at the restore) and closes it with the rows of both
    sides."""
    p = pairs(SESSION)
    rng = np.random.default_rng(5)
    for t in (100, 700):
        p.at(t)
        p.feed(_batch(rng, 25, st=False))
    snap = p.tnode.snapshot_state()
    assert snap["session_open"] and snap["session_start"] == 100
    fresh = pairs(SESSION)
    fresh.at(1000)
    fresh.tnode.restore_state(snap)
    fresh.jnode.restore_state(snap)
    for t in (1500, 2000):
        fresh.at(t)
        fresh.feed(_batch(rng, 25, st=False))
    fresh.at(5000)
    assert len(fresh.tgot) == len(fresh.jgot) == 1
    _assert_windows(fresh.tgot, fresh.jgot)
    assert _rows_of(fresh.tgot) == 4 * 25
    assert fresh.tgot[0].timestamps[0] == 4000  # last row + gap


# ------------------------------------------------ checkpoints across packages
@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
@pytest.mark.parametrize("sql", [COUNT, STATE], ids=["count", "state"])
def test_checkpoint_mid_window_crosses_packages(pairs, sql, direction):
    """A snapshot in the middle of a count or state window, taken by one
    package, restores into a fresh node of each package (rows_in_window,
    the open state window and the sketch partials with it): both then
    emit what the uninterrupted nodes emit."""
    p = pairs(sql, lead=0)
    rng = np.random.default_rng(6)
    first = [_batch(rng, 50, p_st=0.08) for _ in range(3)]
    rest = [_batch(rng, 50, p_st=0.08) for _ in range(4)]
    for cols in first:
        p.feed(cols)
    while sql == STATE and not p.tnode._state_open:
        first.append(_batch(rng, 50, p_st=0.08))
        p.feed(first[-1])
    assert sql == STATE or p.tnode._rows_in_window > 0
    snap = (p.tnode if direction == "port-to-jax" else p.jnode
            ).snapshot_state()
    n_before = len(p.tgot)
    fresh = pairs(sql, lead=0)
    fresh.tnode.restore_state(snap)
    fresh.jnode.restore_state(snap)
    for pair in (p, fresh):
        for cols in rest:
            pair.feed(cols)
        pair.eof()
    _assert_windows(fresh.tgot, fresh.jgot)
    _assert_windows(fresh.tgot, p.tgot[n_before:])
    _assert_windows(fresh.jgot, p.jgot[n_before:])
