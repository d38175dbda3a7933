"""The port's SLIDINGWINDOW rules on the DABA ring (ekuiper_tpu_torch
runtime/nodes_fused.py, ops/slidingring.py) against the JAX package's
DABA node on the CPU, trigger by trigger, over the scenarios of
tests/test_sliding_ring.py: tumbling-degenerate and hopping-shaped
trigger cadences, invertible, min/max and sketch aggregates, delayed
windows on the mock clock, eviction past the pane ring, a re-anchor of
the running totals, a time gap, late rows, a batch spanning more buckets than the ring has
panes, and checkpoints taken in each package and restored in the other.

Batches are made from a seed with numpy and given to both nodes.
Tolerances of each emitted row against the JAX node's: keys, counts,
min and max exact; sums, averages and stddevs within rtol 1e-4 and atol
1e-4 (the running totals add and subtract in float32 in both packages,
but the fold's scatter-add and the flip's reduce run in other orders);
distinct counts within ±1; percentiles in the same bin (rtol 4 ulp).
"""
import gc
import json
import queue

import numpy as np
import pytest

from ekuiper_tpu.data.batch import ColumnBatch as JaxBatch
from ekuiper_tpu.ops.aggspec import extract_kernel_plan as jax_plan_of
from ekuiper_tpu.ops.emit import build_direct_emit as jax_direct_emit
from ekuiper_tpu.runtime.nodes_fused import FusedWindowAggNode as JaxNode
from ekuiper_tpu.sql.parser import parse_select as jax_parse
from ekuiper_tpu.utils import timex as jax_timex
from ekuiper_tpu_torch.data.batch import ColumnBatch
from ekuiper_tpu_torch.ops.aggspec import extract_kernel_plan
from ekuiper_tpu_torch.ops.emit import build_direct_emit
from ekuiper_tpu_torch.planner.fused import plan_fused_rule
from ekuiper_tpu_torch.runtime.nodes_fused import FusedWindowAggNode
from ekuiper_tpu_torch.sql.parser import parse_select
from ekuiper_tpu_torch.utils import timex

from test_sliding_ring import random_trigger_batches, trigger_batches

SQL_INV = ("SELECT deviceId, count(*) AS c, sum(temp) AS s, "
           "avg(temp) AS a, stddev(temp) AS sd FROM s GROUP BY deviceId, "
           "SLIDINGWINDOW(ss, 2) OVER (WHEN temp > 90)")
SQL_MM = ("SELECT deviceId, min(temp) AS mn, max(temp) AS mx, "
          "count(*) AS c FROM s GROUP BY deviceId, "
          "SLIDINGWINDOW(ss, 2) OVER (WHEN temp > 90)")
SQL_SKETCH = ("SELECT deviceId, percentile_approx(temp, 0.9) AS p90, "
              "distinct_count_approx(temp) AS dc FROM s GROUP BY deviceId, "
              "SLIDINGWINDOW(ss, 2) OVER (WHEN temp > 90)")
SQL_DELAY = ("SELECT deviceId, count(*) AS c, max(temp) AS mx, "
             "avg(temp) AS a FROM s GROUP BY deviceId, "
             "SLIDINGWINDOW(ss, 2, 1) OVER (WHEN temp > 90)")
EXACT = {"c", "mn", "mx"}
CAP, MB = 64, 128


@pytest.fixture(scope="module", autouse=True)
def _no_cyclic_gc_inside_jax_locks():
    """As in test_torch_pipeline.py: the JAX package's devwatch registry
    deadlocks when a cyclic collection lands inside its weakref prune, so
    this module, which builds many JAX nodes, runs with the cyclic
    collector off and collects at its end."""
    enabled = gc.isenabled()
    gc.disable()
    yield
    if enabled:
        gc.enable()
    gc.collect()


class Pair:
    """The JAX DABA node and the port's node of one rule; the port's
    deliveries are recorded with the route that served each."""

    def __init__(self, sql, **kw):
        stmt = jax_parse(sql)
        plan = jax_plan_of(stmt)
        self.j = JaxNode("ref", stmt.window, plan,
                         [d.expr for d in stmt.dimensions], capacity=CAP,
                         micro_batch=MB,
                         direct_emit=jax_direct_emit(stmt, plan,
                                                     ["deviceId"]),
                         emit_columnar=True, sliding_impl="daba", **kw)
        self.j.state = self.j.gb.init_state()
        stmt = parse_select(sql)
        plan = extract_kernel_plan(stmt)
        self.t = FusedWindowAggNode(
            "port", stmt.window, plan, [d.expr for d in stmt.dimensions],
            capacity=CAP, micro_batch=MB,
            direct_emit=build_direct_emit(stmt, plan, ["deviceId"]),
            emit_columnar=True, device="cpu", **kw)
        assert self.j.sliding_impl == self.t.sliding_impl == "daba"
        self.jgot, self.tgot, self.sources = [], [], []
        self.j.broadcast = self.jgot.append

        def got(item):
            self.tgot.append(item)
            self.sources.append(self.t.last_emit_info["source"])

        self.t.broadcast = got

    def feed(self, batch):
        """One batch of the JAX package's (the reference tests' helpers
        make them) into both nodes."""
        self.j.process(batch)
        self.t.process(_port(batch))

    def pump(self):
        """Hand the JAX node's queued control events (its timers only
        enqueue) to its dispatch, as its worker thread would."""
        while True:
            try:
                item = self.j.inq.get_nowait()
            except queue.Empty:
                return
            self.j._dispatch(item)
            self.j.inq.task_done()

    def drain(self):
        self.j._drain_async_emits()
        self.t._drain_async_emits()

    def check(self, min_triggers=1):
        self.drain()
        assert len(self.tgot) == len(self.jgot) >= min_triggers
        assert set(self.sources) == {"device-ring"}
        routes = sum(self.t.ring_counts[k]
                     for k in ("fast", "dyn", "head", "edge"))
        assert routes == len(self.tgot)  # every trigger took a named route
        # the same host bookkeeping of the ring and the panes
        for attr in ("_rg_head", "_rg_closed", "_rg_dirty", "_rg_flip_lo",
                     "_rg_flip_hi", "_rg_closes", "_rg_anchor",
                     "_pane_bucket", "_ring_max_bucket", "_bucket_max_ts"):
            assert getattr(self.t, attr) == getattr(self.j, attr), attr
        assert list(self.t._rg_tot) == list(self.j._rg_tot)
        for g, r in zip(self.tgot, self.jgot):
            assert_window(g, r)


def _by_key(item):
    names = list(item.columns)
    rows = [dict(zip(names, vals))
            for vals in zip(*(item.columns[k].tolist() for k in names))]
    return {r["deviceId"]: r for r in rows}


def assert_window(got, ref):
    g_rows, r_rows = _by_key(got), _by_key(ref)
    assert g_rows.keys() == r_rows.keys()
    for key, r in r_rows.items():
        g = g_rows[key]
        assert g.keys() == r.keys()
        for f, rv in r.items():
            gv = g[f]
            if rv is None or isinstance(rv, str) or f in EXACT:
                assert gv == rv, (key, f, gv, rv)
            elif f == "dc":
                assert abs(gv - rv) <= 1, (key, f, gv, rv)
            elif f == "p90":
                assert gv == pytest.approx(rv, rel=4 * 2.0 ** -23), (key, f)
            else:
                np.testing.assert_allclose(gv, rv, rtol=1e-4, atol=1e-4,
                                           err_msg=f"{key}.{f}")


# ------------------------------------------------------------------ data
def _port(b):
    """The port's ColumnBatch of a JAX package one (the same arrays)."""
    return ColumnBatch(n=b.n, columns=dict(b.columns), valid=dict(b.valid),
                       timestamps=b.timestamps, emitter=b.emitter)


def _batch(ids, temp, ts):
    return JaxBatch(n=len(ts), columns={"deviceId": ids, "temp": temp},
                    timestamps=np.asarray(ts, dtype=np.int64), emitter="s")


def run(sql, batches, **kw):
    pair = Pair(sql, **kw)
    for b in batches:
        pair.feed(b)
    return pair


# ------------------------------------------------------------- scenarios
@pytest.mark.parametrize("shape", ["tumbling", "hopping"])
def test_trigger_cadences(shape):
    """Tumbling-degenerate (one trigger per window length: windows tile)
    and hopping-shaped (a trigger every 500 ms on a 2 s window)."""
    trig = ([12_000, 14_000, 16_000, 18_000] if shape == "tumbling"
            else list(range(12_000, 18_001, 500)))
    pair = run(SQL_INV, trigger_batches(trig, n_batches=85))
    pair.check(min_triggers=len(trig))


@pytest.mark.parametrize("sql", [SQL_INV, SQL_MM], ids=["invertible",
                                                        "min_max"])
def test_head_bucket_triggers_take_the_constant_time_route(sql):
    """A trigger in the newest bucket (the last row of its batch) is
    served by the ring query on the running partials: after the first
    trigger's flip, no other flip and no pane merge while batches span
    less than a bucket (25 ms here; a batch spanning several buckets
    recycles a pane before the total evicts it, which the reference
    heals with a flip)."""
    batches = random_trigger_batches(seed=2, n_batches=160, rows=16,
                                     step=20, spike_every=10**9)
    for i in range(40, 160, 20):
        batches[i].columns["temp"][-1] = 99.0
    pair = run(sql, batches)
    pair.check(min_triggers=6)
    counts = pair.t.ring_counts
    assert counts["fast"] == 6 and counts["dyn"] == 0, counts
    # the two-stack components flip again once the window start passes
    # the front stack's span (the amortized DABA flip)
    assert counts["flip"] == (1 if sql == SQL_INV else 2), counts
    assert counts["advance"] > 0, counts


@pytest.mark.parametrize("sql,seed", [(SQL_INV, 7), (SQL_MM, 11),
                                      (SQL_SKETCH, 13)],
                         ids=["invertible", "min_max", "sketches"])
def test_true_sliding(sql, seed):
    pair = run(sql, random_trigger_batches(seed=seed, n_batches=30))
    pair.check(min_triggers=20)
    if sql == SQL_MM:
        assert pair.t.ring.mm_comps == ["mn", "mx"]
    counts = pair.t.ring_counts
    assert counts["fast"] > 0 and counts["advance"] > 0


def test_delay_windows_on_the_mock_clock():
    """SLIDINGWINDOW(ss, 2, 1): each trigger row arms a timer 1 s ahead on
    the engine clock; both nodes fire it there (the JAX node's timers
    enqueue, the test pumps them) and emit (t - 2 s, t + 1 s]."""
    jclock = jax_timex.set_mock_clock(0)
    tclock = timex.set_mock_clock(0)
    try:
        pair = Pair(SQL_DELAY)
        for b in random_trigger_batches(seed=5, n_batches=20):
            t = int(b.timestamps[-1])
            jclock.set(t)
            pair.pump()
            tclock.set(t)
            pair.feed(b)
        assert pair.t._pending_slides
        jclock.advance(5_000)
        pair.pump()
        tclock.advance(5_000)
        assert not pair.t._pending_slides and not pair.j._pending_slides
        pair.check(min_triggers=20)
        assert pair.t.ring_counts["dyn"] > 0  # the delay's exact route
    finally:
        jax_timex.use_real_clock()
        timex.use_real_clock()


def test_processing_time_batches_take_the_clock():
    """Batches without timestamps fold at the engine clock's now."""
    jclock = jax_timex.set_mock_clock(50_000)
    tclock = timex.set_mock_clock(50_000)
    try:
        rng = np.random.default_rng(23)
        pair = Pair(SQL_INV)
        for i in range(40):
            ids = np.array([f"d{j}" for j in rng.integers(0, 4, 32)],
                           dtype=np.object_)
            temp = rng.uniform(0, 88, 32).astype(np.float32)
            if i % 7 == 6:
                temp[-1] = 97.0
            b = JaxBatch(n=32, columns={"deviceId": ids, "temp": temp},
                         emitter="s")
            pair.feed(b)
            jclock.advance(100)
            tclock.advance(100)
        pair.check(min_triggers=5)
    finally:
        jax_timex.use_real_clock()
        timex.use_real_clock()


def test_eviction_past_the_ring():
    """A stream of 360 buckets on an 83-pane ring: panes recycle, the
    running totals evict in lockstep, and a batch that crosses two bucket
    edges (a pane recycled before the total evicts it) dirties the ring,
    which the next trigger's flip heals."""
    batches = random_trigger_batches(seed=31, n_batches=90, rows=24,
                                     spike_every=29)
    pair = run(SQL_INV, batches)
    assert 90 * 100 // pair.t.bucket_ms > pair.t.n_ring_panes
    pair.check(min_triggers=50)
    assert pair.t.ring_counts["flip"] >= 2 and pair.t._rg_anchor > 0
    assert pair.t._rg_anchor == pair.j._rg_anchor


def test_re_anchor_rebuilds_the_running_totals():
    """Subtract-on-evict drift: after 4 x span_tot closes without a flip,
    the next trigger rebuilds the totals from the panes (a 1 s window:
    41 buckets of 25 ms, a re-anchor after 164 closes). Batches of 20 ms
    with evenly spaced rows, each trigger the last row of its batch."""
    sql = SQL_INV.replace("SLIDINGWINDOW(ss, 2)", "SLIDINGWINDOW(ss, 1)")
    rng = np.random.default_rng(43)
    batches = []
    for i in range(260):
        ids = np.array([f"d{k}" for k in rng.integers(0, 5, 10)],
                       dtype=np.object_)
        temp = rng.uniform(0, 88, 10).astype(np.float32)
        if i >= 10 and i % 10 == 0:
            temp[-1] = 99.0
        batches.append(_batch(ids, temp, 10_000 + 20 * i
                              + 2 * np.arange(10)))
    pair = run(sql, batches)
    pair.check(min_triggers=25)
    counts = pair.t.ring_counts
    assert counts["reanchor"] >= 1 and counts["dyn"] == 0, counts
    assert counts["flip"] == 1 + counts["reanchor"], counts


def test_gap_rebuilds_the_ring():
    b1 = trigger_batches([10_250], n_batches=3, t0=10_000)
    b2 = trigger_batches([28_250], n_batches=3, t0=28_000, seed=9)
    pair = run(SQL_INV, b1 + b2)
    pair.check(min_triggers=2)
    assert len(pair.tgot) == 2 and pair.t._rg_dirty  # rebuilt at need


def test_late_rows_mark_the_ring_dirty():
    def b(ts_list, temps):
        k = len(ts_list)
        return _batch(np.array(["d0"] * k, dtype=np.object_),
                      np.asarray(temps, dtype=np.float32), ts_list)

    pair = run(SQL_INV, [b([10_000, 10_100, 10_200], [50.0] * 3),
                         b([10_150], [50.0]),  # into a closed bucket
                         b([10_400], [95.0])])  # the trigger
    pair.check()
    assert _by_key(pair.tgot[0])["d0"]["c"] == 5


def test_batch_spanning_more_buckets_than_the_ring():
    """A replay burst: one batch spanning 3 s of a 2 s window's 83 x 25 ms
    ring folds as alias-free chunks in bucket order."""
    rng = np.random.default_rng(41)
    n = 600
    ts = np.sort(rng.integers(10_000, 13_000, n)).astype(np.int64)
    temp = rng.uniform(0, 88, n).astype(np.float32)
    temp[[150, 420, 599]] = 99.0
    ids = np.array([f"d{i}" for i in rng.integers(0, 5, n)],
                   dtype=np.object_)
    pair = run(SQL_MM, [_batch(ids, temp, ts)] + random_trigger_batches(
        seed=42, n_batches=8, t0=13_000))
    assert 3_000 // pair.t.bucket_ms >= pair.t.n_ring_panes
    pair.check(min_triggers=3)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_crosses_packages(direction):
    """A checkpoint (JSON round trip) taken in one package restores in the
    other; the windows after it match an uninterrupted JAX node's."""
    batches = random_trigger_batches(seed=17, n_batches=16)
    ref = run(SQL_MM, batches)
    ref.drain()
    first = run(SQL_MM, batches[:8])
    first.drain()
    src = first.j if direction == "jax_to_port" else first.t
    snap = json.loads(json.dumps(src.snapshot_state()))
    second = Pair(SQL_MM)
    dst = second.t if direction == "jax_to_port" else second.j
    dst.restore_state(snap)
    node = dst
    got = second.tgot if node is second.t else second.jgot
    for b in batches[8:]:
        node.process(_port(b) if node is second.t else b)
    node._drain_async_emits()
    want = ref.jgot[len(first.jgot):]
    assert len(got) == len(want) >= 1
    for g, r in zip(got, want):
        assert_window(g, r)


# ------------------------------------------------------------- refusals
def _node(sql, **kw):
    stmt = parse_select(sql)
    plan = extract_kernel_plan(stmt)
    return FusedWindowAggNode(
        "port", stmt.window, plan, [d.expr for d in stmt.dimensions],
        capacity=2048, micro_batch=MB,
        direct_emit=build_direct_emit(stmt, plan, ["deviceId"]),
        emit_columnar=True, device="cpu", **kw)


WIDE = ("SELECT deviceId, distinct_count_approx(temp) AS dc, "
        "percentile_approx(temp, 0.9) AS p, count(*) AS c FROM s "
        "GROUP BY deviceId, SLIDINGWINDOW(ss, 30) OVER (WHEN temp > 90)")


@pytest.mark.parametrize("case", ["refold", "heavy_hitters", "budget"])
def test_refold_cases_raise(case):
    """Where the reference quietly takes its refold path, the port
    raises: the refold path is not ported."""
    if case == "refold":
        sql, kw, opts = SQL_INV, {"sliding_impl": "refold"}, \
            {"slidingImpl": "refold"}
    elif case == "heavy_hitters":
        sql = ("SELECT deviceId, heavy_hitters(code, 3) AS top FROM s "
               "GROUP BY deviceId, SLIDINGWINDOW(ss, 2) OVER (WHEN code > 9)")
        kw, opts = {}, {}
    else:
        sql, kw, opts = WIDE, {"dev_ring_budget_mb": 0}, \
            {"slidingDevRingMb": 0}
    with pytest.raises(NotImplementedError):
        _node(sql, **kw)
    with pytest.raises(NotImplementedError):
        plan_fused_rule(sql, key_slots=2048, micro_batch=MB, device="cpu",
                        options=opts)


@pytest.mark.parametrize("sql", [
    "SELECT deviceId, count(*) AS c FROM s GROUP BY deviceId, "
    "SLIDINGWINDOW(ss, 2)",
    "SELECT deviceId, count(*) AS c FROM s GROUP BY deviceId, "
    "SLIDINGWINDOW(ss, 2) OVER (WHEN temp LIKE 'a%')"],
    ids=["no_condition", "host_condition"])
def test_host_path_sliding_rules_raise(sql):
    with pytest.raises(NotImplementedError, match="host path"):
        plan_fused_rule(sql, key_slots=64, micro_batch=MB, device="cpu")


def test_plan_fused_rule_takes_the_sliding_options():
    node = plan_fused_rule(WIDE, key_slots=2048, micro_batch=MB,
                           device="cpu", options={"slidingDevRingMb": 64,
                                                  "slidingImpl": "daba"})
    assert node.sliding_impl == "daba"
    assert node.ring.estimate_bytes(2048) <= 64 << 20
    default = plan_fused_rule(WIDE, key_slots=2048, micro_batch=MB,
                              device="cpu")
    assert node.n_ring_panes < default.n_ring_panes  # coarsened to fit
    with pytest.raises(Exception, match="slidingImpl"):
        plan_fused_rule(WIDE, device="cpu", options={"slidingImpl": "x"})
    with pytest.raises(Exception, match="slidingDevRingMb"):
        plan_fused_rule(WIDE, device="cpu",
                        options={"slidingDevRingMb": -1})
