"""Tiered SLIDING rules on the port (ekuiper_tpu_torch ops/tierstore.py's
quiescent-only mode, the fused node's tier hooks on the DABA ring and the
refold path, and the masked fold's touch column) against the JAX package
on the CPU.

The stream is a churning fleet: a few steady keys, and a cohort of new
keys every second that reports for one second and goes silent for good,
made from a numpy seed and given to both packages' nodes. Both nodes take
the same tier budget; the reference's hot-slot floor (1,024) is far above
a test-sized key set, so both tiers are then given the same smaller hot
target, and the placement policy demotes for real. The scan cadence reads
the engine clock, so both mock clocks move to each batch's last row.

Tolerances, each against the JAX node: keys, counts, min and max exact,
sums rtol 1e-5 (float32 adds in another order); placement plans, tier
counters, requeues, capacities, the touch column and the DABA-or-refold
choice equal; checkpoints in the reference's format, requeued rows
included, restored across the packages both ways.
"""
import gc
import json

import numpy as np
import pytest

from ekuiper_tpu.data.batch import ColumnBatch as JaxBatch
from ekuiper_tpu.ops import tierstore as jts
from ekuiper_tpu.ops.aggspec import extract_kernel_plan as jax_plan_of
from ekuiper_tpu.ops.emit import build_direct_emit as jax_direct_emit
from ekuiper_tpu.ops.groupby import DeviceGroupBy
from ekuiper_tpu.ops.keytable import KeyTable as JaxKeyTable
from ekuiper_tpu.runtime.nodes_fused import FusedWindowAggNode as JaxNode
from ekuiper_tpu.sql.parser import parse_select as jax_parse
from ekuiper_tpu.utils import timex as jax_timex
from ekuiper_tpu_torch.data.batch import ColumnBatch
from ekuiper_tpu_torch.ops import tierstore as tts
from ekuiper_tpu_torch.ops.aggspec import extract_kernel_plan
from ekuiper_tpu_torch.ops.emit import build_direct_emit
from ekuiper_tpu_torch.ops.groupby import TorchGroupBy
from ekuiper_tpu_torch.ops.keytable import KeyTable
from ekuiper_tpu_torch.runtime.nodes_fused import FusedWindowAggNode
from ekuiper_tpu_torch.sql.parser import parse_select
from ekuiper_tpu_torch.utils import timex

SQL = ("SELECT deviceId, count(*) AS c, sum(temp) AS s, min(temp) AS mn, "
       "max(temp) AS mx FROM s GROUP BY deviceId, SLIDINGWINDOW(ss, 2) "
       "OVER (WHEN temp > 90)")
#: the reference's test_kill_restore_daba_tiered_cross_impl rule
XSQL = ("SELECT deviceId, count(*) AS c, sum(temp) AS s FROM s "
        "GROUP BY deviceId, SLIDINGWINDOW(ss, 2) OVER (WHEN temp > 90)")
HLL_SQL = ("SELECT deviceId, distinct_count_approx(temp) AS dc, count(*) AS c "
           "FROM s GROUP BY deviceId, SLIDINGWINDOW(ss, 2) "
           "OVER (WHEN temp > 90)")
CAP, MB = 64, 128
TIER_MB, SCAN_MS = 0.001, 250
#: the hot target both tiers are given (the layout's floor is 1,024)
HOT = 24
EXACT = {"deviceId", "c", "mn", "mx"}


@pytest.fixture(scope="module", autouse=True)
def _no_cyclic_gc_inside_jax_locks():
    """The JAX package's devwatch registry deadlocks when a cyclic
    collection lands inside its weakref prune, so this module runs with the
    cyclic collector off and collects at its end."""
    enabled = gc.isenabled()
    gc.disable()
    yield
    if enabled:
        gc.enable()
    gc.collect()


@pytest.fixture(autouse=True)
def clocks():
    """Both packages' engine clocks, mock ones at 0 for each test."""
    yield jax_timex.set_mock_clock(0), timex.set_mock_clock(0)
    timex.use_real_clock()


# ------------------------------------------------------------------ nodes
def jax_node(sql=SQL, impl="refold", tier_mb=TIER_MB, capacity=CAP, **kw):
    stmt = jax_parse(sql)
    plan = jax_plan_of(stmt)
    node = JaxNode("ref", stmt.window, plan, [d.expr for d in stmt.dimensions],
                   capacity=capacity, micro_batch=MB,
                   direct_emit=jax_direct_emit(stmt, plan, ["deviceId"]),
                   emit_columnar=True, sliding_impl=impl,
                   tier_budget_mb=tier_mb, tier_scan_ms=SCAN_MS, **kw)
    node.state = node.gb.init_state()
    return node


def port_node(sql=SQL, impl="refold", tier_mb=TIER_MB, capacity=CAP, **kw):
    stmt = parse_select(sql)
    plan = extract_kernel_plan(stmt)
    return FusedWindowAggNode(
        "port", stmt.window, plan, [d.expr for d in stmt.dimensions],
        capacity=capacity, micro_batch=MB,
        direct_emit=build_direct_emit(stmt, plan, ["deviceId"]),
        emit_columnar=True, device="cpu", sliding_impl=impl,
        tier_budget_mb=tier_mb, tier_scan_ms=SCAN_MS, **kw)


def hot_target(node):
    """Give a node's tier the test's hot target (its own layout else)."""
    mod = tts if isinstance(node, FusedWindowAggNode) else jts
    lay = node.tier.layout
    node.tier.layout = mod.TierLayout(
        hot_slots=HOT, demote_batch=lay.demote_batch,
        scan_interval_ms=lay.scan_interval_ms,
        min_idle_scans=lay.min_idle_scans)
    return node


@pytest.fixture
def made():
    """Nodes built by a test, closed at its end (emit workers joined)."""
    nodes = []
    yield nodes
    for node in nodes:
        node.on_close()
    nodes.clear()


def _sink(node):
    got = []
    node.broadcast = got.append
    return got


# ------------------------------------------------------------------ data
def fleet(seed=5, n_batches=100, rows=48, t0=10_000, step=100):
    """The churning fleet: per 100 ms batch, 32 rows over 4 steady keys and
    16 over the current cohort of 8 keys (a new cohort every 10 batches);
    every third batch carries one 99.0 trigger row; from batch 80 on the
    first cohort comes back (fresh keys on recycled slots)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        cohort = 0 if i >= 80 else i // 10
        ids = np.array([f"s{k}" for k in rng.integers(0, 4, rows - 16)]
                       + [f"c{cohort}_{k}" for k in rng.integers(0, 8, 16)],
                       dtype=np.object_)
        temp = rng.uniform(0, 88, rows).astype(np.float32)
        if i % 3 == 0:
            temp[rng.integers(0, rows)] = 99.0
        ts = t0 + i * step + np.sort(rng.integers(0, step, rows)).astype(
            np.int64)
        out.append(JaxBatch(n=rows, columns={"deviceId": ids, "temp": temp},
                            timestamps=ts, emitter="s"))
    return out


def _port(b):
    return ColumnBatch(n=b.n, columns=dict(b.columns), valid=dict(b.valid),
                       timestamps=b.timestamps, emitter=b.emitter)


def feed(clocks, pairs, batch):
    """One batch to each node at the engine time of the batch's last row;
    the deferred deliveries and the tier's worker tasks drained after."""
    t = int(batch.timestamps[-1])
    for c in clocks:
        c.set(t)
    for node in pairs:
        node.process(_port(batch) if isinstance(node, FusedWindowAggNode)
                     else batch)
        node._drain_async_emits()


# ------------------------------------------------------------- comparing
def _rows(item):
    names = list(item.columns)
    rows = [dict(zip(names, vals))
            for vals in zip(*(item.columns[k].tolist() for k in names))]
    return {r["deviceId"]: r for r in rows}


def assert_windows(got, ref):
    assert len(got) == len(ref)
    for g_item, r_item in zip(got, ref):
        g_rows, r_rows = _rows(g_item), _rows(r_item)
        assert g_rows.keys() == r_rows.keys()
        for key, r in r_rows.items():
            for f, rv in r.items():
                if f in EXACT:
                    assert g_rows[key][f] == rv, (key, f)
                else:
                    assert g_rows[key][f] == pytest.approx(rv, rel=1e-5)


def tier_counts(node):
    return {"demoted": node.tier.demoted_total,
            "promoted": node.tier.promoted_total,
            "recycled": node.tier.recycled_total,
            "requeue": len(node.tier._requeue),
            "store": len(node.tier.store),
            "capacity": node.gb.capacity}


# -------------------------------------------------------------- the stream
@pytest.mark.parametrize("impl", ["daba", "refold"])
def test_churning_fleet_matches_reference(impl, clocks, made):
    """The fleet through a tiered sliding rule on each implementation: the
    quiescent cohorts are demoted as pure slot recycles, the state never
    grows past the hot capacity, and every window, placement plan, tier
    counter and the touch column (the refold path's masked folds bump it)
    equal the JAX node's after every batch."""
    j = hot_target(jax_node(impl=impl))
    t = hot_target(port_node(impl=impl))
    made += [j, t]
    assert t.tier.quiescent_only and j.tier.quiescent_only
    assert t.tier.min_idle_ms == j.tier.min_idle_ms \
        == (t.n_ring_panes + 10) * t.bucket_ms
    assert t.sliding_impl == j.sliding_impl == impl
    jgot, tgot = _sink(j), _sink(t)
    for b in fleet():
        feed(clocks, (j, t), b)
        assert t.tier._plan == j.tier._plan
        assert tier_counts(t) == tier_counts(j)
        np.testing.assert_array_equal(t.state["touch"].numpy(),
                                      np.asarray(j.state["touch"]))
    assert t.tier.demoted_total > 0
    assert t.tier.recycled_total == t.tier.demoted_total  # pure recycles
    assert t.gb.capacity == CAP and t.kt.n_keys <= CAP
    assert len(tgot) >= 30
    assert_windows(tgot, jgot)
    if impl == "refold":
        assert t.refold_counts["cached"] > 0
    assert not t.recoveries


def test_refold_touches_delay_quiescence(clocks, made):
    """The reference counts the refold path's edge refolds as touches of
    the rule's state (its masked fold bumps the touch column), so a key
    stays warm while a trigger's edge still refolds its rows: on the same
    stream the refold path demotes fewer keys than the DABA ring (whose
    edges fold on the host). The stream is test_churning_fleet_matches_
    reference's, whose counts equal the JAX node's on each path."""
    got = {}
    for k, impl in enumerate(("daba", "refold")):
        t = hot_target(port_node(impl=impl))
        made.append(t)
        for b in fleet(t0=10_000 + k * 100_000):
            feed(clocks, (t,), b)
        got[impl] = t.tier.demoted_total
    assert 0 < got["refold"] < got["daba"]


# ------------------------------------------------------- the impl choice
def test_impl_chosen_at_tier_capped_capacity(made):
    """A wide-hll sliding rule whose ring fits slidingDevRingMb only at the
    tier's capped capacity (12 MB at 1,024 slots, 48 MB at 4,096) keeps
    the DABA ring when tiered, as the reference's node does; untiered, it
    takes the refold path for its ring budget."""
    kw = {"sql": HLL_SQL, "impl": "daba", "tier_mb": 1.0, "capacity": 4096,
          "dev_ring_budget_mb": 16}
    j, t = jax_node(**kw), port_node(**kw)
    made += [j, t]
    assert t.tier is not None and j.tier is not None
    assert t.gb.capacity == j.gb.capacity == 1024
    assert t.sliding_impl == j.sliding_impl == "daba"
    assert t.sliding_fallback is None
    plain = port_node(**{**kw, "tier_mb": 0.0})
    made.append(plain)
    assert plain.sliding_impl == "refold"
    assert plain.sliding_fallback == "ring_budget"


# ------------------------------------------------------------ the manager
def _plan_of(sql):
    return jax_plan_of(jax_parse(sql)), extract_kernel_plan(parse_select(sql))


def test_live_spill_requeues_on_both_managers():
    """The reference's TestQuiescentMode.test_live_spill_requeues on both
    managers: a key with live data demoted in quiescent mode is requeued by
    the harvest, not stored, and the next admit re-seats it on a fresh slot
    with its partials; both managers end alike."""
    sql = ("SELECT deviceId, sum(v) AS s, count(*) AS c, min(v) AS mn "
           "FROM demo GROUP BY deviceId, HOPPINGWINDOW(ss, 4, 2)")
    jplan, tplan = _plan_of(sql)
    jgb = DeviceGroupBy(jplan, capacity=16, n_panes=2, micro_batch=8,
                        track_touch=True)
    tgb = TorchGroupBy(tplan, capacity=16, n_panes=2, micro_batch=8,
                       device="cpu", track_touch=True)
    got = {}
    for pkg, gb, kt, mod in (("j", jgb, JaxKeyTable(16), jts),
                             ("t", tgb, KeyTable(16), tts)):
        events = []
        mgr = mod.TierManager(gb, kt, mod.TierLayout(4, 4, 100, 1),
                              quiescent_only=True,
                              on_tier_event=lambda k, n: events.append((k,
                                                                        n)))
        st = gb.init_state()
        kt.encode_column(np.array(["a", "b"], np.object_))
        kt.drain_new_keys()
        st = gb.fold(st, {"v": np.ones(2)}, np.array([0, 1], np.int32),
                     pane_idx=0)
        mgr._plan = [0]  # "a" has live data
        st = mgr.on_boundary(st)
        assert mgr.demoted_total == 1 and len(mgr._requeue) == 1
        assert len(mgr.store) == 0
        snap = mgr.snapshot()
        st = mgr.admit(st)
        assert mgr.promoted_total == 1 and not mgr._requeue
        outs, act = gb.finalize(st, kt.n_keys)
        alive = {kt.decode(i) for i in np.nonzero(np.asarray(act) > 0)[0]}
        assert alive == {"a", "b"}
        got[pkg] = (snap, kt.decode_all(), events, [np.asarray(o).tolist()
                                                    for o in outs])
    assert got["t"] == got["j"]
    assert got["t"][2] == [("demote", 1), ("promote", 1)]


# ------------------------------------------------------------ checkpoints
def _requeued(clocks, pair, batches):
    """Run `batches` through the nodes of `pair`, then demote one live key
    on each (a forced plan, as a racy scan would): its row is requeued."""
    for b in batches:
        feed(clocks, pair, b)
    for node in pair:
        live = node.kt._ids["s0"]
        node.tier._plan = [live]
        node._tier_boundary()
        node._drain_async_emits()
        assert len(node.tier._requeue) == 1


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_requeue_checkpoint_crosses(direction, clocks, made):
    """A tiered sliding node holding a requeued live row checkpoints it in
    the reference's format; the other package's node restores it, promotes
    it at its first batch, and emits what the uninterrupted node emits."""
    j, t = jax_node(), port_node()
    made += [j, t]
    src, dst_make = (j, port_node) if direction == "jax_to_port" \
        else (t, jax_node)
    batches = fleet(seed=3, n_batches=40)
    _requeued(clocks, (src,), batches[:30])
    snap = json.loads(json.dumps(src.snapshot_state()))
    assert len(snap["tier"]["requeue"]) == 1
    dst = dst_make()
    made.append(dst)
    dst.restore_state(snap)
    assert dst.tier._requeue[0][0] == "s0"
    assert json.loads(json.dumps(dst.snapshot_state()))["tier"] \
        == snap["tier"]
    sgot, dgot = _sink(src), _sink(dst)
    for b in batches[30:]:
        feed(clocks, (src, dst), b)
    assert tier_counts(dst) == tier_counts(src)
    assert dst.tier.promoted_total == 1
    assert len(dgot) >= 3
    assert_windows(dgot, sgot)


def test_kill_restore_daba_tiered_cross_impl(clocks, made):
    """The reference's test of the same name on the port: a tiered DABA
    rule killed with a quiescent key demoted restores into a tiered refold
    node; the key's slot hole survives, and after the restore the window
    equals the untiered refold node's, on the port and in the JAX
    package alike."""
    def batch(ids, temps, tss):
        ids = np.array(ids, dtype=np.object_)
        return JaxBatch(n=len(ids), columns={
            "deviceId": ids, "temp": np.asarray(temps, np.float64)},
            timestamps=np.asarray(tss, np.int64), emitter="s")

    tiered = port_node(XSQL, impl="daba")
    ref = port_node(XSQL, tier_mb=0.0)
    jref = jax_node(XSQL, tier_mb=0.0)
    made += [tiered, ref, jref]
    assert tiered.tier.quiescent_only and tiered.sliding_impl == "daba"
    stream = [batch(["d_old", "d1"], [10.0, 20.0], [100, 100])] + [
        batch(["d1"], [30.0], [t * 250]) for t in range(1, 40)]
    for b in stream:
        feed(clocks, (tiered, ref, jref), b)
    slot_old = tiered.kt._ids["d_old"]
    tiered.tier._plan = [slot_old]
    tiered._tier_boundary()
    tiered._drain_async_emits()
    assert tiered.tier.demoted_total == tiered.tier.recycled_total == 1
    assert tiered.kt.decode(slot_old) is None
    assert tiered._rg_dirty  # the ring rebuilds from the panes
    snap = tiered.snapshot_state()
    assert None in snap["keys"]
    restored = port_node(XSQL)  # the other implementation, tier on
    made.append(restored)
    restored.restore_state(json.loads(json.dumps(snap)))
    assert restored.kt.free_slots() == tiered.kt.free_slots()
    outs = [_sink(n) for n in (restored, ref, jref)]
    feed(clocks, (restored, ref, jref),
         batch(["d_old", "d1"], [50.0, 95.0], [40 * 250, 40 * 250]))
    assert len(outs[0]) == 1
    assert_windows(outs[0], outs[1])
    assert_windows(outs[0], outs[2])
    rows = _rows(outs[0][0])
    assert rows["d_old"]["c"] == 1 and rows["d_old"]["s"] == 50.0
