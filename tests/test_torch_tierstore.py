"""Parity of the port's tiered key state (ekuiper_tpu_torch ops/tierstore.py,
the key table's free list, the fold's touch column, the tier demote and
promote kernels' plain versions, and the fused node's tier path) against
the JAX package on the CPU.

Inputs are made from a seed with numpy and given to both packages.
Tolerances, each against the JAX result:
- layouts, per-key bytes, key-table slots, logs and free lists: equal;
- the touch column after folds, and tier_demote / tier_promote's plain
  versions against TierStore.demote / promote (packed blocks, pad rows
  included, and the state after): bit-equal (the states are handed from
  the JAX package to the port, so only the gather / scatter is compared);
- emitted windows of the two packages' nodes: keys and counts exact, sums
  of integer values exact, sums of other values rtol 1e-5, hll estimates
  exact (the registers are exact);
- cold-tier checkpoints: the reference's format, restored across the
  packages both ways, with the windows after the restore as above.
"""
import gc
import json
import queue

import numpy as np
import pytest
import torch

from ekuiper_tpu.data.batch import ColumnBatch as JaxBatch
from ekuiper_tpu.ops import tierstore as jts
from ekuiper_tpu.ops.aggspec import extract_kernel_plan as jax_plan_of
from ekuiper_tpu.ops.emit import build_direct_emit as jax_direct_emit
from ekuiper_tpu.ops.groupby import DeviceGroupBy
from ekuiper_tpu.ops.keytable import KeyTable as JaxKeyTable
from ekuiper_tpu.runtime.events import Trigger as JaxTrigger
from ekuiper_tpu.runtime.nodes_fused import FusedWindowAggNode as JaxNode
from ekuiper_tpu.sql.parser import parse_select as jax_parse
from ekuiper_tpu.utils import timex as jax_timex
from ekuiper_tpu_torch.data.batch import ColumnBatch
from ekuiper_tpu_torch.ops import kernels
from ekuiper_tpu_torch.ops import tierstore as tts
from ekuiper_tpu_torch.ops.aggspec import (extract_kernel_plan,
                                           materialize_hll_columns)
from ekuiper_tpu_torch.ops.emit import build_direct_emit
from ekuiper_tpu_torch.ops.groupby import TorchGroupBy
from ekuiper_tpu_torch.ops.keytable import KeyTable
from ekuiper_tpu_torch.planner.fused import plan_fused_rule
from ekuiper_tpu_torch.runtime.events import Trigger
from ekuiper_tpu_torch.runtime.nodes_fused import FusedWindowAggNode
from ekuiper_tpu_torch.sql.parser import parse_select
from ekuiper_tpu_torch.utils import timex

import torch_finalize_cases as fc
from ekuiper_tpu_torch.utils.infra import PlanError

#: the reference tier tests' rule (tests/test_tierstore.py:21-22)
SQL = ("SELECT deviceId, sum(v) AS s, count(*) AS c, min(v) AS mn "
       "FROM demo GROUP BY deviceId, HOPPINGWINDOW(ss, 4, 2)")
WIDE_SQL = ("SELECT deviceId, distinct_count_approx(v) AS u, count(*) AS c "
            "FROM demo GROUP BY deviceId, HOPPINGWINDOW(ss, 4, 2)")
#: ten panes: keys the policy demotes a few boundaries after their last
#: row still hold live panes (tools/probe_tiering.py's reason for them)
WIDE_SQL_10 = WIDE_SQL.replace("HOPPINGWINDOW(ss, 4, 2)",
                               "HOPPINGWINDOW(ss, 10, 1)")
PCT_SQL = ("SELECT deviceId, percentile_approx(v, 0.9) AS p, max(v) AS mx "
           "FROM demo GROUP BY deviceId, TUMBLINGWINDOW(ss, 2)")
TUMBLING_SQL = ("SELECT deviceId, sum(v) AS s, count(*) AS c FROM demo "
                "GROUP BY deviceId, TUMBLINGWINDOW(ss, 1)")
#: the tail-return case: a hopping window of four 1 s panes, so a key
#: demoted with live panes can return inside a later window's tail
TAIL_SQL = ("SELECT deviceId, sum(v) AS s, count(*) AS c FROM demo "
            "GROUP BY deviceId, HOPPINGWINDOW(ss, 4, 1)")
HOST_TAIL_SQL = ("SELECT deviceId, sum(v) AS s, count(*) AS c FROM demo "
                 "GROUP BY deviceId, TUMBLINGWINDOW(ss, 2)")


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
    """The port's engine clock is a mock one at 0 for each test."""
    yield timex.set_mock_clock(0)
    timex.use_real_clock()


def _plans(sql):
    return jax_plan_of(jax_parse(sql)), extract_kernel_plan(parse_select(sql))


# ------------------------------------------------------------ the layout
@pytest.mark.parametrize("sql,n_panes", [
    (SQL, 2), (WIDE_SQL, 2), (PCT_SQL, 1), (TUMBLING_SQL, 1),
    (TAIL_SQL, 4), (SQL, 10)])
@pytest.mark.parametrize("capacity,budget_mb,scan_ms", [
    (64, 0.001, 0), (1 << 20, 64.0, 1), (1 << 20, 1.0, 0),
    (1024, 1e6, 0), (4096, 0.01, 250), (16384, 0.0, 0)])
def test_layout_matches_reference(sql, n_panes, capacity, budget_mb,
                                  scan_ms):
    jplan, tplan = _plans(sql)
    assert tts.state_bytes_per_key(tplan, n_panes) == \
        jts.state_bytes_per_key(jplan, n_panes)
    got = tts.plan_tier_layout(tplan, n_panes, capacity, budget_mb,
                               scan_interval_ms=scan_ms, window_ms=2000)
    ref = jts.plan_tier_layout(jplan, n_panes, capacity, budget_mb,
                               scan_interval_ms=scan_ms, window_ms=2000)
    assert (got is None) == (ref is None)
    if ref is not None:
        assert (got.hot_slots, got.demote_batch, got.scan_interval_ms,
                got.min_idle_scans, got.hot_capacity()) == \
            (ref.hot_slots, ref.demote_batch, ref.scan_interval_ms,
             ref.min_idle_scans, ref.hot_capacity())


def test_env_budget_matches_reference(monkeypatch):
    for raw in ("", "64", "0.5", "junk", "-3"):
        monkeypatch.setenv("KUIPER_HBM_BUDGET_MB", raw)
        assert tts.env_hbm_budget_mb() == jts.env_hbm_budget_mb()
    monkeypatch.delenv("KUIPER_HBM_BUDGET_MB")
    assert tts.env_hbm_budget_mb() == jts.env_hbm_budget_mb() == 0.0


# ---------------------------------------------------------- the key table
def _same_tables(kt, jkt):
    assert kt.decode_all() == jkt.decode_all()
    assert kt.free_slots() == jkt.free_slots()
    assert kt.n_keys == jkt.n_keys and kt.capacity == jkt.capacity


def test_key_table_retire_recycle_log_and_holes():
    """The same encodes, retirements and restores on both tables: the
    same slots, new-key logs, free lists and holes (recycling takes the
    per-key path, as in the reference)."""
    rng = np.random.default_rng(5)
    kt, jkt = KeyTable(16), JaxKeyTable(16)
    kt.track_new = jkt.track_new = True
    for step in range(12):
        ids = np.array([f"k{i}" for i in rng.integers(0, 40, 30)],
                       dtype=np.object_)
        if step == 7:  # a nil key and a composite key path
            ids[:3] = None
        got = kt.encode_column(ids)
        ref = jkt.encode_column(ids)
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[1] == ref[1]
        assert kt.drain_new_keys() == jkt.drain_new_keys()
        live = [s for s in range(kt.n_keys) if kt.decode(s) not in
                (None, "")]
        pick = sorted(rng.choice(live, size=min(4, len(live)),
                                 replace=False).tolist())
        keys = [kt.decode(s) for s in pick]
        kt.retire(pick, keys)
        jkt.retire(pick, keys)
        _same_tables(kt, jkt)
    # a stale retire (the slot was re-assigned) leaves the slot live
    slot = kt.free_slots()[-1]
    kt.encode_column(np.array(["fresh"], dtype=np.object_))
    jkt.encode_column(np.array(["fresh"], dtype=np.object_))
    kt.retire([slot], ["gone"])
    jkt.retire([slot], ["gone"])
    _same_tables(kt, jkt)
    # composite keys recycle too
    cols = [np.array(["a", "b", "a"], dtype=np.object_),
            np.array([1, 2, 3], dtype=np.object_)]
    np.testing.assert_array_equal(kt.encode_multi(cols)[0],
                                  jkt.encode_multi(cols)[0])
    assert kt.drain_new_keys() == jkt.drain_new_keys()
    # restore with holes: the holes rejoin the free list
    kt2, jkt2 = KeyTable(16), JaxKeyTable(16)
    kt2.restore(kt.decode_all())
    jkt2.restore(jkt.decode_all())
    _same_tables(kt2, jkt2)
    ids = np.array(["x", "y", "x"], dtype=np.object_)
    np.testing.assert_array_equal(kt2.encode_column(ids)[0],
                                  jkt2.encode_column(ids)[0])
    kt2.clear()
    assert kt2.free_slots() == [] and kt2.drain_new_keys() == []


# -------------------------------------------------------- the touch column
def _batch_cols(rng, plan, n, keys):
    v = np.rint(rng.normal(50, 10, n)).astype(np.float32)
    v[rng.random(n) < 0.05] = np.nan
    cols = materialize_hll_columns(plan.columns, {"v": v}, n)
    return ({k: cols[k] for k in plan.columns},
            rng.integers(0, keys, n).astype(np.int32))


@pytest.mark.parametrize("sql,n_panes", [
    (SQL.replace("FROM demo", "FROM demo WHERE v > 45"), 2),
    (WIDE_SQL, 2)])
def test_touch_column_after_folds(sql, n_panes):
    """touch counts each slot's rows after WHERE (cumulative), survives
    pane resets, pads with zeros on growth and crosses snapshots as
    uint32, as the reference's."""
    jplan, tplan = _plans(sql)
    jgb = DeviceGroupBy(jplan, capacity=32, n_panes=n_panes, micro_batch=64,
                        track_touch=True)
    tgb = TorchGroupBy(tplan, capacity=32, n_panes=n_panes, micro_batch=64,
                       device="cpu", track_touch=True)
    js, ts = jgb.init_state(), tgb.init_state()
    assert ts["touch"].dtype == torch.uint32 and ts["touch"].shape == (32,)
    rng = np.random.default_rng(11)
    for step in range(5):
        cols, slots = _batch_cols(rng, jplan, 100, 32)  # two chunks of 64
        pane = step % n_panes
        js = jgb.fold(js, dict(cols), slots, None, pane)
        ts = tgb.fold(ts, dict(cols), slots, None, pane)
        if step == 2:
            js = jgb.reset_pane(js, 0)
            ts = tgb.reset_pane(ts, 0)
        np.testing.assert_array_equal(ts["touch"].numpy(),
                                      np.asarray(js["touch"]))
        np.testing.assert_array_equal(ts["act"].numpy(),
                                      np.asarray(js["act"]))
    js, ts = jgb.grow(js, 64), tgb.grow(ts, 64)
    np.testing.assert_array_equal(ts["touch"].numpy(), np.asarray(js["touch"]))
    host = tgb.state_to_host(ts)
    assert host["touch"].dtype == np.uint32
    # checkpoint partials of either package: kept by a tracking kernel,
    # zero-filled for a pre-tier snapshot, dropped by an untracked one
    partials = {k: np.asarray(v).tolist()
                for k, v in jgb.state_to_host(js).items()}
    got, cap = tgb.host_from_partials(partials)
    ref, rcap = jgb.host_from_partials(partials)
    assert cap == rcap and got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k])
    pre_tier = {k: v for k, v in partials.items() if k != "touch"}
    assert (tgb.host_from_partials(pre_tier)[0]["touch"] == 0).all()
    plain = TorchGroupBy(tplan, capacity=64, n_panes=n_panes,
                         micro_batch=64, device="cpu")
    assert "touch" not in plain.host_from_partials(partials)[0]
    back = tgb.state_from_host(got)
    assert back["touch"].dtype == torch.uint32


# ---------------------------------------------------- demote and promote
def _tier_pair(sql, n_panes, cap=48, D=8, seed=0):
    """A JAX TierStore over a seeded folded state, and the port's over the
    same state handed across."""
    jplan, tplan = _plans(sql)
    jgb = DeviceGroupBy(jplan, capacity=cap, n_panes=n_panes, micro_batch=64,
                        track_touch=True)
    tgb = TorchGroupBy(tplan, capacity=cap, n_panes=n_panes, micro_batch=64,
                       device="cpu", track_touch=True)
    layout = jts.TierLayout(hot_slots=cap, demote_batch=D,
                            scan_interval_ms=100, min_idle_scans=1)
    tlayout = tts.TierLayout(hot_slots=cap, demote_batch=D,
                             scan_interval_ms=100, min_idle_scans=1)
    rng = np.random.default_rng(seed)
    js = jgb.init_state()
    for pane in range(n_panes):
        cols, slots = _batch_cols(rng, jplan, 120, cap)
        js = jgb.fold(js, dict(cols), slots, None, pane)
    ts = tgb.state_from_host(jgb.state_to_host(js))
    return jts.TierStore(jgb, layout), tts.TierStore(tgb, tlayout), js, ts


def _assert_state_equal(ts, js):
    assert set(ts) == set(js)
    for k in js:
        got, ref = ts[k].numpy(), np.asarray(js[k])
        assert got.dtype == ref.dtype, k
        np.testing.assert_array_equal(got, ref, err_msg=k)


@pytest.mark.parametrize("sql,n_panes", [
    (SQL, 2), (SQL, 10), (WIDE_SQL, 2), (PCT_SQL, 1)])
@pytest.mark.parametrize("n", [1, 5, 8])
def test_demote_promote_plain_match_reference(sql, n_panes, n):
    """tier_demote / tier_promote's plain versions, through the port's
    TierStore, against the reference's TierStore.demote / promote: the
    packed block (pad rows included) and the state after, bit for bit."""
    jstore, tstore, js, ts = _tier_pair(sql, n_panes, seed=n)
    assert tstore.packed_w == jstore.packed_w
    assert tstore.blocks == jstore.blocks
    np.testing.assert_array_equal(tstore.init_row(), jstore.init_row())
    rng = np.random.default_rng(100 + n)
    slots = rng.choice(48, size=n, replace=False).astype(np.int32)
    kernels.reset_launches()
    js, jpacked = jstore.demote(js, slots)
    ts, tpacked = tstore.demote(ts, slots)
    assert kernels.LAUNCHES["tier_demote"] == 0  # CPU: the plain version
    jpacked = np.asarray(jpacked)
    assert tpacked.shape == jpacked.shape == (8, jstore.packed_w)
    np.testing.assert_array_equal(tpacked.numpy(), jpacked)
    _assert_state_equal(ts, js)
    # promote some rows back into other free slots; the pad rows are
    # init_row(), so the repeated pad slot merges identities only
    back = rng.choice(48, size=n, replace=False).astype(np.int32)
    rows = jpacked[:n][::-1].copy()
    js = jstore.promote(js, rows, back)
    ts = tstore.promote(ts, rows, back)
    _assert_state_equal(ts, js)
    # rows, stale masks and idleness
    for i in range(n):
        row = jpacked[i].copy()
        assert tstore.row_is_idle(row) == jstore.row_is_idle(row)
        stale = rng.random(n_panes) < 0.5
        np.testing.assert_array_equal(
            tstore.mask_stale_panes(row.copy(), stale),
            jstore.mask_stale_panes(row.copy(), stale))


@pytest.mark.parametrize("case", list(fc.TIER_CASES))
def test_demote_edge_states_match_reference(case):
    """tier_demote's plain version, through the port's TierStore, against
    the reference's TierStore.demote on tests/torch_finalize_cases.py's
    blocks of 2,048 rows: one real row and 2,047 pads, half or all of the
    block real, rows of 18, 774 and 1,027 floats (none a multiple of 4),
    scalar, hll and percentile state, with and without the touch column:
    the packed block and the state after, bit for bit."""
    plan_tag, n, touch = fc.TIER_CASES[case]
    sql, n_panes = fc.TIER_SQL[plan_tag]
    jplan, tplan = _plans(sql)
    jgb = DeviceGroupBy(jplan, capacity=fc.TIER_CAP, n_panes=n_panes,
                        micro_batch=64, track_touch=touch)
    tgb = TorchGroupBy(tplan, capacity=fc.TIER_CAP, n_panes=n_panes,
                       micro_batch=64, device="cpu", track_touch=touch)
    host = fc.tier_fill(jgb.state_to_host(jgb.init_state()), seed=5)
    assert ("touch" in host) == touch
    js, ts = jgb.state_from_host(host), tgb.state_from_host(host)
    args = dict(hot_slots=fc.TIER_CAP, demote_batch=fc.TIER_D,
                scan_interval_ms=100, min_idle_scans=1)
    jstore = jts.TierStore(jgb, jts.TierLayout(**args))
    tstore = tts.TierStore(tgb, tts.TierLayout(**args))
    assert tstore.packed_w == jstore.packed_w and tstore.packed_w % 4
    slots = fc.tier_slots(n, seed=6)
    kernels.reset_launches()
    js, jpacked = jstore.demote(js, slots)
    ts, tpacked = tstore.demote(ts, slots)
    assert kernels.LAUNCHES["tier_demote"] == 0  # CPU: the plain version
    jpacked = np.asarray(jpacked)
    assert tpacked.shape == jpacked.shape == (fc.TIER_D, jstore.packed_w)
    np.testing.assert_array_equal(tpacked.numpy(), jpacked)
    np.testing.assert_array_equal(jpacked[n:], np.broadcast_to(
        jpacked[0], (fc.TIER_D - n, jstore.packed_w)))
    _assert_state_equal(ts, js)


def _same_bits(got, ref, what):
    """Equal element for element, float32 by its bits (signs of zero)."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype, what
    if got.dtype == np.float32:
        got, ref = got.view(np.uint32), ref.view(np.uint32)
    np.testing.assert_array_equal(got, ref, err_msg=what)


@pytest.mark.parametrize("case", list(fc.TIER_CASES))
def test_promote_edge_states_match_reference(case):
    """tier_promote's plain version against the reference's padded
    TierStore.promote on tests/torch_finalize_cases.py's blocks (one real
    row and 2,047 pads, half or all of the block real; scalar, hll and
    percentile state): state and rows with +/-0.0 and +/-inf in mn, mx and
    hll, -0.0 in slots[0]'s additive elements and in half of row 0's. The
    port's TierStore.promote (the n real rows up, no pads), and
    kernels.tier_promote given a block and slots longer than n: the state
    after bit for bit, signs of zero included."""
    plan_tag, n, touch = fc.TIER_CASES[case]
    sql, n_panes = fc.TIER_SQL[plan_tag]
    jplan, tplan = _plans(sql)
    jgb = DeviceGroupBy(jplan, capacity=fc.TIER_CAP, n_panes=n_panes,
                        micro_batch=64, track_touch=touch)
    tgb = TorchGroupBy(tplan, capacity=fc.TIER_CAP, n_panes=n_panes,
                       micro_batch=64, device="cpu", track_touch=touch)
    host = fc.tier_fill(jgb.state_to_host(jgb.init_state()), seed=5)
    args = dict(hot_slots=fc.TIER_CAP, demote_batch=fc.TIER_D,
                scan_interval_ms=100, min_idle_scans=1)
    jstore = jts.TierStore(jgb, jts.TierLayout(**args))
    tstore = tts.TierStore(tgb, tts.TierLayout(**args))
    rng = np.random.default_rng(7)
    js, block = jstore.demote(jgb.state_from_host(host), fc.tier_slots(n, 6))
    rows = fc.promote_rows(np.asarray(block), jstore.blocks, n, rng)
    back = fc.tier_slots(n, seed=8)
    host = {k: np.array(v) for k, v in jgb.state_to_host(js).items()}
    for comp, arr in host.items():
        if arr.dtype == np.float32:
            fc.promote_specials(arr, comp, rng, zero_cols=back[0])
    want = jgb.state_to_host(jstore.promote(jgb.state_from_host(host), rows,
                                            back))
    kernels.reset_launches()
    got = tgb.state_to_host(tstore.promote(tgb.state_from_host(host), rows,
                                           back))
    st = tgb.state_from_host(host)
    extra = rng.normal(0, 1, (3, tstore.packed_w)).astype(np.float32)
    kernels.tier_promote(
        st, torch.from_numpy(np.concatenate([rows, extra])),
        torch.from_numpy(np.concatenate([back, [0, 1, 2]]).astype(np.int32)),
        n, fc.TIER_D, tstore.comps)
    assert kernels.LAUNCHES["tier_promote"] == 0  # CPU: the plain version
    direct = tgb.state_to_host(st)
    for comp in want:
        _same_bits(got[comp], want[comp], comp)
        _same_bits(direct[comp], want[comp], comp)
    # the pads' identity reached slots[0] only where the block had pads:
    # -0.0 + -0.0 stays -0.0 in row 0's first column, + 0.0 makes it +0.0
    sign = np.signbit(want["act"][0, back[0]])
    assert sign == (n == fc.TIER_D)


def test_tier_store_refuses_what_the_kernels_do_not_take():
    _, tstore, _, ts = _tier_pair(SQL, 2)
    for bad in ([], [1, 1], [48], [-1], list(range(9))):
        with pytest.raises(ValueError):
            tstore.demote(ts, np.asarray(bad, np.int32))


# ------------------------------------------------------- the fused nodes
def _jbatch(ids, vals, ts=None):
    ids = np.array(ids, dtype=np.object_)
    return JaxBatch(n=len(ids), columns={"deviceId": ids,
                                         "v": np.asarray(vals, np.float64)},
                    timestamps=np.zeros(len(ids), np.int64)
                    if ts is None else ts, emitter="demo")


def _tbatch(ids, vals):
    ids = np.array(ids, dtype=np.object_)
    return ColumnBatch(n=len(ids), columns={"deviceId": ids,
                                            "v": np.asarray(vals, np.float64)},
                       timestamps=np.zeros(len(ids), np.int64),
                       emitter="demo")


class _Nodes:
    """A JAX node and a port node of one rule (tiered by tier_mb), and a
    port node without the tier; each emits into its own list. Driven by
    hand (prefinalize_lead_ms 0) unless `clock` is set, in which case the
    tiered pair is opened on their mock clocks and the JAX node's timers
    are pumped from its input queue, as its worker thread would."""

    def __init__(self, sql, tier_mb, capacity=64, micro_batch=128,
                 clock=False, columnar=False, **kw):
        kw.setdefault("prefinalize_lead_ms", 250 if clock else 0)
        self.clock = clock
        stmt = jax_parse(sql)
        plan = jax_plan_of(stmt)
        self.j = JaxNode("ref", stmt.window, plan,
                         [d.expr for d in stmt.dimensions],
                         capacity=capacity, micro_batch=micro_batch,
                         direct_emit=jax_direct_emit(stmt, plan,
                                                     ["deviceId"]),
                         emit_columnar=columnar, tier_budget_mb=tier_mb,
                         **kw)
        stmt = parse_select(sql)
        plan = extract_kernel_plan(stmt)
        self.t, self.p = (FusedWindowAggNode(
            "port", stmt.window, plan, [d.expr for d in stmt.dimensions],
            capacity=capacity, micro_batch=micro_batch,
            direct_emit=build_direct_emit(stmt, plan, ["deviceId"]),
            emit_columnar=columnar, device="cpu", tier_budget_mb=mb, **kw)
            for mb in (tier_mb, 0.0))
        self.out = {"j": [], "t": [], "p": []}
        for tag, node in self.nodes():
            node.emit = lambda item, count=None, _o=self.out[tag]: \
                _o.append(item)
            if clock and tag != "p":
                node.on_open()
            elif node.state is None:
                node.state = node.gb.init_state()
        if clock:
            self.jclock = jax_timex.get_mock_clock()
            self.tclock = timex.get_mock_clock()

    def nodes(self):
        return (("j", self.j), ("t", self.t), ("p", self.p))

    def tiered(self):
        return (self.j, self.t)

    def at(self, t):
        self.jclock.set(t)
        while True:
            try:
                item = self.j.inq.get_nowait()
            except queue.Empty:
                break
            self.j._dispatch(item)
            self.j.inq.task_done()
        self.tclock.set(t)

    def feed(self, ids, vals, untiered=True):
        self.j.process(_jbatch(ids, vals))
        self.t.process(_tbatch(ids, vals))
        if untiered:
            self.p.process(_tbatch(ids, vals))

    def trigger(self, ts):
        self.j.on_trigger(JaxTrigger(ts=ts))
        for node in (self.t, self.p):
            node.on_trigger(Trigger(ts=ts))

    def force_demote(self, slots):
        """The worker's plan, set on both tiered nodes and applied as at a
        boundary (the reference tests' forced _plan)."""
        for node in self.tiered():
            node.tier._plan = list(slots)
            node._tier_boundary()

    def drain(self):
        for _, node in self.nodes():
            node._drain_async_emits()

    def close(self):
        """Stop the timers and the emit workers, so nothing of a JAX node
        outlives the test (this module collects its cycles at its end)."""
        self.drain()
        for node in (self.t, self.p):
            node.on_close()
        j = self.j
        for t in [j._timer, *j._pre_timers]:
            if t is not None:
                t.stop()
        if self.clock:
            self.jclock.advance(10 ** 7)  # past the stopped timers
        if j._emit_q is not None:
            j._emit_q.put(None)
            j._emit_worker.join(timeout=5)


def _flat(msgs):
    """Emitted messages of one node as a multiset of sorted row items."""
    rows = {}
    for m in msgs:
        for r in (m if isinstance(m, list) else [m]):
            k = tuple(sorted(r.items()))
            rows[k] = rows.get(k, 0) + 1
    return rows


@pytest.fixture
def nodes():
    made = []

    def make(*a, **kw):
        n = _Nodes(*a, **kw)
        made.append(n)
        return n

    yield make
    for n in made:
        n.close()
    made.clear()


def _vals(rng, n):
    return np.rint(rng.normal(50, 10, n))


def test_forced_plan_spill_emit_promote(nodes):
    """The reference's test_demote_spill_emit_promote_parity shape: ten
    keys demoted at a boundary with live panes, half of them back in the
    next window (promoted), fresh keys on the recycled slots: every
    window equals the JAX tiered node's and the untiered port's, with no
    growth."""
    n = nodes(SQL, 0.001)
    assert n.t.tier is not None and n.p.tier is None
    assert n.t.gb.capacity == n.j.gb.capacity
    rng = np.random.default_rng(3)
    ids = [f"c{i}" for i in range(10)] + ["h"]
    n.feed(ids, _vals(rng, len(ids)))
    n.trigger(2000)
    n.force_demote(range(10))
    for node in n.tiered():
        node._drain_async_emits()
        assert node.tier.demoted_total == 10
        assert len(node.tier.store) == 10
        assert len(node.kt.free_slots()) == 10
    assert n.t.kt.decode_all() == n.j.kt.decode_all()
    ids = [f"c{i}" for i in range(0, 10, 2)] + [f"n{i}" for i in range(4)] \
        + ["h"]
    n.feed(ids, _vals(rng, len(ids)))
    n.trigger(4000)
    n.trigger(6000)
    n.drain()
    assert _flat(n.out["t"]) == _flat(n.out["j"]) == _flat(n.out["p"])
    for node in n.tiered():
        assert node.tier.promoted_total == 5
    assert n.t.gb.capacity == n.p.gb.capacity
    assert n.t.tier.snapshot() == n.j.tier.snapshot()


def test_promote_before_harvest(nodes):
    """Keys back before their demote block was harvested are promoted
    straight off the pending block; the late harvest skips them."""
    n = nodes(SQL, 0.001)
    held = {"j": [], "t": []}
    n.j.tier._submit = held["j"].append
    n.t.tier._submit = held["t"].append
    rng = np.random.default_rng(4)
    n.feed([f"k{i}" for i in range(6)], _vals(rng, 6))
    n.trigger(2000)
    n.force_demote(range(6))
    for node in n.tiered():
        assert len(node.tier._inflight) == 6
    n.feed(["k0", "k1", "k2"], _vals(rng, 3))
    n.trigger(4000)
    for tag, node in (("j", n.j), ("t", n.t)):
        assert node.tier.promoted_total == 3
        for payload in held[tag]:
            node.tier.worker_task(payload)
        assert len(node.tier._inflight) == 0
        assert len(node.tier.store) == 3
    n.trigger(6000)
    n.drain()
    assert _flat(n.out["t"]) == _flat(n.out["j"]) == _flat(n.out["p"])


def test_pane_epoch_masks_closed_windows(nodes):
    """A key back after its spilled panes all expired merges nothing old."""
    n = nodes(SQL, 0.001)
    n.feed(["a", "b"], [1.0, 2.0])
    n.trigger(2000)
    n.force_demote([0, 1])
    n.trigger(4000)
    n.trigger(6000)
    for tag in n.out:
        n.out[tag].clear()
    n.feed(["a"], [5.0])
    n.trigger(8000)
    n.drain()
    rows = _flat(n.out["t"])
    assert rows == _flat(n.out["j"]) == _flat(n.out["p"])
    (key,) = [k for k in rows if ("deviceId", "a") in k]
    assert dict(key)["s"] == 5.0 and dict(key)["c"] == 1
    assert n.t.tier.recycled_total == n.j.tier.recycled_total >= 1
    assert n.t.tier.snapshot() == n.j.tier.snapshot()


def _sorted_rows(cbs):
    """Columnar windows → one row dict per (window end, key), sorted."""
    out = []
    for cb in cbs:
        cols = cb.columns
        for i in range(cb.n):
            out.append({k: v[i] for k, v in cols.items()}
                       | {"_end": int(cb.timestamps[i])})
    return sorted(out, key=lambda r: (r["_end"], str(r["deviceId"])))


def _assert_windows_close(got, ref):
    """Keys and counts exact, sums within float32 rounding (rtol 1e-5)."""
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k, rv in r.items():
            if k == "s":
                assert g[k] == pytest.approx(rv, rel=1e-5), k
            else:
                assert g[k] == rv, k


def test_sub_budget_parity(nodes):
    """The key-cardinality bench's parity segment (bench.py:730-771): the
    tier engaged at 0.01 MB under its hot target, 1,000 keys, 8,192-row
    batches, 3 windows: the port's tiered windows byte-identical to its
    untiered ones, and equal to the JAX tiered node's."""
    n = nodes(TUMBLING_SQL, 0.01, capacity=4096, micro_batch=8192,
              columnar=True)
    assert n.t.tier is not None and n.t.gb.capacity == 1024
    rng = np.random.default_rng(13)
    par_ids = np.array([f"p{i}" for i in range(1000)], dtype=np.object_)
    for w in range(3):
        idx = rng.integers(0, 1000, 8192)
        n.feed(par_ids[idx].tolist(), rng.normal(50, 10, 8192))
        n.trigger((w + 1) * 1000)
    n.drain()

    def raw(emits):
        return [{k: np.asarray(v).tobytes() if np.asarray(v).dtype
                 != np.object_ else tuple(v) for k, v in sorted(
                     cb.columns.items())} for cb in emits]

    assert len(n.out["t"]) == 3 and raw(n.out["t"]) == raw(n.out["p"])
    _assert_windows_close(_sorted_rows(n.out["t"]), _sorted_rows(n.out["j"]))
    assert n.t.tier.demoted_total == n.j.tier.demoted_total == 0


def test_wide_plan_natural_policy(nodes):
    """A wide plan (distinct_count_approx, ten panes) at the 1,024-slot
    hot floor under the natural policy: 1,400 keys, then a hot set only,
    so the touch scans find idle keys and demote them with live panes;
    some come back (promoted). Windows, plans, counters and the cold tier
    equal the JAX node's at every boundary."""
    n = nodes(WIDE_SQL_10, 1, capacity=2048, micro_batch=2048,
              tier_scan_ms=1)
    for node in n.tiered():
        assert node.tier.layout.hot_slots == 1024
        assert node.gb.capacity == 1024
    rng = np.random.default_rng(21)
    keys = np.array([f"w{i}" for i in range(1400)], dtype=np.object_)
    t = 0
    for step in range(9):
        if step == 0:
            ids = keys[rng.permutation(1400)]
        elif step < 6:
            ids = keys[rng.integers(0, 400, 600)]
        else:  # cold keys come back
            ids = keys[np.concatenate([rng.integers(0, 400, 500),
                                       rng.integers(400, 1400, 300)])]
        n.feed(ids.tolist(), rng.integers(0, 5000, len(ids)), untiered=False)
        t += 1000
        # the scan cadence reads the engine clocks
        jax_timex.get_mock_clock().set(t)
        timex.get_mock_clock().set(t)
        n.j.on_trigger(JaxTrigger(ts=t))
        n.t.on_trigger(Trigger(ts=t))
        for node in n.tiered():
            node._drain_async_emits()
        assert n.t.tier._plan == n.j.tier._plan
    n.drain()
    for attr in ("demoted_total", "promoted_total", "recycled_total"):
        assert getattr(n.t.tier, attr) == getattr(n.j.tier, attr), attr
    assert n.t.tier.demoted_total > 0 and n.t.tier.promoted_total > 0
    assert n.t.gb.capacity == n.j.gb.capacity
    assert _flat(n.out["t"]) == _flat(n.out["j"])
    assert n.t.tier.snapshot() == n.j.tier.snapshot()
    np.testing.assert_array_equal(n.t.state["touch"].numpy(),
                                  np.asarray(n.j.state["touch"]))


# --------------------------------------------------- returns in a tail
def test_tail_return_default_boundary_drops_spilled_panes(nodes):
    """A fault of the reference, reproduced: under the default boundary
    (prefinalizeLeadMs 250, tailMode device), a key that comes back after
    the window's pre-issue is promoted into device state the components
    fetch has already snapshotted, and `admit` has taken its row out of
    the cold tier, so the window emits the key's tail rows only. The
    next windows hold its promoted panes again. Both packages emit the
    same windows (ROADMAP.md Queue 3)."""
    n = nodes(TAIL_SQL, 0.001, clock=True)
    n.at(100)
    n.feed(["a", "b"], [1.0, 2.0], untiered=False)
    n.at(1000)  # boundary: window (-3000, 1000]
    n.at(1100)
    n.feed(["a", "b"], [10.0, 20.0], untiered=False)
    n.at(1900)
    for node in n.tiered():
        node._drain_async_emits()
        node.tier._plan = [0]  # "a", applied at the 2000 boundary
    n.at(2000)
    for node in n.tiered():
        node._drain_async_emits()
        assert node.tier.demoted_total == 1 and "a" in node.tier.store
    n.at(2900)  # after the 2x- and 1x-lead pre-issues of the 3000 boundary
    n.feed(["a"], [100.0], untiered=False)
    n.at(3000)
    n.at(4000)
    n.drain()
    got, ref = _flat(n.out["t"]), _flat(n.out["j"])
    assert got == ref

    def a_rows(rows):
        return sorted((dict(k)["s"], dict(k)["c"]) for k in rows
                      if ("deviceId", "a") in k)

    # the truth for "a" at 3000 is (111, 3), at 4000 (111, 3) as well;
    # the reference emits its tail row only at 3000
    assert a_rows(ref) == [(1.0, 1), (11.0, 2), (100.0, 1), (111.0, 3)]
    for node in n.tiered():
        assert node.tier.promoted_total == 1


def test_tail_return_host_tail_mode_is_exact(nodes):
    """The same return under tailMode host on a tumbling rule (the only
    window host tails serve): a tumbling rule demotes at a boundary right
    after the pane reset, so its demoted rows are identity (pure
    recycles) and nothing spilled can be lost or emitted twice; a key
    back in the frozen tail is a fresh key in the shadow. Both packages
    emit the same, exact windows."""
    n = nodes(HOST_TAIL_SQL, 0.001, clock=True, tail_mode="host")
    n.at(100)
    n.feed(["a", "b"], [1.0, 2.0], untiered=False)
    n.at(1900)
    for node in n.tiered():
        node._drain_async_emits()
        node.tier._plan = [0]
    n.at(2000)
    n.at(2100)
    n.feed(["b"], [3.0], untiered=False)
    n.at(3800)  # frozen since the 3500 pre-issue
    n.feed(["a", "b"], [7.0, 4.0], untiered=False)
    n.at(4000)
    n.at(4100)
    n.feed(["a"], [9.0], untiered=False)
    n.at(6000)
    n.drain()
    got, ref = _flat(n.out["t"]), _flat(n.out["j"])
    assert got == ref
    rows = sorted((dict(k)["deviceId"], dict(k)["s"], dict(k)["c"])
                  for k in ref)
    assert rows == [("a", 1.0, 1), ("a", 7.0, 1), ("a", 9.0, 1),
                    ("b", 2.0, 1), ("b", 7.0, 2)]
    for node in n.tiered():
        assert node.tier.demoted_total == 1
        assert node.tier.recycled_total == 1 and node.tier.promoted_total == 0


# ------------------------------------------------------------ checkpoints
def _roundtrip(snap):
    return json.loads(json.dumps(snap))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_crosses_packages(nodes, direction):
    """A tiered checkpoint (hot partials with the touch column, retired
    slots as None holes, the cold tier's rows and epochs) taken in one
    package restores in the other; the windows after it equal those of
    the node that took it."""
    n = nodes(SQL, 0.001)
    rng = np.random.default_rng(8)
    n.feed(["a", "b", "c", "d"], [1.0, 2.0, 3.0, 4.0])
    n.trigger(2000)
    n.force_demote([0, 1])
    src = n.j if direction == "jax_to_port" else n.t
    snap = _roundtrip(src.snapshot_state())
    assert snap["tier"]["keys"] == ["a", "b"] and None in snap["keys"]
    assert "touch" in snap["partials"]
    assert snap == _roundtrip((n.t if src is n.j else n.j).snapshot_state())
    stmt = parse_select(SQL)
    plan = extract_kernel_plan(stmt)
    if direction == "jax_to_port":
        dst = FusedWindowAggNode(
            "restored", stmt.window, plan, [d.expr for d in stmt.dimensions],
            capacity=64, micro_batch=128, prefinalize_lead_ms=0,
            direct_emit=build_direct_emit(stmt, plan, ["deviceId"]),
            device="cpu", tier_budget_mb=0.001)
        ref_node, trig = n.j, JaxTrigger
        dst_trig = Trigger
    else:
        jstmt = jax_parse(SQL)
        jplan = jax_plan_of(jstmt)
        dst = JaxNode("restored", jstmt.window, jplan,
                      [d.expr for d in jstmt.dimensions], capacity=64,
                      micro_batch=128, prefinalize_lead_ms=0,
                      direct_emit=jax_direct_emit(jstmt, jplan,
                                                  ["deviceId"]),
                      tier_budget_mb=0.001)
        ref_node, trig = n.t, Trigger
        dst_trig = JaxTrigger
    out_dst, out_ref = [], []
    dst.emit = lambda item, count=None: out_dst.append(item)
    ref_node.emit = lambda item, count=None: out_ref.append(item)
    dst.restore_state(snap)
    assert len(dst.tier.store) == 2
    assert dst.kt.free_slots() == ref_node.kt.free_slots()
    vals = _vals(rng, 3)
    batch = _tbatch if dst_trig is Trigger else _jbatch
    ref_batch = _jbatch if dst_trig is Trigger else _tbatch
    for node, mk, tg in ((dst, batch, dst_trig), (ref_node, ref_batch, trig)):
        node.process(mk(["a", "e", "c"], vals))
        node.on_trigger(tg(ts=4000))
        node.on_trigger(tg(ts=6000))
        node._drain_async_emits()
    assert _flat(out_dst) == _flat(out_ref)
    a = [dict(k) for k in _flat(out_dst) if ("deviceId", "a") in k]
    assert sorted((r["s"], r["c"]) for r in a) == sorted(
        [(1.0 + vals[0], 2), (vals[0], 1)])
    if isinstance(dst, JaxNode):
        dst._emit_q and dst._emit_q.put(None)
    else:
        dst.on_close()


# ---------------------------------------------------------------- options
def test_tier_options(monkeypatch):
    """The three rule options with the reference's defaults and checks:
    tierStore "auto" engages with a budget (tierHotMb or
    KUIPER_HBM_BUDGET_MB), "on" needs one, "off" never engages; LIMIT
    gates the tier off (ORDER BY does not plan on the port yet);
    heavy_hitters stays untiered; a sliding rule tiers in quiescent-only
    mode."""
    monkeypatch.delenv("KUIPER_HBM_BUDGET_MB", raising=False)
    wide = WIDE_SQL

    def plan(options, sql=wide, **kw):
        return plan_fused_rule(sql, key_slots=2048, micro_batch=256,
                               device="cpu", options=options, **kw)

    assert plan({}).tier is None
    node = plan({"tierHotMb": 1})
    assert node.tier is not None and node.gb.capacity == 1024
    assert node.tier.layout.scan_interval_ms == 2000
    assert plan({"tierHotMb": 1, "tierScanMs": 5}).tier.layout \
        .scan_interval_ms == 5
    assert plan({"tierHotMb": 1, "tierStore": "OFF"}).tier is None
    assert plan({"tierHotMb": 1, "tierStore": "on"}).tier is not None
    with pytest.raises(PlanError):
        plan({"tierStore": "on"})
    monkeypatch.setenv("KUIPER_HBM_BUDGET_MB", "1")
    assert plan({"tierStore": "on"}).tier is not None
    assert plan({}).tier is not None  # auto with the engine budget
    assert plan({"tierStore": "off"}).tier is None
    assert plan({}, sql=wide + " LIMIT 5").tier is None
    assert plan({}, sql="SELECT deviceId, heavy_hitters(v, 3) AS h FROM "
                "demo GROUP BY deviceId, TUMBLINGWINDOW(ss, 2)").tier is None
    sliding = plan({}, sql="SELECT deviceId, distinct_count_approx(v) AS u "
                   "FROM demo GROUP BY deviceId, SLIDINGWINDOW(ss, 4) OVER "
                   "(WHEN v > 3)")
    assert sliding.tier is not None and sliding.tier.quiescent_only
    assert plan({}, sql="SELECT deviceId, heavy_hitters(v, 3) AS h FROM "
                "demo GROUP BY deviceId, SLIDINGWINDOW(ss, 4) OVER (WHEN v > "
                "3)").tier is None
    monkeypatch.delenv("KUIPER_HBM_BUDGET_MB")
    for bad in ({"tierStore": "maybe"}, {"tierStore": 1},
                {"tierHotMb": -1}, {"tierHotMb": True},
                {"tierHotMb": 0.5}, {"tierScanMs": "1s"},
                {"tierScanMs": -5}):
        with pytest.raises(PlanError):
            plan(bad)


@pytest.mark.parametrize("mode", ["auto", "on", "off"])
@pytest.mark.parametrize("hot_mb,env", [(0, ""), (3, ""), (0, "7"),
                                        (2, "9")])
def test_budget_resolution_matches_reference(mode, hot_mb, env,
                                             monkeypatch):
    from ekuiper_tpu.planner.planner import (PlanError as JaxPlanError,
                                             resolve_tier_budget_mb)
    from ekuiper_tpu.utils.config import RuleOptionConfig

    from ekuiper_tpu_torch.planner.fused import (resolve_tier_budget_mb as
                                                 port_resolve, rule_options)

    monkeypatch.setenv("KUIPER_HBM_BUDGET_MB", env)
    ref_opts = RuleOptionConfig()
    ref_opts.tier_store, ref_opts.tier_hot_mb = mode, hot_mb
    try:
        want = resolve_tier_budget_mb(ref_opts)
    except JaxPlanError:
        want = PlanError
    opts = rule_options({"tierStore": mode, "tierHotMb": hot_mb})
    if want is PlanError:
        with pytest.raises(PlanError):
            port_resolve(opts)
    else:
        assert port_resolve(opts) == want
