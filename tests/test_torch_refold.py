"""The port's sliding refold path (ekuiper_tpu_torch runtime/nodes_fused.py
`_emit_sliding_refold`, ops/groupby.py `fold_masked`, the masked fold
kernels' plain versions) against the JAX package's refold node on the CPU,
trigger by trigger: the four cases that take it (a requested
`slidingImpl: "refold"`, a heavy_hitters rule, a ring over its
`slidingDevRingMb` budget, a plan the ring rejects), scalar, min/max,
percentile/hll and heavy_hitters rules, a window over many buckets, a
delayed window on the mock clock, the stale-pane whole-window refold, the
device batch cache's budgets (tests/test_sliding_device.py
TestDevRingBudget's zero, default and tiny), a key capacity grown past
65,535 with uint16 and int32 batches both cached, and checkpoints across
the packages and across `daba`/`refold`.

Batches are made from a seed with numpy and given to both nodes. Besides
every window, each batch compares the cache's bookkeeping: its bytes
(`_dev_ring_bytes`), which entries are cached or evicted, the age-ordered
eviction queue, and the pane bookkeeping.

Tolerances of each emitted value against the JAX node's: keys, counts,
min, max and heavy-hitters lists exact; sums and averages rtol 1e-5
(float32 scatter-add and pane merges in another order); stddev rtol 1e-4
plus the cancellation floor 4·sqrt(ε32)·|mean| (ROADMAP Queue 3: XLA and
torch round s2/n − mean² differently); distinct counts within ±1;
percentiles within 4 ulp (the same bin's centre). Windows against the DABA
node (the daba/refold checkpoints) are compared on min/max/count, exact.
"""
import gc
import json
import queue

import numpy as np
import pytest
import torch

from ekuiper_tpu.data.batch import ColumnBatch as JaxBatch
from ekuiper_tpu.ops import slidingring as jax_slidingring
from ekuiper_tpu.ops.aggspec import extract_kernel_plan as jax_plan_of
from ekuiper_tpu.ops.emit import build_direct_emit as jax_direct_emit
from ekuiper_tpu.ops.groupby import DeviceGroupBy
from ekuiper_tpu.runtime.nodes_fused import FusedWindowAggNode as JaxNode
from ekuiper_tpu.sql.parser import parse_select as jax_parse
from ekuiper_tpu.utils import timex as jax_timex
from ekuiper_tpu_torch.data.batch import ColumnBatch
from ekuiper_tpu_torch.ops.aggspec import (HH_COL_PREFIX, HLL_COL_PREFIX,
                                           encode_hll_column,
                                           extract_kernel_plan)
from ekuiper_tpu_torch.ops.emit import build_direct_emit
from ekuiper_tpu_torch.ops.groupby import TorchGroupBy
from ekuiper_tpu_torch.planner.fused import plan_fused_rule
from ekuiper_tpu_torch.runtime import nodes_fused
from ekuiper_tpu_torch.runtime.nodes_fused import FusedWindowAggNode
from ekuiper_tpu_torch.sql.parser import parse_select
from ekuiper_tpu_torch.utils import timex

from test_sliding_ring import random_trigger_batches

SQL_INV = ("SELECT deviceId, count(*) AS c, sum(temp) AS s, "
           "avg(temp) AS a, stddev(temp) AS sd FROM s GROUP BY deviceId, "
           "SLIDINGWINDOW(ss, 2) OVER (WHEN temp > 90)")
SQL_MM = ("SELECT deviceId, min(temp) AS mn, max(temp) AS mx, "
          "count(*) AS c FROM s GROUP BY deviceId, "
          "SLIDINGWINDOW(ss, 2) OVER (WHEN temp > 90)")
SQL_SKETCH = ("SELECT deviceId, percentile_approx(temp, 0.9) AS p90, "
              "distinct_count_approx(temp) AS dc FROM s GROUP BY deviceId, "
              "SLIDINGWINDOW(ss, 2) OVER (WHEN temp > 90)")
SQL_HH = ("SELECT deviceId, heavy_hitters(code, 3) AS top, count(*) AS c "
          "FROM s GROUP BY deviceId, SLIDINGWINDOW(ss, 1) "
          "OVER (WHEN temp > 90)")
SQL_DELAY = ("SELECT deviceId, count(*) AS c, max(temp) AS mx, "
             "avg(temp) AS a FROM s GROUP BY deviceId, "
             "SLIDINGWINDOW(ss, 2, 1) OVER (WHEN temp > 90)")
EXACT = {"c", "mn", "mx", "top"}
CAP, MB = 64, 128
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(scope="module", autouse=True)
def _no_cyclic_gc_inside_jax_locks():
    """As in test_torch_sliding.py: the JAX package's devwatch registry
    deadlocks when a cyclic collection lands inside its weakref prune, so
    this module runs with the cyclic collector off and collects at its
    end."""
    enabled = gc.isenabled()
    gc.disable()
    yield
    if enabled:
        gc.enable()
    gc.collect()


# ------------------------------------------------------------------ nodes
def jax_node(sql, impl="refold", capacity=CAP, micro_batch=MB, **kw):
    stmt = jax_parse(sql)
    plan = jax_plan_of(stmt)
    node = JaxNode("ref", stmt.window, plan, [d.expr for d in stmt.dimensions],
                   capacity=capacity, micro_batch=micro_batch,
                   direct_emit=jax_direct_emit(stmt, plan, ["deviceId"]),
                   emit_columnar=True, sliding_impl=impl, **kw)
    node.state = node.gb.init_state()
    return node


def port_node(sql, impl="refold", capacity=CAP, micro_batch=MB, **kw):
    stmt = parse_select(sql)
    plan = extract_kernel_plan(stmt)
    return FusedWindowAggNode(
        "port", stmt.window, plan, [d.expr for d in stmt.dimensions],
        capacity=capacity, micro_batch=micro_batch,
        direct_emit=build_direct_emit(stmt, plan, ["deviceId"]),
        emit_columnar=True, device="cpu", sliding_impl=impl, **kw)


def books(node):
    """The device cache's and the panes' bookkeeping, comparable across
    the packages."""
    return {"bytes": node._dev_ring_bytes,
            "cached": {b: [e is not None for e in lst]
                       for b, lst in node._dev_ring.items()},
            "fifo": [tuple(int(x) for x in e) for e in node._dev_ring_fifo],
            "pane_bucket": dict(node._pane_bucket),
            "max_bucket": node._ring_max_bucket,
            "bucket_max_ts": dict(node._bucket_max_ts)}


class Pair:
    """The JAX refold node and the port's node of one rule; `feed` gives a
    batch to both and compares the bookkeeping after it. The port's
    deliveries are recorded with the route that served each."""

    def __init__(self, sql, budget_bytes=None, t_kw=None, **kw):
        self.j = jax_node(sql, **kw)
        self.t = port_node(sql, **{**kw, **(t_kw or {})})
        if budget_bytes is not None:
            self.j.dev_ring_budget_bytes = budget_bytes
            self.t.dev_ring_budget_bytes = budget_bytes
        self.jgot, self.tgot, self.sources = [], [], []
        self.j.broadcast = self.jgot.append

        def got(item):
            self.tgot.append(item)
            self.sources.append(self.t.last_emit_info["source"])

        self.t.broadcast = got

    def feed(self, batch):
        self.j.process(batch)
        self.t.process(_port(batch))
        assert books(self.t) == books(self.j)

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

    def check(self, min_triggers=1):
        self.j._drain_async_emits()
        self.t._drain_async_emits()
        assert self.t.sliding_impl == self.j.sliding_impl == "refold"
        assert len(self.tgot) == len(self.jgot) >= min_triggers
        want = "sync" if self.t.gb._host_finalize_only else "device-async"
        assert set(self.sources) == {want}
        assert not self.t.recoveries
        for g, r in zip(self.tgot, self.jgot):
            assert_window(g, r)

    def close(self):
        for node in (self.j, self.t):
            node.on_close()


@pytest.fixture
def pairs():
    made = []
    yield lambda *a, **kw: made.append(Pair(*a, **kw)) or made[-1]
    for p in made:
        p.close()
    made.clear()  # as test_torch_multirule.py's `groups`


# ------------------------------------------------------------- comparing
def _rows(item):
    names = list(item.columns)
    rows = [dict(zip(names, vals))
            for vals in zip(*(item.columns[k].tolist() for k in names))]
    return {r["deviceId"]: r for r in rows}


def assert_window(got, ref, exact_only=False):
    g_rows, r_rows = _rows(got), _rows(ref)
    assert g_rows.keys() == r_rows.keys()
    for key, r in r_rows.items():
        g = g_rows[key]
        assert g.keys() == r.keys()
        for f, rv in r.items():
            gv = g[f]
            if rv is None or isinstance(rv, str) or f in EXACT:
                assert gv == rv, (key, f, gv, rv)
            elif exact_only:
                continue
            elif f == "dc":
                assert abs(gv - rv) <= 1, (key, f, gv, rv)
            elif f == "p90":
                assert gv == pytest.approx(rv, rel=4 * EPS32), (key, f)
            elif f == "sd":
                floor = 4 * np.sqrt(EPS32) * abs(r["a"])
                assert abs(gv - rv) <= 1e-4 * abs(rv) + floor, (key, f)
            else:
                assert gv == pytest.approx(rv, rel=1e-5), (key, f, gv, rv)


# ------------------------------------------------------------------ data
def _port(b):
    """The port's ColumnBatch of a JAX package one (the same arrays)."""
    return ColumnBatch(n=b.n, columns=dict(b.columns), valid=dict(b.valid),
                       timestamps=b.timestamps, emitter=b.emitter)


def hh_batches(seed, n_batches=16, rows=48, keys=5, t0=10_000, step=100):
    """Random trigger batches with a skewed `code` column (7 at ~40 %,
    13 at ~25 %, a tail of 30 values)."""
    rng = np.random.default_rng(seed)
    out = random_trigger_batches(seed=seed, n_batches=n_batches, rows=rows,
                                 keys=keys, t0=t0, step=step)
    for b in out:
        u = rng.random(b.n)
        code = np.where(u < 0.4, 7, np.where(u < 0.65, 13,
                                             rng.integers(20, 50, b.n)))
        b.columns["code"] = code.astype(np.int64)
    return out


def run(pair, batches):
    for b in batches:
        pair.feed(b)
    return pair


# ------------------------------------------------------------- the cases
@pytest.mark.parametrize("case", ["refold", "heavy_hitters", "budget",
                                  "ring_rejected"])
def test_refold_cases_plan_and_match(case, pairs, monkeypatch):
    """Each case in which the reference takes its refold path plans a port
    node on it (plan_fused_rule and direct construction alike) that emits
    what the JAX refold node emits."""
    kw, opts, reason = {}, {}, None
    if case == "refold":
        sql, kw, opts = SQL_INV, {"impl": "refold"}, {"slidingImpl": "refold"}
        batches = random_trigger_batches(seed=7, n_batches=24)
    elif case == "heavy_hitters":
        sql, kw, reason = SQL_HH, {"impl": "daba"}, "heavy_hitters"
        batches = hh_batches(seed=8)
    elif case == "budget":
        # the ring's static footprint at 64 slots is 1.0003 MB
        sql, reason = SQL_SKETCH, "ring_budget"
        kw, opts = {"impl": "daba", "dev_ring_budget_mb": 1}, \
            {"slidingDevRingMb": 1}
        batches = random_trigger_batches(seed=13, n_batches=20)
    else:
        sql, kw, reason = SQL_MM, {"impl": "daba"}, "ring_rejected"

        class Rejecting:
            def __init__(self, *a, **k):
                raise ValueError("no combine class")

        monkeypatch.setattr(nodes_fused, "SlidingRing", Rejecting)
        monkeypatch.setattr(jax_slidingring, "SlidingRing", Rejecting)
        batches = random_trigger_batches(seed=11, n_batches=24)
    planned = plan_fused_rule(sql, key_slots=CAP, micro_batch=MB,
                              device="cpu", options=opts)
    assert planned.sliding_impl == "refold"
    assert planned.sliding_fallback == reason and planned.ring is None
    pair = run(pairs(sql, **kw), batches)
    assert pair.t.sliding_fallback == reason
    pair.check(min_triggers=5)
    counts = pair.t.refold_counts
    assert counts["cached"] > 0 and counts["stale"] == 0, counts
    assert pair.t.ring_dev_bytes() == 0  # no DABA partials


def test_window_over_many_buckets(pairs):
    """A 10 s window over 400 buckets of 25 ms, batches of 250 ms (each
    crossing ten bucket edges: the fold's per-row pane vector from the
    cached upload, one cache entry per bucket over the same tensors)."""
    sql = SQL_INV.replace("SLIDINGWINDOW(ss, 2)", "SLIDINGWINDOW(ss, 10)")
    batches = random_trigger_batches(seed=19, n_batches=60, rows=96,
                                     step=250, spike_every=113)
    pair = run(pairs(sql), batches)
    assert pair.t.length_ms // pair.t.bucket_ms >= 100
    pair.check(min_triggers=20)
    # multi-bucket batches count their tensors once per bucket entry
    assert len(pair.t._dev_ring_fifo) > 60


def test_delayed_window_on_the_mock_clock(pairs):
    """SLIDINGWINDOW(ss, 2, 1): each trigger arms a timer 1 s ahead on
    the engine clock; both nodes refold (t - 2 s, t + 1 s] when it fires
    (the JAX node's timers enqueue, the test pumps them)."""
    jclock = jax_timex.set_mock_clock(0)
    tclock = timex.set_mock_clock(0)
    try:
        pair = pairs(SQL_DELAY)
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
    finally:
        jax_timex.use_real_clock()
        timex.use_real_clock()


def test_stale_pane_refolds_the_whole_window(pairs):
    """Delayed triggers still pending when a batch 3.1 s ahead recycles
    panes inside their windows (rows of buckets b + R land in the panes of
    buckets b): those windows refold whole from the retained rows."""
    jclock = jax_timex.set_mock_clock(0)
    tclock = timex.set_mock_clock(0)
    try:
        pair = pairs(SQL_DELAY)
        batches = random_trigger_batches(seed=29, n_batches=20, rows=40,
                                         spike_every=23)
        for b in batches:
            t = int(b.timestamps[-1])
            jclock.set(t)
            pair.pump()
            tclock.set(t)
            pair.feed(b)
        R, B = pair.t.n_ring_panes, pair.t.bucket_ms
        lo_bucket = 10_000 // B
        # rows in buckets lo_bucket + 2 + R .. + 7 + R: recycles the panes
        # of buckets lo_bucket + 2 .. + 7, whose rows stay retained
        ts = (np.arange(6 * B, step=5) + (lo_bucket + 2 + R) * B).astype(
            np.int64)
        rng = np.random.default_rng(3)
        ids = np.array([f"d{i}" for i in rng.integers(0, 5, len(ts))],
                       dtype=np.object_)
        jump = JaxBatch(n=len(ts), columns={
            "deviceId": ids,
            "temp": rng.uniform(0, 88, len(ts)).astype(np.float32)},
            timestamps=ts, emitter="s")
        pair.feed(jump)
        jclock.advance(5_000)
        pair.pump()
        tclock.advance(5_000)
        pair.check(min_triggers=10)
        assert pair.t.refold_counts["stale"] >= 1, pair.t.refold_counts
    finally:
        jax_timex.use_real_clock()
        timex.use_real_clock()


@pytest.mark.parametrize("budget", ["zero", "default", "tiny"])
def test_dev_ring_budgets(budget, pairs):
    """tests/test_sliding_device.py TestDevRingBudget on the port: past the
    budget the oldest cached entries are evicted, their refolds take the
    host rows, and every window still equals the reference's; the bytes
    and the evicted entries equal the reference's after every batch."""
    batches = random_trigger_batches(seed=21, n_batches=12, rows=64)
    # one entry: the padded temp column and the uint16 slots
    one_entry = MB * 4 + MB * 2
    budget_bytes = {"zero": 0, "default": None, "tiny": one_entry}[budget]
    pair = run(pairs(SQL_INV, budget_bytes=budget_bytes), batches)
    pair.check(min_triggers=5)
    t = pair.t
    entry = next(e for lst in pair.j._dev_ring.values() for e in lst
                 if e is not None) if budget == "default" else None
    if entry is not None:
        assert pair.j._dev_entry_nbytes(entry) == one_entry
    cached = [e for lst in t._dev_ring.values() for e in lst
              if e is not None]
    counts = t.refold_counts
    if budget == "zero":
        assert t._dev_ring_bytes == 0 and not cached
        assert counts["cached"] == 0 and counts["host"] > 0
        # every entry (one per bucket a batch touches) was evicted
        assert counts["evicted"] == sum(len(lst)
                                        for lst in t._dev_ring.values())
    elif budget == "default":
        assert cached and t._dev_ring_bytes > 0
        assert t._dev_ring_bytes <= t.dev_ring_budget_bytes
        assert counts["evicted"] == 0 and counts["host"] == 0
    else:
        assert len(cached) <= 1
        assert t._dev_ring_bytes <= t.dev_ring_budget_bytes
        assert counts["cached"] > 0 and counts["host"] > 0


def test_capacity_past_65535_caches_both_slot_dtypes(pairs):
    """Batches cached at a key capacity of 32,768 carry uint16 slots; a
    batch that grows it to 65,536 is cached with int32 ones. Windows whose
    edges cut into both are refolded from both dtypes."""
    sql = ("SELECT deviceId, count(*) AS c, max(temp) AS mx FROM s "
           "GROUP BY deviceId, SLIDINGWINDOW(ss, 1) OVER (WHEN temp > 90)")
    rng = np.random.default_rng(37)
    n = 20_000
    keys = np.array([f"k{i}" for i in range(35_000)], dtype=np.object_)

    def batch(t0, span, key_lo, key_hi, trig=()):
        ts = np.sort(rng.integers(t0, t0 + span, n)).astype(np.int64)
        temp = rng.uniform(0, 88, n).astype(np.float32)
        for tv in trig:
            i = int(np.argmin(np.abs(ts - tv)))
            ts[i], temp[i] = tv, 99.0
        # every key of [key_lo, key_hi) once when that range holds n keys
        ids = keys[key_lo + (rng.permutation(n) % (key_hi - key_lo))
                   if key_hi - key_lo == n
                   else rng.integers(key_lo, key_hi, n)]
        return JaxBatch(n=n, columns={"deviceId": ids, "temp": temp},
                        timestamps=ts, emitter="s")

    pair = pairs(sql, capacity=32_768, micro_batch=32_768)
    pair.feed(batch(10_000, 100, 0, 20_000))
    dtypes = {lst[0][1].dtype for lst in pair.t._dev_ring.values()}
    assert dtypes == {torch.uint16}
    pair.feed(batch(10_100, 100, 15_000, 35_000))
    assert pair.t.gb.capacity == pair.j.gb.capacity == 65_536
    # trigger windows (t - 1 s, t]: lo cuts into the first batch (t =
    # 11,050) and into the second (t = 11,150); hi cuts into the third
    pair.feed(batch(11_000, 200, 0, 35_000, trig=(11_050, 11_150)))
    dtypes = {e[1].dtype for lst in pair.t._dev_ring.values() for e in lst}
    assert dtypes == {torch.uint16, torch.int32}
    pair.check(min_triggers=2)
    assert pair.t.refold_counts["cached"] >= 4


# ------------------------------------------------------------ checkpoints
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax",
                                       "daba_to_refold", "refold_to_daba"])
def test_checkpoint_crosses(direction):
    """A checkpoint (JSON round trip) taken in one package or
    implementation restores in the other; the windows after it match an
    uninterrupted JAX refold node's. The device cache is not checkpointed:
    the restored refold node refolds from host rows until new batches are
    cached."""
    sql = SQL_MM
    batches = random_trigger_batches(seed=17, n_batches=30)
    split = 20  # later windows' low edges cut into buckets from before it
    nodes = []
    try:
        ref = jax_node(sql)
        nodes.append(ref)
        want = []
        ref.broadcast = want.append
        for b in batches:
            ref.process(b)
        ref._drain_async_emits()
        n_before = None
        src_impl = "daba" if direction == "daba_to_refold" else "refold"
        dst_impl = "daba" if direction == "refold_to_daba" else "refold"
        if direction == "jax_to_port":
            src, dst = jax_node(sql, src_impl), port_node(sql, dst_impl)
        elif direction == "port_to_jax":
            src, dst = port_node(sql, src_impl), jax_node(sql, dst_impl)
        else:
            src, dst = port_node(sql, src_impl), port_node(sql, dst_impl)
        nodes += [src, dst]
        first = []
        src.broadcast = first.append
        for b in batches[:split]:
            src.process(b if isinstance(src, JaxNode) else _port(b))
        src._drain_async_emits()
        n_before = len(first)
        snap = json.loads(json.dumps(src.snapshot_state()))
        dst.restore_state(snap)
        if isinstance(dst, FusedWindowAggNode) and dst_impl == "refold":
            assert dst._dev_ring_bytes == 0
            assert all(e is None for lst in dst._dev_ring.values()
                       for e in lst)
        got = []
        dst.broadcast = got.append
        for b in batches[split:]:
            dst.process(b if isinstance(dst, JaxNode) else _port(b))
        dst._drain_async_emits()
        assert len(got) == len(want) - n_before >= 3
        for g, r in zip(got, want[n_before:]):
            assert_window(g, r, exact_only=True)
        if isinstance(dst, FusedWindowAggNode) and dst_impl == "refold":
            assert dst.refold_counts["host"] > 0  # pre-restore rows
            assert dst.refold_counts["cached"] > 0  # batches after it
    finally:
        for node in nodes:
            node.on_close()


# -------------------------------------------------------- fold_masked
FOLD_SQL = {
    "scalar": ("SELECT k, count(*) AS c, sum(v) AS s, min(v) AS mn, "
               "max(v) AS mx, stddev(v) AS sd FROM s WHERE v > 12 "
               "GROUP BY k, TUMBLINGWINDOW(ss, 10)"),
    "sketch": ("SELECT k, hll(v) AS u, percentile_approx(v, 0.5) AS p, "
               "count(*) AS c FROM s GROUP BY k, TUMBLINGWINDOW(ss, 10)"),
    "hh": ("SELECT k, heavy_hitters(code, 3) AS top, count(*) AS c FROM s "
           "GROUP BY k, TUMBLINGWINDOW(ss, 10)"),
}


@pytest.mark.parametrize("slots_dtype", ["uint16", "int32"])
@pytest.mark.parametrize("plan", ["scalar", "sketch", "hh"])
def test_fold_masked_matches_reference(plan, slots_dtype):
    """TorchGroupBy.fold_masked (the masked fold kernels' plain versions)
    against DeviceGroupBy.fold_masked: a padded 128-row batch of 90 real
    rows with holes in the mask, a validity mask, WHERE, into pane 3 of 4
    over a state that already holds rows; the padding rows carry slot 0
    and mask 0 and change nothing. Counts, act, min/max and the sketch
    components exact; sums rtol 1e-5."""
    import jax.numpy as jnp

    sql = FOLD_SQL[plan]
    jgb = DeviceGroupBy(jax_plan_of(jax_parse(sql)), capacity=CAP,
                        n_panes=4, micro_batch=MB)
    tgb = TorchGroupBy(extract_kernel_plan(parse_select(sql)), capacity=CAP,
                       n_panes=4, micro_batch=MB, device="cpu")
    rng = np.random.default_rng(5 + len(plan))
    n = 90
    v = rng.normal(20, 5, n).astype(np.float32)
    code = rng.choice([7, 13, 21, 40], n).astype(np.float32)
    cols = {}
    for name in tgb.plan.columns:
        if name.startswith(HLL_COL_PREFIX):
            cols[name] = encode_hll_column(v, n)
        elif name.startswith(HH_COL_PREFIX):
            cols[name] = code  # the dictionary codes, as the node's
        else:
            cols[name] = v
    valid = {"v": rng.random(n) > 0.1} if "v" in cols else {}
    slots = rng.integers(0, 40, n).astype(np.int32)
    js, ts = jgb.init_state(), tgb.init_state()
    js = jgb.fold(js, cols, slots, valid, 3)  # pane 3 already holds rows
    ts = tgb.fold(ts, cols, slots, valid, 3)
    pad = MB - n
    sdt = np.uint16 if slots_dtype == "uint16" else np.int32
    s_pad = np.pad(slots, (0, pad)).astype(sdt)
    mask = np.pad(rng.random(n) > 0.3, (0, pad))
    jcols, tcols = {}, {}
    for name in tgb.plan.columns:
        arr = np.pad(cols[name], (0, pad))
        jcols[name] = jnp.asarray(arr)
        tcols[name] = torch.from_numpy(arr)
        vm = valid.get(name)
        jcols["__valid_" + name] = (None if vm is None
                                    else jnp.asarray(np.pad(vm, (0, pad))))
        tcols["__valid_" + name] = (None if vm is None
                                    else torch.from_numpy(np.pad(vm,
                                                                 (0, pad))))
    js = jgb.fold_masked(js, jcols, jnp.asarray(s_pad), mask, 3)
    ts = tgb.fold_masked(ts, tcols, torch.from_numpy(s_pad), mask, 3)
    got = tgb.state_to_host(ts)
    for comp, r in jgb.state_to_host(js).items():
        if comp in ("s1", "s2"):
            np.testing.assert_allclose(got[comp], r, rtol=1e-5,
                                       err_msg=comp)
        else:
            np.testing.assert_array_equal(got[comp], r, err_msg=comp)
    # nothing reached the other panes, the padding rows' slot 0 included
    for comp, arr in got.items():
        assert (arr[:3] == tgb.init_state()[comp][:3].numpy()).all(), comp
