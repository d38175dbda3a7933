"""Parity of the port's rule group (ekuiper_tpu_torch/parallel/multirule.py,
runtime/nodes_multirule.py, planner/rulegroup.py, through the plain PyTorch
versions of its kernels on the CPU) against the JAX package's
build_rule_batch, BatchedGroupBy and MultiRuleFusedNode, and against R
single-rule TorchGroupBys.

Inputs are made from a seed with numpy and given to both packages; R = 6
rules, 40-200 keys, batches of 500 rows folded in chunks of 128. Rows
sit on the decimal thresholds on purpose (two-decimal data, thresholds
stepping by 0.05): both packages compare the float32 column with float32
parameters. Tolerances, each against the reference:
- params, param names, plan columns, counts, act, min, max, the emitted
  keys: exact (small integer sums; min/max pick an input);
- sum, avg: rtol 1e-5 (float32 scatter-add order differs between XLA and
  torch);
- stddev: rtol 1e-4 plus the absolute floor the cancellation in
  s2/n - mean² leaves where the variance is ~0 (test_torch_groupby.py's:
  16·ε32·mean² in the variance, its square root in the deviation);
- the sketch groups (hll on a hopping window, percentile_approx and
  stddev on a tumbling one, 4 rules at capacity 64): hist counters
  exact; hll registers exact outside the cells a jnp.log2 miss of the
  reference reaches (test_torch_groupby.py's rule: the port reads rho
  from the float exponent); hll estimates within ±1; percentiles the
  same bin centre within 4 ulp (ROADMAP Queue 3 "Numerical bounds").
"""
import gc

import numpy as np
import pytest

from ekuiper_tpu.data.batch import ColumnBatch as JaxBatch
from ekuiper_tpu.ops.emit import build_direct_emit as jax_direct_emit
from ekuiper_tpu.parallel.multirule import BatchedGroupBy as JaxBatched
from ekuiper_tpu.parallel.multirule import build_rule_batch as jax_build
from ekuiper_tpu.runtime.events import EOF as JaxEOF
from ekuiper_tpu.runtime.events import Trigger as JaxTrigger
from ekuiper_tpu.runtime.nodes_multirule import \
    MultiRuleFusedNode as JaxGroupNode
from ekuiper_tpu.sql.parser import parse_select as jax_parse
from ekuiper_tpu.utils import timex as jax_timex
from ekuiper_tpu_torch.data.batch import ColumnBatch
from ekuiper_tpu_torch.ops import kernels
from ekuiper_tpu_torch.ops.aggspec import extract_kernel_plan
from ekuiper_tpu_torch.ops.groupby import TorchGroupBy
from ekuiper_tpu_torch.parallel.multirule import (BatchedGroupBy,
                                                  build_rule_batch)
from ekuiper_tpu_torch.planner.rulegroup import plan_rule_group
from ekuiper_tpu_torch.runtime.events import EOF, Trigger
from ekuiper_tpu_torch.runtime.node import Node
from ekuiper_tpu_torch.sql.parser import parse_select
from ekuiper_tpu_torch.utils import timex
from ekuiper_tpu_torch.utils.infra import PlanError

R, CAP, MB, KEYS = 6, 256, 128, 200
#: the sketch groups: rules, capacity, keys
WR, WCAP, WKEYS = 4, 64, 50
EPS32 = float(np.finfo(np.float32).eps)

#: every scalar kind the group carries, under a two-parameter WHERE
SQL = ("SELECT k, avg(v) AS avg_v, count(*) AS c, sum(w) AS sum_w, "
       "min(v) AS mn, max(v) AS mx, stddev(v) AS sd_v FROM s "
       "WHERE v > {lo} AND w < {hi} GROUP BY k, {window}")
TUMBLING, HOPPING = "TUMBLINGWINDOW(ss, 10)", "HOPPINGWINDOW(ss, 10, 5)"
#: the sketch groups (bench.py's E2 solo sketch rules as families)
HLL_SQL = ("SELECT k, hll(v) AS u, count(*) AS c FROM s WHERE v > {lo} "
           "GROUP BY k, {window}")
PCT_SQL = ("SELECT k, avg(v) AS avg_v, stddev(v) AS sd_v, "
           "percentile_approx(v, 0.9) AS p FROM s WHERE w < {hi} "
           "GROUP BY k, {window}")
WIDE = {"hll-hopping": (HLL_SQL, HOPPING), "pct-tumbling": (PCT_SQL, TUMBLING)}


@pytest.fixture(scope="module", autouse=True)
def _no_cyclic_gc_inside_jax_locks():
    """The JAX package's devwatch registry prunes its weakrefs under a lock
    that a dying watch's __del__ also takes, so a cyclic collection that
    lands inside the prune deadlocks the process. This module builds many
    JAX group-bys: it runs with the cyclic collector off and collects once
    at its end, outside any lock."""
    enabled = gc.isenabled()
    gc.disable()
    yield
    if enabled:
        gc.enable()
    gc.collect()


@pytest.fixture(autouse=True)
def _port_clock():
    """The port's engine clock is a mock one at 0 for each test, as the
    JAX package's is (tests/conftest.py), then real again."""
    yield timex.set_mock_clock(0)
    timex.use_real_clock()


def _sqls(window=TUMBLING, n=R, sql=SQL):
    """Rule i: v > 14 + 0.05 i, w < 0.5 + 0.25 i (on the data's grid)."""
    return [sql.format(lo=14.0 + 0.05 * i, hi=0.5 + 0.25 * i, window=window)
            for i in range(n)]


def _ids(n=R):
    return [f"r{i}" for i in range(n)]


def _specs(sqls):
    return (build_rule_batch(_ids(len(sqls)), [parse_select(q) for q in sqls]),
            jax_build(_ids(len(sqls)), [jax_parse(q) for q in sqls]))


def _batch(rng, n=500, keys=KEYS):
    """Two-decimal values, as a JSON source decodes them: many rows sit
    exactly on a threshold of the 0.05 grid."""
    cols = {"v": rng.normal(20, 5, n).round(2),
            "w": rng.normal(1, 1, n).round(2)}
    slots = rng.integers(0, keys, n).astype(np.int32)
    return cols, slots


# ------------------------------------------------------ (a) build_rule_batch
BATCH_CASES = {
    "one-param": ["SELECT k, avg(v) AS a FROM s WHERE v > {x} "
                  "GROUP BY k, TUMBLINGWINDOW(ss, 10)"] * 3,
    "two-params": [SQL.format(lo=1, hi=2, window=TUMBLING),
                   SQL.format(lo=3.5, hi=-4, window=TUMBLING)],
    "between-case-unary": [
        "SELECT k, count(*) AS c FROM s WHERE v BETWEEN {x} AND 30 AND "
        "CASE WHEN w > 0 THEN -v ELSE v END < {x} "
        "GROUP BY k, TUMBLINGWINDOW(ss, 10)"] * 2,
    "no-where": ["SELECT k, max(v) AS m FROM s "
                 "GROUP BY k, HOPPINGWINDOW(ss, 10, 5)"] * 2,
    "heterogeneous": [SQL.format(lo=1, hi=2, window=TUMBLING),
                      "SELECT k, sum(v) AS a FROM s "
                      "GROUP BY k, TUMBLINGWINDOW(ss, 10)"],
    "where-shape-differs": ["SELECT k, avg(v) AS a FROM s WHERE v > 1 "
                            "GROUP BY k, TUMBLINGWINDOW(ss, 10)",
                            "SELECT k, avg(v) AS a FROM s WHERE v > 1 "
                            "AND v < 9 GROUP BY k, TUMBLINGWINDOW(ss, 10)"],
    "heavy-hitters": ["SELECT k, heavy_hitters(c, 3) AS t FROM s "
                      "WHERE v > {x} GROUP BY k, TUMBLINGWINDOW(ss, 10)"] * 2,
    "not-device": ["SELECT k, collect(v) AS a FROM s WHERE v > {x} "
                   "GROUP BY k, TUMBLINGWINDOW(ss, 10)"] * 2,
    "empty": [],
}


@pytest.mark.parametrize("case", list(BATCH_CASES))
def test_build_rule_batch_matches_reference(case):
    """The canonical statement, params (float32 (R, P)), param names and
    plan columns equal the reference's; a group it refuses, the port
    refuses with the same message."""
    sqls = [q.replace("{x}", str(10 + 2.5 * i))
            for i, q in enumerate(BATCH_CASES[case])]
    stmts = [parse_select(q) for q in sqls]
    jstmts = [jax_parse(q) for q in sqls]
    try:
        ref = jax_build(_ids(len(sqls)), jstmts)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            build_rule_batch(_ids(len(sqls)), stmts)
        assert str(got.value) == str(exc)
        return
    spec = build_rule_batch(_ids(len(sqls)), stmts)
    assert spec.params.dtype == np.float32 == ref.params.dtype
    np.testing.assert_array_equal(spec.params, ref.params)
    assert spec.param_names == ref.param_names
    assert spec.plan.columns == ref.plan.columns
    assert not any(c.startswith("__param_") for c in spec.plan.columns)
    assert repr(spec.stmt.condition) == repr(ref.stmt.condition)
    assert spec.rule_ids == ref.rule_ids


# ------------------------------------------------------- (b) BatchedGroupBy
def _assert_state(got: dict, ref: dict):
    assert set(got) == set(ref)
    for comp in ref:
        g, r = got[comp], np.asarray(ref[comp])
        assert g.shape == r.shape and g.dtype == r.dtype, comp
        if comp in ("s1", "s2"):
            np.testing.assert_allclose(g, r, rtol=1e-5, err_msg=comp)
        else:
            np.testing.assert_array_equal(g, r, err_msg=comp)


def _assert_outs(specs, got, ref):
    """Per-spec (R, n_keys) arrays; `ref[0]` is avg(v), the deviation's
    mean."""
    floor = 16 * EPS32 * np.nan_to_num(np.asarray(ref[0])) ** 2
    for spec, g, r in zip(specs, got, ref):
        g, r = np.asarray(g), np.asarray(r)
        assert g.shape == r.shape and g.dtype == r.dtype, spec.kind
        if spec.kind in ("count", "min", "max"):
            np.testing.assert_array_equal(g, r, err_msg=spec.kind)
        elif spec.kind in ("sum", "avg"):
            np.testing.assert_allclose(g, r, rtol=1e-5, equal_nan=True,
                                       err_msg=spec.kind)
        else:
            assert (np.isnan(g) == np.isnan(r)).all(), spec.kind
            ok = np.isnan(r) | (np.abs(g - r) <= 1e-4 * np.abs(r)
                                + np.sqrt(floor))
            assert ok.all(), (spec.kind, g[~ok], r[~ok])


def _groupbys(window, cap=CAP, sql=SQL):
    spec, jspec = _specs(_sqls(window, sql=sql))
    n_panes = 2 if window == HOPPING else 1
    tgb = BatchedGroupBy(spec, capacity=cap, n_panes=n_panes,
                         micro_batch=MB, device="cpu")
    jgb = JaxBatched(jspec, capacity=cap, n_panes=n_panes, micro_batch=MB)
    return tgb, jgb


def _fold_both(tgb, jgb, ts, js, rng, panes, keys=KEYS):
    for pane in panes:
        cols, slots = _batch(rng, keys=keys)
        ts = tgb.fold(ts, cols, slots, pane_idx=pane)
        js = jgb.fold(js, cols, slots, pane_idx=pane)
    return ts, js


@pytest.mark.parametrize("window", [TUMBLING, HOPPING],
                         ids=["tumbling", "hopping"])
def test_batched_groupby_matches_reference(window):
    """Fold (over chunks, into both panes), then finalize under the full
    and a subset mask, then reset: state and outputs equal the JAX
    BatchedGroupBy's, every rule."""
    rng = np.random.default_rng(1)
    tgb, jgb = _groupbys(window)
    panes = [0, 0] if window == TUMBLING else [0, 1, 1]
    ts, js = _fold_both(tgb, jgb, tgb.init_state(), jgb.init_state(), rng,
                        panes)
    assert ts["act"].shape == (R, tgb.n_panes, CAP)
    _assert_state(tgb.state_to_host(ts), jgb.state_to_host(js))
    for mask in [None] + ([[1]] if window == HOPPING else []):
        got, got_act = tgb.finalize(ts, KEYS, mask)
        ref, ref_act = jgb.finalize(js, KEYS, mask)
        assert got_act.shape == (R, KEYS)
        np.testing.assert_array_equal(got_act, ref_act)
        _assert_outs(tgb.plan.specs, got, ref)
    # the rules' parameters select different rows
    assert (got_act[0] != got_act[-1]).any() and got_act.sum() > 0
    last = tgb.n_panes - 1
    ts, js = tgb.reset_pane(ts, last), jgb.reset_pane(js, last)
    _assert_state(tgb.state_to_host(ts), jgb.state_to_host(js))


@pytest.mark.parametrize("where", ["params", "no-params", "no-where"])
def test_batched_groupby_matches_single_rules(where):
    """Each rule of the group equals its own single-rule TorchGroupBy fed
    the same rows; a WHERE without literals, or none, broadcasts to every
    rule."""
    sql = {"params": SQL,
           "no-params": SQL.replace("v > {lo} AND w < {hi}", "v > w"),
           "no-where": SQL.replace(" WHERE v > {lo} AND w < {hi}", "")}[where]
    sqls = _sqls(HOPPING, sql=sql)
    spec, _ = _specs(sqls)
    tgb = BatchedGroupBy(spec, capacity=CAP, n_panes=2, micro_batch=MB,
                         device="cpu")
    singles = [TorchGroupBy(extract_kernel_plan(parse_select(q)),
                            capacity=CAP, n_panes=2, micro_batch=MB,
                            device="cpu") for q in sqls]
    rng = np.random.default_rng(2)
    ts = tgb.init_state()
    ss = [g.init_state() for g in singles]
    for pane in (0, 1, 0):
        cols, slots = _batch(rng)
        ts = tgb.fold(ts, cols, slots, pane_idx=pane)
        ss = [g.fold(s, cols, slots, pane_idx=pane)
              for g, s in zip(singles, ss)]
    got, got_act = tgb.finalize(ts, KEYS)
    for r, (g, s) in enumerate(zip(singles, ss)):
        ref, ref_act = g.finalize(s, KEYS)
        np.testing.assert_array_equal(got_act[r], ref_act)
        _assert_outs(tgb.plan.specs, [o[r] for o in got], ref)
    if where != "params":
        assert (got_act == got_act[0]).all()


def test_batched_grow_and_key_cut_match_reference():
    """Keys past the capacity grow the state on its capacity axis, as the
    reference's does; the finalize writes only the power-of-two cut of the
    live keys (floor 1024), which the host slices to n_keys."""
    rng = np.random.default_rng(3)
    tgb, jgb = _groupbys(TUMBLING, cap=1024)
    ts, js = _fold_both(tgb, jgb, tgb.init_state(), jgb.init_state(), rng,
                        [0], keys=1000)
    ts, js = tgb.grow(ts, 4096), jgb.grow(js, 4096)
    assert tgb.capacity == jgb.capacity == 4096
    assert ts["n"].shape[:3] == (R, 1, 4096)
    ts, js = _fold_both(tgb, jgb, ts, js, rng, [0], keys=1500)
    _assert_state(tgb.state_to_host(ts), jgb.state_to_host(js))
    assert tgb._slice_keys(1500) == 2048 == jgb._slice_keys(1500)
    out = tgb._finalize_rules(ts, 1500)
    assert tuple(out.shape) == (R, len(tgb.plan.specs) + 1, 2048)
    got, got_act = tgb.finalize(ts, 1500)
    ref, ref_act = jgb.finalize(js, 1500)
    np.testing.assert_array_equal(got_act, ref_act)
    _assert_outs(tgb.plan.specs, got, ref)


# ------------------------------------------------------ (c) the group nodes
class _Sink(Node):
    """A rule's downstream node in the port."""

    def __init__(self, name):
        super().__init__(name)
        self.got = []

    def process(self, item):
        self.got.append(item)


class _JaxSink:
    """A rule's downstream node in the JAX package (its put() interface)."""

    def __init__(self):
        self.got = []
        self._input_names = set()

    def put(self, item, *_):
        self.got.append(item)


class _Groups:
    """The port's group node and the JAX package's, each rule routed to its
    own sink; both get the same batches and the same triggers by hand."""

    def __init__(self, window, keys=40, sqls=None, cap=CAP):
        sqls = _sqls(window) if sqls is None else sqls
        self.rule_ids = _ids(len(sqls))
        self.tnode = plan_rule_group(self.rule_ids, sqls, key_slots=cap,
                                     micro_batch=MB, device="cpu")
        _, jspec = _specs(sqls)
        stmt = jax_parse(sqls[0])
        self.jnode = JaxGroupNode(
            "ref", stmt.window, jspec, [d.expr for d in stmt.dimensions],
            capacity=cap, micro_batch=MB,
            direct_emit=jax_direct_emit(jspec.stmt, jspec.plan, ["k"]),
            emit_columnar=True)
        self.tsinks = {rid: _Sink(rid) for rid in self.rule_ids}
        self.jsinks = {rid: _JaxSink() for rid in self.rule_ids}
        for rid in self.rule_ids:
            self.tnode.add_rule_output(rid, self.tsinks[rid])
            self.jnode.add_rule_output(rid, self.jsinks[rid])
        # the JAX node's state exists once it is opened (its timers sit on
        # the test's mock clock, which nothing moves)
        self.jnode.on_open()
        self.interval = self.tnode._tick_interval()
        self.rng = np.random.default_rng(4)
        self.ids = np.array([f"d{i}" for i in range(keys)], dtype=object)

    def feed(self, n_batches=2, keys=None):
        for _ in range(n_batches):
            cols, slots = _batch(self.rng, keys=len(self.ids))
            cols["k"] = self.ids[slots]
            if self.tnode.wt.name == "STATE_WINDOW":
                # the state windows' toggle column (about 5 rows a batch)
                cols["st"] = (self.rng.random(len(slots)) < 0.01).astype(
                    np.int64)
            self.tnode.process(ColumnBatch(n=len(slots), columns=dict(cols),
                                           emitter="s"))
            self.jnode.process(JaxBatch(n=len(slots), columns=dict(cols),
                                        emitter="s"))

    def trigger(self, w):
        ts = (w + 1) * self.interval
        self.tnode.on_trigger(Trigger(ts=ts))
        self.jnode.on_trigger(JaxTrigger(ts=ts))

    def drain(self):
        self.tnode._drain_async_emits()
        self.jnode._drain_async_emits()

    def close(self):
        """Stop both nodes' timers and emit workers, then move the test's
        JAX mock clock past the stopped timers: it would keep them, and
        the JAX node with them, as long as the clock lives."""
        self.tnode.on_close()
        self.jnode.on_close()
        jax_timex.get_mock_clock().advance(60_000)


@pytest.fixture
def groups():
    """_Groups factory; every pair made is closed at teardown, so no emit
    worker thread outlives its test."""
    made = []

    def make(window, **kw):
        made.append(_Groups(window, **kw))
        return made[-1]

    yield make
    for g in made:
        g.close()
    # the last test holds this fixture's value past the module's
    # collection: empty it, so the JAX groups die in that collection and
    # not later, inside another module's devwatch lock
    made.clear()


def _assert_rule_windows(got, ref):
    """One rule's emitted windows: same keys in the same order, values
    within the module's tolerances."""
    assert len(got) == len(ref) > 0
    for g_item, r_item in zip(got, ref):
        assert list(g_item.columns) == list(r_item.columns)
        np.testing.assert_array_equal(g_item.timestamps, r_item.timestamps)
        col = {k: np.asarray(v) for k, v in r_item.columns.items()}
        for name, rv in col.items():
            gv = np.asarray(g_item.columns[name])
            assert gv.shape == rv.shape, name
            if name in ("k", "c", "mn", "mx"):
                np.testing.assert_array_equal(gv, rv, err_msg=name)
            elif name == "u":  # hll: within ±1
                assert (np.abs(gv - rv) <= 1).all(), name
            elif name == "p":  # percentile: the same bin centre
                np.testing.assert_allclose(gv, rv, rtol=4 * 2.0 ** -23,
                                           err_msg=name)
            elif name == "sd_v":
                floor = np.sqrt(16 * EPS32) * np.abs(col["avg_v"])
                assert (np.abs(gv - rv) <= 1e-4 * np.abs(rv) + floor).all()
            else:
                np.testing.assert_allclose(gv, rv, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("window", [TUMBLING, HOPPING],
                         ids=["tumbling", "hopping"])
def test_group_node_matches_reference(groups, window):
    """Three boundaries by hand (the tumbling group's on the emit worker,
    the hopping group's synchronously), then EOF: every rule's sink
    receives the reference's windows, and the EOF."""
    g = groups(window)
    assert g.tnode._async_mr == g.jnode._async_mr == (window == TUMBLING)
    for w in range(3):
        g.feed()
        g.trigger(w)
    g.drain()
    source = "device-async" if window == TUMBLING else "sync"
    assert g.tnode.last_emit_info["source"] == source
    g.feed()
    g.tnode.on_eof(EOF())
    g.jnode.on_eof(JaxEOF())
    g.drain()
    for rid in _ids():
        got, ref = g.tsinks[rid].got, g.jsinks[rid].got
        assert isinstance(got[-1], EOF) and isinstance(ref[-1], JaxEOF)
        assert len(got) == 5  # three boundaries, the EOF flush, the EOF
        _assert_rule_windows(got[:-1], ref[:-1])
    rows = [sum(int(cb.columns["c"].sum()) for cb in g.tsinks[rid].got[:-1])
            for rid in _ids()]
    assert rows[0] > 0 and rows != [rows[0]] * R  # the rules differ


@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
def test_group_checkpoint_crosses_packages(groups, direction):
    """A hopping group's snapshot in the middle of a window, taken by one
    package, restores into a fresh node of each package: both then emit
    the windows the uninterrupted nodes emit."""
    g = groups(HOPPING)
    g.feed()
    g.trigger(0)
    g.feed()
    snap = (g.tnode if direction == "port-to-jax" else g.jnode
            ).snapshot_state()
    assert np.asarray(snap["partials"]["act"]).shape == (R, 2, CAP)
    fresh = groups(HOPPING)
    fresh.tnode.restore_state(snap)
    fresh.jnode.restore_state(snap)
    for pair in (g, fresh):
        pair.rng = np.random.default_rng(5)
        pair.feed()
        pair.trigger(1)
        pair.feed()
        pair.trigger(2)
        pair.drain()
    for rid in _ids():
        _assert_rule_windows(fresh.tsinks[rid].got, g.tsinks[rid].got[-2:])
        _assert_rule_windows(fresh.jsinks[rid].got, g.jsinks[rid].got[-2:])
        _assert_rule_windows(fresh.tsinks[rid].got, fresh.jsinks[rid].got)


# ------------------------------------------------------------ the planner
PLAN_CASES = {
    "empty": ([], PlanError),
    "two-sources": (["SELECT k, avg(v) AS a FROM s WHERE v > 1 "
                     "GROUP BY k, TUMBLINGWINDOW(ss, 10)",
                     "SELECT k, avg(v) AS a FROM t WHERE v > 2 "
                     "GROUP BY k, TUMBLINGWINDOW(ss, 10)"], PlanError),
    "heterogeneous": ([SQL.format(lo=1, hi=2, window=TUMBLING),
                       SQL.format(lo=1, hi=2, window=HOPPING)], PlanError),
    "heavy-hitters": (["SELECT k, heavy_hitters(c, 3) AS t FROM s WHERE "
                       f"v > {x} GROUP BY k, TUMBLINGWINDOW(ss, 10)"
                       for x in (1, 2)], PlanError),
    "hll": (["SELECT k, hll(v) AS u FROM s WHERE v > "
             f"{x} GROUP BY k, TUMBLINGWINDOW(ss, 10)" for x in (1, 2)],
            None),
    "percentile": (["SELECT k, percentile_approx(v, 0.5) AS p FROM s WHERE "
                    f"v > {x} GROUP BY k, HOPPINGWINDOW(ss, 10, 5)"
                    for x in (1, 2)], None),
    "sliding": (["SELECT k, avg(v) AS a FROM s WHERE v > "
                 f"{x} GROUP BY k, SLIDINGWINDOW(ss, 10) OVER (WHEN v > 90)"
                 for x in (1, 2)], NotImplementedError),
    "option": ([SQL.format(lo=1, hi=2, window=TUMBLING)] * 2, PlanError),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_rule_group_refusals(case):
    """The reference's refusals raise PlanError; a group the port does not
    run yet raises NotImplementedError (each is a ROADMAP line). The
    sketch groups (hll, percentile_approx) were refused until the batched
    wide fold and finalize were ported: they now plan (exc None)."""
    sqls, exc = PLAN_CASES[case]
    opts = {"tailMode": "sideways"} if case == "option" else None
    if exc is None:
        node = plan_rule_group(_ids(len(sqls)), sqls, key_slots=64,
                               micro_batch=64, device="cpu", options=opts)
        assert node.gb.n_rules == len(sqls) and len(node.gb._widemap)
        return
    with pytest.raises(exc):
        plan_rule_group(_ids(len(sqls)), sqls, key_slots=64, micro_batch=64,
                        device="cpu", options=opts)


def test_group_kernels_count_one_launch_each(groups):
    """One fold launch per chunk, one finalize and one reset per boundary,
    whatever the number of rules (the CPU state takes the plain versions,
    which count nothing: the counts stay at 0 here)."""
    g = groups(TUMBLING)
    kernels.reset_launches()
    g.feed(1)
    g.trigger(0)
    g.drain()
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)
    assert sum(cb.n for s in g.tsinks.values() for cb in s.got) > 0


# ------------------------------------------------------- (d) sketch groups
def _wide_groupbys(name):
    sql, window = WIDE[name]
    sqls = _sqls(window, n=WR, sql=sql)
    spec, jspec = _specs(sqls)
    n_panes = 2 if window == HOPPING else 1
    tgb = BatchedGroupBy(spec, capacity=WCAP, n_panes=n_panes,
                         micro_batch=MB, device="cpu")
    jgb = JaxBatched(jspec, capacity=WCAP, n_panes=n_panes, micro_batch=MB)
    return tgb, jgb


def _wide_miss_cells(tgb, cols, slots, pane):
    """(pane, slot, k, register) cells a value reaches whose rho the
    reference's jnp.log2 misses (test_torch_groupby.py's rule), for every
    rule of the group."""
    from test_torch_groupby import _hll_miss_cells

    return _hll_miss_cells(tgb, cols, slots, pane)


def _assert_wide_state(got, ref, miss):
    assert set(got) == set(ref)
    for comp in ref:
        g, r = got[comp], np.asarray(ref[comp])
        assert g.shape == r.shape and g.dtype == r.dtype, comp
        if comp in ("s1", "s2"):
            np.testing.assert_allclose(g, r, rtol=1e-5, err_msg=comp)
            continue
        if comp == "hll":
            g, r = g.copy(), r.copy()
            for pane, slot, k, reg in miss:
                g[:, pane, slot, k, reg] = r[:, pane, slot, k, reg] = 0.0
        np.testing.assert_array_equal(g, r, err_msg=comp)


def _assert_wide_outs(specs, got, ref):
    """Every spec's (R, n_keys) output: the sketch kinds within their
    bounds, the scalar ones as _assert_outs holds them."""
    scalar = [i for i, s in enumerate(specs)
              if s.kind not in ("hll", "percentile_approx")]
    _assert_outs([specs[i] for i in scalar], [got[i] for i in scalar],
                 [ref[i] for i in scalar])
    for spec, g, r in zip(specs, got, ref):
        g, r = np.asarray(g), np.asarray(r)
        assert g.shape == r.shape and g.dtype == r.dtype, spec.kind
        if spec.kind == "hll":
            assert np.abs(g - r).max() <= 1
        elif spec.kind == "percentile_approx":
            assert (np.isnan(g) == np.isnan(r)).all()
            np.testing.assert_allclose(g, r, rtol=4 * 2.0 ** -23)


@pytest.mark.parametrize("name", list(WIDE))
def test_batched_wide_matches_reference(name):
    """The plain multirule_fold_wide and multirule_finalize_wide (with the
    scalar fold and finalize beside them) against the JAX BatchedGroupBy's
    _batched_fold_impl / _batched_finalize_impl: hll registers and hist
    counters equal, every rule's final values within the module's
    bounds, under the full and a subset pane mask; then a grow and a
    pane reset over the wide state."""
    rng = np.random.default_rng(7)
    tgb, jgb = _wide_groupbys(name)
    ts, js, miss = tgb.init_state(), jgb.init_state(), set()
    for pane in ([0, 1, 1] if tgb.n_panes == 2 else [0, 0]):
        cols, slots = _batch(rng, keys=WKEYS)
        ts = tgb.fold(ts, cols, slots, pane_idx=pane)
        js = jgb.fold(js, cols, slots, pane_idx=pane)
        miss |= _wide_miss_cells(tgb, cols, slots, pane)
    wide = "hll" if name.startswith("hll") else "hist"
    assert ts[wide].shape[:3] == (WR, tgb.n_panes, WCAP)
    _assert_wide_state(tgb.state_to_host(ts), jgb.state_to_host(js), miss)
    for mask in [None] + ([[1]] if tgb.n_panes == 2 else []):
        got, got_act = tgb.finalize(ts, WKEYS, mask)
        ref, ref_act = jgb.finalize(js, WKEYS, mask)
        np.testing.assert_array_equal(got_act, ref_act)
        _assert_wide_outs(tgb.plan.specs, got, ref)
    assert (got_act[0] != got_act[-1]).any()  # the rules differ
    ts, js = tgb.grow(ts, 2 * WCAP), jgb.grow(js, 2 * WCAP)
    last = tgb.n_panes - 1
    ts, js = tgb.reset_pane(ts, last), jgb.reset_pane(js, last)
    _assert_wide_state(tgb.state_to_host(ts), jgb.state_to_host(js), miss)


@pytest.mark.parametrize("name", list(WIDE))
def test_batched_wide_matches_single_rules(name):
    """Each rule of a sketch group equals its own single-rule TorchGroupBy
    (groupby_fold_wide, groupby_finalize_wide) fed the same rows: the
    batched registers, bins and final values bit for bit."""
    sql, window = WIDE[name]
    sqls = _sqls(window, n=WR, sql=sql)
    spec, _ = _specs(sqls)
    n_panes = 2 if window == HOPPING else 1
    tgb = BatchedGroupBy(spec, capacity=WCAP, n_panes=n_panes,
                         micro_batch=MB, device="cpu")
    singles = [TorchGroupBy(extract_kernel_plan(parse_select(q)),
                            capacity=WCAP, n_panes=n_panes, micro_batch=MB,
                            device="cpu") for q in sqls]
    rng = np.random.default_rng(8)
    ts = tgb.init_state()
    ss = [g.init_state() for g in singles]
    for pane in range(n_panes):
        cols, slots = _batch(rng, keys=WKEYS)
        ts = tgb.fold(ts, cols, slots, pane_idx=pane)
        ss = [g.fold(s, cols, slots, pane_idx=pane)
              for g, s in zip(singles, ss)]
    got, got_act = tgb.finalize(ts, WKEYS)
    for r, (g, s) in enumerate(zip(singles, ss)):
        for comp in ("hll", "hist"):
            if comp in s:
                np.testing.assert_array_equal(ts[comp][r].numpy(),
                                              s[comp].numpy())
        ref, ref_act = g.finalize(s, WKEYS)
        np.testing.assert_array_equal(got_act[r], ref_act)
        for i, spec in enumerate(tgb.plan.specs):
            if spec.kind in ("hll", "percentile_approx"):
                np.testing.assert_array_equal(got[i][r], ref[i])


@pytest.mark.parametrize("name", list(WIDE))
def test_wide_group_node_matches_reference(groups, name):
    """A 4-rule sketch group at capacity 64 (the tumbling one delivering
    on the emit worker, the hopping one synchronously), three boundaries
    and EOF: every rule's sink receives the reference's windows."""
    sql, window = WIDE[name]
    g = groups(window, sqls=_sqls(window, n=WR, sql=sql), cap=WCAP)
    for w in range(3):
        g.feed()
        g.trigger(w)
    g.drain()
    g.feed()
    g.tnode.on_eof(EOF())
    g.jnode.on_eof(JaxEOF())
    g.drain()
    for rid in g.rule_ids:
        got, ref = g.tsinks[rid].got, g.jsinks[rid].got
        assert len(got) == 5 and isinstance(got[-1], EOF)
        _assert_rule_windows(got[:-1], ref[:-1])


@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
def test_wide_group_checkpoint_crosses_packages(groups, direction):
    """A hopping hll group's snapshot in the middle of a window, taken by
    one package, restores into a fresh node of each package (registers
    (R, panes, cap, 1, 256)): both then emit what the uninterrupted nodes
    emit."""
    sql, window = WIDE["hll-hopping"]
    sqls = _sqls(window, n=WR, sql=sql)
    g = groups(window, sqls=sqls, cap=WCAP)
    g.feed()
    g.trigger(0)
    g.feed()
    snap = (g.tnode if direction == "port-to-jax" else g.jnode
            ).snapshot_state()
    assert np.asarray(snap["partials"]["hll"]).shape == (WR, 2, WCAP, 1, 256)
    fresh = groups(window, sqls=sqls, cap=WCAP)
    fresh.tnode.restore_state(snap)
    fresh.jnode.restore_state(snap)
    for pair in (g, fresh):
        pair.rng = np.random.default_rng(5)
        pair.feed()
        pair.trigger(1)
        pair.feed()
        pair.trigger(2)
        pair.drain()
    for rid in g.rule_ids:
        _assert_rule_windows(fresh.tsinks[rid].got, g.tsinks[rid].got[-2:])
        _assert_rule_windows(fresh.jsinks[rid].got, g.jsinks[rid].got[-2:])
        _assert_rule_windows(fresh.tsinks[rid].got, fresh.jsinks[rid].got)


# ----------------------------------------- (e) groups on the row windows
ROW_GROUPS = {
    # the count is of the stream's rows, before each rule's WHERE (the
    # reference's group applies no single-rule window gate)
    "count": "COUNTWINDOW(300)",
    "session": "SESSIONWINDOW(ss, 10, 2)",
    "state": "STATEWINDOW(st = 1, st = 0)",
}


@pytest.mark.parametrize("case", list(ROW_GROUPS))
def test_row_window_group_matches_reference(groups, case):
    """A group of the module's rules (a WHERE literal per rule) on a count,
    session or state window, against the JAX group node, which runs these
    shapes through the fused node's paths it inherits: every rule's
    windows equal, emitted synchronously at the window's edge."""
    window = ROW_GROUPS[case]
    g = groups(window)
    clock = timex.get_mock_clock()
    jclock = jax_timex.get_mock_clock()
    for b in range(6):
        t = 700 * (b + 1) if b < 4 else 9000 + 500 * b
        jclock.set(t)
        _pump(g.jnode)
        clock.set(t)
        g.feed(1)
    g.tnode.on_eof(EOF())
    g.jnode.on_eof(JaxEOF())
    for rid in _ids():
        got, ref = g.tsinks[rid].got, g.jsinks[rid].got
        assert isinstance(got[-1], EOF) and isinstance(ref[-1], JaxEOF)
        _assert_rule_windows(got[:-1], ref[:-1])
    assert g.tnode.last_emit_info["source"] == "sync"
    if case == "count":
        # 3,000 rows of the stream, 300 a window: ten windows, each rule's
        # keys from fewer rows past its own WHERE
        assert all(len(g.tsinks[rid].got) == 11 for rid in _ids())
        assert all(0 < int(cb.columns["c"].sum()) < 300
                   for cb in g.tsinks["r0"].got[:-1])
    if case == "session":
        # the gap closed the first session at 2.8 s + 2 s, EOF the second
        assert [int(w.timestamps[0]) for w in g.tsinks["r0"].got[:-1]] == \
            [4800, 11_500]


def _pump(jnode):
    """Hand the JAX node's queued control events (its timers') to its
    dispatch, as its worker thread would."""
    import queue

    while True:
        try:
            item = jnode.inq.get_nowait()
        except queue.Empty:
            return
        jnode._dispatch(item)
        jnode.inq.task_done()


def test_state_group_restore_keeps_the_open_window(groups):
    """A state group's snapshot inside an open window: the port's group
    restores the open window (the fused node's restore), the JAX group's
    restore (MultiRuleFusedNode.restore_state) drops it, a fault of the
    reference the port does not copy (ROADMAP Queue 3). Both keep the
    partials."""
    g = groups(ROW_GROUPS["state"])
    g.feed(4)
    while not g.tnode._state_open:
        g.feed(1)
    assert g.jnode._state_open
    snap = g.tnode.snapshot_state()
    assert snap["state_open"] is True
    fresh = groups(ROW_GROUPS["state"])
    fresh.tnode.restore_state(snap)
    fresh.jnode.restore_state(snap)
    assert fresh.tnode._state_open and not fresh.jnode._state_open
    np.testing.assert_array_equal(
        fresh.tnode.gb.state_to_host(fresh.tnode.state)["act"],
        np.asarray(fresh.jnode.gb.state_to_host(fresh.jnode.state)["act"]))
