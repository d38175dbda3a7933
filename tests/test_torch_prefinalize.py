"""Parity of the port's latency-hiding window emit (ekuiper_tpu_torch
ops/prefinalize.py, the components / absorb kernels' plain versions, the
fused node's boundary machinery) against the JAX package on the CPU.

Inputs are made from a seed with numpy and given to both packages.
Tolerances, each against the JAX result:
- pane-merged components and absorbed state: exact, except s1/s2 within
  rtol 1e-5 (the states are handed from the JAX package to the port, so
  only the merge itself is compared);
- the port's HostShadow against the port's own plain fold: counts, act,
  min/max, hll registers, hist and hh counters bit-equal; s1/s2 rtol 1e-5
  (float64 bincount weights added into float32, against a float32
  scatter-add);
- the port's HostShadow against the JAX package's: the same, except the
  cells a value reaches by another sketch rule (the reference's shadow
  takes hist bins from an eagerly divided numpy log and rho from np.log2;
  the port's follows its fold, PERF.md); those cells are counted and left
  out;
- numpy final values of identical components: bit-equal;
- emitted rows of the two packages' nodes: as tests/test_torch_pipeline.py
  (keys, counts, min/max exact; avg rtol 1e-5; stddev rtol 1e-4 plus the
  cancellation floor).
"""
import gc
import queue

import numpy as np
import pytest
import torch

from ekuiper_tpu.data.batch import ColumnBatch as JaxBatch
from ekuiper_tpu.ops import prefinalize as jpf
from ekuiper_tpu.ops.aggspec import extract_kernel_plan as jax_plan_of
from ekuiper_tpu.ops.emit import build_direct_emit as jax_direct_emit
from ekuiper_tpu.ops.groupby import DeviceGroupBy
from ekuiper_tpu.runtime.events import EOF as JaxEOF
from ekuiper_tpu.runtime.nodes_fused import FusedWindowAggNode as JaxNode
from ekuiper_tpu.sql.parser import parse_select as jax_parse
from ekuiper_tpu.utils import timex as jax_timex
from ekuiper_tpu_torch.data.batch import ColumnBatch
from ekuiper_tpu_torch.ops import kernels
from ekuiper_tpu_torch.ops import prefinalize as pf
from ekuiper_tpu_torch.ops.aggspec import (extract_kernel_plan,
                                           materialize_hll_columns)
from ekuiper_tpu_torch.ops.emit import build_direct_emit
from ekuiper_tpu_torch.ops.groupby import TorchGroupBy
from ekuiper_tpu_torch.planner.fused import plan_fused_rule
from ekuiper_tpu_torch.runtime.events import EOF
from ekuiper_tpu_torch.runtime.nodes_fused import FusedWindowAggNode
from ekuiper_tpu_torch.sql.parser import parse_select
from ekuiper_tpu_torch.utils import timex

from test_torch_pipeline import _assert_same_windows, _rows

CAP, MB, KEYS = 64, 256, 50
SQL = {
    "scalar": ("SELECT k, count(*) AS c, sum(v) AS s, min(v) AS mn, "
               "max(v) AS mx, stddev(v) AS sd, count(v) FILTER "
               "(WHERE w > 0) AS cf FROM s WHERE v > 12 OR w < 0 "
               "GROUP BY k, TUMBLINGWINDOW(ss, 10)"),
    "hopping": ("SELECT k, avg(v) AS a, max(v) AS mx, stddev(v) AS sd "
                "FROM s GROUP BY k, HOPPINGWINDOW(ss, 10, 5)"),
    "hll": ("SELECT k, hll(v) AS u, count(*) AS c FROM s "
            "GROUP BY k, HOPPINGWINDOW(ss, 10, 5)"),
    "hist": ("SELECT k, percentile_approx(v, 0.9) AS p, min(v) AS mn "
             "FROM s GROUP BY k, TUMBLINGWINDOW(ss, 10)"),
    "hh": ("SELECT k, heavy_hitters(code, 3) AS top, count(*) AS c "
           "FROM s GROUP BY k, TUMBLINGWINDOW(ss, 10)"),
}
N_PANES = {"scalar": 1, "hopping": 2, "hll": 2, "hist": 1, "hh": 1}


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


def _cols(rng, n, keys=KEYS):
    v = rng.normal(20, 5, n).astype(np.float32)
    v[rng.random(n) < 0.05] = np.nan
    p = rng.random(n)
    code = np.where(p < 0.35, 7, np.where(p < 0.55, 13, rng.integers(
        100, 400, n))).astype(np.float32)
    cols = {"v": v, "w": rng.normal(0, 1, n).astype(np.float32),
            "__hhc__code": code}
    return cols, rng.integers(0, keys, n).astype(np.int32)


def _groupbys(name, cap=CAP):
    sql = SQL[name]
    jgb = DeviceGroupBy(jax_plan_of(jax_parse(sql)), capacity=cap,
                        n_panes=N_PANES[name], micro_batch=MB)
    tgb = TorchGroupBy(extract_kernel_plan(parse_select(sql)), capacity=cap,
                       n_panes=N_PANES[name], micro_batch=MB, device="cpu")
    return jgb, tgb


def _jax_state(jgb, seed):
    """A JAX state with rows in every pane, and the same state handed to
    the port."""
    rng = np.random.default_rng(seed)
    js = jgb.init_state()
    for pane in range(jgb.n_panes):
        cols, slots = _cols(rng, 300)
        cols = materialize_hll_columns(jgb.plan.columns, cols, len(slots))
        js = jgb.fold(js, {k: cols[k] for k in jgb.plan.columns}, slots,
                      None, pane)
    return js, jgb.state_to_host(js)


def _assert_comps(got, ref):
    assert set(got) == set(ref)
    for comp in ref:
        g, r = np.asarray(got[comp]), np.asarray(ref[comp])
        assert g.shape == r.shape and g.dtype == r.dtype, comp
        if comp in ("s1", "s2"):
            np.testing.assert_allclose(g, r, rtol=1e-5, err_msg=comp)
        else:
            np.testing.assert_array_equal(g, r, err_msg=comp)


# ------------------------------------------------------------- components
@pytest.mark.parametrize("name", ["scalar", "hopping", "hll", "hist"])
def test_components_match_reference(name):
    """groupby_components' plain version against _components (full mask)
    and _components_dyn (subset and empty masks)."""
    jgb, tgb = _groupbys(name)
    assert tgb._components_layout() == jgb._components_layout()
    js, host = _jax_state(jgb, 1)
    ts = tgb.state_from_host(host)
    layout = jgb._components_layout()
    P = jgb.n_panes
    masks = [np.ones(P, bool), np.zeros(P, bool)] + (
        [np.array([False, True])] if P == 2 else [])
    for i, mask in enumerate(masks):
        if i == 0:
            ref = jgb._components(js, tuple(mask.tolist()))
            got = tgb.prefinalize_begin(ts).get()
        else:
            ref = jgb._components_dyn(js, mask)
            got = tgb.components_begin_dyn(ts, mask).get()
        _assert_comps(got, jpf.unpack_components(np.asarray(ref), layout))
        if not mask.any():  # the identities of an empty merge
            assert (got["act"] == 0).all()
            for comp, arr in got.items():
                if comp in ("mx", "hll"):
                    assert (arr == -np.inf).all()


def test_fold_after_pre_issue_stays_out_of_the_fetch():
    """Rows folded after prefinalize_begin reach the state, not the
    fetched components: those equal the components of the head alone."""
    _, tgb = _groupbys("scalar")
    rng = np.random.default_rng(2)
    state = tgb.init_state()
    head, tail = _cols(rng, 300), _cols(rng, 300)
    state = tgb.fold(state, head[0], head[1])
    before = {k: v.clone() for k, v in state.items()}
    pending = tgb.prefinalize_begin(state)
    state = tgb.fold(state, tail[0], tail[1])
    assert not torch.equal(state["act"], before["act"])
    _assert_comps(pending.get(), tgb.prefinalize_begin(before).get())


# ----------------------------------------------------------------- absorb
@pytest.mark.parametrize("name,pane,drop", [
    ("scalar", 0, None), ("hopping", 1, None), ("hopping", 0, "mx"),
    ("hll", 1, None), ("hist", 0, "mn")],
    ids=["scalar", "hopping", "hopping-no-mx", "hll", "hist-no-mn"])
def test_absorb_matches_reference(name, pane, drop):
    jgb, tgb = _groupbys(name)
    js, host = _jax_state(jgb, 3)
    ts = tgb.state_from_host(host)
    shadow = jpf.HostShadow(jgb.plan, jgb.comp_specs, CAP)
    rng = np.random.default_rng(4)
    cols, slots = _cols(rng, 200)
    cols = materialize_hll_columns(jgb.plan.columns, cols, len(slots))
    shadow.fold({k: cols[k] for k in jgb.plan.columns}, slots)
    data = {k: v for k, v in shadow.data.items() if k != drop}
    js = jgb.absorb(js, data, pane)
    ts = tgb.absorb(ts, data, pane)
    _assert_comps(tgb.state_to_host(ts), jgb.state_to_host(js))
    if drop is not None:
        np.testing.assert_array_equal(ts[drop].numpy(), host[drop])


# ------------------------------------------------------------ host shadow
def _shadow_pair(name, seed):
    jgb, tgb = _groupbys(name)
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(2):
        cols, slots = _cols(rng, 400)
        cols["v"][:6] = [0.0, -0.0, -3.5, 1e-12, 3e12, -2e20]  # signs, clip
        valid = {"w": rng.random(len(slots)) > 0.1}
        cols = materialize_hll_columns(tgb.plan.columns, cols, len(slots))
        batches.append(({k: cols[k] for k in tgb.plan.columns}, slots, valid))
    return jgb, tgb, batches


@pytest.mark.parametrize("name", ["scalar", "hll", "hist", "hh"])
def test_shadow_matches_the_ports_fold(name):
    _, tgb, batches = _shadow_pair(name, 5)
    shadow = pf.HostShadow(tgb.plan, tgb.comp_specs, CAP)
    state = tgb.init_state()
    for cols, slots, valid in batches:
        shadow.fold(cols, slots, valid)
        state = tgb.fold(state, cols, slots, valid, 0)
    assert shadow.n_rows == sum(len(b[1]) for b in batches)
    fold = {k: v[0] for k, v in tgb.state_to_host(state).items()}
    _assert_comps(shadow.data, fold)


def _edge_cells(name, tgb, batches):
    """Cells (slot, k, register or bin) where the reference's shadow puts a
    value by another rule than the port's fold: hist bins of the eager
    numpy log, rho of np.log2."""
    cells = set()
    for comp, mine, theirs in (
            ("hll", lambda v: pf.hll_parts_np(v)[1],
             lambda v: jpf.hll_parts_np(v)[1]),
            ("hist", pf.hist_bin_np, jpf.hist_bin_np)):
        for k, si in enumerate(tgb.comp_specs.get(comp, [])):
            (col,) = tgb.plan.specs[si].arg.columns
            for cols, slots, _ in batches:
                v = cols[col]
                diff = (mine(v) != theirs(v)) & ~np.isnan(v)
                for r in np.nonzero(diff)[0]:
                    if comp == "hll":
                        at = [int(pf.hll_parts_np(v[r:r + 1])[0][0])]
                    else:
                        at = [int(pf.hist_bin_np(v[r:r + 1])[0]),
                              int(jpf.hist_bin_np(v[r:r + 1])[0])]
                    cells |= {(comp, int(slots[r]), k, a) for a in at}
    return cells


@pytest.mark.parametrize("name", ["scalar", "hll", "hist", "hh"])
def test_shadow_matches_reference_shadow(name):
    jgb, tgb, batches = _shadow_pair(name, 6)
    mine = pf.HostShadow(tgb.plan, tgb.comp_specs, CAP)
    theirs = jpf.HostShadow(jgb.plan, jgb.comp_specs, CAP)
    for cols, slots, _ in batches:
        # no validity masks: the reference's closure twins never see them
        # (its device closures do, as the port's twins do)
        mine.fold(cols, slots)
        theirs.fold(cols, slots)
    cells = _edge_cells(name, tgb, batches)
    assert len(cells) <= 4  # a value within ~2e-5 of an edge, or a miss
    got, ref = dict(mine.data), dict(theirs.data)
    for comp, slot, k, at in cells:
        got[comp] = got[comp].copy()
        ref[comp] = ref[comp].copy()
        got[comp][slot, k, at] = ref[comp][slot, k, at] = 0.0
    _assert_comps(got, ref)


def test_shadow_grows_with_its_keys():
    _, tgb = _groupbys("scalar")
    shadow = pf.HostShadow(tgb.plan, tgb.comp_specs, 8)
    cols, _ = _cols(np.random.default_rng(7), 30)
    shadow.fold(cols, np.arange(30, dtype=np.int32))
    assert shadow.capacity == 32 and shadow.data["act"][:30].sum() > 0
    assert shadow.data["mn"].shape == (32, 1)


# ------------------------------------------------------- host final values
def _random_comps(rng, tgb, cap=40):
    comps = {}
    for comp, idxs in tgb.comp_specs.items():
        shape = (cap,) + pf._comp_shape(comp, idxs)
        if comp == "n":
            arr = rng.integers(0, 4, shape).astype(np.float32)
        elif comp in ("hll",):
            arr = rng.integers(0, 12, shape).astype(np.float32)
            arr[:3] = 0.0  # empty sketches: the small-range estimate
        elif comp == "hist":
            arr = (rng.random(shape) < 0.02).astype(np.float32) * \
                rng.integers(1, 9, shape)
        elif comp == "hh":  # per key: code 7 five times, code 13 twice
            arr = np.zeros(shape, dtype=np.float32)
            for code, times in ((7.0, 5), (13.0, 2)):
                idx, wts = pf.hh_update_parts_np(np.full(times, code),
                                                 np.ones(times))
                np.add.at(arr[:, 0], (slice(None), idx.ravel()), wts.ravel())
        else:
            arr = rng.normal(20, 5, shape).astype(np.float32)
        comps[comp] = arr
    comps["act"] = comps["n"][:, 0].copy()
    return comps


@pytest.mark.parametrize("name", ["scalar", "hopping", "hll", "hist", "hh"])
def test_final_values_match_reference(name):
    jgb, tgb = _groupbys(name)
    comps = _random_comps(np.random.default_rng(8), tgb)
    for i, (jspec, tspec) in enumerate(zip(jgb.plan.specs, tgb.plan.specs)):
        c = {comp: comps[comp][:, tgb.comp_specs[comp].index(i)]
             for comp in tspec.components}
        got, ref = pf.final_value_np(tspec, c), jpf.final_value_np(jspec, c)
        if tspec.kind == "heavy_hitters":
            assert got.tolist() == ref.tolist()
            assert all(row == [(7, 5), (13, 2)] for row in got)
        else:
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)
    got = tgb._final_from_components(comps, 30)
    ref = jgb._final_from_components(comps, 30)
    np.testing.assert_array_equal(got[1], ref[1])


# -------------------------------------------------------------- the nodes
class _Pair:
    """A JAX node and a port node of one rule, each opened on its own
    package's mock clock; both get the same batches at the same times.
    The JAX node's timers queue control events on its input queue, which
    `at()` hands to its dispatch, as its worker thread would."""

    def __init__(self, sql, cap=CAP, **kw):
        stmt = jax_parse(sql)
        plan = jax_plan_of(stmt)
        self.jnode = JaxNode(
            "ref", stmt.window, plan, [d.expr for d in stmt.dimensions],
            capacity=cap, micro_batch=MB,
            direct_emit=jax_direct_emit(stmt, plan, ["k"]),
            emit_columnar=True, **kw)
        stmt = parse_select(sql)
        plan = extract_kernel_plan(stmt)
        self.tnode = FusedWindowAggNode(
            "port", stmt.window, plan, [d.expr for d in stmt.dimensions],
            capacity=cap, micro_batch=MB,
            direct_emit=build_direct_emit(stmt, plan, ["k"]),
            emit_columnar=True, device="cpu", **kw)
        self.jgot, self.tgot = [], []
        self.jnode.broadcast = self.jgot.append
        self.tnode.broadcast = self.tgot.append
        self.jclock = jax_timex.get_mock_clock()
        self.tclock = timex.get_mock_clock()
        self.jnode.on_open()
        self.tnode.on_open()

    def _pump(self):
        while True:
            try:
                item = self.jnode.inq.get_nowait()
            except queue.Empty:
                return
            self.jnode._dispatch(item)
            self.jnode.inq.task_done()

    def at(self, t):
        self.jclock.set(t)
        self._pump()
        self.tclock.set(t)

    def feed(self, cols, valid=None):
        n = len(next(iter(cols.values())))
        self.jnode.process(JaxBatch(n=n, columns=dict(cols),
                                    valid=dict(valid or {}), emitter="s"))
        self.tnode.process(ColumnBatch(n=n, columns=dict(cols),
                                       valid=dict(valid or {}), emitter="s"))

    def drain(self):
        self.jnode._drain_async_emits()
        self.tnode._drain_async_emits()

    def close(self):
        self.drain()
        self.tnode.on_close()
        for t in [self.jnode._timer, *self.jnode._pre_timers]:
            if t is not None:
                t.stop()


def _node_batches(seed, n, rows=120, keys=40, new_keys=0):
    rng = np.random.default_rng(seed)
    ids = np.array([f"d{i}" for i in range(keys + new_keys)], dtype=object)
    out = []
    for b in range(n):
        hi = keys + (new_keys if b % 4 == 3 else 0)  # new keys in tails
        out.append({"k": ids[rng.integers(0, hi, rows)],
                    "v": rng.normal(20, 5, rows).astype(np.float32),
                    "w": rng.normal(0, 1, rows).astype(np.float32)})
    return out


#: batch offsets in an interval of 10 s (tumbling) / 5 s (hopping): two
#: after the 2x-lead pre-trigger, one of them after the 1x-lead one
OFFSETS = {10_000: (1000, 5000, 9600, 9800), 5_000: (500, 2500, 4600, 4800)}


def _drive(pair, batches, interval, windows, hook=None):
    for w in range(windows):
        base = w * interval
        for i, off in enumerate(OFFSETS[interval]):
            pair.at(base + off)
            if hook is not None:
                hook(pair, w, i)
            pair.feed(batches[w * 4 + i])
        pair.at(base + interval)
    pair.drain()


SCALAR_T = ("SELECT k, avg(v) AS avg_t, count(*) AS c, min(v) AS mn, "
            "max(v) AS mx, stddev(v) AS sd FROM s WHERE w > -1.5 "
            "GROUP BY k, TUMBLINGWINDOW(ss, 10)")
SCALAR_H = SCALAR_T.replace("TUMBLINGWINDOW(ss, 10)",
                            "HOPPINGWINDOW(ss, 10, 5)")


@pytest.mark.parametrize("sql,tail,backstop,new_keys", [
    (SCALAR_T, "device", True, 0), (SCALAR_T, "host", True, 0),
    (SCALAR_T, "device", False, 0), (SCALAR_H, "device", True, 0),
    (SCALAR_T, "device", True, 40), (SCALAR_T, "host", True, 40)],
    ids=["tumbling", "tumbling-host-tail", "tumbling-no-backstop",
         "hopping", "grow-in-tail", "grow-in-frozen-tail"])
def test_nodes_emit_the_same_rows(sql, tail, backstop, new_keys):
    """Both nodes driven by their clocks through pre-triggers, tail rows
    and boundaries emit the same windows; the port serves every boundary
    from its pre-issue (or, with the backstop, the backstop or the
    pre-issue)."""
    pair = _Pair(sql, cap=32 if new_keys else CAP, tail_mode=tail,
                 prefinalize_backstop=backstop)
    interval = pair.jnode._tick_interval()
    sources = []
    pair.tnode.broadcast = lambda item: (
        pair.tgot.append(item),
        sources.append(pair.tnode.last_emit_info["source"]))
    _drive(pair, _node_batches(9, 16, new_keys=new_keys), interval, 4)
    pair.close()
    assert len(pair.tgot) == 4
    _assert_same_windows(pair.tgot, pair.jgot)
    assert set(sources) <= {"device", "backstop"}
    assert "device" in sources and not pair.tnode.recoveries
    if new_keys:
        assert pair.tnode.kt.n_keys == 80 and pair.tgot[-1].n > 40


def test_frozen_span_checkpoint_restores_in_the_other_package():
    """A snapshot taken in a host-tail frozen span (its shadow absorbed
    into the state) restores into a JAX node, and the JAX node's own
    snapshot at the same point restores into the port: each pair then
    emits the same windows."""
    pair = _Pair(SCALAR_T, tail_mode="host")
    batches = _node_batches(10, 16)
    snaps = {}

    def snap(p, w, i):
        if w == 1 and i == 3:  # inside the frozen span of window 1
            assert p.tnode._device_frozen and p.jnode._device_frozen
            kernels.reset_launches()
            snaps["port"] = p.tnode.snapshot_state()
            snaps["jax"] = p.jnode.snapshot_state()
            assert kernels.LAUNCHES["groupby_absorb"] == 0  # CPU: plain
    _drive(pair, batches[:8], 10_000, 2, hook=snap)
    _assert_comps(*[{k: np.asarray(v, dtype=np.float32)
                     for k, v in snaps[s]["partials"].items()
                     if k != "touch"} for s in ("port", "jax")])
    pair.close()
    for src, dst in (("port", "jax"), ("jax", "port")):
        timex.set_mock_clock(15_000)
        jax_timex.set_mock_clock(15_000)
        other = _Pair(SCALAR_T, tail_mode="host")
        restored = other.jnode if dst == "jax" else other.tnode
        restored.restore_state(snaps[src])
        own = other.tnode if dst == "jax" else other.jnode
        own.restore_state(snaps[dst])
        for i, off in enumerate((16_000, 19_600, 19_800)):
            other.at(off)
            other.feed(batches[8 + i])
        other.at(20_000)
        other.close()
        _assert_same_windows(other.tgot, other.jgot)


HH_SQL = ("SELECT k, heavy_hitters(v, 2) AS top, count(*) AS c FROM s "
          "GROUP BY k, HOPPINGWINDOW(ss, 10, 5)")


def test_heavy_hitters_emit_on_the_worker():
    """Heavy-hitters boundaries go to the emit worker in both packages;
    snapshot_state and on_eof drain it, so each delivery has landed when
    they return, and the rows match the JAX node's."""
    pair = _Pair(HH_SQL)
    assert pair.tnode._async_hh and pair.jnode._async_hh
    rng = np.random.default_rng(11)
    ids = np.array([f"d{i}" for i in range(30)], dtype=object)

    def batch():
        p = rng.random(150)
        v = np.where(p < 0.4, 7, np.where(p < 0.6, 13,
                                          rng.integers(100, 200, 150)))
        return {"k": ids[rng.integers(0, 30, 150)], "v": v}

    for w in range(3):
        for off in (1000, 3000):
            pair.at(w * 5000 + off)
            pair.feed(batch())
        pair.at((w + 1) * 5000)
        pair.tnode.snapshot_state()
        assert len(pair.tgot) == w + 1
        assert pair.tnode.last_emit_info["source"] == "device-async"
    pair.at(16_000)
    pair.feed(batch())
    pair.tnode.on_eof(EOF())
    pair.jnode.on_eof(JaxEOF())
    pair.close()
    assert len(pair.tgot) == 5 and isinstance(pair.tgot[-1], EOF)
    _assert_same_windows(pair.tgot[:-1], pair.jgot[:-1])
    tops = [r["top"] for r in _rows(pair.tgot[-2])]
    assert sum(t[0]["value"] == 7 for t in tops) > len(tops) / 2


def test_rule_options_plan_the_reference_defaults():
    node = plan_fused_rule(SCALAR_T, key_slots=CAP, micro_batch=MB,
                           device="cpu")
    assert node.prefinalize_lead_ms == 250 and node.tail_mode == "device"
    assert node._prefinalize_ok and node._backstop
    hop = plan_fused_rule(SCALAR_H, key_slots=CAP, micro_batch=MB,
                          device="cpu")
    assert hop._prefinalize_ok and not hop._backstop
    hh = plan_fused_rule(HH_SQL, key_slots=CAP, micro_batch=MB, device="cpu")
    assert hh._async_hh and not hh._prefinalize_ok
    sync = plan_fused_rule(SCALAR_T, key_slots=CAP, micro_batch=MB,
                           device="cpu", options={"prefinalizeLeadMs": 0})
    assert not (sync._prefinalize_ok or sync._backstop)
    hh0 = plan_fused_rule(HH_SQL, key_slots=CAP, micro_batch=MB,
                          device="cpu", options={"prefinalizeLeadMs": 0})
    assert not hh0._async_hh
    host = plan_fused_rule(SCALAR_T, key_slots=CAP, micro_batch=MB,
                           device="cpu", options={"tailMode": "host"})
    assert host._tail_host_only
    with pytest.raises(NotImplementedError):
        plan_fused_rule(SCALAR_T, device="cpu", options={"isEventTime": 1})
    for bad in ({"tailMode": "disk"}, {"prefinalizeLeadMs": -1},
                {"prefinalizeLeadMs": True}):
        with pytest.raises(Exception, match="tailMode|prefinalizeLeadMs"):
            plan_fused_rule(SCALAR_T, device="cpu", options=bad)


def test_mock_clock_fires_timers_in_deadline_order():
    clock = timex.get_mock_clock()
    fired = []
    clock.after(30, lambda ts: fired.append(("b", ts)))
    clock.after(10, lambda ts: (fired.append(("a", ts)), clock.after(
        5, lambda t2: fired.append(("a2", t2)))))
    stopped = clock.after(20, lambda ts: fired.append(("x", ts)))
    stopped.stop()
    clock.advance(25)
    assert fired == [("a", 10), ("a2", 15)] and clock.now_ms() == 25
    clock.set(40)
    assert fired[-1] == ("b", 30)
    with pytest.raises(ValueError):
        clock.set(39)
    assert timex.align_to_window(10_001, 10_000) == 20_000
    assert timex.align_to_window(20_000, 10_000) == 20_000
