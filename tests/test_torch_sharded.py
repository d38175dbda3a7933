"""The port's device mesh (ekuiper_tpu_torch/parallel/mesh.py,
parallel/sharded.py ShardedGroupBy, the sharded kernels' plain versions in
ops/kernels.py, the mesh in runtime/nodes_fused.py and planner/fused.py)
against the JAX package's ShardedGroupBy, mesh helpers and sharded rules
on the CPU. The port's mesh is one device named eight times (["cpu"] * 8),
the counterpart of the reference's eight virtual CPU devices
(tests/conftest.py); the JAX side runs on those devices.

Inputs are made from a seed with numpy and given to both packages.
Tolerances, each against the JAX result:
- state: n, act, mn, mx, touch and the hist counters exact; hll registers
  exact outside the cells where a value's rho comes from a jnp.log2 miss
  (tests/test_torch_groupby.py); s1, s2 rtol 1e-5 (the partials add in
  another order than XLA's scatter and psum);
- windows: keys, counts, min, max exact; sums and averages rtol 1e-5;
  stddev rtol 1e-4 plus the cancellation floor 4·sqrt(ε32)·|mean|; hll
  estimates within ±1; percentiles within 4 ulp (tests/test_torch_event.py
  and tests/test_torch_refold.py state why).
The port sharded against the port single-chip: every component exact but
s1 / s2 (rtol 1e-5). The plain kernels against a numpy twin: the
partials and the merged state exact but the partial sums (rtol 1e-6).
"""
import gc
import json

import numpy as np
import pytest
import torch

from ekuiper_tpu.data.batch import ColumnBatch as JaxBatch
from ekuiper_tpu.ops.aggspec import extract_kernel_plan as jax_plan_of
from ekuiper_tpu.ops.emit import build_direct_emit as jax_direct_emit
from ekuiper_tpu.parallel import mesh as jax_mesh
from ekuiper_tpu.parallel.sharded import ShardedGroupBy as JaxSharded
from ekuiper_tpu.planner import planner as jax_planner
from ekuiper_tpu.runtime.events import Trigger as JaxTrigger
from ekuiper_tpu.runtime.events import Watermark as JaxWatermark
from ekuiper_tpu.runtime.nodes_fused import FusedWindowAggNode as JaxNode
from ekuiper_tpu.runtime.nodes_window import WatermarkNode as JaxWatermarkNode
from ekuiper_tpu.sql.parser import parse_select as jax_parse
from ekuiper_tpu_torch.data.batch import ColumnBatch
from ekuiper_tpu_torch.ops import kernels, sketches
from ekuiper_tpu_torch.ops.aggspec import (extract_kernel_plan,
                                           materialize_hll_columns)
from ekuiper_tpu_torch.ops.groupby import TorchGroupBy
from ekuiper_tpu_torch.parallel import mesh as port_mesh
from ekuiper_tpu_torch.parallel.sharded import ShardedGroupBy
from ekuiper_tpu_torch.planner import fused
from ekuiper_tpu_torch.planner.fused import plan_fused_rule
from ekuiper_tpu_torch.runtime.events import Trigger, Watermark
from ekuiper_tpu_torch.runtime.nodes_fused import FusedWindowAggNode
from ekuiper_tpu_torch.sql.parser import parse_select
from ekuiper_tpu_torch.utils import timex
from ekuiper_tpu_torch.utils.device import resolve_devices
from ekuiper_tpu_torch.utils.infra import PlanError
from test_torch_groupby import _assert_sketch_state, _hll_miss_cells

CPU8 = ["cpu"] * 8
EPS32 = float(np.finfo(np.float32).eps)
MB = 128
SCALAR = ("SELECT k, count(*) AS c, sum(v) AS s, avg(v) AS a, min(v) AS mn, "
          "max(v) AS mx, stddev(v) AS sd, count(v) FILTER (WHERE w > 0) AS "
          "cf FROM s WHERE v > 5 OR w < 0 GROUP BY k, TUMBLINGWINDOW(ss, 10)")
SKETCH = ("SELECT k, count(*) AS c, sum(v) AS s, min(v) AS mn, hll(v) AS u, "
          "percentile_approx(v, 0.9) AS p FROM s "
          "GROUP BY k, HOPPINGWINDOW(ss, 30, 10)")
MESHES = [(2, 4), (1, 8)]


@pytest.fixture(scope="module", autouse=True)
def _no_cyclic_gc_inside_jax_locks():
    """As in test_torch_groupby.py: the JAX package's devwatch registry
    deadlocks when a cyclic collection lands inside its weakref prune, so
    this module runs with the cyclic collector off and collects at its
    end."""
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


@pytest.fixture
def nodes():
    """Nodes made by a test (either package), closed at teardown."""
    made = []
    yield made
    for node in made:
        node.on_close()
    made.clear()


def _batch(rng, n, keys, nan=0.05):
    v = rng.normal(10, 5, n).astype(np.float32)
    v[rng.random(n) < nan] = np.nan
    cols = {"v": v, "w": rng.normal(0, 1, n).astype(np.float32)}
    valid = {"w": rng.random(n) > 0.1}
    return cols, valid, rng.integers(0, keys, n).astype(np.int32)


def _misses(tgb, cols, slots, pane):
    """hll cells reached by a jnp.log2 miss, for a scalar pane or a per-row
    pane vector."""
    if not isinstance(pane, np.ndarray):
        return _hll_miss_cells(tgb, cols, slots, pane)
    miss = set()
    for p in np.unique(pane).tolist():
        sel = np.nonzero(pane == p)[0]
        miss |= _hll_miss_cells(tgb, {k: v[sel] for k, v in cols.items()},
                                slots[sel], p)
    return miss


# ------------------------------------------------ (a) against the JAX mesh
# each case: (SQL, panes, touch, steps); a step folds (rows, key range,
# pane: an int or "vec") or grows the state to a capacity ("grow", cap)
CASES = {
    "scalar-touch-grow": (SCALAR, 1, True,
                          [(700, 40, 0), (300, 40, 0), ("grow", 100),
                           (500, 90, 0)]),
    "hopping-sketch-panevec": (SKETCH, 3, False,
                               [(300, 40, 0), (300, 40, 1), (300, 40, 2),
                                (400, 40, "vec")]),
}


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_state_matches_reference_mesh(case, mesh):
    """ShardedGroupBy on ["cpu"] * 8 against the JAX one on the same mesh
    shape: chunks across row shards (micro_batch 128, batches of 300-700
    rows), validity masks, NaNs, WHERE and FILTER, hopping panes, hll and
    percentile, a per-row pane vector (#24), a grow that shifts every key
    shard's range, the touch column; the state after every step, then the
    finalize."""
    sql, P, touch, steps = CASES[case]
    R, K = mesh
    jgb = JaxSharded(jax_plan_of(jax_parse(sql)),
                     jax_mesh.make_mesh(rows=R, keys=K), capacity=44,
                     n_panes=P, micro_batch=MB, track_touch=touch)
    tgb = ShardedGroupBy(extract_kernel_plan(parse_select(sql)),
                         port_mesh.make_mesh(R, K, CPU8), capacity=44,
                         n_panes=P, micro_batch=MB, track_touch=touch)
    assert (tgb.capacity, tgb.micro_batch) == (jgb.capacity, jgb.micro_batch)
    assert tgb.mesh_tag == jgb.mesh_tag == f"{R}x{K}"
    rng = np.random.default_rng(list(CASES).index(case) * 10 + R)
    js, ts, miss = jgb.init_state(), tgb.init_state(), set()
    for step in steps:
        if step[0] == "grow":
            js, ts = jgb.grow(js, step[1]), tgb.grow(ts, step[1])
            assert tgb.capacity == jgb.capacity
        else:
            n, keys, pane = step
            cols, valid, slots = _batch(rng, n, keys)
            if pane == "vec":
                pane = rng.integers(0, P, n).astype(np.uint8)
            js = jgb.fold(js, cols, slots, valid, pane)
            ts = tgb.fold(ts, cols, slots, valid, pane)
            miss |= _misses(tgb, materialize_hll_columns(
                tgb.plan.columns, cols, n), slots, pane)
        _assert_sketch_state(tgb.state_to_host(ts), jgb.state_to_host(js),
                             miss)
    np.testing.assert_array_equal(tgb.shard_rows, jgb.shard_rows)
    assert tgb.shard_stats(ts) == jgb.shard_stats(js)
    assert tgb.collective_bytes_per_fold() == jgb.collective_bytes_per_fold()
    got, got_act = tgb.finalize(ts, 90)
    ref, ref_act = jgb.finalize(js, 90)
    np.testing.assert_array_equal(got_act, ref_act)
    for spec, g, r in zip(tgb.plan.specs, got, ref):
        if spec.kind in ("count", "min", "max"):
            np.testing.assert_array_equal(g, r, err_msg=spec.kind)
        elif spec.kind == "hll":
            assert np.abs(g - r).max() <= 1
        elif spec.kind == "percentile_approx":
            np.testing.assert_allclose(g, r, rtol=4 * 2.0 ** -23)
        elif spec.kind == "stddev":
            floor = 4 * np.sqrt(EPS32) * np.nan_to_num(np.abs(got[2]))
            ok = np.isnan(r) | (np.abs(g - r) <= 1e-4 * np.abs(r) + floor)
            assert ok.all()
        else:
            np.testing.assert_allclose(g, r, rtol=1e-5, equal_nan=True)
    del jgb, js


# ------------------------------------------ (b) against the port's one chip
@pytest.mark.parametrize("mesh", [(2, 4), (1, 8), (4, 2), (8, 1), (3, 1)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_matches_single_chip(mesh):
    """The port's sharded group-by against its single-chip one on the same
    batches: every component exact but the sums, whatever the mesh (a row
    shard count that does not divide the micro-batch rounds it up)."""
    R, K = mesh
    plan = extract_kernel_plan(parse_select(SKETCH))
    sgb = ShardedGroupBy(plan, port_mesh.make_mesh(R, K, ["cpu"] * (R * K)),
                         capacity=40, n_panes=3, micro_batch=100,
                         track_touch=True)
    gb = TorchGroupBy(extract_kernel_plan(parse_select(SKETCH)),
                      capacity=sgb.capacity, n_panes=3, micro_batch=100,
                      device="cpu", track_touch=True)
    assert sgb.micro_batch % R == 0 and sgb.capacity % K == 0
    rng = np.random.default_rng(R * 10 + K)
    ss, gs = sgb.init_state(), gb.init_state()
    for pane in (0, 1, 2, rng.integers(0, 3, 333).astype(np.uint8)):
        cols, valid, slots = _batch(rng, 333, 37)
        ss = sgb.fold(ss, cols, slots, valid, pane)
        gs = gb.fold(gs, cols, slots, valid, pane)
    a, b = sgb.state_to_host(ss), gb.state_to_host(gs)
    assert set(a) == set(b)
    for comp in b:
        assert a[comp].dtype == b[comp].dtype, comp
        if comp in ("s1", "s2"):
            np.testing.assert_allclose(a[comp], b[comp], rtol=1e-5)
        else:
            np.testing.assert_array_equal(a[comp], b[comp], err_msg=comp)
    # the partials are back at their identity after each merge
    for parts in sgb._parts.values():
        for comp, t in parts.items():
            want = kernels.INIT.get(comp, 0.0)
            assert bool((t.double() == want).all()), comp
    stats = sgb.shard_stats(ss)
    assert [s["shard"] for s in stats] == list(range(K))
    assert sum(s["rows"] for s in stats) == 4 * 333


def test_masked_fold_refused_on_a_sharded_state():
    """The refold path's masked fold (#2) never reaches a sharded state."""
    sgb = ShardedGroupBy(extract_kernel_plan(parse_select(SCALAR)),
                         port_mesh.make_mesh(2, 4, CPU8), capacity=16)
    with pytest.raises(NotImplementedError):
        sgb.fold_masked(sgb.init_state(), {}, torch.zeros(4), np.ones(4), 0)


def test_heavy_hitters_never_builds_a_sharded_state():
    plan = extract_kernel_plan(parse_select(
        "SELECT k, heavy_hitters(code, 3) AS t FROM s "
        "GROUP BY k, TUMBLINGWINDOW(ss, 10)"))
    with pytest.raises(ValueError, match="heavy_hitters"):
        ShardedGroupBy(plan, port_mesh.make_mesh(2, 4, CPU8))


# -------------------------------------------------- (c) checkpoints
HOP = ("SELECT k, sum(v) AS s, count(*) AS c, min(v) AS mn "
       "FROM d GROUP BY k, HOPPINGWINDOW(ss, 4, 2)")


def _jax_node(sql, mesh=None, capacity=64, **kw):
    stmt = jax_parse(sql)
    plan = jax_plan_of(stmt)
    node = JaxNode("ref", stmt.window, plan, [d.expr for d in stmt.dimensions],
                   capacity=capacity, micro_batch=MB,
                   direct_emit=jax_direct_emit(stmt, plan, ["k"]),
                   emit_columnar=True, prefinalize_lead_ms=0,
                   mesh=None if mesh is None else jax_mesh.make_mesh(*mesh),
                   **kw)
    node.state = node.gb.init_state()
    node.broadcast = (got := []).append
    node.got = got
    return node


def _port_node(sql, mesh=None, capacity=64, options=None):
    opts = {"prefinalizeLeadMs": 0, **(options or {})}
    if mesh is not None:
        opts["planOptimizeStrategy"] = {"mesh": {"rows": mesh[0],
                                                 "keys": mesh[1]}}
    node = plan_fused_rule(sql, key_slots=capacity, micro_batch=MB,
                           device=CPU8 if mesh else "cpu", options=opts)
    node.broadcast = (got := []).append
    node.got = got
    return node


def _cols(ids, vals):
    return {"k": np.array(ids, dtype=object),
            "v": np.asarray(vals, np.float32)}


def _feed(node, cols, ts=None):
    n = len(cols["k"])
    cls = ColumnBatch if isinstance(node, FusedWindowAggNode) else JaxBatch
    node.process(cls(n=n, columns=dict(cols), timestamps=ts, emitter="d"))


def _fire(node, ts):
    node.on_trigger((Trigger if isinstance(node, FusedWindowAggNode)
                     else JaxTrigger)(ts=ts))
    node._drain_async_emits()


def _rows(item):
    names = list(item.columns)
    return {r[names[0]]: r for r in (
        dict(zip(names, vals))
        for vals in zip(*(np.asarray(item.columns[k]).tolist()
                          for k in names)))}


def _assert_windows(got, ref, n_min=1):
    """Emitted windows equal within the module's tolerances."""
    got = [w for w in got if hasattr(w, "columns")]
    ref = [w for w in ref if hasattr(w, "columns")]
    assert len(got) == len(ref) >= n_min
    for g_item, r_item in zip(got, ref):
        if r_item.timestamps is not None:
            np.testing.assert_array_equal(g_item.timestamps,
                                          r_item.timestamps)
        g_rows, r_rows = _rows(g_item), _rows(r_item)
        assert g_rows.keys() == r_rows.keys()
        for key, r in r_rows.items():
            g = g_rows[key]
            assert g.keys() == r.keys()
            for f, rv in r.items():
                gv = g[f]
                if rv is None or isinstance(rv, str) or f in (
                        "c", "cnt", "mn", "mx", "min_t", "max_t"):
                    assert gv == rv, (key, f, gv, rv)
                elif f == "u":
                    assert abs(gv - rv) <= 1, (key, f, gv, rv)
                elif f == "p":
                    assert gv == pytest.approx(rv, rel=4 * EPS32), (key, f)
                elif f == "sd":
                    floor = 4 * np.sqrt(EPS32) * abs(r.get("a") or 0.0)
                    assert abs(gv - rv) <= 1e-4 * abs(rv) + floor, (key, f)
                elif isinstance(rv, float) and np.isnan(rv):
                    assert np.isnan(gv), (key, f)
                else:
                    assert gv == pytest.approx(rv, rel=1e-5), (key, f, gv, rv)


def _snap(node):
    return json.loads(json.dumps(node.snapshot_state()))


def test_checkpoint_port_mesh_to_jax_single_chip(nodes):
    """A port 2x4 rule's snapshot restores on the JAX single-chip node
    (and grows past 64 keys first); every later window equals the port's
    sharded one."""
    rng = np.random.default_rng(3)
    t = _port_node(HOP, mesh=(2, 4))
    nodes.append(t)
    _feed(t, _cols([f"k{i}" for i in range(90)], rng.normal(40, 9, 90)))
    _fire(t, 2000)
    j = _jax_node(HOP)
    nodes.append(j)
    j.restore_state(_snap(t))
    assert j.kt.decode_all() == t.kt.decode_all()
    assert j.cur_pane == t.cur_pane == 1
    t.got.clear()
    for ts in (4000, 6000):
        cols = _cols([f"k{i}" for i in range(30, 120)],
                     rng.normal(40, 9, 90))
        _feed(t, cols)
        _feed(j, cols)
        _fire(t, ts)
        _fire(j, ts)
    _assert_windows(t.got, j.got, n_min=2)


def test_checkpoint_jax_mesh_to_port_1x8(nodes):
    """A JAX 2x4 rule's snapshot restores on a port rule planned with
    shards 8 (1x8); every later window equals the JAX sharded node's."""
    rng = np.random.default_rng(4)
    j = _jax_node(HOP, mesh=(2, 4))
    nodes.append(j)
    _feed(j, _cols([f"k{i}" for i in range(70)], rng.normal(40, 9, 70)))
    _fire(j, 2000)
    t = plan_fused_rule(HOP, key_slots=64, micro_batch=MB, device=CPU8,
                        options={"prefinalizeLeadMs": 0,
                                 "planOptimizeStrategy": {"shards": 8}})
    t.broadcast = (got := []).append
    nodes.append(t)
    assert t.gb.mesh_tag == "1x8" and t.shard_info["source"] == "shards=8"
    t.restore_state(_snap(j))
    assert t.kt.decode_all() == j.kt.decode_all()
    j.got.clear()
    for ts in (4000, 6000):
        cols = _cols([f"k{i}" for i in range(20, 110)],
                     rng.normal(40, 9, 90))
        _feed(t, cols)
        _feed(j, cols)
        _fire(t, ts)
        _fire(j, ts)
    _assert_windows(got, j.got, n_min=2)


def test_checkpoint_8_to_1_to_8_rounds_odd_capacity(nodes):
    """8 -> 1 -> 8 on the port (tests/test_multichip_serving.py:78-126),
    the JAX nodes taking the same path beside it: the key table, the pane
    cursor and every window equal; a capacity of 20 restored on 1x8 rounds
    up to 24, and every restored key emits."""
    rng = np.random.default_rng(5)
    ids = [f"k{i}" for i in range(90)]
    vals = np.rint(rng.normal(40, 9, len(ids)))
    ports, refs = [_port_node(HOP, mesh=(2, 4))], [_jax_node(HOP, mesh=(2, 4))]
    nodes.extend(ports + refs)
    for pkg in (ports, refs):
        _feed(pkg[0], _cols(ids, vals))
        _fire(pkg[0], 2000)
        pkg.append((_port_node if pkg is ports else _jax_node)(HOP))
        nodes.append(pkg[1])
        pkg[1].restore_state(_snap(pkg[0]))
        assert pkg[1].kt.decode_all() == pkg[0].kt.decode_all()
        assert pkg[1].cur_pane == pkg[0].cur_pane
    tail_ids = [f"k{i}" for i in range(30, 120)]
    tail_vals = np.rint(rng.normal(40, 9, len(tail_ids)))
    for node in ports + refs:
        node.got.clear()
        _feed(node, _cols(tail_ids, tail_vals))
        _fire(node, 4000)
    _assert_windows(ports[1].got, ports[0].got)
    _assert_windows(ports[1].got, refs[1].got)
    for pkg in (ports, refs):
        pkg.append((_port_node if pkg is ports else _jax_node)(
            HOP, mesh=(1, 8)))
        nodes.append(pkg[2])
        pkg[2].restore_state(_snap(pkg[1]))
        assert pkg[2].gb.capacity >= pkg[1].gb.capacity
        assert pkg[2].gb.capacity % 8 == 0
    for node in (ports[2], ports[1], refs[2]):
        node.got.clear()
        _feed(node, _cols(ids, vals))
        _fire(node, 6000)
    _assert_windows(ports[2].got, ports[1].got)
    _assert_windows(ports[2].got, refs[2].got)
    # a capacity of 20 restored on 1x8 rounds up to 24, every key emits
    plain = _port_node(HOP, capacity=20)
    nodes.append(plain)
    _feed(plain, _cols([f"k{i}" for i in range(10)], np.ones(10)))
    remesh = _port_node(HOP, mesh=(1, 8), capacity=64)
    nodes.append(remesh)
    remesh.restore_state(_snap(plain))
    assert remesh.gb.capacity == 24 and remesh.kt.capacity >= 24
    assert remesh.state["act"].shape == (2, 24)
    _fire(remesh, 2000)
    assert sum(len(_rows(w)) for w in remesh.got) == 10


# ---------------------------------------------- (d) plain vs a numpy twin
def _twin_fold(parts, base, V, M, slots, m, R, colmap, pane_vec, P):
    """numpy twin of sharded_fold's scalar branch: per row shard, np.add.at /
    minimum.at / maximum.at into block r·P + pane."""
    out = {k: v.numpy().copy() for k, v in parts.items()}
    base, V, M = base.numpy(), V.numpy(), M.numpy()
    s = slots.numpy().astype(np.int64)
    for i in range(len(s)):
        r = i // m
        p = 0 if pane_vec is None else int(pane_vec[i])
        if not base[i] or r >= R:
            continue
        if "touch" in out:
            out["touch"][r, s[i]] += 1
        if p >= P:
            continue
        at = r * P + p
        out["act"][at, s[i]] += 1
        for comp_id, k, si in colmap.tolist():
            if not M[si, i]:
                continue
            comp = {j: c for c, j in kernels.COMP_IDS.items()}[comp_id]
            cell = (at, s[i], k)
            v = V[si, i]
            if comp == "n":
                out[comp][cell] += np.float32(1)
            elif comp == "s1":
                out[comp][cell] += v
            elif comp == "s2":
                out[comp][cell] += v * v
            elif comp == "mn":
                out[comp][cell] = min(out[comp][cell], v)
            else:
                out[comp][cell] = max(out[comp][cell], v)
    return out


@pytest.mark.parametrize("vec", [False, True], ids=["pane", "pane_vec"])
def test_plain_kernels_match_numpy_twin(vec):
    """sharded_fold_plain (through the sharded_fold wrapper on CPU
    tensors) and shard_merge_plain against numpy twins: the partials (routing by row
    shard, key range and pane), then the merge in r order into the state
    and the partials back at their identity."""
    R, K, m, P, C, N = 2, 4, 50, 3, 32, 97
    sgb = ShardedGroupBy(extract_kernel_plan(parse_select(SKETCH)),
                         port_mesh.make_mesh(R, K, CPU8), capacity=C,
                         n_panes=P, micro_batch=2 * m, track_touch=True)
    rng = np.random.default_rng(11 + vec)
    cols, valid, slots = _batch(rng, N, C)
    cols = {k: torch.from_numpy(v) for k, v in materialize_hll_columns(
        sgb.plan.columns, cols, N).items()}
    cols["__valid_w"] = torch.from_numpy(valid["w"])
    base, V, M = sgb.spec_inputs(cols, N)
    s = torch.from_numpy(slots)
    pv = (torch.from_numpy(rng.integers(0, P + 1, N).astype(np.uint8))
          if vec else None)  # P + 1: some panes outside [0, P) drop
    parts = sgb._partials(P if vec else 1)
    want = _twin_fold(parts, base, V, M, s, m, R, sgb._colmap, pv,
                      P if vec else 1)
    kernels.sharded_fold(parts, base, V, M, s, m, R, K, sgb._colmap,
                         sgb._widemap, pv)
    for comp, w in want.items():
        g = parts[comp].numpy()
        if comp in ("s1", "s2"):
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=comp)
        elif comp not in ("hll", "hist"):
            np.testing.assert_array_equal(g, w, err_msg=comp)
    # wide twin: each row's register / bin from the port's sketch helpers
    Pp = P if vec else 1
    hll, hist = np.zeros_like(parts["hll"].numpy()), np.zeros_like(
        parts["hist"].numpy())
    for k, si in enumerate(sgb.comp_specs["hll"]):
        reg, rho = (t.numpy() for t in sketches.hll_parts(V[si]))
        for i in range(N):
            p = 0 if pv is None else int(pv[i])
            if M[si, i] and p < Pp:
                cell = ((i // m) * Pp + p, slots[i], k, reg[i])
                hll[cell] = max(hll[cell], rho[i])
    for k, si in enumerate(sgb.comp_specs["hist"]):
        b = sketches.hist_bin(V[si]).numpy()
        for i in range(N):
            p = 0 if pv is None else int(pv[i])
            if M[si, i] and p < Pp:
                hist[((i // m) * Pp + p, slots[i], k, b[i])] += 1
    np.testing.assert_array_equal(parts["hll"].numpy(), hll)
    np.testing.assert_array_equal(parts["hist"].numpy(), hist)
    # the merge: r order, combined into pane 1 (or every pane)
    state = sgb.init_state()
    for comp in state:  # a state already holding data
        if comp not in ("touch",):
            state[comp].copy_(torch.from_numpy(
                rng.normal(1, 1, tuple(state[comp].shape)).astype(
                    np.float32)))
    before = {k: v.numpy().copy() for k, v in state.items()}
    parts_np = {k: v.numpy().copy() for k, v in parts.items()}
    kernels.shard_merge(state, parts, 1, R)
    for comp, st in before.items():
        p = parts_np[comp]
        if comp == "touch":
            want = st + p.sum(0).astype(np.uint32)
        else:
            blocks = p.reshape(R, Pp, *p.shape[1:])
            fn = {0: np.add, 1: np.minimum, 2: np.maximum}[
                kernels.SHARD_OPS.get(comp, 0)]
            acc = blocks[0]
            for r in range(1, R):
                acc = fn(acc, blocks[r])
            want = st.copy()
            if Pp == 1:
                want[1] = fn(st[1], acc[0])
            else:
                want = fn(st, acc)
        np.testing.assert_array_equal(state[comp].numpy(), want,
                                      err_msg=comp)
        np.testing.assert_array_equal(
            parts[comp].double().numpy(),
            np.full(p.shape, kernels.INIT.get(comp, 0.0)), err_msg=comp)


def test_sharded_wrappers_never_take_the_plain_versions(monkeypatch):
    """Given CUDA tensors, the two sharded wrappers launch or raise (no
    card, no nvcc here: they fail loudly) and never run a plain version;
    inputs the kernels do not take are refused before any build."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card: fake CUDA tensors "
                    "would reach a real launch")
    import warnings

    from torch._subclasses.fake_tensor import FakeTensorMode

    taken = []
    for name in ("sharded_fold_plain", "fold_scalar_plain",
                 "fold_wide_plain", "shard_merge_plain"):
        monkeypatch.setattr(kernels, name,
                            lambda *a, _n=name, **k: taken.append(_n))
    kernels.reset_launches()
    with FakeTensorMode(allow_non_fake_inputs=True):
        state = {"n": torch.zeros((1, 8, 1), device="cuda"),
                 "hist": torch.zeros((1, 8, 1, kernels.WIDE_W["hist"]),
                                     device="cuda"),
                 "act": torch.zeros((1, 8), device="cuda")}
        parts = {k: torch.zeros((2, *v.shape[1:]), device="cuda")
                 for k, v in state.items()}
        base = torch.ones(4, dtype=torch.bool, device="cuda")
        V = torch.ones((1, 4), device="cuda")
        M = torch.ones((1, 4), dtype=torch.bool, device="cuda")
        slots = torch.zeros(4, dtype=torch.int32, device="cuda")
    colmap = kernels.column_map({"n": [0]})
    widemap = kernels.wide_column_map({"hist": [0]})
    calls = [
        lambda: kernels.sharded_fold(parts, base, V, M, slots, 2, 2, 4,
                                     colmap, widemap),
        lambda: kernels.shard_merge(state, parts, 0, 2),
    ]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # fake data_ptr()
        for call in calls:
            with pytest.raises((RuntimeError, AssertionError)):
                call()
        with pytest.raises(ValueError):  # 8 slots in 3 key shards
            kernels.sharded_fold(parts, base, V, M, slots, 2, 2, 3, colmap,
                                 widemap)
        with pytest.raises(ValueError):  # 4 rows past 2 shards of 1
            kernels.sharded_fold(parts, base, V, M, slots, 1, 2, 4, colmap,
                                 widemap)
        with pytest.raises(ValueError):  # a pane outside the state
            kernels.shard_merge(state, parts, 1, 2)
    assert taken == []
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)


# ------------------------------------------------ (e) the mesh's planning
ENV_TABLE = ["", "0", "off", "none", "1", "auto", "AUTO", "2x4", " 1x8 ",
             "8", "4", "0x4", "2x0", "1x1", "bad", "2xq", "x4", "-2"]


@pytest.mark.parametrize("raw", ENV_TABLE)
def test_mesh_cfg_from_env_matches_reference(raw, monkeypatch):
    monkeypatch.setenv("KUIPER_MESH", raw)
    assert port_mesh.mesh_cfg_from_env() == jax_mesh.mesh_cfg_from_env()


def _jax_req(options, sql=HOP):
    opts = jax_planner.merged_options(jax_planner.RuleDef(
        id="r", sql=sql, options=options))
    return jax_planner.mesh_request(opts, jax_plan_of(jax_parse(sql)))


def _port_req(options, sql=HOP):
    return fused.mesh_request(fused.rule_options(options),
                              extract_kernel_plan(parse_select(sql)))


@pytest.mark.parametrize("env", [None, "2x4", "1x8", "auto"])
@pytest.mark.parametrize("strategy", [None, {"shards": "auto"},
                                      {"shards": "off"}, {"shards": 4},
                                      {"mesh": {"rows": 2, "keys": 4}}],
                         ids=["none", "auto", "off", "four", "mesh"])
def test_mesh_request_matches_reference(strategy, env, monkeypatch):
    """mesh_request's resolution (tests/test_multichip_serving.py:129-170):
    explicit mesh first, then shards, then KUIPER_MESH; heavy_hitters
    single-chip under shards / env."""
    if env is None:
        monkeypatch.delenv("KUIPER_MESH", raising=False)
    else:
        monkeypatch.setenv("KUIPER_MESH", env)
    options = {} if strategy is None else {"planOptimizeStrategy": strategy}
    assert _port_req(options) == _jax_req(options)
    hh = ("SELECT k, heavy_hitters(t, 2) AS hh FROM d "
          "GROUP BY k, TUMBLINGWINDOW(ss, 2)")
    assert _port_req(options, hh) == _jax_req(options, hh)


def test_planner_mesh_choices(monkeypatch):
    """The planner's build (tests/test_multichip_serving.py:172-200): an
    env mesh under shards auto builds ShardedGroupBy on the device list;
    an explicit mesh with too few devices is a PlanError; shards auto on
    one device plans single-chip with its reason; a heavy_hitters rule
    under an explicit mesh, a device list of two different cards and an
    unported strategy key raise."""
    sql = "SELECT k, avg(v) AS a FROM d GROUP BY k, TUMBLINGWINDOW(ss, 10)"
    monkeypatch.setenv("KUIPER_MESH", "2x4")
    node = plan_fused_rule(sql, key_slots=30, micro_batch=64, device=CPU8,
                           options={"planOptimizeStrategy": {"shards":
                                                             "auto"}})
    assert isinstance(node.gb, ShardedGroupBy)
    assert node.shard_info["mode"] == "sharded"
    assert node.shard_info["mesh"] == {"rows": 2, "keys": 4}
    assert node.gb.capacity == 32 and node.gb.watch_prefix == "sharded"
    assert not node._prefinalize_ok and node.tier is None
    monkeypatch.delenv("KUIPER_MESH")
    mesh = {"planOptimizeStrategy": {"mesh": {"rows": 2, "keys": 4}}}
    with pytest.raises(PlanError, match="cannot build device mesh"):
        plan_fused_rule(sql, key_slots=30, device=["cpu"] * 4, options=mesh)
    node = plan_fused_rule(sql, key_slots=30, device="cpu",
                           options={"planOptimizeStrategy": {"shards":
                                                             "auto"}})
    assert type(node.gb) is TorchGroupBy
    assert node.shard_info["mode"] == "single-chip"
    assert "fewer than 2 devices" in node.shard_info["reason"]
    hh = ("SELECT k, heavy_hitters(v, 2) AS hh FROM d "
          "GROUP BY k, TUMBLINGWINDOW(ss, 2)")
    with pytest.raises(NotImplementedError, match="heavy_hitters"):
        plan_fused_rule(hh, device=CPU8, options=mesh)
    with pytest.raises(NotImplementedError, match="planOptimizeStrategy"):
        plan_fused_rule(sql, device="cpu", options={
            "planOptimizeStrategy": {"enableIncrementalWindow": True}})
    # tiering is gated off under a mesh
    node = plan_fused_rule(sql, key_slots=2048, device=CPU8, options={
        **mesh, "tierStore": "on", "tierHotMb": 1})
    assert node.tier is None and isinstance(node.gb, ShardedGroupBy)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for devs in (["cuda:0", "cuda:1"], ["cpu", "cuda:0"]):
        with pytest.raises(NotImplementedError, match="item 9"):
            resolve_devices(devs)
        with pytest.raises(NotImplementedError, match="item 9"):
            plan_fused_rule(sql, device=devs, options=mesh)


def test_mesh_helpers():
    """make_mesh / ensure_devices / resolve_auto_cfg on a device list."""
    m = port_mesh.make_mesh(rows=2, devices=CPU8)
    assert m.shape == {"rows": 2, "keys": 4} and m.devices.shape == (2, 4)
    assert m.device == torch.device("cpu")
    with pytest.raises(ValueError):
        port_mesh.make_mesh(3, 3, CPU8)
    assert len(port_mesh.ensure_devices(4, CPU8)) == 4
    with pytest.raises(RuntimeError):
        port_mesh.ensure_devices(9, CPU8)
    assert port_mesh.resolve_auto_cfg({"auto": True}, CPU8) == {
        "rows": 1, "keys": 8}
    assert port_mesh.resolve_auto_cfg({"auto": True}, "cpu") is None
    assert port_mesh.resolve_auto_cfg({"rows": 2, "keys": 1}, "cpu") == {
        "rows": 2, "keys": 1}
    with pytest.raises(ValueError):
        port_mesh.mesh_from_options({"rows": 0, "keys": 4}, CPU8)


# ------------------------------------- (f) rules on the mesh, end to end
TUMBLING = ("SELECT k, count(*) AS c, avg(v) AS a, min(v) AS mn, "
            "max(v) AS mx, stddev(v) AS sd FROM s "
            "GROUP BY k, TUMBLINGWINDOW(ss, 10)")


def _rows_batch(rng, n, keys=60):
    return {"k": np.array([f"k{i}" for i in rng.integers(0, keys, n)],
                          dtype=object),
            "v": rng.normal(20, 5, n).astype(np.float32)}


def test_tumbling_rule_on_mesh_matches_reference(nodes):
    """plan_fused_rule with planOptimizeStrategy.mesh 2x4 on ["cpu"] * 8
    (default options) against the JAX rule on its 2x4 mesh
    (tests/test_parallel.py:243-258): windows equal, the state's keys
    growing past the first capacity."""
    t = plan_fused_rule(TUMBLING, key_slots=30, micro_batch=MB, device=CPU8,
                        options={"planOptimizeStrategy": {
                            "mesh": {"rows": 2, "keys": 4}}})
    t.broadcast = (tgot := []).append
    j = _jax_node(TUMBLING, mesh=(2, 4), capacity=30)
    nodes.extend([t, j])
    assert isinstance(t.gb, ShardedGroupBy) and t.gb.mesh_tag == "2x4"
    rng = np.random.default_rng(21)
    for w in range(4):
        for _ in range(3):
            cols = _rows_batch(rng, 300, keys=20 + 20 * w)
            _feed(t, cols)
            _feed(j, cols)
        _fire(t, (w + 1) * 10_000)
        _fire(j, (w + 1) * 10_000)
    assert t.gb.capacity == j.gb.capacity > 32
    _assert_windows(tgot, j.got, n_min=4)
    assert t.last_emit_info["source"] == "sync"


EV_HOP = ("SELECT k, count(*) AS c, avg(v) AS a, max(v) AS mx, hll(v) AS u "
          "FROM s GROUP BY k, HOPPINGWINDOW(ss, 4, 1)")


def test_event_time_hopping_on_mesh_matches_reference(nodes):
    """An event-time hopping rule on 2x4, behind both packages' watermark
    nodes: batches across bucket edges fold with the per-row pane vector
    (#24); windows equal, window by window."""
    opts = {"isEventTime": True, "lateTolerance": 1000,
            "planOptimizeStrategy": {"mesh": {"rows": 2, "keys": 4}}}
    t = plan_fused_rule(EV_HOP, key_slots=64, micro_batch=64, device=CPU8,
                        options=opts)
    t.broadcast = (tgot := []).append
    stmt = jax_parse(EV_HOP)
    plan = jax_plan_of(stmt)
    j = JaxNode("ref", stmt.window, plan, [d.expr for d in stmt.dimensions],
                capacity=64, micro_batch=64,
                direct_emit=jax_direct_emit(stmt, plan, ["k"]),
                emit_columnar=True, is_event_time=True,
                late_tolerance_ms=1000, mesh=jax_mesh.make_mesh(2, 4))
    j.state = j.gb.init_state()
    j.broadcast = (jgot := []).append
    jwm = JaxWatermarkNode("wm", late_tolerance_ms=1000)
    jwm.broadcast = lambda item: (j.on_watermark(item) if isinstance(
        item, JaxWatermark) else j.process(item))
    nodes.extend([t, j])
    rng = np.random.default_rng(22)
    for i in range(14):
        ts = ((3 + i) * 1000 + rng.integers(-1200, 300, 90)).astype(np.int64)
        cols = _rows_batch(rng, 90, keys=25)
        jwm.process(JaxBatch(n=90, columns=dict(cols), timestamps=ts,
                             emitter="s"))
        t.watermark.process(ColumnBatch(n=90, columns=dict(cols),
                                        timestamps=ts, emitter="s"))
    assert t.event_counts["vector_folds"] > 0
    _assert_windows(tgot, jgot, n_min=5)


SLIDE = ("SELECT deviceId, count(*) AS c, avg(temp) AS a, min(temp) AS mn, "
         "max(temp) AS mx FROM s GROUP BY deviceId, "
         "SLIDINGWINDOW(ss, 2) OVER (WHEN temp > 90)")


def test_sliding_rule_on_mesh_takes_the_refold_path(nodes, monkeypatch):
    """A sliding rule on 2x4 plans the refold path (sliding_fallback
    "sharded_kernel", as the reference names it), refolds its edges from
    the host rows (no masked fold, #2, on the sharded state) and emits the
    JAX sharded rule's windows, trigger by trigger."""
    from test_sliding_ring import random_trigger_batches

    def no_masked(*a, **k):
        raise AssertionError("masked fold on a sharded state")

    monkeypatch.setattr(kernels, "groupby_fold_masked", no_masked)
    t = plan_fused_rule(SLIDE, key_slots=64, micro_batch=MB, device=CPU8,
                        options={"planOptimizeStrategy": {
                            "mesh": {"rows": 2, "keys": 4}}})
    t.broadcast = (tgot := []).append
    stmt = jax_parse(SLIDE)
    plan = jax_plan_of(stmt)
    j = JaxNode("ref", stmt.window, plan, [d.expr for d in stmt.dimensions],
                capacity=64, micro_batch=MB,
                direct_emit=jax_direct_emit(stmt, plan, ["deviceId"]),
                emit_columnar=True, mesh=jax_mesh.make_mesh(2, 4))
    j.state = j.gb.init_state()
    j.broadcast = (jgot := []).append
    nodes.extend([t, j])
    assert t.sliding_impl == j.sliding_impl == "refold"
    assert t.sliding_fallback == "sharded_kernel"
    for b in random_trigger_batches(seed=23, n_batches=40, rows=60, keys=9):
        j.process(b)
        t.process(ColumnBatch(n=b.n, columns=dict(b.columns),
                              timestamps=b.timestamps, emitter=b.emitter))
    j._drain_async_emits()
    t._drain_async_emits()
    assert t.refold_counts["host"] > 0 and t.refold_counts["cached"] == 0
    assert not t._dev_ring_bytes
    _assert_windows(tgot, jgot, n_min=5)


STATE_SQL = ("SELECT deviceId, count(*) AS c, avg(v) AS a FROM s "
             "GROUP BY deviceId, STATEWINDOW(st = 1, st = 0)")
SESSION_SQL = ("SELECT k, count(*) AS c, avg(v) AS a FROM s "
               "GROUP BY k, SESSIONWINDOW(ss, 10, 2)")


def test_state_window_and_event_sessions_on_mesh(nodes):
    """A state window and event-time sessions on 2x4
    (tests/test_parallel.py:452-520), against the JAX rules on the same
    mesh."""
    mesh = {"planOptimizeStrategy": {"mesh": {"rows": 2, "keys": 4}}}
    t = plan_fused_rule(STATE_SQL, key_slots=64, micro_batch=64,
                        device=CPU8, options=mesh)
    t.broadcast = (tgot := []).append
    stmt = jax_parse(STATE_SQL)
    plan = jax_plan_of(stmt)
    j = JaxNode("ref", stmt.window, plan, [d.expr for d in stmt.dimensions],
                capacity=64, micro_batch=64,
                direct_emit=jax_direct_emit(stmt, plan, ["deviceId"]),
                emit_columnar=True, mesh=jax_mesh.make_mesh(2, 4))
    j.state = j.gb.init_state()
    j.broadcast = (jgot := []).append
    nodes.extend([t, j])
    rng = np.random.default_rng(24)
    for _ in range(6):
        n = 80
        st = np.where(rng.random(n) < 0.05, 1,
                      np.where(rng.random(n) < 0.05, 0, 2))
        cols = {"deviceId": np.array([f"d{i}" for i in
                                      rng.integers(0, 12, n)], dtype=object),
                "v": rng.normal(5, 2, n).astype(np.float32),
                "st": st.astype(np.int64)}
        j.process(JaxBatch(n=n, columns=dict(cols), emitter="s"))
        t.process(ColumnBatch(n=n, columns=dict(cols), emitter="s"))
    _assert_windows(tgot, jgot, n_min=2)

    opts = {**mesh, "isEventTime": True, "lateTolerance": 0}
    t2 = plan_fused_rule(SESSION_SQL, key_slots=32, micro_batch=64,
                         device=CPU8, options=opts)
    t2.broadcast = (tgot2 := []).append
    stmt = jax_parse(SESSION_SQL)
    plan = jax_plan_of(stmt)
    j2 = JaxNode("evs", stmt.window, plan, [d.expr for d in stmt.dimensions],
                 capacity=32, micro_batch=64, is_event_time=True,
                 direct_emit=jax_direct_emit(stmt, plan, ["k"]),
                 emit_columnar=True, mesh=jax_mesh.make_mesh(2, 4))
    j2.state = j2.gb.init_state()
    j2.broadcast = (jgot2 := []).append
    nodes.extend([t2, j2])
    for lo in (1000, 4000, 20_000):
        ts = np.sort(lo + rng.integers(0, 1500, 40)).astype(np.int64)
        cols = _rows_batch(rng, 40, keys=6)
        j2.process(JaxBatch(n=40, columns=dict(cols), timestamps=ts,
                            emitter="s"))
        t2.process(ColumnBatch(n=40, columns=dict(cols), timestamps=ts,
                               emitter="s"))
        j2.on_watermark(JaxWatermark(ts=int(ts[-1])))
        t2.on_watermark(Watermark(ts=int(ts[-1])))
    j2.on_watermark(JaxWatermark(ts=60_000))
    t2.on_watermark(Watermark(ts=60_000))
    assert t2.event_counts["sessions"] >= 2
    _assert_windows(tgot2, jgot2, n_min=2)
