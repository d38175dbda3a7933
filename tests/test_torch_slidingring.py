"""Parity of the port's DABA ring module (ekuiper_tpu_torch/ops/slidingring.py,
through the plain PyTorch versions of ring_advance / ring_flip / ring_query
on the CPU) and of the per-row pane fold against the JAX package's
SlidingRing and DeviceGroupBy.

Pane states and ring states are made from a seed with numpy (capacity 64,
scalar, hist and hll components) and handed to both packages; the
reference's programs run jitted, as the JAX package runs them.
Tolerances, each against the JAX result:
- layouts, the budget ladder, byte estimates: equal;
- advance and query: bit-equal (one add and one subtract per element; the
  query's weights are 0 and ±1, so every product is exact);
- flip: counts, act, hist, min/max and hll bit-equal; s1/s2 within rtol
  1e-5 (the masked sum over R panes runs in another order than XLA's
  reduce);
- the per-row pane fold: as tests/test_torch_groupby.py (s1/s2 rtol 1e-5,
  hll exact outside the cells a jnp.log2 miss reaches, the rest exact);
- a ±inf in pane 0 of an additive component: the reference multiplies it
  by a zero weight and the query gives NaN; the port gives the same NaN.
"""
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekuiper_tpu.ops import slidingring as jring
from ekuiper_tpu.ops.aggspec import extract_kernel_plan as jax_plan_of
from ekuiper_tpu.ops.groupby import DeviceGroupBy
from ekuiper_tpu.sql.parser import parse_select as jax_parse
from ekuiper_tpu_torch.ops import kernels
from ekuiper_tpu_torch.ops import slidingring as tring
from ekuiper_tpu_torch.ops.aggspec import extract_kernel_plan
from ekuiper_tpu_torch.ops.groupby import TorchGroupBy
from ekuiper_tpu_torch.sql.parser import parse_select

from test_torch_groupby import (_assert_sketch_state, _assert_state, _batch,
                                _hll_miss_cells, _sketch_batch)

CAP = 64
SQL = ("SELECT k, count(*) AS c, sum(v) AS s, stddev(v) AS sd, "
       "min(v) AS mn, max(v) AS mx, percentile_approx(v, 0.9) AS p, "
       "hll(v) AS u FROM s GROUP BY k, SLIDINGWINDOW(ss, 2) "
       "OVER (WHEN v > 90)")
LAYOUT_SQL = {
    "scalar": ("SELECT k, avg(v) AS a, min(v) AS mn, max(v) AS mx, "
               "count(*) AS c FROM s GROUP BY k, SLIDINGWINDOW(ss, 10) "
               "OVER (WHEN v > 44.5)"),
    "pct": ("SELECT k, percentile_approx(v, 0.99) AS p, count(*) AS c "
            "FROM s GROUP BY k, SLIDINGWINDOW(ss, 10) OVER (WHEN v > 44.5)"),
    "hll": ("SELECT k, hll(h) AS u FROM s GROUP BY k, "
            "SLIDINGWINDOW(ss, 10) OVER (WHEN v > 44.5)"),
    "wide_delay": ("SELECT k, distinct_count_approx(v) AS dc, "
                   "percentile_approx(v, 0.9) AS p, count(*) AS c FROM s "
                   "GROUP BY k, SLIDINGWINDOW(ss, 30, 2) "
                   "OVER (WHEN v > 90)"),
}


@pytest.fixture(scope="module", autouse=True)
def _no_cyclic_gc_inside_jax_locks():
    """As in test_torch_groupby.py: the JAX package's devwatch registry
    deadlocks when a cyclic collection lands inside its weakref prune."""
    enabled = gc.isenabled()
    gc.disable()
    yield
    if enabled:
        gc.enable()
    gc.collect()


# ---------------------------------------------------------------- layout
@pytest.mark.parametrize("args", [
    (10_000, 0, False, None, 0, 0), (10_000, 0, True, None, 0, 0),
    (2_000, 1_000, False, None, 0, 0), (500, 0, True, None, 0, 0),
    (60_000, 0, False, None, 0, 0),
    # the ladder: fits at once, after some rungs, never
    (10_000, 0, True, 256 << 20, 16 << 20, 1 << 20),
    (10_000, 0, True, 64 << 20, 16 << 20, 1 << 20),
    (10_000, 0, False, 8 << 20, 1 << 20, 0),
    (10_000, 0, True, 1, 16 << 20, 1 << 20)],
    ids=lambda a: "-".join(map(str, a)))
def test_plan_ring_layout_matches_reference(args):
    assert tring.plan_ring_layout(*args).__dict__ == \
        jring.plan_ring_layout(*args).__dict__


@pytest.mark.parametrize("name", sorted(LAYOUT_SQL))
@pytest.mark.parametrize("cap,budget", [(None, None), (16_384, 256),
                                        (16_384, 64), (2_048, 1),
                                        (64, 256)])
def test_ring_layout_for_matches_reference(name, cap, budget):
    sql = LAYOUT_SQL[name]
    jstmt, tstmt = jax_parse(sql), parse_select(sql)
    jplan, tplan = jax_plan_of(jstmt), extract_kernel_plan(tstmt)
    got = tring.ring_layout_for(tstmt.window, tplan, capacity=cap,
                                budget_mb=budget)
    want = jring.ring_layout_for(jstmt.window, jplan, capacity=cap,
                                 budget_mb=budget)
    assert got.__dict__ == want.__dict__
    if cap is not None:
        assert tring._plan_ring_bytes(tplan, cap) == \
            jring._plan_ring_bytes(jplan, cap)


def test_flagship_layouts():
    """The three rules of chip_smoke.py phase D at 16,384 slots and the
    default 256 MB budget: the percentile rule's 208 ms buckets on 52 ring
    panes, the scalar rule's 78 ms on 132, hll coarsened to 1,250 ms on 11
    (201 MB)."""
    want = {"pct": (208, 52), "scalar": (78, 132), "hll": (1250, 11)}
    for name, (bucket, r) in want.items():
        stmt = parse_select(LAYOUT_SQL[name])
        plan = extract_kernel_plan(stmt)
        lay = tring.ring_layout_for(stmt.window, plan, capacity=16_384,
                                    budget_mb=256)
        assert (lay.bucket_ms, lay.n_ring_panes) == (bucket, r)
        mm, fixed = tring._plan_ring_bytes(plan, 16_384)
        assert fixed + (1 + r) * mm <= 256 << 20


# ------------------------------------------------------------- the kernels
def _pair(sql=SQL, cap=CAP):
    jplan = jax_plan_of(jax_parse(sql))
    tstmt = parse_select(sql)
    tplan = extract_kernel_plan(tstmt)
    layout = tring.ring_layout_for(tstmt.window, tplan)
    jgb = DeviceGroupBy(jplan, capacity=cap, n_panes=layout.n_panes,
                        micro_batch=256)
    tgb = TorchGroupBy(tplan, capacity=cap, n_panes=layout.n_panes,
                       micro_batch=256, device="cpu")
    jr = jring.SlidingRing(jgb, jring.RingLayout(**layout.__dict__))
    tr = tring.SlidingRing(tgb, layout)
    return jgb, tgb, jr, tr


def _random_like(rng, comp, shape):
    """Values of one component: small integer counts for the additive
    counters, N(20, 5) sums, min/max with some identities, hll ranks."""
    if comp in ("n", "act", "hist"):
        return rng.integers(0, 6, shape).astype(np.float32)
    if comp in ("s1", "s2"):
        return rng.normal(20, 5, shape).astype(np.float32)
    if comp == "hll":
        return rng.integers(0, 30, shape).astype(np.float32)
    v = rng.normal(20, 5, shape).astype(np.float32)
    v[rng.random(shape) < 0.2] = kernels.INIT[comp]
    return v


def _states(seed, jgb, tgb, jr, tr):
    """(jax pane state, port pane state, jax ring, port ring), numpy-made."""
    rng = np.random.default_rng(seed)
    pane = {c: _random_like(rng, c, tuple(a.shape))
            for c, a in tgb.init_state().items()}
    ring = {k: _random_like(rng, k.split("_", 1)[1], tuple(a.shape))
            for k, a in tr.init_state().items()}
    assert set(ring) == set(jr.init_state())
    return ({c: jnp.asarray(v) for c, v in pane.items()},
            {c: torch.from_numpy(v.copy()) for c, v in pane.items()},
            {k: jnp.asarray(v) for k, v in ring.items()},
            {k: torch.from_numpy(v.copy()) for k, v in ring.items()})


def _same(got: dict, want: dict, sum_rtol=0.0):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key].numpy() if isinstance(got[key], torch.Tensor) \
            else np.asarray(got[key])
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, key
        if sum_rtol and key.split("_", 1)[-1] in ("s1", "s2"):
            np.testing.assert_allclose(g, w, rtol=sum_rtol, err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


@pytest.fixture(scope="module")
def pair():
    return _pair()


def test_ring_state_init_grow_estimate_match_reference(pair):
    jgb, tgb, jr, tr = pair
    assert (tr.add_comps, tr.mm_comps) == (jr.add_comps, jr.mm_comps)
    _same(tr.init_state(), jr.init_state())
    assert tr.state_nbytes(tr.init_state()) == \
        jr.state_nbytes(jr.init_state()) == tr.estimate_bytes(CAP) == \
        jr.estimate_bytes(CAP)
    _, _, jring_st, tring_st = _states(3, jgb, tgb, jr, tr)
    _same(tr.grow(tring_st, 2 * CAP), jr.grow(jring_st, 2 * CAP))
    tr.capacity = jr.capacity = CAP


@pytest.mark.parametrize("closed_on,evict_on",
                         [(True, True), (True, False), (False, True),
                          (False, False)])
def test_advance_matches_reference(pair, closed_on, evict_on):
    jgb, tgb, jr, tr = pair
    js, ts, jring_st, tring_st = _states(4, jgb, tgb, jr, tr)
    want = jr.advance(jring_st, js, 7, closed_on, 40, evict_on)
    got = tr.advance(tring_st, ts, 7, closed_on, 40, evict_on)
    assert got is tring_st  # in place
    _same(got, want)


@pytest.mark.parametrize("base,pattern", [(0, "all"), (17, "all"),
                                          (51, "some"), (30, "none")])
def test_flip_matches_reference(pair, base, pattern):
    jgb, tgb, jr, tr = pair
    js, ts, jring_st, tring_st = _states(5 + base, jgb, tgb, jr, tr)
    R = tr.n_ring_panes
    valid = {"all": np.ones(R, dtype=bool), "none": np.zeros(R, dtype=bool),
             "some": np.random.default_rng(base).random(R) < 0.6}[pattern]
    want = jr.flip(jring_st, js, base, valid)
    got = tr.flip(tring_st, ts, base, valid)
    _same(got, want, sum_rtol=1e-5)


QUERIES = {
    "fast": dict(body_on=True, f_on=True, f_slot=9,
                 adj_slots=[3, 4, 12, 0], adj_weights=[-1, -1, 1, 0],
                 adj_mm=[False, False, True, False]),
    "no_front": dict(body_on=True, f_on=False, f_slot=0,
                     adj_slots=[5, 0, 0, 0], adj_weights=[1, 0, 0, 0],
                     adj_mm=[True, False, False, False]),
    "head_only": dict(body_on=False, f_on=False, f_slot=0,
                      adj_slots=[21, 0, 0, 0], adj_weights=[1, 0, 0, 0],
                      adj_mm=[True, False, False, False]),
}


def _query(ring, st, q, ring_state):
    kw = dict(q)
    for key, dt in (("adj_slots", np.int32), ("adj_weights", np.float32),
                    ("adj_mm", np.bool_)):
        kw[key] = np.asarray(kw[key], dtype=dt)
    pending = ring.query_begin(ring_state, st, **kw)
    out = {k: np.array(v) for k, v in pending.get().items()}
    pending.release() if hasattr(pending, "release") else None
    return out


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_query_matches_reference(pair, name):
    jgb, tgb, jr, tr = pair
    js, ts, jring_st, tring_st = _states(6, jgb, tgb, jr, tr)
    got = _query(tr, ts, QUERIES[name], tring_st)
    want = _query(jr, js, QUERIES[name], jring_st)
    assert [c for c, *_ in tgb._components_layout()] == list(want)
    _same({k: torch.from_numpy(v) for k, v in got.items()}, want)


@pytest.mark.parametrize("value", [np.inf, -np.inf])
def test_query_zero_weight_inf_is_nan_as_the_reference(pair, value):
    """A fault of the reference, reproduced: every adjustment slot is
    multiplied by its weight, the unused ones (weight 0) point at pane 0,
    so a ±inf sum in pane 0 makes the queried sum NaN (0·inf)."""
    jgb, tgb, jr, tr = pair
    js, ts, jring_st, tring_st = _states(7, jgb, tgb, jr, tr)
    s1 = np.array(js["s1"])
    s1[0, 3, 0] = value
    js["s1"] = jnp.asarray(s1)
    ts["s1"][0, 3, 0] = value
    q = QUERIES["no_front"]
    got = _query(tr, ts, q, tring_st)
    want = _query(jr, js, q, jring_st)
    assert np.isnan(want["s1"][3, 0]) and np.isnan(got["s1"][3, 0])
    _same({k: torch.from_numpy(v) for k, v in got.items()}, want)


def test_kernel_wrappers_count_no_launch_on_the_cpu(pair):
    jgb, tgb, jr, tr = pair
    _, ts, _, tring_st = _states(8, jgb, tgb, jr, tr)
    kernels.reset_launches()
    tr.advance(tring_st, ts, 1, True, 2, True)
    tr.flip(tring_st, ts, 0, np.ones(tr.n_ring_panes, dtype=bool))
    _query(tr, ts, QUERIES["fast"], tring_st)
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)


def test_flip_refuses_an_order_that_is_no_permutation(pair):
    jgb, tgb, jr, tr = pair
    _, ts, _, tring_st = _states(9, jgb, tgb, jr, tr)
    order = np.zeros(tr.n_ring_panes, dtype=np.int32)
    with pytest.raises(ValueError, match="permutation"):
        kernels.ring_flip(tring_st, ts, tr._comps, order,
                          np.ones(tr.n_ring_panes, dtype=bool))


# ------------------------------------------------------- per-row pane fold
FOLD_SQL = {
    "scalar": ("SELECT k, count(*) AS c, sum(v) AS s, min(v) AS mn, "
               "max(v) AS mx, stddev(v) AS sd, count(v) FILTER "
               "(WHERE w > 0) AS cf FROM s WHERE v > 5 OR w < 0 "
               "GROUP BY k, SLIDINGWINDOW(ss, 2) OVER (WHEN v > 90)"),
    "wide": ("SELECT k, count(*) AS c, hll(v) AS u, percentile_approx(v, "
             "0.9) AS p, heavy_hitters(code, 3) AS top FROM s "
             "GROUP BY k, SLIDINGWINDOW(ss, 2) OVER (WHEN v > 90)"),
}


@pytest.mark.parametrize("name", sorted(FOLD_SQL))
def test_per_row_pane_fold_matches_reference(name):
    sql = FOLD_SQL[name]
    jplan = jax_plan_of(jax_parse(sql))
    tplan = extract_kernel_plan(parse_select(sql))
    P = 6
    jgb = DeviceGroupBy(jplan, capacity=CAP, n_panes=P, micro_batch=256)
    tgb = TorchGroupBy(tplan, capacity=CAP, n_panes=P, micro_batch=256,
                       device="cpu")
    rng = np.random.default_rng(21)
    js, ts, miss = jgb.init_state(), tgb.init_state(), set()
    for _ in range(3):
        cols, valid, slots = (_sketch_batch(rng, 600) if name == "wide"
                              else _batch(rng, 600, 50))  # > mb: 3 chunks
        pv = rng.integers(0, P, 600)
        js = jgb.fold(js, cols, slots, valid, pv)
        ts = tgb.fold(ts, cols, slots, valid, pv)
        if name == "wide":
            for p in range(P):
                sel = np.nonzero(pv == p)[0]
                miss |= _hll_miss_cells(
                    tgb, {k: v[sel] for k, v in cols.items()}, slots[sel], p)
    got, want = tgb.state_to_host(ts), jgb.state_to_host(js)
    assert (got["act"].sum(axis=1) > 0).all()  # every pane received rows
    if name == "wide":
        _assert_sketch_state(got, want, miss)
    else:
        _assert_state(got, want)


def test_per_row_pane_outside_the_panes_raises():
    tgb = TorchGroupBy(extract_kernel_plan(parse_select(FOLD_SQL["scalar"])),
                       capacity=CAP, n_panes=4, micro_batch=64, device="cpu")
    st = tgb.init_state()
    cols, valid, slots = _batch(np.random.default_rng(1), 10, 20)
    for bad in (np.full(10, 4), np.full(10, -1)):
        with pytest.raises(ValueError, match="pane outside"):
            tgb.fold(st, cols, slots, valid, bad)
    assert float(st["act"].sum()) == 0.0
