"""The port's CUDA kernels against their plain PyTorch versions, on the
card (marked `cuda`; each test skips where no card is present). Run on a
machine with a card:

    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda

Small shapes with colliding slots (many rows per key) so the atomics
contend. Tolerances: counts, act, min, max and reset bit-equal; sums rtol
1e-5 (atomic order differs from index_put_'s); final values rtol 1e-6
(the kernel rounds each step as the plain version does). Sketches: the
hll registers, hist bins and hh counters bit-equal (integer-valued float
atomics); the heavy-hitter candidates (codes, estimates and their order)
bit-equal; the hll estimate within ±1 (its 256-term sum runs in another
order than torch.sum's, which can move the rounded estimate by one); the
percentile within 4 ulp (expf of the kernel against torch.exp).
Prefinalize: the pane-merged components and the absorbed state
bit-equal (a merge of at most two panes, and one add per element, round
alike in any order); the components fetch lands in pinned host memory
and holds no row folded after its launch. Sliding ring: advance and query
bit-equal (one add and one subtract per element; query weights 0 and ±1,
zero-weight slots included, so 0·inf gives NaN in both); flip bit-equal
except s1/s2 within rtol 1e-5 (the kernel sums the ring slots in age
order, torch.sum in its own); the folds with a per-row pane vector as
the folds; a ring query's fetch holds no fold, advance, flip or pane
reset launched after it. Rule group: the batched fold, finalize (on the
key cut) and pane reset with the single-rule tolerances; a group
boundary's fetch holds no fold or pane reset launched after it. Sketch
groups: the batched wide fold bit-equal to its plain version (max is
order-free, counts stay below 2^24) and to the single-rule wide fold of
each rule; the batched wide finalize with the single-rule finalize's
bounds (hll within ±1, percentile within 4 ulp); the pane reset over
the wide state bit-equal.
"""
import numpy as np
import pytest
import torch

from ekuiper_tpu_torch.ops import kernels
from ekuiper_tpu_torch.ops.aggspec import encode_hll_column
from ekuiper_tpu_torch.planner.fused import plan_fused_rule

pytestmark = pytest.mark.cuda

SQL = (
    "SELECT k, count(*) AS c, sum(v) AS s, avg(v) AS a, min(v) AS mn, "
    "max(v) AS mx, stddev(v) AS sd, stddevs(v) AS sds, var(v) AS va, "
    "vars(v) AS vas, count(v) FILTER (WHERE w > 0) AS cf "
    "FROM s WHERE v > 5 OR w < 0 GROUP BY k, HOPPINGWINDOW(ss, 10, 5)"
)


@pytest.fixture
def gb():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    node = plan_fused_rule(SQL, key_slots=512, micro_batch=4096)
    return node.gb


def _inputs(gb, seed, rows=4096, keys=300):
    rng = np.random.default_rng(seed)
    v = rng.normal(20, 5, rows).astype(np.float32)
    v[rng.random(rows) < 0.05] = np.nan
    # signed zeros, tiny values, and overflow to inf in s2 and mean² (an
    # inf - inf variance must stay NaN, as in the reference); all large
    # values positive, so no sum depends on the atomics' order beyond
    # rounding
    v[:8] = [0.0, -0.0, -1.5, 3.0e38, 1.0e30, 1e-30, -1e-30, 2.0]
    w = rng.normal(0, 1, rows).astype(np.float32)
    dev = gb.device
    cols = {"v": torch.from_numpy(v).to(dev),
            "w": torch.from_numpy(w).to(dev),
            "__valid_w": torch.from_numpy(rng.random(rows) > 0.1).to(dev)}
    base, V, M = gb.spec_inputs(cols, rows)
    slots = torch.from_numpy(
        rng.integers(0, keys, rows).astype(np.int32)).to(dev)
    return base, V, M, slots


def _same(got, ref, rtol):
    for comp in ref:
        g, r = got[comp].cpu().numpy(), ref[comp].cpu().numpy()
        if comp in ("s1", "s2"):
            np.testing.assert_allclose(g, r, rtol=rtol, err_msg=comp)
        else:
            np.testing.assert_array_equal(g, r, err_msg=comp)


@pytest.mark.parametrize("pane", [0, 1])
def test_fold_matches_plain(gb, pane):
    kernels.reset_launches()
    got, ref = gb.init_state(), gb.init_state()
    for seed in range(3):
        base, V, M, slots = _inputs(gb, seed)
        kernels.groupby_fold_scalar(got, base, V, M, slots, pane, gb._colmap)
        kernels.fold_scalar_plain(ref, base, V, M, slots, pane, gb._colmap)
    torch.cuda.synchronize()
    _same(got, ref, 1e-5)
    assert kernels.LAUNCHES["groupby_fold_scalar"] == 3


@pytest.mark.parametrize("panes", [None, [0], [1]])
def test_finalize_matches_plain(gb, panes):
    st = gb.init_state()
    for pane in (0, 1):
        base, V, M, slots = _inputs(gb, 10 + pane)
        kernels.fold_scalar_plain(st, base, V, M, slots, pane, gb._colmap)
    pm = gb._pane_mask(panes)
    got = kernels.groupby_finalize_scalar(st, pm, gb._spectab).cpu().numpy()
    ref = kernels.finalize_scalar_plain(st, pm, gb._spectab).cpu().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0, equal_nan=True)


def test_reset_matches_plain(gb):
    st = gb.init_state()
    base, V, M, slots = _inputs(gb, 20)
    kernels.fold_scalar_plain(st, base, V, M, slots, 1, gb._colmap)
    got = {k: v.clone() for k, v in st.items()}
    kernels.groupby_reset_pane(got, 1)
    kernels.reset_pane_plain(st, 1)
    torch.cuda.synchronize()
    _same(got, st, 0)


SKETCH_SQL = (
    "SELECT k, count(*) AS c, hll(v) AS u, percentile_approx(v, 0.9) AS p, "
    "heavy_hitters(code, 3) AS top, avg(v) AS a "
    "FROM s GROUP BY k, HOPPINGWINDOW(ss, 10, 5)"
)


@pytest.fixture
def sgb():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    node = plan_fused_rule(SKETCH_SQL, key_slots=512, micro_batch=4096)
    return node.gb


def _sketch_inputs(gb, seed, rows=4096, keys=300):
    rng = np.random.default_rng(seed)
    v = rng.normal(20, 5, rows).astype(np.float32)
    v[rng.random(rows) < 0.05] = np.nan
    v[:6] = [0.0, -0.0, -3.5, 1e-12, 3e12, -2e20]  # zero, both signs, clip
    p = rng.random(rows)
    code = np.where(p < 0.35, 7, np.where(p < 0.55, 13, rng.integers(
        100, 2100, rows))).astype(np.float32)
    code[rng.random(rows) < 0.02] = np.nan  # NULL codes are masked
    dev = gb.device
    cols = {"v": torch.from_numpy(v).to(dev),
            "__hll__v": torch.from_numpy(encode_hll_column(v, rows)).to(dev),
            "__hhc__code": torch.from_numpy(code).to(dev)}
    base, V, M = gb.spec_inputs(cols, rows)
    slots = torch.from_numpy(
        rng.integers(0, keys, rows).astype(np.int32)).to(dev)
    return base, V, M, slots


def _fold_sketches(gb, st, seed, pane, kernel: bool):
    base, V, M, slots = _sketch_inputs(gb, seed)
    if kernel:
        kernels.groupby_fold_scalar(st, base, V, M, slots, pane, gb._colmap)
        kernels.groupby_fold_wide(st, V, M, slots, pane, gb._widemap)
    else:
        kernels.fold_scalar_plain(st, base, V, M, slots, pane, gb._colmap)
        kernels.fold_wide_plain(st, V, M, slots, pane, gb._widemap)


@pytest.mark.parametrize("pane", [0, 1])
def test_fold_wide_matches_plain(sgb, pane):
    kernels.reset_launches()
    got, ref = sgb.init_state(), sgb.init_state()
    for seed in range(3):
        _fold_sketches(sgb, got, seed, pane, kernel=True)
        _fold_sketches(sgb, ref, seed, pane, kernel=False)
    torch.cuda.synchronize()
    _same(got, ref, 1e-5)
    assert kernels.LAUNCHES["groupby_fold_wide"] == 3
    assert float(got["hh"].sum()) > 0 and float(got["hll"].max()) > 0


def _folded_sketch_state(gb):
    st = gb.init_state()
    for pane in (0, 1):
        _fold_sketches(gb, st, 30 + pane, pane, kernel=False)
    return st


@pytest.mark.parametrize("panes", [None, [0], [1]])
def test_finalize_wide_matches_plain(sgb, panes):
    st = _folded_sketch_state(sgb)
    pm = sgb._pane_mask(panes)
    got = torch.full((sgb._rows, sgb.capacity), -1.0, device=sgb.device)
    ref = got.clone()
    kernels.groupby_finalize_wide(st, pm, sgb._widetab, sgb._fracs, got)
    kernels.finalize_wide_plain(st, pm, sgb._widetab, sgb._fracs, ref)
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    for kind, _, row in sgb._widetab.tolist():
        g, r = got[row], ref[row]
        if kind == kernels.WIDE_KIND_IDS["hll"]:
            assert np.abs(g - r).max() <= 1.0
        else:
            assert (np.isnan(g) == np.isnan(r)).all()
            ok = ~np.isnan(r)
            np.testing.assert_allclose(g[ok], r[ok], rtol=4 * 2.0 ** -23)
    untouched = np.setdiff1d(np.arange(sgb._rows), sgb._widetab[:, 2])
    assert (got[untouched] == -1.0).all()


@pytest.mark.parametrize("panes", [None, [0], [1]])
def test_hh_finalize_matches_plain(sgb, panes):
    st = _folded_sketch_state(sgb)
    pm = sgb._pane_mask(panes)
    got = torch.full((sgb._rows, sgb.capacity), -1.0, device=sgb.device)
    ref = got.clone()
    kernels.groupby_hh_finalize(st, pm, sgb._hhtab, got)
    kernels.hh_finalize_plain(st, pm, sgb._hhtab, ref)
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())
    (k, k2, row), = sgb._hhtab.tolist()
    assert (got[row + k2] > 0).sum() > 0  # some key has a heavy hitter


def test_sketch_rule_finalizes_through_the_kernels(sgb):
    """The whole finalize of a plan with scalar, sketch and heavy-hitters
    specs: the three finalize kernels fill one result, read once."""
    st = _folded_sketch_state(sgb)
    kernels.reset_launches()
    outs, act = sgb.finalize(st, 300)
    assert {n: kernels.LAUNCHES[n] for n in (
        "groupby_finalize_scalar", "groupby_finalize_wide",
        "groupby_hh_finalize")} == dict.fromkeys(
        ("groupby_finalize_scalar", "groupby_finalize_wide",
         "groupby_hh_finalize"), 1)
    live = act > 0
    top = outs[3][live]
    assert all(top)  # every live key has a heavy hitter
    assert np.mean([row[0][0] == 7 for row in top]) > 0.7  # 35 % of rows
    assert outs[1].dtype == np.int64 and (outs[1][live] > 0).all()


def test_reset_wide_matches_plain(sgb):
    st = _folded_sketch_state(sgb)
    got = {k: v.clone() for k, v in st.items()}
    kernels.groupby_reset_pane(got, 1)
    kernels.reset_pane_plain(st, 1)
    torch.cuda.synchronize()
    _same(got, st, 0)


# ------------------------------------------------------------ prefinalize
def _comps_state(gb, panes):
    """A state with rows in both panes, and the pane mask of `panes`."""
    st = _folded_sketch_state(gb) if "hh" in gb.comp_specs else None
    if st is None:
        st = gb.init_state()
        for pane in (0, 1):
            base, V, M, slots = _inputs(gb, 40 + pane)
            kernels.fold_scalar_plain(st, base, V, M, slots, pane,
                                      gb._colmap)
    pm = gb._pane_mask(panes) if panes != "empty" else \
        gb._mask_tensor(np.zeros(gb.n_panes, dtype=bool))
    return st, pm


@pytest.mark.parametrize("panes", [None, [0], [1], "empty"])
@pytest.mark.parametrize("which", ["scalar", "sketch"])
def test_components_match_plain(gb, sgb, which, panes):
    g = gb if which == "scalar" else sgb
    st, pm = _comps_state(g, panes)
    kernels.reset_launches()
    got = kernels.groupby_components(st, pm, g._comp_order)
    ref = kernels.components_plain(st, pm, g._comp_order)
    assert kernels.LAUNCHES["groupby_components"] == 1
    assert got.shape == ref.shape == (g.capacity, sum(
        w for _, _, w, _ in g._components_layout()))
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.parametrize("pane", [0, 1])
@pytest.mark.parametrize("which,lacks", [("scalar", "mx"),
                                         ("sketch", "s1")])
def test_absorb_matches_plain(gb, sgb, which, lacks, pane):
    g = gb if which == "scalar" else sgb
    st, _ = _comps_state(g, None)
    rng = np.random.default_rng(50)
    cs = g.capacity // 2  # a shadow narrower than the state
    shadow = {}
    for comp, arr in st.items():
        if comp == lacks:
            continue  # a component the shadow lacks stays as it is
        host = (rng.normal(20, 5, (cs, *arr.shape[2:])) if comp in (
            "mn", "mx", "s1", "s2") else rng.integers(
            0, 5, (cs, *arr.shape[2:])))
        shadow[comp] = torch.from_numpy(host.astype(np.float32)).to(
            g.device)
    got = {k: v.clone() for k, v in st.items()}
    kernels.reset_launches()
    kernels.groupby_absorb(got, shadow, pane)
    kernels.absorb_plain(st, shadow, pane)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["groupby_absorb"] == 1
    _same(got, st, 0)


def test_fetch_is_pinned_and_holds_no_later_fold(gb):
    """The components fetch copies into pinned memory on its own stream;
    a fold launched right after the pre-issue (no synchronize between)
    does not reach it."""
    st = gb.init_state()
    base, V, M, slots = _inputs(gb, 60)
    kernels.groupby_fold_scalar(st, base, V, M, slots, 0, gb._colmap)
    head = kernels.components_plain(st, gb._pane_mask(None), gb._comp_order)
    pending = gb.prefinalize_begin(st)
    for seed in range(61, 64):
        base, V, M, slots = _inputs(gb, seed)
        kernels.groupby_fold_scalar(st, base, V, M, slots, 0, gb._colmap)
    assert pending._buf.is_pinned()
    comps = pending.get()
    assert pending.ready() and pending.copy_ms() is not None
    torch.cuda.synchronize()
    full = kernels.components_plain(st, gb._pane_mask(None), gb._comp_order)
    want = head.cpu().numpy()
    assert not np.array_equal(want, full.cpu().numpy())
    got = np.concatenate([comps[c].reshape(len(want), -1)
                          for c, *_ in gb._components_layout()], axis=1)
    np.testing.assert_array_equal(got, want)
    pending.release()


# ------------------------------------------------------------ sliding ring
RING_SQL = (
    "SELECT k, count(*) AS c, sum(v) AS s, stddev(v) AS sd, min(v) AS mn, "
    "max(v) AS mx, percentile_approx(v, 0.9) AS p, hll(v) AS u "
    "FROM s GROUP BY k, SLIDINGWINDOW(ss, 2) OVER (WHEN v > 90)"
)


@pytest.fixture
def rnode():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return plan_fused_rule(RING_SQL, key_slots=512, micro_batch=4096)


def _ring_states(node, seed):
    """Pane state and ring state of the node's plan on the card, made from
    numpy: counts, N(20, 5) sums, min/max with some identities, ranks."""
    rng = np.random.default_rng(seed)

    def like(comp, shape):
        if comp in ("n", "act", "hist"):
            return rng.integers(0, 6, shape).astype(np.float32)
        if comp == "hll":
            return rng.integers(0, 30, shape).astype(np.float32)
        v = rng.normal(20, 5, shape).astype(np.float32)
        if comp in ("mn", "mx"):
            v[rng.random(shape) < 0.2] = kernels.INIT[comp]
        return v

    dev = node.gb.device
    st = {c: torch.from_numpy(like(c, tuple(a.shape))).to(dev)
          for c, a in node.gb.init_state().items()}
    ring = {k: torch.from_numpy(like(k.split("_", 1)[1],
                                     tuple(a.shape))).to(dev)
            for k, a in node.ring.init_state().items()}
    return st, ring


def _same_ring(got, ref, rtol):
    for key in ref:
        g, r = got[key].cpu().numpy(), ref[key].cpu().numpy()
        if key.split("_", 1)[1] in ("s1", "s2"):
            np.testing.assert_allclose(g, r, rtol=rtol, err_msg=key)
        else:
            np.testing.assert_array_equal(g, r, err_msg=key)


@pytest.mark.parametrize("closed_on,evict_on", [(True, True), (True, False),
                                                (False, True)])
def test_ring_advance_matches_plain(rnode, closed_on, evict_on):
    st, ring = _ring_states(rnode, 70)
    ref = {k: v.clone() for k, v in ring.items()}
    comps = rnode.ring._comps
    kernels.reset_launches()
    kernels.ring_advance(ring, st, comps, 5, closed_on, 40, evict_on)
    kernels.ring_advance_plain(ref, st, comps, 5, closed_on, 40, evict_on)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ring_advance"] == 1
    _same_ring(ring, ref, 0)


@pytest.mark.parametrize("base,pattern", [(0, "all"), (29, "some"),
                                          (7, "none")])
def test_ring_flip_matches_plain(rnode, base, pattern):
    st, ring = _ring_states(rnode, 71)
    R = rnode.n_ring_panes
    order = ((base + np.arange(R)) % R).astype(np.int32)
    valid = {"all": np.ones(R, dtype=bool), "none": np.zeros(R, dtype=bool),
             "some": np.random.default_rng(base).random(R) < 0.6}[pattern]
    ref = {k: v.clone() for k, v in ring.items()}
    comps = rnode.ring._comps
    kernels.ring_flip(ring, st, comps, order, valid)
    kernels.ring_flip_plain(ref, st, comps, order, valid)
    torch.cuda.synchronize()
    _same_ring(ring, ref, 1e-5)


@pytest.mark.parametrize("case", ["fast", "head_only", "zero_weight_inf"])
def test_ring_query_matches_plain(rnode, case):
    st, ring = _ring_states(rnode, 72)
    if case == "zero_weight_inf":
        st["s1"][0, 3, 0] = float("inf")
    body = case != "head_only"
    slots = np.array([3, 4, 12, 0] if body else [21, 0, 0, 0], np.int32)
    w = np.array([-1, -1, 1, 0] if body else [1, 0, 0, 0], np.float32)
    mm = np.array([0, 0, 1, 0] if body else [1, 0, 0, 0], bool)
    comps = rnode.ring._query_comps
    got = kernels.ring_query(ring, st, comps, body, body, 9, slots, w, mm)
    ref = kernels.ring_query_plain(ring, st, comps, body, body, 9, slots, w,
                                   mm)
    g, r = got.cpu().numpy(), ref.cpu().numpy()
    assert g.shape == (rnode.gb.capacity, sum(
        w_ for _, _, w_, _ in rnode.gb._components_layout()))
    np.testing.assert_array_equal(g, r)
    if case == "zero_weight_inf":  # 0 · inf in an unused slot: NaN
        col = next(c for comp, c, *_ in rnode.gb._components_layout()
                   if comp == "s1")
        assert np.isnan(g[3, col])


@pytest.mark.parametrize("which", ["scalar", "wide"])
def test_fold_with_pane_vector_matches_plain(rnode, which):
    gb = rnode.gb
    rng = np.random.default_rng(73)
    rows = 4096
    v = rng.normal(20, 5, rows).astype(np.float32)
    dev = gb.device
    cols = {"v": torch.from_numpy(v).to(dev),
            "__hll__v": torch.from_numpy(encode_hll_column(v, rows)).to(dev)}
    base, V, M = gb.spec_inputs(cols, rows)
    slots = torch.from_numpy(rng.integers(0, 300, rows).astype(np.int32)
                             ).to(dev)
    pv = torch.from_numpy(rng.integers(0, gb.n_panes, rows).astype(np.uint8)
                          ).to(dev)
    got, ref = gb.init_state(), gb.init_state()
    kernels.reset_launches()
    if which == "scalar":
        kernels.groupby_fold_scalar(got, base, V, M, slots, 0, gb._colmap, pv)
        kernels.fold_scalar_plain(ref, base, V, M, slots, 0, gb._colmap, pv)
    else:
        kernels.groupby_fold_wide(got, V, M, slots, 0, gb._widemap, pv)
        kernels.fold_wide_plain(ref, V, M, slots, 0, gb._widemap, pv)
    torch.cuda.synchronize()
    name = f"groupby_fold_{which}"
    assert kernels.LAUNCHES[name] == kernels.ROW_PANE_LAUNCHES[name] == 1
    _same(got, ref, 1e-5)


def test_ring_query_fetch_holds_no_later_update(rnode):
    """In place against the reference's donation: a ring query launched
    right before a fold, an advance, a flip and a pane reset (no
    synchronize between) fetches the body as it stood at its launch."""
    st, ring = _ring_states(rnode, 74)
    ring_ref = {k: v.clone() for k, v in ring.items()}
    st_ref = {k: v.clone() for k, v in st.items()}
    args = dict(body_on=True, f_on=True, f_slot=9,
                adj_slots=np.array([3, 4, 12, 0], np.int32),
                adj_weights=np.array([-1, -1, 1, 0], np.float32),
                adj_mm=np.array([0, 0, 1, 0], bool))
    want = kernels.ring_query_plain(
        ring_ref, st_ref, rnode.ring._query_comps, True, True, 9,
        args["adj_slots"], args["adj_weights"], args["adj_mm"])
    pending = rnode.ring.query_begin(ring, st, **args)
    rnode.gb.fold(st, {"v": np.full(65_536, 7.0, np.float32)},
                  np.zeros(65_536, np.int32), pane_idx=12)
    rnode.ring.advance(ring, st, 12, True, 3, True)
    rnode.ring.flip(ring, st, 0, np.ones(rnode.n_ring_panes, dtype=bool))
    rnode.gb.reset_pane(st, 4)
    assert pending._buf.is_pinned()
    comps = pending.get()
    torch.cuda.synchronize()
    got = np.concatenate([comps[c].reshape(rnode.gb.capacity, -1)
                          for c, *_ in rnode.gb._components_layout()],
                         axis=1)
    np.testing.assert_array_equal(got, want.cpu().numpy())
    now = kernels.ring_query_plain(
        ring, st, rnode.ring._query_comps, True, True, 9,
        args["adj_slots"], args["adj_weights"], args["adj_mm"])
    assert not np.array_equal(now.cpu().numpy(), got)
    pending.release()


# ------------------------------------------------------------- rule group
GROUP_SQL = (
    "SELECT k, count(*) AS c, sum(v) AS s, avg(v) AS a, min(v) AS mn, "
    "max(v) AS mx, stddev(v) AS sd, vars(v) AS vas, "
    "count(v) FILTER (WHERE w > 0) AS cf "
    "FROM s WHERE v > {lo} OR w < {hi} GROUP BY k, HOPPINGWINDOW(ss, 10, 5)"
)


@pytest.fixture
def mnode():
    """A 6-rule hopping group on the card, 2,048 slots (so 300 keys cut to
    a 1,024-column finalize)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ekuiper_tpu_torch.planner.rulegroup import plan_rule_group

    sqls = [GROUP_SQL.format(lo=10 + 2 * i, hi=-1 + 0.25 * i)
            for i in range(6)]
    return plan_rule_group([f"r{i}" for i in range(6)], sqls,
                           key_slots=2048, micro_batch=4096)


def _group_inputs(gb, seed, rows=4096, keys=300):
    """(base (R, rows), V, M, slots) for one batch, specials as _inputs."""
    rng = np.random.default_rng(seed)
    v = rng.normal(20, 5, rows).astype(np.float32)
    v[rng.random(rows) < 0.05] = np.nan
    v[:8] = [0.0, -0.0, -1.5, 3.0e38, 1.0e30, 1e-30, -1e-30, 2.0]
    dev = gb.device
    cols = {"v": torch.from_numpy(v).to(dev),
            "w": torch.from_numpy(
                rng.normal(0, 1, rows).astype(np.float32)).to(dev),
            "__valid_w": torch.from_numpy(rng.random(rows) > 0.1).to(dev)}
    base, V, M = gb.rule_inputs(cols, rows)
    slots = torch.from_numpy(
        rng.integers(0, keys, rows).astype(np.int32)).to(dev)
    return base, V, M, slots


@pytest.mark.parametrize("pane", [0, 1])
def test_multirule_fold_matches_plain(mnode, pane):
    """One launch per batch folds every rule; each rule's row mask differs."""
    gb = mnode.gb
    kernels.reset_launches()
    got, ref = gb.init_state(), gb.init_state()
    for seed in range(3):
        base, V, M, slots = _group_inputs(gb, 80 + seed)
        assert tuple(base.shape) == (6, 4096)
        kernels.multirule_fold(got, base, V, M, slots, pane, gb._colmap)
        kernels.multirule_fold_plain(ref, base, V, M, slots, pane,
                                     gb._colmap)
    torch.cuda.synchronize()
    _same(got, ref, 1e-5)
    assert kernels.LAUNCHES["multirule_fold"] == 3
    act = got["act"].cpu().numpy()
    assert (act[0] != act[-1]).any()


def _group_state(gb):
    st = gb.init_state()
    for pane in (0, 1):
        base, V, M, slots = _group_inputs(gb, 90 + pane)
        kernels.multirule_fold_plain(st, base, V, M, slots, pane, gb._colmap)
    return st


@pytest.mark.parametrize("panes", [None, [0], [1]])
def test_multirule_finalize_matches_plain(mnode, panes):
    """Every rule's final values and act in one launch, only the K = 1,024
    columns of the key cut written; rtol 1e-6 as the single-rule
    finalize."""
    gb = mnode.gb
    st = _group_state(gb)
    pm = gb._pane_mask(panes)
    K = gb._slice_keys(300)
    kernels.reset_launches()
    got = kernels.multirule_finalize(st, pm, gb._spectab, K)
    ref = kernels.multirule_finalize_plain(st, pm, gb._spectab, K)
    assert tuple(got.shape) == (6, len(gb.plan.specs) + 1, 1024)
    assert kernels.LAUNCHES["multirule_finalize"] == 1
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-6, atol=0, equal_nan=True)


def test_multirule_reset_matches_plain(mnode):
    gb = mnode.gb
    st = _group_state(gb)
    got = {k: v.clone() for k, v in st.items()}
    kernels.multirule_reset_pane(got, 1)
    kernels.multirule_reset_pane_plain(st, 1)
    torch.cuda.synchronize()
    _same(got, st, 0)
    assert not got["act"][:, 1].any() and got["act"][:, 0].any()


def test_group_fetch_holds_no_later_fold_or_reset(mnode):
    """The group boundary's stacked finalize writes a fresh tensor and its
    copy lands in pinned memory on the fetch stream: a fold and a pane
    reset launched right after finalize_begin (no synchronize between)
    are absent from the fetch."""
    gb = mnode.gb
    st = _group_state(gb)
    want = kernels.multirule_finalize_plain(
        st, gb._pane_mask(None), gb._spectab, gb._slice_keys(300)
    ).cpu().numpy()
    pending = gb.finalize_begin(st, 300)
    base, V, M, slots = _group_inputs(gb, 99, rows=65_536)
    kernels.multirule_fold(st, base, V, M, slots, 0, gb._colmap)
    gb.reset_pane(st, 1)
    assert pending._buf.is_pinned()
    got = pending.get()
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got, want)
    now = kernels.multirule_finalize_plain(
        st, gb._pane_mask(None), gb._spectab, gb._slice_keys(300))
    assert not np.array_equal(now.cpu().numpy(), want, equal_nan=True)
    outs, act = gb.host_tail(got, 300)
    assert act.shape == (6, 300) and outs[0].dtype == np.int64
    pending.release()


# ------------------------------------------------------ sketch rule group
WIDE_GROUP_SQL = (
    "SELECT k, hll(v) AS u, percentile_approx(v, 0.9) AS p, "
    "stddev(v) AS sd, count(*) AS c FROM s WHERE v > {lo} OR w < {hi} "
    "GROUP BY k, HOPPINGWINDOW(ss, 10, 5)")


@pytest.fixture
def wnode():
    """A 40-rule hopping sketch group on the card (two blocks of rules in
    the wide fold's grid), 2,048 slots."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ekuiper_tpu_torch.planner.rulegroup import plan_rule_group

    sqls = [WIDE_GROUP_SQL.format(lo=10 + 0.5 * i, hi=-1 + 0.05 * i)
            for i in range(40)]
    return plan_rule_group([f"r{i}" for i in range(40)], sqls,
                           key_slots=2048, micro_batch=4096)


def _wide_group_inputs(gb, seed, rows=4096, keys=300):
    """(base (R, rows), V, M, slots) of a sketch group's batch: v with
    NaNs, zeros and extremes, and hll's distinct-preserving encoding of
    it."""
    rng = np.random.default_rng(seed)
    v = rng.normal(20, 5, rows).astype(np.float32)
    v[rng.random(rows) < 0.05] = np.nan
    v[:8] = [0.0, -0.0, -1.5, 3.0e38, 1.0e30, 1e-30, -1e-30, 2.0]
    dev = gb.device
    cols = {"v": torch.from_numpy(v).to(dev),
            "__hll__v": torch.from_numpy(encode_hll_column(v, rows)).to(dev),
            "w": torch.from_numpy(
                rng.normal(0, 1, rows).astype(np.float32)).to(dev),
            "__valid_w": torch.from_numpy(rng.random(rows) > 0.1).to(dev)}
    base, V, M = gb.rule_inputs(cols, rows)
    slots = torch.from_numpy(
        rng.integers(0, keys, rows).astype(np.int32)).to(dev)
    return base, V, M, slots


def _wide_group_state(gb):
    st = gb.init_state()
    for pane in (0, 1):
        base, V, M, slots = _wide_group_inputs(gb, 110 + pane)
        kernels.multirule_fold_plain(st, base, V, M, slots, pane, gb._colmap)
        kernels.multirule_fold_wide_plain(st, base, V, M, slots, pane,
                                          gb._widemap)
    return st


@pytest.mark.parametrize("pane", [0, 1])
def test_multirule_fold_wide_matches_plain(wnode, pane):
    """One launch per batch folds every rule's registers and bins,
    bit-equal to the plain version and to each rule's single-rule wide
    fold."""
    gb = wnode.gb
    kernels.reset_launches()
    got, ref = gb.init_state(), gb.init_state()
    for seed in range(3):
        base, V, M, slots = _wide_group_inputs(gb, 120 + seed)
        kernels.multirule_fold_wide(got, base, V, M, slots, pane,
                                    gb._widemap)
        kernels.multirule_fold_wide_plain(ref, base, V, M, slots, pane,
                                          gb._widemap)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["multirule_fold_wide"] == 3
    for comp in ("hll", "hist"):
        np.testing.assert_array_equal(got[comp].cpu().numpy(),
                                      ref[comp].cpu().numpy(), err_msg=comp)
    h = got["hist"].cpu().numpy()
    assert h.sum() > 0 and (h[0] != h[-1]).any()
    # rule 7 alone, through the single-rule wide fold
    one = {c: torch.zeros_like(got[c][7]) for c in ("hll", "hist")}
    one["act"] = torch.zeros_like(got["act"][7])
    for seed in range(3):
        base, V, M, slots = _wide_group_inputs(gb, 120 + seed)
        kernels.groupby_fold_wide(one, V, M & base[7], slots, pane,
                                  gb._widemap)
    torch.cuda.synchronize()
    for comp in ("hll", "hist"):
        np.testing.assert_array_equal(got[comp][7].cpu().numpy(),
                                      one[comp].cpu().numpy(), err_msg=comp)


@pytest.mark.parametrize("panes", [None, [0], [1]])
def test_multirule_finalize_wide_matches_plain(wnode, panes):
    """Every rule's hll and percentile values in one launch into the
    scalar finalize's (R, S+1, K) result, on the key cut."""
    gb = wnode.gb
    st = _wide_group_state(gb)
    pm = gb._pane_mask(panes)
    K = gb._slice_keys(300)
    kernels.reset_launches()
    got = kernels.multirule_finalize(st, pm, gb._spectab, K, gb._rows)
    kernels.multirule_finalize_wide(st, pm, gb._widetab, gb._fracs, got)
    ref = kernels.multirule_finalize_plain(st, pm, gb._spectab, K, gb._rows)
    kernels.multirule_finalize_wide_plain(st, pm, gb._widetab, gb._fracs,
                                          ref)
    assert kernels.LAUNCHES["multirule_finalize_wide"] == 1
    g, r = got.cpu().numpy(), ref.cpu().numpy()
    kinds = [s.kind for s in gb.plan.specs]
    hll, pct = kinds.index("hll"), kinds.index("percentile_approx")
    assert np.abs(g[:, hll] - r[:, hll]).max() <= 1
    assert (np.isnan(g[:, pct]) == np.isnan(r[:, pct])).all()
    np.testing.assert_allclose(g[:, pct], r[:, pct], rtol=4 * 2.0 ** -23)
    rest = [i for i in range(g.shape[1]) if i not in (hll, pct)]
    np.testing.assert_allclose(g[:, rest], r[:, rest], rtol=1e-6, atol=0,
                               equal_nan=True)


def test_multirule_reset_wide_matches_plain(wnode):
    gb = wnode.gb
    st = _wide_group_state(gb)
    got = {k: v.clone() for k, v in st.items()}
    kernels.multirule_reset_pane(got, 0)
    kernels.multirule_reset_pane_plain(st, 0)
    torch.cuda.synchronize()
    _same(got, st, 0)
    assert not got["hist"][:, 0].any() and got["hist"][:, 1].any()


# ------------------------------------------------------ the masked fold
def _masked_inputs(gb, seed, slot_dtype, rows=4096, n=3000, keys=300):
    """A padded batch of `rows` rows of which the first `n` are real (the
    rest zeros, slot 0), a row mask with holes (0 on the padding), and
    the masked fold's (mask ∧ WHERE, V, M ∧ it) on the card."""
    rng = np.random.default_rng(seed)
    v = rng.normal(20, 5, rows).astype(np.float32)
    v[rng.random(rows) < 0.05] = np.nan
    v[:6] = [0.0, -0.0, -3.5, 1e-12, 3e12, -2e20]
    w = rng.normal(0, 1, rows).astype(np.float32)
    p = rng.random(rows)
    code = np.where(p < 0.35, 7, np.where(p < 0.55, 13, rng.integers(
        100, 2100, rows))).astype(np.float32)
    slots = rng.integers(0, keys, rows)
    mask = rng.random(rows) < 0.7
    v[n:], w[n:], code[n:], slots[n:], mask[n:] = 0, 0, 0, 0, False
    dev = gb.device
    cols = {"v": torch.from_numpy(v).to(dev),
            "w": torch.from_numpy(w).to(dev),
            "__valid_w": torch.from_numpy(rng.random(rows) > 0.1).to(dev),
            "__hll__v": torch.from_numpy(encode_hll_column(v, rows)).to(dev),
            "__hhc__code": torch.from_numpy(code).to(dev)}
    base = gb._where(cols, (rows,)) & torch.from_numpy(mask).to(dev)
    V, M = gb._spec_values(cols, rows)
    return (base, V, M & base,
            torch.from_numpy(slots.astype(slot_dtype)).to(dev), n)


@pytest.mark.parametrize("slot_dtype", [np.uint16, np.int32])
@pytest.mark.parametrize("which", ["scalar", "wide", "hh"])
def test_fold_masked_matches_plain(gb, sgb, which, slot_dtype):
    """#2 against its plain version: the kernel over the padded batch,
    the plain version over its real rows only, so the padding (slot 0,
    mask 0) must change nothing; uint16 and int32 slots."""
    g = gb if which == "scalar" else sgb
    wide = g._widemap
    if which != "scalar":
        keep = (wide[:, 0] == kernels.WIDE_IDS["hh"]) == (which == "hh")
        wide = wide[keep]
    kernels.reset_launches()
    got, ref = g.init_state(), g.init_state()
    pane = g.n_panes - 1
    for seed in range(3):
        base, V, M, slots, n = _masked_inputs(g, 80 + seed, slot_dtype)
        kernels.groupby_fold_masked_scalar(got, base, V, M, slots, pane,
                                           g._colmap)
        kernels.fold_masked_scalar_plain(ref, base[:n], V[:, :n], M[:, :n],
                                         slots[:n], pane, g._colmap)
        if len(wide):
            kernels.groupby_fold_masked_wide(got, base, V, M, slots, pane,
                                             wide)
            kernels.fold_masked_wide_plain(ref, base[:n], V[:, :n],
                                           M[:, :n], slots[:n], pane, wide)
    torch.cuda.synchronize()
    _same(got, ref, 1e-5)
    assert kernels.LAUNCHES["groupby_fold_masked_scalar"] == 3
    assert kernels.LAUNCHES["groupby_fold_masked_wide"] == (
        3 if len(wide) else 0)
    assert float(got["act"].sum()) > 0
    if which == "hh":
        assert float(got["hh"].sum()) > 0 and float(got["hll"].sum()) == 0
    if which == "wide":
        assert float(got["hll"].max()) > 0 and float(got["hh"].sum()) == 0


@pytest.mark.parametrize("which", ["scalar", "sketch"])
def test_fold_takes_uint16_slots(gb, sgb, which):
    """#1 on uint16 slots (a cached sliding batch) folds as on the same
    slots in int32."""
    g = gb if which == "scalar" else sgb
    kernels.reset_launches()
    got, ref = g.init_state(), g.init_state()
    base, V, M, slots, _ = _masked_inputs(g, 90, np.uint16)
    for st, s in ((got, slots), (ref, slots.to(torch.int32))):
        kernels.groupby_fold_scalar(st, base, V, M, s, 0, g._colmap)
        if len(g._widemap):
            kernels.groupby_fold_wide(st, V, M, s, 0, g._widemap)
    torch.cuda.synchronize()
    _same(got, ref, 1e-5)
    assert kernels.LAUNCHES["groupby_fold_scalar"] == 2


def test_refold_fetch_holds_no_later_reset_or_fold():
    """Snapshot against the in-place reset: a refold's pane-mask finalize
    (finalize_begin over the full panes and the scratch pane) launched
    right before the scratch pane's reset and further folds (no
    synchronize between) fetches the window as it stood at its launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    node = plan_fused_rule(RING_SQL, key_slots=512, micro_batch=4096,
                           options={"slidingImpl": "refold"})
    assert node.sliding_impl == "refold"
    gb = node.gb
    st = gb.init_state()
    rng = np.random.default_rng(75)
    for pane in (3, 4, node._scratch_pane):
        gb.fold(st, {"v": rng.normal(20, 5, 4096).astype(np.float32)},
                rng.integers(0, 300, 4096).astype(np.int32), pane_idx=pane)
    pm = np.zeros(gb.n_panes, dtype=bool)
    pm[[3, 4, node._scratch_pane]] = True
    torch.cuda.synchronize()
    want = gb._finalize({k: v.clone() for k, v in st.items()},
                        gb._mask_tensor(pm)).cpu().numpy()
    pending = gb.finalize_begin(st, pm)
    gb.reset_pane(st, node._scratch_pane)
    gb.fold(st, {"v": np.full(65_536, 7.0, np.float32)},
            np.zeros(65_536, np.int32), pane_idx=4)
    assert pending._buf.is_pinned()
    got = pending.get()
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got, want)
    now = gb._finalize(st, gb._mask_tensor(pm)).cpu().numpy()
    assert not np.array_equal(now, got)
    pending.release()


# ------------------------------------------------------------ tier store
TIER_SQL = {
    # G2's rule (ten panes), min and max added for the min/max merges
    "scalar": ("SELECT k, sum(v) AS s, count(*) AS c, min(v) AS mn, "
               "max(v) AS mx FROM s GROUP BY k, HOPPINGWINDOW(ss, 10, 1)"),
    # the wide components: hll registers (max) and hist bins (add)
    "wide": ("SELECT k, hll(v) AS u, percentile_approx(v, 0.5) AS p FROM s "
             "GROUP BY k, HOPPINGWINDOW(ss, 10, 5)"),
}


@pytest.fixture(params=sorted(TIER_SQL))
def tnode(request):
    """A tiered node on the card (tierHotMb 1: the scalar rule at 2,048
    slots, the wide one at the 1,024-slot floor) with rows in every pane
    and touch counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    node = plan_fused_rule(TIER_SQL[request.param], key_slots=4096,
                           micro_batch=4096,
                           options={"tierHotMb": 1, "prefinalizeLeadMs": 0})
    assert node.tier is not None
    gb = node.gb
    st = gb.init_state()
    rng = np.random.default_rng(91)
    for pane in range(gb.n_panes):
        v = rng.normal(20, 5, 4096).astype(np.float32)
        v[:4] = [0.0, -0.0, -2.5, 1e30]
        cols = {"v": v, "__hll__v": encode_hll_column(v, 4096)}
        gb.fold(st, {c: cols[c] for c in gb.plan.columns},
                rng.integers(0, 700, 4096).astype(np.int32), pane_idx=pane)
    node.state = st
    return node


def _clone(st):
    return {k: v.clone() for k, v in st.items()}


def _same_exact(got, ref):
    assert got.keys() == ref.keys()
    for comp in ref:
        np.testing.assert_array_equal(got[comp].cpu().numpy(),
                                      ref[comp].cpu().numpy(), err_msg=comp)


@pytest.mark.parametrize("n", [1, 37, 2048])
def test_tier_demote_matches_plain(tnode, n):
    """#18 against its plain version: the packed block (pad rows, which
    repeat slots[0], included) and the reset state (touch included)
    bit-equal, for a partial, a small and a full block."""
    ts = tnode.tier.ts
    gb = tnode.gb
    rng = np.random.default_rng(n)
    slots = rng.choice(gb.capacity, size=min(n, gb.capacity),
                       replace=False).astype(np.int32)
    s, real = ts._slots(slots)
    s_dev = torch.from_numpy(s).to(gb.device)
    got, ref = _clone(tnode.state), _clone(tnode.state)
    kernels.reset_launches()
    packed = kernels.tier_demote(got, s_dev, real, ts.comps)
    want = kernels.tier_demote_plain(ref, s_dev, real, ts.comps)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["tier_demote"] == 1
    assert packed.shape == (ts.demote_batch, ts.packed_w)
    np.testing.assert_array_equal(packed.cpu().numpy(), want.cpu().numpy())
    _same_exact(got, ref)
    assert float(got["act"][:, torch.from_numpy(s[:real]).long()].abs()
                 .sum()) == 0
    touch = got["touch"].cpu().numpy()  # torch indexes no uint32 on CUDA
    assert int(touch[s[:real]].sum()) == 0


@pytest.mark.parametrize("n", [1, 37, 2048])
def test_tier_promote_matches_plain(tnode, n):
    """#19 against its plain version, bit-equal: a demoted block merged
    back into other slots holding data (add, min, max per component);
    identity pad rows on the repeated pad slot."""
    ts = tnode.tier.ts
    gb = tnode.gb
    rng = np.random.default_rng(100 + n)
    k = min(n, gb.capacity)
    src = rng.choice(gb.capacity, size=k, replace=False).astype(np.int32)
    st = _clone(tnode.state)
    s, real = ts._slots(src)
    block = kernels.tier_demote_plain(
        st, torch.from_numpy(s).to(gb.device), real, ts.comps)
    rows = block.cpu().numpy()[:real][::-1].copy()
    dst = rng.choice(gb.capacity, size=k, replace=False).astype(np.int32)
    d, _ = ts._slots(dst)
    full = np.tile(ts.init_row(), (ts.demote_batch, 1))
    full[:real] = rows
    packed = torch.from_numpy(full).to(gb.device)
    d_dev = torch.from_numpy(d).to(gb.device)
    got, ref = _clone(st), _clone(st)
    kernels.reset_launches()
    kernels.tier_promote(got, packed, d_dev, ts.comps)
    kernels.tier_promote_plain(ref, packed, d_dev, ts.comps)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["tier_promote"] == 1
    _same_exact(got, ref)


def test_fold_touch_column_matches_plain(tnode):
    """#1's touch branch: the fold kernel's uint32 touch[slot] += 1 per row
    past WHERE equals the plain fold's, exactly; the pane reset keeps it."""
    gb = tnode.gb
    rng = np.random.default_rng(92)
    got, ref = _clone(tnode.state), _clone(tnode.state)
    for seed in range(3):
        v = rng.normal(20, 5, 4096).astype(np.float32)
        cols = {"v": torch.from_numpy(v).to(gb.device),
                "__hll__v": torch.from_numpy(
                    encode_hll_column(v, 4096)).to(gb.device)}
        cols = {c: cols[c] for c in gb.plan.columns}
        base, V, M = gb.spec_inputs(cols, 4096)
        base[::7] = False  # rows a WHERE would drop
        M &= base
        slots = torch.from_numpy(
            rng.integers(0, 700, 4096).astype(np.int32)).to(gb.device)
        kernels.groupby_fold_scalar(got, base, V, M, slots, seed % 2,
                                    gb._colmap)
        kernels.fold_scalar_plain(ref, base, V, M, slots, seed % 2,
                                  gb._colmap)
    kernels.groupby_reset_pane(got, 0)
    kernels.reset_pane_plain(ref, 0)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got["touch"].cpu().numpy(),
                                  ref["touch"].cpu().numpy())
    np.testing.assert_array_equal(got["act"].cpu().numpy(),
                                  ref["act"].cpu().numpy())
    assert int(got["touch"].to(torch.int64).sum()) == int(
        tnode.state["touch"].to(torch.int64).sum()) + 3 * (4096 - 586)


def test_tier_fetches_hold_no_later_fold(tnode):
    """Snapshot against the in-place folds: the touch scan's clone and a
    demote block, each launched right before a fold (no synchronize
    between), are fetched as they stood at their launch."""
    tier = tnode.tier
    gb = tnode.gb
    held = []
    tier._submit = held.append
    st = tnode.state
    touch_then = st["touch"].cpu().numpy().copy()
    tier._last_scan_ms = -10 ** 9
    tier._plan = [3, 5]
    tnode.kt.encode_column(np.array([f"k{i}" for i in range(8)],
                                    dtype=np.object_))
    want_rows = tier.ts.demote(_clone(st), np.array([3, 5]))[1][:2] \
        .cpu().numpy()
    st = tier.on_boundary(st)
    gb.fold(st, {c: np.full(65_536, 7.0, np.float32)
                 for c in gb.plan.columns},
            np.full(65_536, 3, np.int32), pane_idx=0)
    (harvest,) = [p for p in held if p[0] == "harvest"]
    (scan,) = [p for p in held if p[0] == "scan"]
    assert harvest[1]._buf.is_pinned() and scan[1]._buf.is_pinned()
    np.testing.assert_array_equal(harvest[1].get()[:2], want_rows)
    np.testing.assert_array_equal(scan[1].get(), touch_then * (
        np.arange(len(touch_then)) != 3) * (np.arange(len(touch_then)) != 5))
    torch.cuda.synchronize()
    assert int(st["touch"].cpu().numpy()[3]) == 65_536
