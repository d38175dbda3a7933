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
the wide state bit-equal. The group folds with a per-row pane vector
(event-time groups) as the folds; the touch column under a pane vector
exact, and under the masked fold's row mask. Count-min: the update's
counts and the query's estimates bit-equal (integer counts under 2^24).
The rule group's row order (`multirule_fold_order`): rows and segment
offsets equal to the plain stable argsort's; both group folds on
tests/torch_group_batches.py's edge batches, with the host pane bound
and the shared order and without them, as the folds above; the reset on
pane runs that start off a 16-byte boundary bit-equal.
"""
import numpy as np
import pytest
import torch

from ekuiper_tpu_torch.ops import kernels
from ekuiper_tpu_torch.ops.groupby import concat_slots
from ekuiper_tpu_torch.ops.aggspec import encode_hll_column
from ekuiper_tpu_torch.planner.fused import plan_fused_rule

import torch_finalize_cases as fc
import torch_fold_batches as fb
import torch_group_batches as gbt
import torch_hh_batches as hb

pytestmark = pytest.mark.cuda

#: the empty column map of a fold that takes only the other branch
NO_COLS = np.zeros((0, 3), dtype=np.int32)

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
        kernels.groupby_fold(got, base, V, M, slots, pane, gb._colmap,
                             gb._widemap)
        kernels.fold_plain(ref, base, V, M, slots, pane, gb._colmap,
                           gb._widemap)
    torch.cuda.synchronize()
    _same(got, ref, 1e-5)
    assert kernels.LAUNCHES["groupby_fold"] == 3


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
    fold = kernels.groupby_fold if kernel else kernels.fold_plain
    fold(st, base, V, M, slots, pane, gb._colmap, gb._widemap)


HH_CAP, HH_ROWS = 512, 4096


def _hh_gb(plan):
    """The group-by of tests/torch_hh_batches.py's plan `plan` on the
    card (2 panes)."""
    return plan_fused_rule(hb.PLANS[plan], key_slots=HH_CAP,
                           micro_batch=HH_ROWS).gb


def _hh_inputs(gb, seed, slot_dtype, masked=False, edge_codes=hb.EDGE_CODES):
    """An edge-case batch of tests/torch_hh_batches.py on the card:
    (base, V, M, slots, pane_vec). Under `masked`, base is the masked
    fold's row mask (the batch's mask ∧ WHERE), and M is ANDed with it."""
    b = hb.hh_batch(seed, HH_ROWS, gb.capacity, gb.n_panes, slot_dtype,
                    edge_codes=edge_codes)
    dev = gb.device
    cols = {k: torch.from_numpy(v).to(dev) for k, v in hb.plan_columns(
        gb.plan.columns, b["cols"], encode_hll_column).items()}
    if masked:
        base = gb._where(cols, (HH_ROWS,)) & torch.from_numpy(
            b["mask"]).to(dev)
        V, M = gb._spec_values(cols, HH_ROWS)
        M = M & base
    else:
        base, V, M = gb.spec_inputs(cols, HH_ROWS)
    return (base, V, M, torch.from_numpy(b["slots"]).to(dev),
            torch.from_numpy(b["pane_vec"]).to(dev))


WIDE_CASES = [("sketch", 0, np.int32), ("sketch", 1, np.int32)] + [
    (plan, pane, dt) for plan in hb.PLANS for pane in (0, 1, "vec")
    for dt in (np.uint16, np.int32)]


@pytest.mark.parametrize("plan,pane,slot_dtype", WIDE_CASES)
def test_fold_wide_matches_plain(sgb, plan, pane, slot_dtype):
    """#1's fold of sketch columns against its plain version: the sketch
    rule's batches, and tests/torch_hh_batches.py's heavy-hitters edge
    cases (two hh columns, one under a FILTER; with hll and hist beside
    them, the three roles of one launch) into one pane or by a per-row
    pane vector, on uint16 and int32 slots. hll, hist and hh bit-equal."""
    kernels.reset_launches()
    if plan == "sketch":
        got, ref = sgb.init_state(), sgb.init_state()
        for seed in range(3):
            _fold_sketches(sgb, got, seed, pane, kernel=True)
            _fold_sketches(sgb, ref, seed, pane, kernel=False)
        torch.cuda.synchronize()
        _same(got, ref, 1e-5)
        assert kernels.LAUNCHES["groupby_fold"] == 3
        assert float(got["hh"].sum()) > 0 and float(got["hll"].max()) > 0
        return
    g = _hh_gb(plan)
    got, ref = g.init_state(), g.init_state()
    for seed in range(3):
        base, V, M, slots, pv = _hh_inputs(g, seed, slot_dtype)
        p, pv = (0, pv) if pane == "vec" else (pane, None)
        kernels.groupby_fold(got, base, V, M, slots, p, g._colmap,
                             g._widemap, pv)
        kernels.fold_plain(ref, base, V, M, slots, p, g._colmap, g._widemap,
                           pv)
    torch.cuda.synchronize()
    _same(got, ref, 1e-5)
    assert kernels.LAUNCHES["groupby_fold"] == 3
    assert kernels.ROW_PANE_LAUNCHES["groupby_fold"] == (
        3 if pane == "vec" else 0)
    assert float(got["hh"][:, :, 1].sum()) > 0  # the FILTERed column
    if plan == "mixed":
        assert float(got["hll"].max()) > 0 and float(got["hist"].sum()) > 0


@pytest.mark.parametrize("masked", [False, True])
def test_fold_hh_codes_past_20_bits(masked):
    """Codes at 2^20 and above and negative codes, which the dictionary
    never makes, through #1 (by a pane vector) and #2: the kernel counts
    their low 20 bits only, as the plain versions do, and adds nothing
    outside the code's two cells. hh bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = _hh_gb("hh2")
    kernels.reset_launches()
    got, ref = g.init_state(), g.init_state()
    for seed in range(3):
        base, V, M, slots, pv = _hh_inputs(g, 70 + seed, np.int32, masked,
                                           edge_codes=hb.PAST_CODES)
        if masked:
            kernels.groupby_fold_masked(got, base, V, M, slots, 1,
                                        g._colmap, g._widemap)
            kernels.fold_plain(ref, base, V, M, slots, 1, g._colmap,
                               g._widemap)
        else:
            kernels.groupby_fold(got, base, V, M, slots, 0, g._colmap,
                                 g._widemap, pv)
            kernels.fold_plain(ref, base, V, M, slots, 0, g._colmap,
                               g._widemap, pv)
    torch.cuda.synchronize()
    _same(got, ref, 1e-5)
    name = "groupby_fold_masked" if masked else "groupby_fold"
    assert kernels.LAUNCHES[name] == 3


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


@pytest.mark.parametrize("mask", list(fc.HH_MASKS))
@pytest.mark.parametrize("k2s", [(6, 128), (1, 2), (128, 1)])
def test_hh_finalize_edge_states(mask, k2s):
    """#8's kernel against its plain version on
    tests/torch_finalize_cases.py's hh edge slots (an all-zero slot, fewer
    positive estimates than k2, a valid code of estimate 0 tying the
    invalid cells, codes 0 and 2^20 - 1, ties) in two columns, k2 = 1 and
    128, under no, one, two, three and every pane of four live (every
    route of the kernel's column ring: nothing copied, one buffer read,
    two read together, a running sum). Rows bit-equal; other rows
    untouched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    hh = fc.hh_state((fc.HH_PANES, fc.HH_CAP, 2, fc.HH_SIZE), seed=11)
    _hh_finalize_pair(hh, fc.HH_MASKS[mask], k2s)


@pytest.mark.parametrize("live", [1, 9, 37])
def test_hh_finalize_many_panes(live):
    """#8 over 37 panes (the refold's scratch pane alone, nine live, all
    live), 3,001 slots of random skewed codes: more items than the
    persistent grid's warps, so each warp's ring wraps many times."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(live)
    P, C = 37, 3001
    hh = np.zeros((P, C, 1, fc.HH_SIZE), dtype=np.float32)
    for p in range(P):
        for c in rng.choice(C, 400, replace=False):
            for code in rng.zipf(1.5, 8) % 50:
                fc.hh_add(hh[p, c, 0], int(code) * 977, int(rng.integers(1,
                                                                         4)))
    pm = np.zeros(P, dtype=bool)
    pm[rng.choice(P, live, replace=False)] = True
    _hh_finalize_pair(hh, pm.tolist(), (6,))


def _hh_finalize_pair(hh, pm, k2s):
    dev = torch.device("cuda")
    P, C, K = hh.shape[:3]
    state = {"hh": torch.from_numpy(hh).to(dev),
             "act": torch.zeros((P, C), device=dev)}
    pm_t = torch.tensor(pm, dtype=torch.bool, device=dev)
    rows = 2 * sum(k2s) + 3
    hhtab = np.array([[K - 1 - i, k2, 1 + 2 * sum(k2s[:i])]
                      for i, k2 in enumerate(k2s)], dtype=np.int32)
    got = torch.full((rows, C), -1.0, device=dev)
    ref = got.clone()
    kernels.reset_launches()
    kernels.groupby_hh_finalize(state, pm_t, hhtab, got)
    kernels.hh_finalize_plain(state, pm_t, hhtab, ref)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["groupby_hh_finalize"] == 1
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32),
                                  ref.cpu().numpy().view(np.uint32))


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
    kernels.groupby_fold(st, base, V, M, slots, 0, gb._colmap, gb._widemap)
    head = kernels.components_plain(st, gb._pane_mask(None), gb._comp_order)
    pending = gb.prefinalize_begin(st)
    for seed in range(61, 64):
        base, V, M, slots = _inputs(gb, seed)
        kernels.groupby_fold(st, base, V, M, slots, 0, gb._colmap,
                             gb._widemap)
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
    cmap, wmap = ((gb._colmap, NO_COLS) if which == "scalar"
                  else (NO_COLS, gb._widemap))
    kernels.groupby_fold(got, base, V, M, slots, 0, cmap, wmap, pv)
    kernels.fold_plain(ref, base, V, M, slots, 0, cmap, wmap, pv)
    torch.cuda.synchronize()
    name = "groupby_fold"
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


def test_multirule_fold_pane_vector_matches_plain(mnode):
    """The per-row pane vector (an event-time batch across bucket edges),
    shared by every rule: as the plain version; a constant vector as the
    scalar pane; counted as a pane-vector launch."""
    gb = mnode.gb
    kernels.reset_launches()
    got, ref = gb.init_state(), gb.init_state()
    rng = np.random.default_rng(85)
    for seed in range(3):
        base, V, M, slots = _group_inputs(gb, 85 + seed)
        pv = torch.from_numpy(rng.integers(0, 2, 4096).astype(
            np.uint8)).to(gb.device)
        kernels.multirule_fold(got, base, V, M, slots, 0, gb._colmap, pv)
        kernels.multirule_fold_plain(ref, base, V, M, slots, 0, gb._colmap,
                                     pv)
    torch.cuda.synchronize()
    _same(got, ref, 1e-5)
    assert kernels.LAUNCHES["multirule_fold"] == 3
    assert kernels.ROW_PANE_LAUNCHES["multirule_fold"] == 3
    assert got["act"][:, 0].any() and got["act"][:, 1].any()
    a, b = gb.init_state(), gb.init_state()
    base, V, M, slots = _group_inputs(gb, 89)
    ones = torch.ones(4096, dtype=torch.uint8, device=gb.device)
    kernels.multirule_fold(a, base, V, M, slots, 0, gb._colmap, ones)
    kernels.multirule_fold(b, base, V, M, slots, 1, gb._colmap)
    torch.cuda.synchronize()
    _same(a, b, 1e-5)
    with pytest.raises(ValueError):
        kernels.multirule_fold(a, base, V, M, slots, 0, gb._colmap, ones * 2)


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
        kernels.groupby_fold(one, base[7], V, M & base[7], slots, pane,
                             NO_COLS, gb._widemap)
    torch.cuda.synchronize()
    for comp in ("hll", "hist"):
        np.testing.assert_array_equal(got[comp][7].cpu().numpy(),
                                      one[comp].cpu().numpy(), err_msg=comp)


def test_multirule_fold_wide_pane_vector_matches_plain(wnode):
    """The wide fold with a per-row pane vector: bit-equal to its plain
    version, and a constant vector to the scalar pane."""
    gb = wnode.gb
    kernels.reset_launches()
    got, ref = gb.init_state(), gb.init_state()
    rng = np.random.default_rng(125)
    for seed in range(3):
        base, V, M, slots = _wide_group_inputs(gb, 125 + seed)
        pv = torch.from_numpy(rng.integers(0, 2, 4096).astype(
            np.uint8)).to(gb.device)
        kernels.multirule_fold_wide(got, base, V, M, slots, 0, gb._widemap,
                                    pv)
        kernels.multirule_fold_wide_plain(ref, base, V, M, slots, 0,
                                          gb._widemap, pv)
    torch.cuda.synchronize()
    assert kernels.ROW_PANE_LAUNCHES["multirule_fold_wide"] == 3
    for comp in ("hll", "hist"):
        np.testing.assert_array_equal(got[comp].cpu().numpy(),
                                      ref[comp].cpu().numpy(), err_msg=comp)
        assert got[comp][:, 0].any() and got[comp][:, 1].any()
    a, b = gb.init_state(), gb.init_state()
    base, V, M, slots = _wide_group_inputs(gb, 129)
    zeros = torch.zeros(4096, dtype=torch.uint8, device=gb.device)
    kernels.multirule_fold_wide(a, base, V, M, slots, 0, gb._widemap, zeros)
    kernels.multirule_fold_wide(b, base, V, M, slots, 0, gb._widemap)
    torch.cuda.synchronize()
    for comp in ("hll", "hist"):
        assert torch.equal(a[comp], b[comp]), comp


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


@pytest.fixture(scope="module")
def fin_edges():
    """tests/torch_finalize_cases.py's 3-rule sketch group on the card, its
    edge state loaded."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ekuiper_tpu_torch.parallel.multirule import (BatchedGroupBy,
                                                      build_rule_batch)
    from ekuiper_tpu_torch.sql.parser import parse_select
    sqls = fc.fin_sqls()
    spec = build_rule_batch([f"r{i}" for i in range(len(sqls))],
                            [parse_select(q) for q in sqls])
    gb = BatchedGroupBy(spec, capacity=fc.FIN_CAP, n_panes=fc.FIN_PANES,
                        micro_batch=128)
    host = fc.fin_state({c: tuple(a.shape)
                         for c, a in gb.init_state().items()}, seed=3)
    return gb, {c: torch.from_numpy(a).to(gb.device)
                for c, a in host.items()}


def _wide_rows_hold(got, ref, widetab):
    """hll rows bit-equal, percentile rows NaN alike and within 4 ulp, the
    other rows untouched (-1)."""
    for kind, _, row in widetab.tolist():
        g, r = got[..., row, :], ref[..., row, :]
        if kind == kernels.WIDE_KIND_IDS["hll"]:
            np.testing.assert_array_equal(g, r)
        else:
            assert (np.isnan(g) == np.isnan(r)).all()
            np.testing.assert_allclose(g, r, rtol=4 * 2.0 ** -23)
    others = np.setdiff1d(np.arange(got.shape[-2]), widetab[:, 2])
    assert (got[..., others, :] == -1.0).all()


@pytest.mark.parametrize("n_cols", [fc.FIN_COLS, fc.FIN_CAP])
@pytest.mark.parametrize("mask", list(fc.FIN_MASKS))
def test_multirule_finalize_wide_edge_states(fin_edges, mask, n_cols):
    """#16's warp kernel against its plain version on the edge states
    (boundary targets, fractions 0 and 1, empty histograms, zero and
    near-2.5·M registers, K = 2 / 3 columns), every pane mask, on 45 and
    all 64 keys, in one launch."""
    gb, st = fin_edges
    pm = torch.tensor(fc.FIN_MASKS[mask], device=gb.device)
    got = torch.full((fc.FIN_RULES, gb._rows, n_cols), -1.0,
                     device=gb.device)
    ref = got.clone()
    kernels.reset_launches()
    kernels.multirule_finalize_wide(st, pm, gb._widetab, gb._fracs, got)
    kernels.multirule_finalize_wide_plain(st, pm, gb._widetab, gb._fracs,
                                          ref)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["multirule_finalize_wide"] == 1
    _wide_rows_hold(got.cpu().numpy(), ref.cpu().numpy(), gb._widetab)


@pytest.mark.parametrize("mask", list(fc.FIN_MASKS))
def test_finalize_wide_edge_states_one_rule(fin_edges, mask):
    """#3 runs #16's body as a group of one rule: on each rule's own state
    it holds to the plain version as #16 does, and gives the group
    kernel's bits for that rule."""
    gb, st = fin_edges
    pm = torch.tensor(fc.FIN_MASKS[mask], device=gb.device)
    group = torch.full((fc.FIN_RULES, gb._rows, fc.FIN_CAP), -1.0,
                       device=gb.device)
    kernels.multirule_finalize_wide(st, pm, gb._widetab, gb._fracs, group)
    for r in range(fc.FIN_RULES):
        one = {c: a[r].contiguous() for c, a in st.items()}
        got = torch.full((gb._rows, fc.FIN_CAP), -1.0, device=gb.device)
        ref = got.clone()
        kernels.groupby_finalize_wide(one, pm, gb._widetab, gb._fracs, got)
        kernels.finalize_wide_plain(one, pm, gb._widetab, gb._fracs, ref)
        torch.cuda.synchronize()
        _wide_rows_hold(got.cpu().numpy(), ref.cpu().numpy(), gb._widetab)
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      group[r].cpu().numpy())


def test_multirule_reset_wide_matches_plain(wnode):
    gb = wnode.gb
    st = _wide_group_state(gb)
    got = {k: v.clone() for k, v in st.items()}
    kernels.multirule_reset_pane(got, 0)
    kernels.multirule_reset_pane_plain(st, 0)
    torch.cuda.synchronize()
    _same(got, st, 0)
    assert not got["hist"][:, 0].any() and got["hist"][:, 1].any()


# ------------------------------- rule group: edge batches, order, bound
EDGE_ROWS, EDGE_CAP, EDGE_PANES = 4096, 512, 2


def _edge_group(plan, n_rules, cap=EDGE_CAP):
    """A BatchedGroupBy on the card over tests/torch_group_batches.py's
    statements."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ekuiper_tpu_torch.parallel.multirule import (BatchedGroupBy,
                                                      build_rule_batch)
    from ekuiper_tpu_torch.sql.parser import parse_select

    sqls = gbt.group_sqls(plan, n_rules)
    spec = build_rule_batch([f"r{i}" for i in range(n_rules)],
                            [parse_select(q) for q in sqls])
    return BatchedGroupBy(spec, capacity=cap, n_panes=EDGE_PANES,
                          micro_batch=EDGE_ROWS, device="cuda")


def _edge_inputs(gb, seed, kind, cap=EDGE_CAP):
    """(base, V, M, slots, pane_vec) of one edge batch on the card."""
    b = gbt.group_batch(seed, EDGE_ROWS, cap, EDGE_PANES, kind)
    cols = {k: torch.from_numpy(v).cuda() for k, v in b["cols"].items()}
    if "__hll__v" in gb.plan.columns:
        cols["__hll__v"] = torch.from_numpy(
            encode_hll_column(b["cols"]["v"], EDGE_ROWS)).cuda()
    base, V, M = gb.rule_inputs(cols, EDGE_ROWS)
    return (base, V, M, torch.from_numpy(b["slots"]).cuda(),
            torch.from_numpy(b["pane_vec"]).cuda())


@pytest.mark.parametrize("mode", ["pane", "vec"])
@pytest.mark.parametrize("kind", gbt.SLOT_KINDS)
def test_multirule_fold_order_matches_plain(kind, mode):
    """The radix order of a chunk's rows by pane * C + slot: rows and
    segment offsets equal to the plain stable argsort's (dropped rows
    last), the 63 rules' WHERE bits packed as the plain version packs
    them, one launch count."""
    gb = _edge_group("scalar", 63)
    base, _, _, slots, pv = _edge_inputs(gb, 140, kind)
    pane, pv = (0, pv) if mode == "vec" else (1, None)
    kernels.reset_launches()
    got = kernels.multirule_fold_order(slots, pane, EDGE_PANES, EDGE_CAP, pv,
                                       base)
    want = kernels.multirule_fold_order_plain(slots, pane, EDGE_PANES,
                                              EDGE_CAP, pv, base)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["multirule_fold_order"] == 1
    assert torch.equal(got.rows, want.rows)
    assert torch.equal(got.offsets, want.offsets)
    assert torch.equal(got.bits, want.bits)


@pytest.mark.parametrize("bound", ["host", "read_back"])
@pytest.mark.parametrize("mode", ["pane", "vec"])
@pytest.mark.parametrize("kind", gbt.SLOT_KINDS)
@pytest.mark.parametrize("n_rules", gbt.RULE_COUNTS)
@pytest.mark.parametrize("plan", sorted(gbt.PLANS))
def test_multirule_fold_edges_match_plain(plan, n_rules, kind, mode, bound):
    """Both folds on the edge batches (a slot holding every row: pieces
    added by atomics; Zipf-skewed slots; slots past C; NaN and ±inf), as
    their plain versions: "host" with the host pane bound and the order
    built once for both, the vector's panes past P dropped; "read_back"
    without either (the wrappers read the vector's max and build their
    own order), the vector clipped below P. s1 / s2 rtol 1e-5, the rest
    bit-equal; the rule that passes no row stays at the identity. The
    order given carries the WHERE bits packed once for both folds, as
    BatchedGroupBy builds it."""
    gb = _edge_group(plan, n_rules)
    got, ref = gb.init_state(), gb.init_state()
    kernels.reset_launches()
    for seed in range(2):
        base, V, M, slots, pv = _edge_inputs(gb, 150 + seed, kind)
        if mode == "pane":
            pane, pv, hi = 1, None, None
        else:
            pane = 0
            hi = EDGE_PANES - 1 if bound == "host" else None
            if bound == "read_back":
                pv = pv.clamp(max=EDGE_PANES - 1)
        order = (kernels.multirule_fold_order(slots, pane, EDGE_PANES,
                                              EDGE_CAP, pv, base)
                 if bound == "host" else None)
        kernels.multirule_fold(got, base, V, M, slots, pane, gb._colmap, pv,
                               hi, order)
        kernels.multirule_fold_plain(ref, base, V, M, slots, pane,
                                     gb._colmap, pv)
        if len(gb._widemap):
            kernels.multirule_fold_wide(got, base, V, M, slots, pane,
                                        gb._widemap, pv, hi, order)
            kernels.multirule_fold_wide_plain(ref, base, V, M, slots, pane,
                                              gb._widemap, pv)
    torch.cuda.synchronize()
    _same(got, ref, 1e-5)
    assert kernels.LAUNCHES["multirule_fold"] == 2
    assert kernels.LAUNCHES["multirule_fold_order"] == 2 * (
        1 if bound == "host" or not len(gb._widemap) else 2)
    act = got["act"].cpu().numpy()
    assert act.sum() > 0
    if n_rules > 1:
        assert act[-1].sum() == 0


@pytest.mark.parametrize("cap", [37, EDGE_CAP])
def test_multirule_reset_edges_match_plain(cap):
    """The reset over a 63-rule sketch group's state, each pane: at 37
    slots every other rule's scalar pane runs start off a 16-byte boundary
    and end mid-float4 (scalar head and tail), the wide runs stay
    aligned; bit-equal to the plain version, the other pane untouched."""
    gb = _edge_group("wide", 63, cap)
    st = gb.init_state()
    for pane in range(EDGE_PANES):
        base, V, M, slots, _ = _edge_inputs(gb, 160 + pane, "uniform", cap)
        kernels.multirule_fold_plain(st, base, V, M, slots, pane, gb._colmap)
        kernels.multirule_fold_wide_plain(st, base, V, M, slots, pane,
                                          gb._widemap)
    for pane in range(EDGE_PANES):
        got = {k: v.clone() for k, v in st.items()}
        ref = {k: v.clone() for k, v in st.items()}
        kernels.multirule_reset_pane(got, pane)
        kernels.multirule_reset_pane_plain(ref, pane)
        torch.cuda.synchronize()
        _same(got, ref, 0)
        other = 1 - pane
        assert got["act"][:, other].any() and not got["act"][:, pane].any()


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
@pytest.mark.parametrize("which", ["scalar", "wide", "hh", "hh2", "mixed"])
def test_fold_masked_matches_plain(gb, sgb, which, slot_dtype):
    """#2 against its plain version, one segment a launch: the kernel over
    the padded batch, the plain version over its real rows only, so the
    padding (slot 0, mask 0) must change nothing; uint16 and int32 slots;
    act, the scalar columns and the wide ones of each kind in ONE launch.
    hh2 / mixed: tests/torch_hh_batches.py's heavy-hitters edge cases
    under their row mask, hll, hist and hh bit-equal."""
    if which in hb.PLANS:
        g = _hh_gb(which)
        pane = g.n_panes - 1
        kernels.reset_launches()
        got, ref = g.init_state(), g.init_state()
        for seed in range(3):
            base, V, M, slots, _ = _hh_inputs(g, 90 + seed, slot_dtype,
                                              masked=True)
            kernels.groupby_fold_masked(got, base, V, M, slots, pane,
                                        g._colmap, g._widemap)
            kernels.fold_plain(ref, base, V, M, slots, pane, g._colmap,
                               g._widemap)
        torch.cuda.synchronize()
        _same(got, ref, 1e-5)
        assert kernels.LAUNCHES["groupby_fold_masked"] == 3
        assert float(got["hh"][pane, :, 1].sum()) > 0
        assert float(got["hh"][:pane].abs().sum()) == 0
        return
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
        kernels.groupby_fold_masked(got, base, V, M, slots, pane,
                                    g._colmap, wide)
        kernels.fold_plain(ref, base[:n], V[:, :n], M[:, :n], slots[:n],
                           pane, g._colmap, wide)
    torch.cuda.synchronize()
    _same(got, ref, 1e-5)
    assert kernels.LAUNCHES["groupby_fold_masked"] == 3
    assert float(got["act"].sum()) > 0
    if which == "hh":
        assert float(got["hh"].sum()) > 0 and float(got["hll"].sum()) == 0
    if which == "wide":
        assert float(got["hll"].max()) > 0 and float(got["hh"].sum()) == 0


def _segments(g, seed, nseg, slot_dtype, rows):
    """nseg padded batches of `rows` rows as a refold caches them, each
    with its own real rows, mask holes and padding (one segment's mask
    empty, and past two segments one of no rows; slot_dtype "mixed":
    uint16 and int32 segments in turn), as the masked fold's group (base,
    V, M and the slots over every segment's rows, joined as
    fold_masked_many joins them) and as the plain version's segments (the
    same over each one's real rows)."""
    parts, real = [], []
    for j in range(nseg):
        sdt = ((np.uint16, np.int32)[j % 2] if slot_dtype == "mixed"
               else slot_dtype)
        base, V, M, slots, k = _masked_inputs(
            g, seed + j, sdt, rows=rows, n=rows * 3 // 4,
            keys=g.capacity - 1)
        if nseg > 2 and j == nseg // 2:  # a segment of no rows
            base, V, M, slots, k = base[:0], V[:, :0], M[:, :0], slots[:0], 0
        if nseg > 1 and j == 1:
            base = torch.zeros_like(base)
            M = torch.zeros_like(M)
        parts.append((base, V, M, slots))
        real.append((base[:k], V[:, :k], M[:, :k], slots[:k]))
    group = (torch.cat([p[0] for p in parts]),
             torch.cat([p[1] for p in parts], dim=1),
             torch.cat([p[2] for p in parts], dim=1),
             concat_slots([p[3] for p in parts]))
    return group, real


@pytest.mark.parametrize("slot_dtype", [np.uint16, np.int32, "mixed"])
@pytest.mark.parametrize("which", ["scalar", "sketch"])
@pytest.mark.parametrize("nseg", [1, 2, 300])
def test_fold_masked_segments_match_plain(gb, sgb, which, nseg, slot_dtype):
    """#2 over a refold's segment group in ONE launch: 1, 2 and 300
    segments, among them an empty mask and a segment of no rows, on
    uint16, int32 and mixed slots (joined as int32); the scalar rule and
    the sketch rule (act, count, avg, hll, hist and hh in one launch)
    against the plain version over each segment's real rows in turn; s1 /
    s2 within rtol 1e-5, the rest bit-equal, the other panes untouched."""
    g = gb if which == "scalar" else sgb
    rows = 4096 if nseg < 300 else 96
    (base, V, M, slots), real = _segments(g, 300 + nseg, nseg, slot_dtype,
                                          rows)
    mixed = slot_dtype == "mixed" and nseg > 1
    assert slots.dtype == (torch.int32 if mixed or slot_dtype == np.int32
                           else torch.uint16)
    pane = g.n_panes - 1
    kernels.reset_launches()
    got, ref = g.init_state(), g.init_state()
    kernels.groupby_fold_masked(got, base, V, M, slots, pane, g._colmap,
                                g._widemap)
    for rb, rV, rM, rs in real:
        kernels.fold_plain(ref, rb, rV, rM, rs, pane, g._colmap, g._widemap)
    torch.cuda.synchronize()
    _same(got, ref, 1e-5)
    assert kernels.LAUNCHES["groupby_fold_masked"] == 1
    assert float(got["act"][pane].sum()) == float(sum(r[0].sum()
                                                      for r in real))
    assert float(got["act"][:pane].sum()) == 0


@pytest.mark.parametrize("which", ["scalar", "sketch"])
def test_fold_takes_uint16_slots(gb, sgb, which):
    """#1 on uint16 slots (a cached sliding batch) folds as on the same
    slots in int32."""
    g = gb if which == "scalar" else sgb
    kernels.reset_launches()
    got, ref = g.init_state(), g.init_state()
    base, V, M, slots, _ = _masked_inputs(g, 90, np.uint16)
    for st, s in ((got, slots), (ref, slots.to(torch.int32))):
        kernels.groupby_fold(st, base, V, M, s, 0, g._colmap, g._widemap)
    torch.cuda.synchronize()
    _same(got, ref, 1e-5)
    assert kernels.LAUNCHES["groupby_fold"] == 2


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


@pytest.mark.parametrize("case", list(fc.TIER_CASES))
def test_tier_demote_edge_states(case):
    """#18's one launch against its plain version on
    tests/torch_finalize_cases.py's blocks: one real row and 2,047 pads,
    half or all of the block real, rows of 18, 774 and 1,027 floats,
    scalar, hll and percentile state, with and without the touch column;
    the packed block and the state bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ekuiper_tpu_torch.ops import tierstore as tts
    from ekuiper_tpu_torch.ops.aggspec import extract_kernel_plan
    from ekuiper_tpu_torch.ops.groupby import TorchGroupBy
    from ekuiper_tpu_torch.sql.parser import parse_select
    plan_tag, n, touch = fc.TIER_CASES[case]
    sql, n_panes = fc.TIER_SQL[plan_tag]
    gb = TorchGroupBy(extract_kernel_plan(parse_select(sql)),
                      capacity=fc.TIER_CAP, n_panes=n_panes, micro_batch=64,
                      track_touch=touch)
    ts = tts.TierStore(gb, tts.TierLayout(
        hot_slots=fc.TIER_CAP, demote_batch=fc.TIER_D,
        scan_interval_ms=100, min_idle_scans=1))
    st = gb.state_from_host(fc.tier_fill(gb.state_to_host(gb.init_state()),
                                         seed=5))
    s, real = ts._slots(fc.tier_slots(n, seed=6))
    s_dev = torch.from_numpy(s).to(gb.device)
    got, ref = _clone(st), _clone(st)
    kernels.reset_launches()
    packed = kernels.tier_demote(got, s_dev, real, ts.comps)
    want = kernels.tier_demote_plain(ref, s_dev, real, ts.comps)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["tier_demote"] == 1
    np.testing.assert_array_equal(packed.cpu().numpy(), want.cpu().numpy())
    _same_exact(got, ref)


@pytest.mark.parametrize("n", [1, 37, 2048])
def test_tier_promote_matches_plain(tnode, n):
    """#19 against its plain version, bit-equal: n demoted rows merged
    back into other slots holding data (add, min, max per component), the
    block and the slots holding the n real rows only (the reference's
    identity pads on slots[0] merged by the kernel where n < D)."""
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
    packed = torch.from_numpy(rows).to(gb.device)
    d_dev = torch.from_numpy(dst).to(gb.device)
    got, ref = _clone(st), _clone(st)
    kernels.reset_launches()
    kernels.tier_promote(got, packed, d_dev, real, ts.demote_batch, ts.comps)
    kernels.tier_promote_plain(ref, packed, d_dev, real, ts.demote_batch,
                               ts.comps)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["tier_promote"] == 1
    _same_bits(got, ref)


def _same_bits(got, ref):
    """Every component equal element for element, float32 by its bits."""
    assert got.keys() == ref.keys()
    for comp in ref:
        g, r = got[comp].cpu().numpy(), ref[comp].cpu().numpy()
        if g.dtype == np.float32:
            g, r = g.view(np.uint32), r.view(np.uint32)
        np.testing.assert_array_equal(g, r, err_msg=comp)


@pytest.mark.parametrize("case", list(fc.TIER_CASES))
def test_tier_promote_edge_states(case):
    """#19's kernel against its plain version on
    tests/torch_finalize_cases.py's blocks: one real row of 2,048 (the
    identity merged into slots[0] once), half or all of the block real,
    rows of 18, 774 and 1,027 floats, scalar, hll and percentile state
    and rows holding +/-0.0 and +/-inf in mn, mx and hll and -0.0 in
    slots[0]'s and row 0's additive elements; a block and slots longer
    than n. The state bit-equal, signs of zero included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ekuiper_tpu_torch.ops import tierstore as tts
    from ekuiper_tpu_torch.ops.aggspec import extract_kernel_plan
    from ekuiper_tpu_torch.ops.groupby import TorchGroupBy
    from ekuiper_tpu_torch.sql.parser import parse_select
    plan_tag, n, touch = fc.TIER_CASES[case]
    sql, n_panes = fc.TIER_SQL[plan_tag]
    gb = TorchGroupBy(extract_kernel_plan(parse_select(sql)),
                      capacity=fc.TIER_CAP, n_panes=n_panes, micro_batch=64,
                      track_touch=touch)
    ts = tts.TierStore(gb, tts.TierLayout(
        hot_slots=fc.TIER_CAP, demote_batch=fc.TIER_D,
        scan_interval_ms=100, min_idle_scans=1))
    rng = np.random.default_rng(7)
    host = fc.tier_fill(gb.state_to_host(gb.init_state()), seed=5)
    s, real = ts._slots(fc.tier_slots(n, seed=6))
    block = kernels.tier_demote_plain(
        gb.state_from_host(host), torch.from_numpy(s).to(gb.device), real,
        ts.comps)
    rows = fc.promote_rows(block.cpu().numpy(), ts.blocks, n, rng)
    back = fc.tier_slots(n, seed=8)
    for comp, arr in host.items():
        if arr.dtype == np.float32:
            fc.promote_specials(arr, comp, rng, zero_cols=back[0])
    extra = rng.normal(0, 1, (3, ts.packed_w)).astype(np.float32)
    packed = torch.from_numpy(np.concatenate([rows, extra])).to(gb.device)
    slots = torch.from_numpy(np.concatenate([back, [0, 1, 2]]).astype(
        np.int32)).to(gb.device)
    got, ref = gb.state_from_host(host), gb.state_from_host(host)
    kernels.reset_launches()
    kernels.tier_promote(got, packed, slots, n, fc.TIER_D, ts.comps)
    kernels.tier_promote_plain(ref, packed, slots, n, fc.TIER_D, ts.comps)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["tier_promote"] == 1
    _same_bits(got, ref)


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
        kernels.groupby_fold(got, base, V, M, slots, seed % 2, gb._colmap,
                             gb._widemap)
        kernels.fold_plain(ref, base, V, M, slots, seed % 2, gb._colmap,
                           gb._widemap)
    kernels.groupby_reset_pane(got, 0)
    kernels.reset_pane_plain(ref, 0)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got["touch"].cpu().numpy(),
                                  ref["touch"].cpu().numpy())
    np.testing.assert_array_equal(got["act"].cpu().numpy(),
                                  ref["act"].cpu().numpy())
    assert int(got["touch"].to(torch.int64).sum()) == int(
        tnode.state["touch"].to(torch.int64).sum()) + 3 * (4096 - 586)


@pytest.mark.parametrize("slot_dtype", [np.uint16, np.int32])
def test_fold_masked_touch_column_matches_plain(tnode, slot_dtype):
    """#2's touch branch (a tiered sliding rule's edge refolds): the masked
    fold over a padded batch bumps touch[slot] once per row past its mask,
    as the plain version over the real rows does, exactly; the padding
    (slot 0, mask 0) touches nothing."""
    gb = tnode.gb
    rng = np.random.default_rng(94)
    got, ref = _clone(tnode.state), _clone(tnode.state)
    rows, n = 4096, 3000
    kernels.reset_launches()
    for seed in range(3):
        v = rng.normal(20, 5, rows).astype(np.float32)
        slots = rng.integers(0, 700, rows)
        mask = rng.random(rows) < 0.7
        v[n:], slots[n:], mask[n:] = 0, 0, False
        cols = {"v": torch.from_numpy(v).to(gb.device),
                "__hll__v": torch.from_numpy(
                    encode_hll_column(v, rows)).to(gb.device)}
        cols = {c: cols[c] for c in gb.plan.columns}
        base, V, M = gb.spec_inputs(cols, rows)
        base &= torch.from_numpy(mask).to(gb.device)
        M &= base
        s = torch.from_numpy(slots.astype(slot_dtype)).to(gb.device)
        kernels.groupby_fold_masked(got, base, V, M, s, gb.n_panes - 1,
                                    gb._colmap, gb._widemap)
        kernels.fold_plain(ref, base[:n], V[:, :n], M[:, :n], s[:n],
                           gb.n_panes - 1, gb._colmap, gb._widemap)
    torch.cuda.synchronize()
    assert kernels.TOUCH_LAUNCHES["groupby_fold_masked"] == 3
    np.testing.assert_array_equal(got["touch"].cpu().numpy(),
                                  ref["touch"].cpu().numpy())
    _same({k: v for k, v in got.items() if k != "touch"},
          {k: v for k, v in ref.items() if k != "touch"}, 1e-5)
    assert int(got["touch"].to(torch.int64).sum()) > int(
        tnode.state["touch"].to(torch.int64).sum())


def test_fold_touch_column_with_pane_vector(tnode):
    """The touch branch under a per-row pane vector (an event-time tiered
    batch across bucket edges): touch, act and the state as the plain
    version."""
    gb = tnode.gb
    rng = np.random.default_rng(93)
    got, ref = _clone(tnode.state), _clone(tnode.state)
    P = gb.n_panes
    for seed in range(3):
        v = rng.normal(20, 5, 4096).astype(np.float32)
        cols = {"v": torch.from_numpy(v).to(gb.device),
                "__hll__v": torch.from_numpy(
                    encode_hll_column(v, 4096)).to(gb.device)}
        cols = {c: cols[c] for c in gb.plan.columns}
        base, V, M = gb.spec_inputs(cols, 4096)
        base[::5] = False
        M &= base
        slots = torch.from_numpy(
            rng.integers(0, 700, 4096).astype(np.int32)).to(gb.device)
        pv = torch.from_numpy(
            rng.integers(0, P, 4096).astype(np.uint8)).to(gb.device)
        kernels.groupby_fold(got, base, V, M, slots, 0, gb._colmap,
                             gb._widemap, pv)
        kernels.fold_plain(ref, base, V, M, slots, 0, gb._colmap,
                           gb._widemap, pv)
    torch.cuda.synchronize()
    _same_exact({k: got[k] for k in ("touch", "act")},
                {k: ref[k] for k in ("touch", "act")})
    _same(got, ref, 1e-5)


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


# ------------------------------------------------------ relational tier
@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _join_sides(rng, n, keys, dev, null_ts):
    """One padded join side: slots, rebased int32 times (some at the side's
    NULL sentinel), validity (the pad tail invalid)."""
    slot = rng.integers(0, keys, n).astype(np.int32)
    ts = rng.integers(0, 1 << 12, n).astype(np.int32)
    ts[rng.random(n) < 0.05] = null_ts
    valid = np.arange(n) < n - n // 8
    return [torch.from_numpy(a).to(dev) for a in (slot, ts, valid)]


@pytest.mark.parametrize("shape", ["none", "full", "left", "right", "const"])
def test_join_match_matches_plain(cuda_dev, shape):
    """#20 bit-equal to its plain version, the band's edges inclusive, with
    each residual shape the expression IR can give."""
    rng = np.random.default_rng(20)
    PL, PR = 512, 1024
    left = _join_sides(rng, PL, 40, cuda_dev, -(1 << 30))
    right = _join_sides(rng, PR, 40, cuda_dev, 1 << 30)
    resid = {"none": None,
             "full": torch.from_numpy(rng.random((PL, PR)) < 0.5),
             "left": torch.from_numpy(rng.random((PL, 1)) < 0.5),
             "right": torch.from_numpy(rng.random((1, PR)) < 0.5),
             "const": torch.zeros((1, 1), dtype=torch.bool)}[shape]
    if resid is not None:
        resid = resid.to(cuda_dev)
    for lo, hi in ((-300, 300), (-(1 << 28), 0), (-(1 << 30), 1 << 30)):
        got = kernels.join_match(*left, *right, lo, hi, resid)
        want = kernels.join_match_plain(*left, *right, lo, hi, resid)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert shape == "const" or bool(got.any())


#: residual forms of the packed-mask cases: none, each shape the
#: expression IR gives, a transposed (PL, PR) view (made contiguous by the
#: wrapper) and a (PL, PR) view one byte off its allocation (read a byte
#: at a time)
PACKED_RESIDUALS = ["none", "full", "left", "right", "const", "transposed",
                    "offset"]


def _coin(rng, shape):
    return torch.from_numpy(rng.integers(0, 2, shape, dtype=np.uint8)
                            .astype(bool))


def _packed_residual(rng, form, PL, PR, dev):
    if form == "none":
        return None
    shape = {"full": (PL, PR), "left": (PL, 1), "right": (1, PR),
             "const": (1, 1), "transposed": (PR, PL),
             "offset": (PL * PR + 1,)}[form]
    r = _coin(rng, shape).to(dev)
    if form == "transposed":
        return r.t()
    if form == "offset":
        return r[1:].view(PL, PR)
    return r


@pytest.mark.parametrize("form", PACKED_RESIDUALS)
@pytest.mark.parametrize("PL,PR", [(256, 256), (2048, 2048),
                                   (16384, 16384), (64, 4096), (4096, 8),
                                   (32, 32)])
def test_join_match_packed_bit_equal(cuda_dev, PL, PR, form):
    """#20's packed mask bit-equal to its plain version at 256², J1's
    2,048² and J3's 16,384², and on narrow and uneven blocks (a row of
    one partial word, strips of fewer than 32 words), with every residual
    form; it unpacks to the byte mask of the broadcast compares, and a
    word's bits past PR are 0."""
    rng = np.random.default_rng(PL * 7 + PR)
    keys = max(2, min(PL, PR) // 8)
    left = _join_sides(rng, PL, keys, cuda_dev, -(1 << 30))
    right = _join_sides(rng, PR, keys, cuda_dev, 1 << 30)
    resid = _packed_residual(rng, form, PL, PR, cuda_dev)
    kernels.reset_launches()
    for lo, hi in ((-300, 300), (-(1 << 28), 0), (5, 4),
                   (-(1 << 30), 1 << 30)):
        got = kernels.join_match(*left, *right, lo, hi, resid)
        want = kernels.join_match_plain(*left, *right, lo, hi, resid)
        torch.cuda.synchronize()
        assert got.dtype == torch.uint8
        assert got.shape == (PL, 4 * ((PR + 31) // 32))
        assert torch.equal(got, want), (lo, hi)
        if PL * PR <= 1 << 22:
            dt = left[1][:, None] - right[1][None, :]
            byte = ((left[0][:, None] == right[0][None, :]) & (dt >= lo)
                    & (dt <= hi) & left[2][:, None] & right[2][None, :])
            if resid is not None:
                byte = byte & resid
            bits = np.unpackbits(got.cpu().numpy(), axis=1,
                                 bitorder="little")
            np.testing.assert_array_equal(bits[:, :PR],
                                          byte.cpu().numpy())
            assert not bits[:, PR:].any()
        if lo > hi:
            assert not bool(got.any())
    assert kernels.LAUNCHES["join_match"] == 4


def _seg_ids(rng, B, slots, kind):
    """Segment ids: uniform over `slots`, Zipf-skewed sizes over `slots`,
    or spread over [0, 2^30) so that every digit place of the sort varies."""
    if kind == "zipf":
        return ((rng.zipf(1.2, B) - 1) % slots).astype(np.int32)
    if kind == "wide":
        ids = rng.integers(0, 1 << 30, max(slots, 1))
        ids[:2] = [0, (1 << 30) - 1]
        return rng.choice(ids, B).astype(np.int32)
    return rng.integers(0, slots, B).astype(np.int32)


def _seg_batch(rng, B, n, slots, dev, kind="uniform"):
    """The window functions' collection: ties, signed zeros, ±inf and NULL
    (NaN) values; the pad tail invalid."""
    seg = _seg_ids(rng, B, slots, kind)
    vals = rng.choice(np.array([1.5, 2.5, 7.0, -0.0, 0.0, np.inf, -np.inf,
                                np.nan], dtype=np.float32), B)
    valid = np.arange(B) < n
    return [torch.from_numpy(a).to(dev) for a in (seg, vals, valid)]


def _shift_batch(rng, B, n, slots, dev, kind, infs):
    """One micro-batch of the shift: N(20, 5) values with 2 % NULL and some
    signed zeros; with `infs`, ±inf in a quarter of the last n/16 rows
    (so the batches before it check the finite sums across block edges,
    and this one the non-finite sums and carries exactly)."""
    seg = _seg_ids(rng, B, slots, kind)
    vals = rng.normal(20, 5, B).astype(np.float32)
    vals[rng.random(B) < 0.02] = np.nan
    vals[rng.random(B) < 0.01] = -0.0
    if infs:
        tail = (np.arange(B) >= n - n // 16) & (np.arange(B) < n)
        hit = tail & (rng.random(B) < 0.25)
        vals[hit] = np.where(rng.random(B) < 0.5, np.inf, -np.inf)[hit]
    valid = np.arange(B) < n
    return [torch.from_numpy(a).to(dev) for a in (seg, vals, valid)]


def _same_seg(got, want, exact_idx, rtol_idx=()):
    """Outputs `exact_idx` equal (NaN where NaN); `rtol_idx` NaN and ±inf
    where the other is, the finite values within rtol 1e-5."""
    for i in exact_idx:
        g, w = got[i], want[i]
        if g.is_floating_point():
            assert torch.equal(g.isnan(), w.isnan()), i
            m = ~g.isnan()
            assert torch.equal(g[m], w[m]), i
        else:
            assert torch.equal(g, w), i
    for i in rtol_idx:
        g, w = got[i], want[i]
        assert torch.equal(g.isnan(), w.isnan()), i
        assert torch.equal(g.isinf(), w.isinf()), i
        assert torch.equal(g[g.isinf()], w[g.isinf()]), i
        torch.testing.assert_close(g, w, rtol=1e-5, atol=0, equal_nan=True)


@pytest.mark.parametrize("B,slots,C,kind", [
    pytest.param(256, 40, 1024, "uniform", id="256-40"),
    pytest.param(8192, 1000, 1024, "uniform", id="8192-1000"),
    pytest.param(8192, 1, 1024, "uniform", id="8192-1"),
    pytest.param(8192, 1000, 512, "uniform", id="slots_past_C"),
    pytest.param(131072, 1, 1024, "uniform", id="one_segment-131072"),
    pytest.param(1 << 20, 1, 1024, "uniform", id="one_segment-1048576"),
    pytest.param(131072, 10000, 20000, "zipf", id="zipf-131072"),
    pytest.param(65536, 20000, 4096, "wide", id="wide_ids")])
def test_segscan_shift_matches_plain(cuda_dev, B, slots, C, kind):
    """#21 against its plain version over three batches (the carry in
    place): row numbers, lag, flags, counts and last values exact, running
    sums rtol 1e-5 (both in float64 rounded once a row, summed in another
    order), their NaN and ±inf exactly; the third batch holds ±inf. One
    slot of 2^17 and 2^20 rows spans many blocks; Zipf-skewed slots; slot
    ids up to 2^30 - 1 (each digit place varies) and slots past C (no
    carry); B = 256 with pads."""
    rng = np.random.default_rng(21)
    carry_k = (torch.zeros(C, dtype=torch.int32, device=cuda_dev),
               torch.zeros(C, device=cuda_dev),
               torch.zeros(C, dtype=torch.bool, device=cuda_dev),
               torch.zeros(C, device=cuda_dev))
    carry_p = tuple(t.clone() for t in carry_k)
    for b in range(3):
        x = _shift_batch(rng, B, B - B // 5, slots, cuda_dev, kind, b == 2)
        got = kernels.segscan_shift(carry_k, *x)
        want = kernels.segscan_shift_plain(carry_p, *x)
        torch.cuda.synchronize()
        _same_seg(got, want, (0, 1, 2, 4), (3,))
        _same_seg(carry_k, carry_p, (0, 1, 2), (3,))
    assert not bool(want[3].isfinite().all())


@pytest.mark.parametrize("B,segs,kind", [
    pytest.param(256, 5, "uniform", id="256-5"),
    pytest.param(4096, 300, "uniform", id="4096-300"),
    pytest.param(65536, 2000, "uniform", id="65536-2000"),
    pytest.param(65536, 1, "uniform", id="65536-1"),
    pytest.param(131072, 1, "uniform", id="one_segment-131072"),
    pytest.param(1 << 20, 1, "uniform", id="one_segment-1048576"),
    pytest.param(65536, 10000, "zipf", id="zipf-65536"),
    pytest.param(65536, 20000, "wide", id="wide_ids")])
def test_segscan_sort_matches_plain(cuda_dev, B, segs, kind):
    """#22 bit-equal to its plain version: row numbers, lead and its flag,
    rank, dense rank and the rank flag, with ties, signed zeros, ±inf and
    NULL (NaN) values; one segment of up to 2^20 rows over many blocks,
    Zipf-skewed segments, segment ids up to 2^30 - 1, and pads."""
    rng = np.random.default_rng(22)
    x = _seg_batch(rng, B, B - B // 7, segs, cuda_dev, kind)
    got = kernels.segscan_sort(*x)
    want = kernels.segscan_sort_plain(*x)
    torch.cuda.synchronize()
    _same_seg(got, want, range(6))


# ------------------------------------------------------------- count-min
@pytest.mark.parametrize("depth,width,n", [(4, 8192, 65536), (3, 1000, 4099),
                                           (2, 64, 1)])
def test_cms_update_and_query_match_plain(cuda_dev, depth, width, n):
    """#10 and #11 bit-equal to their plain versions (integer counts under
    2^24 add alike in any order), over a skewed mix with signed zeros and
    NaN, a width that is not a power of two and a single value."""
    rng = np.random.default_rng(depth * width + n)
    u = rng.random(n)
    v = np.where(u < 0.35, 7, np.where(u < 0.55, 13, np.where(
        u < 0.7, 99, rng.integers(100, 20_100, n)))).astype(np.float32)
    v[:min(n, 3)] = [-0.0, 0.0, np.nan][:min(n, 3)]
    vals = torch.from_numpy(v).to(cuda_dev)
    got = torch.zeros((depth, width), device=cuda_dev)
    ref = got.clone()
    kernels.reset_launches()
    for _ in range(2):
        kernels.cms_update(got, vals)
        kernels.cms_update_plain(ref, vals)
    q = torch.from_numpy(np.concatenate([v[:4096], [7.0, 12345.0]]).astype(
        np.float32)).to(cuda_dev)
    est = kernels.cms_query(got, q)
    want = kernels.cms_query_plain(ref, q)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["cms_update"] == 2
    assert kernels.LAUNCHES["cms_query"] == 1
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())
    np.testing.assert_array_equal(est.cpu().numpy(), want.cpu().numpy())
    assert float(got.sum()) == 2 * depth * n


def _cms_stream(kind, n, rng):
    """Phase M's mix (7 at 35 %, 13 at 20 %, 99 at 15 %, the rest over
    [100, 20,100)) or a uniform stream over [0, 2^20), with -0.0, +0.0 and
    NaN among the first values."""
    if kind == "mix":
        u = rng.random(n)
        v = np.where(u < 0.35, 7, np.where(u < 0.55, 13, np.where(
            u < 0.7, 99, rng.integers(100, 20_100, n))))
    else:
        v = rng.integers(0, 1 << 20, n)
    v = v.astype(np.float32)
    v[:min(n, 3)] = [-0.0, 0.0, np.nan][:min(n, 3)]
    return v


CMS_CASES = [  # stream, depth, width, n
    pytest.param("mix", 4, 8192, 65536, id="m_mix"),
    pytest.param("uniform", 4, 8192, 65536, id="uniform"),
    pytest.param("mix", 4, 8192, 1, id="n1"),
    pytest.param("mix", 4, 8192, 65536 + 37, id="off_block"),
    pytest.param("uniform", 3, 1000, 4099, id="width_1000"),
    pytest.param("mix", 2, 65536, 20_000, id="past_shared_memory")]


@pytest.mark.parametrize("kind,depth,width,n", CMS_CASES)
def test_cms_update_streams_match_plain(cuda_dev, kind, depth, width, n):
    """#10's warp-aggregated atomics bit-equal to the plain version
    (integer counts under 2^24): at phase M's (4, 8192) on its mix and on
    a uniform stream, one value, a count off a block multiple, a width
    that is not a power of two, and a row of 256 KB, past a block's shared
    memory."""
    rng = np.random.default_rng(depth * width + n)
    vals = torch.from_numpy(_cms_stream(kind, n, rng)).to(cuda_dev)
    got = torch.zeros((depth, width), device=cuda_dev)
    ref = got.clone()
    kernels.reset_launches()
    for _ in range(2):
        kernels.cms_update(got, vals)
        kernels.cms_update_plain(ref, vals)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["cms_update"] == 2
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())
    assert float(got.sum()) == 2 * depth * n


# ------------------------------------------------------------ mesh shards
SHARD_SQL = ("SELECT k, count(*) AS c, sum(v) AS s, min(v) AS mn, "
             "max(v) AS mx, stddev(v) AS sd, hll(v) AS u, "
             "percentile_approx(v, 0.9) AS p FROM s "
             "GROUP BY k, HOPPINGWINDOW(ss, 30, 10)")


@pytest.mark.parametrize("vec", [False, True], ids=["pane", "pane_vec"])
@pytest.mark.parametrize("mesh", [(2, 4), (1, 8), (4, 2)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_kernels_match_plain(cuda_dev, mesh, vec):
    """#23 / #24 on one card: the sharded fold's partials (one launch)
    against its plain version (counts, act, min, max, touch, hll registers and hist
    bins bit-equal, sums rtol 1e-5), then the merge of the same partials
    bit-equal (the R partials in r order, one add / min / max into the
    state) with the partials back at their identity."""
    from ekuiper_tpu_torch.parallel.mesh import make_mesh
    from ekuiper_tpu_torch.parallel.sharded import ShardedGroupBy

    R, K = mesh
    node = plan_fused_rule(SHARD_SQL, key_slots=512, micro_batch=4096,
                           device=cuda_dev)
    gb = ShardedGroupBy(node.plan, make_mesh(R, K, [cuda_dev] * (R * K)),
                        capacity=512, n_panes=3, micro_batch=4096,
                        track_touch=True)
    rng = np.random.default_rng(23 + R)
    n = 4000
    v = rng.normal(20, 5, n).astype(np.float32)
    v[rng.random(n) < 0.05] = np.nan
    cols = {"v": torch.from_numpy(v).to(cuda_dev),
            "__hll__v": torch.from_numpy(encode_hll_column(v, n)).to(
                cuda_dev)}
    base, V, M = gb.spec_inputs(cols, n)
    slots = torch.from_numpy(
        rng.integers(0, 300, n).astype(np.int32)).to(cuda_dev)
    pv = (torch.from_numpy(rng.integers(0, 4, n).astype(np.uint8)).to(
        cuda_dev) if vec else None)  # pane 3: outside the state, dropped
    got = gb._partials(3 if vec else 1)
    ref = {k: t.clone() for k, t in got.items()}
    m = gb.rows_per_shard
    kernels.reset_launches()
    kernels.sharded_fold(got, base, V, M, slots, m, R, K, gb._colmap,
                         gb._widemap, pv)
    kernels.sharded_fold_plain(ref, base, V, M, slots, m, R, K, gb._colmap,
                               gb._widemap, pv)
    torch.cuda.synchronize()
    _same(got, ref, 1e-5)
    assert float(got["act"].sum()) > 0
    st_k = gb.init_state()
    kernels.fold_scalar_plain(st_k, base, V, M, slots, 0, gb._colmap)
    st_p = {k: t.clone() for k, t in st_k.items()}
    parts_k = {k: t.clone() for k, t in ref.items()}
    kernels.shard_merge(st_k, parts_k, 1, R)
    kernels.shard_merge_plain(st_p, ref, 1, R)
    torch.cuda.synchronize()
    _same(st_k, st_p, 0.0)
    _same(parts_k, ref, 0.0)
    assert kernels.LAUNCHES["sharded_fold"] == 1
    assert kernels.LAUNCHES["shard_merge"] == 1
    assert kernels.ROW_PANE_LAUNCHES["sharded_fold"] == int(vec)
    assert kernels.TOUCH_LAUNCHES["sharded_fold"] == 1


#: a merge's component mixes: name -> ({component: trailing shape},
#: touch column, P' = P)
MERGE_MIXES = {
    "scalar": ({"act": (), "n": (2,), "s1": (2,), "s2": (1,), "mn": (2,),
                "mx": (1,)}, True, False),
    "pct": ({"act": (), "n": (1,), "hist": (1, 67)}, False, False),
    "hll": ({"act": (), "hll": (2, 256)}, False, False),
    "touch": ({"act": ()}, True, False),
    "pane_vec": ({"act": (), "n": (1,), "s1": (1,), "mn": (1,),
                  "mx": (1,)}, False, True),
}


def _placed(shape, dtype, dev, off):
    """A contiguous tensor `off` elements past a fresh allocation's
    start."""
    n = int(np.prod(shape))
    return torch.empty(n + off, dtype=dtype, device=dev)[off:].view(shape)


def _merge_case(rng, mix, R, C, P, dev, offs):
    """A state and its R row shards' partials, every tensor at the given
    element offsets (state, partials) from its allocation; about half the
    partial elements at the identity, the sums' others with some -0.0,
    the touch counts near 2^32 so that sums wrap."""
    comps, touch, vec = MERGE_MIXES[mix]
    Pp = P if vec else 1
    state, parts = {}, {}
    for comp, tail in comps.items():
        ident = kernels.INIT[comp]
        st = _placed((P, C) + tail, torch.float32, dev, offs[0])
        st.copy_(torch.from_numpy(
            rng.normal(5, 3, st.shape).astype(np.float32)))
        pa = rng.normal(5, 3, (R * Pp, C) + tail).astype(np.float32)
        if comp in ("n", "s1", "s2", "act"):
            pa[rng.random(pa.shape) < 0.05] = -0.0
        if comp in ("hll", "hist"):
            pa = np.rint(np.abs(pa)).astype(np.float32)
        pa[rng.random(pa.shape) < 0.5] = ident
        part = _placed(pa.shape, torch.float32, dev, offs[1])
        part.copy_(torch.from_numpy(pa))
        state[comp], parts[comp] = st, part
    if touch:
        t = rng.integers(0, 1 << 32, C, dtype=np.uint64).astype(np.uint32)
        tp = rng.integers((1 << 32) - 9, 1 << 32, (R, C),
                          dtype=np.uint64).astype(np.uint32)
        tp[rng.random(tp.shape) < 0.5] = 0
        state["touch"] = _placed((C,), torch.uint32, dev, offs[0])
        state["touch"].copy_(torch.from_numpy(t.astype(np.int64)).to(
            dev).to(torch.uint32))
        parts["touch"] = _placed((R, C), torch.uint32, dev, offs[1])
        parts["touch"].copy_(torch.from_numpy(tp.astype(np.int64)).to(
            dev).to(torch.uint32))
    return state, parts


def _bits(t):
    """A tensor's bytes as int64 numpy, to compare bit for bit."""
    if t.dtype == torch.uint32:
        return t.cpu().long().numpy()
    return t.contiguous().view(torch.int32).cpu().numpy()


#: (C, state offset, partials offset): whole float4 units; a length off
#: 16 bytes (element by element where R > 1); state and partials 4 bytes
#: past a boundary (a head and a tail); partials at another phase than the
#: state (element by element)
MERGE_LAYOUTS = {"aligned": (64, 0, 0), "odd": (37, 0, 0),
                 "offset": (64, 1, 1), "phases": (64, 1, 2)}


@pytest.mark.parametrize("layout", sorted(MERGE_LAYOUTS))
@pytest.mark.parametrize("mix", sorted(MERGE_MIXES))
@pytest.mark.parametrize("R", [1, 2, 4, 8, 11])
def test_shard_merge_flat_bit_equal(cuda_dev, R, mix, layout):
    """#23 / #24's merge (one launch over every component and the touch
    column) bit-equal to shard_merge_plain for R past the eight loads a
    thread issues at once, each component mix, #24's P' = P vector, and
    lengths and pointers off 16-byte boundaries; the partials back at
    their identity afterwards."""
    C, so, po = MERGE_LAYOUTS[layout]
    P = 3
    rng = np.random.default_rng(R * 100 + len(mix) * 10 + C + so + po)
    state, parts = _merge_case(rng, mix, R, C, P, cuda_dev, (so, po))
    st_p = {k: t.clone() for k, t in state.items()}
    pa_p = {k: t.clone() for k, t in parts.items()}
    kernels.reset_launches()
    kernels.shard_merge(state, parts, 1, R)
    kernels.shard_merge_plain(st_p, pa_p, 1, R)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["shard_merge"] == 1
    for comp in st_p:
        np.testing.assert_array_equal(_bits(state[comp]), _bits(st_p[comp]),
                                      err_msg=comp)
        np.testing.assert_array_equal(_bits(parts[comp]), _bits(pa_p[comp]),
                                      err_msg=comp)
        ident = (0 if comp == "touch" else
                 np.float32(kernels.INIT[comp]).view(np.int32))
        assert (_bits(parts[comp]) == ident).all(), comp


def test_sharded_rule_matches_single_chip(cuda_dev):
    """A tumbling rule planned on a 2x4 mesh of one card against the same
    rule single-chip: every window's keys, counts, min and max equal, the
    averages within rtol 1e-5; the sharded path launches the sharded folds
    and merges, never #1."""
    from ekuiper_tpu_torch.data.batch import ColumnBatch
    from ekuiper_tpu_torch.runtime.events import Trigger

    sql = ("SELECT k, count(*) AS c, avg(v) AS a, min(v) AS mn, "
           "max(v) AS mx FROM s GROUP BY k, TUMBLINGWINDOW(ss, 10)")
    mesh = {"planOptimizeStrategy": {"mesh": {"rows": 2, "keys": 4}},
            "prefinalizeLeadMs": 0}
    sharded = plan_fused_rule(sql, key_slots=512, micro_batch=4096,
                              device=[cuda_dev] * 8, options=mesh)
    single = plan_fused_rule(sql, key_slots=512, micro_batch=4096,
                             device=cuda_dev, options={"prefinalizeLeadMs": 0})
    outs = ([], [])
    sharded.broadcast, single.broadcast = outs[0].append, outs[1].append
    for w in range(3):
        counts = []
        for node in (sharded, single):
            kernels.reset_launches()
            rng_w = np.random.default_rng(100 + w)
            for _ in range(3):
                ids = rng_w.integers(0, 700, 5000)
                node.process(ColumnBatch(n=5000, columns={
                    "k": np.array([f"k{i}" for i in ids], dtype=object),
                    "v": rng_w.normal(20, 5, 5000).astype(np.float32)}))
            node.on_trigger(Trigger(ts=(w + 1) * 10_000))
            torch.cuda.synchronize()
            counts.append(dict(kernels.LAUNCHES))
        assert counts[0]["sharded_fold"] == 6  # two chunks a batch
        assert counts[0]["shard_merge"] == 6
        assert counts[0]["groupby_fold"] == 0
        assert counts[1]["groupby_fold"] == 6
    assert len(outs[0]) == len(outs[1]) == 3
    for a, b in zip(*outs):
        for name in b.columns:
            x, y = np.asarray(a.columns[name]), np.asarray(b.columns[name])
            if name == "a":
                np.testing.assert_allclose(x, y, rtol=1e-5)
            else:
                np.testing.assert_array_equal(x, y, err_msg=name)


# -------------------------------------------- the one-launch fold (#1, #23)
FOLD_CAP, FOLD_ROWS = 64, 1000
#: each mode: (panes, a per-row pane vector, touch, rows, negative slots)
FOLD_MODES = {"pane": (2, False, False, FOLD_ROWS, False),
              "vec": (2, True, False, FOLD_ROWS, False),
              "vec255": (255, True, False, FOLD_ROWS, False),
              "touch": (2, False, True, FOLD_ROWS, False),
              "negative": (2, False, True, FOLD_ROWS, True),
              "empty": (2, False, True, 0, False)}
#: touch counters a few rows below 2^32
TOUCH_NEAR_WRAP = 2 ** 32 - 5


def _fold_gb(plan, P, touch, dev, cls=None, **kw):
    from ekuiper_tpu_torch.ops.aggspec import extract_kernel_plan
    from ekuiper_tpu_torch.ops.groupby import TorchGroupBy
    from ekuiper_tpu_torch.sql.parser import parse_select

    kplan = extract_kernel_plan(parse_select(fb.PLANS[plan]))
    if cls is None:
        return TorchGroupBy(kplan, capacity=FOLD_CAP, n_panes=P,
                            micro_batch=max(FOLD_ROWS, 1), device=dev,
                            track_touch=touch)
    return cls(kplan, capacity=FOLD_CAP, n_panes=P, track_touch=touch, **kw)


def _fold_batch_inputs(g, b, rows, dev):
    cols = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in fb.plan_columns(g.plan.columns, b["cols"],
                                        encode_hll_column).items()}
    base, V, M = g.spec_inputs(cols, rows)
    return (base, V, M, torch.from_numpy(b["slots"]).to(dev),
            torch.from_numpy(b["pane_vec"]).to(dev))


def _same_fold(got, ref):
    """The fold's tolerances: s1 / s2 rtol 1e-5, every other component
    exact (min / max by value: the kernel orders -0 below +0, torch's
    scatter_reduce_ as its atomics land; test_fold_orders_signed_zeros
    holds the kernel's order)."""
    for comp in ref:
        g, r = got[comp].cpu(), ref[comp].cpu()
        if not r.is_floating_point():
            assert torch.equal(g, r), comp
        elif comp in ("s1", "s2"):
            torch.testing.assert_close(g, r, rtol=1e-5, atol=0,
                                       equal_nan=True, msg=comp)
        else:
            np.testing.assert_array_equal(g.numpy(), r.numpy(),
                                          err_msg=comp)


FOLD_CASES = [(plan, kind, dt, mode) for plan in sorted(fb.PLANS)
              for kind in fb.SLOT_KINDS for dt in ("uint16", "int32")
              for mode in FOLD_MODES if not (mode == "negative"
                                             and dt == "uint16")]


@pytest.mark.parametrize("plan,kind,slot_dtype,mode", FOLD_CASES,
                         ids=["-".join(c) for c in FOLD_CASES])
def test_fold_edge_batches_match_plain(cuda_dev, plan, kind, slot_dtype,
                                       mode):
    """groupby_fold against its plain version on tests/torch_fold_batches.py's
    edge batches: every plan (an empty colmap, an empty widemap, hh + hll
    + hist in one rule), slot kind and slot type, a scalar pane or a
    per-row pane vector (2 or 255 panes, panes past the last dropped), a
    touch column near 2^32 (it wraps), negative int32 slots (dropped),
    zero rows; one launch a call."""
    P, vec, touch, rows, negative = FOLD_MODES[mode]
    g = _fold_gb(plan, P, touch, cuda_dev)
    got, ref = g.init_state(), g.init_state()
    if touch:
        for st in (got, ref):
            st["touch"].copy_(torch.full(
                (FOLD_CAP,), TOUCH_NEAR_WRAP, dtype=torch.int64).to(
                torch.uint32))
    kernels.reset_launches()
    for seed in range(2):
        b = fb.fold_batch(seed, rows, FOLD_CAP, P, kind,
                          getattr(np, slot_dtype))
        if negative:
            b["slots"][::9] = -3
        base, V, M, slots, pv = _fold_batch_inputs(g, b, rows, cuda_dev)
        pane, pv = (0, pv) if vec else (1, None)
        kernels.groupby_fold(got, base, V, M, slots, pane, g._colmap,
                             g._widemap, pv)
        kernels.fold_plain(ref, base, V, M, slots, pane, g._colmap,
                           g._widemap, pv)
    torch.cuda.synchronize()
    _same_fold(got, ref)
    assert kernels.LAUNCHES["groupby_fold"] == 2
    if rows:
        assert float(got["act"].sum()) > 0


def test_fold_orders_signed_zeros(cuda_dev):
    """min / max of -0 and +0 in one (pane, slot): the kernel's sign-split
    atomics order -0 below +0 whatever the order of the rows (min -0, max
    +0), on both slot types."""
    g = _fold_gb("scalar", 2, False, cuda_dev)
    for order in ([0.0, -0.0, 0.0], [-0.0, 0.0, -0.0]):
        for dt in (np.int32, np.uint16):
            n = len(order)
            b = {"cols": {"v": np.array(order, dtype=np.float32),
                          "w": np.zeros(n, dtype=np.float32),
                          "code": np.zeros(n, dtype=np.float32)},
                 "slots": np.full(n, 5, dtype=dt),
                 "pane_vec": np.zeros(n, dtype=np.uint8)}
            st = g.init_state()
            base, V, M, slots, _ = _fold_batch_inputs(g, b, n, cuda_dev)
            kernels.groupby_fold(st, base, V, M, slots, 1, g._colmap,
                                 g._widemap)
            mn, mx = (float(st[c][1, 5, 0]) for c in ("mn", "mx"))
            assert mn == 0.0 and np.signbit(mn), order
            assert mx == 0.0 and not np.signbit(mx), order


@pytest.mark.parametrize("vec", [False, True], ids=["pane", "pane_vec"])
@pytest.mark.parametrize("kind", fb.SLOT_KINDS)
@pytest.mark.parametrize("plan", fb.MESH_PLANS)
def test_sharded_fold_edge_batches_match_plain(cuda_dev, plan, kind, vec):
    """sharded_fold against its plain version on the edge batches, on a
    2x4 mesh of the card with a touch partial: slots past the mesh's slots
    and panes past the block dropped, one launch a call."""
    from ekuiper_tpu_torch.parallel.mesh import make_mesh
    from ekuiper_tpu_torch.parallel.sharded import ShardedGroupBy

    R, K, P = 2, 4, 3
    g = _fold_gb(plan, P, True, cuda_dev, cls=ShardedGroupBy,
                 mesh=make_mesh(R, K, [cuda_dev] * (R * K)),
                 micro_batch=FOLD_ROWS)
    m = g.rows_per_shard
    got = g._partials(P if vec else 1)
    ref = {k: t.clone() for k, t in got.items()}
    kernels.reset_launches()
    for seed in range(2):
        b = fb.fold_batch(40 + seed, FOLD_ROWS, FOLD_CAP, P, kind)
        base, V, M, slots, pv = _fold_batch_inputs(g, b, FOLD_ROWS,
                                                   cuda_dev)
        pv = pv if vec else None
        kernels.sharded_fold(got, base, V, M, slots, m, R, K, g._colmap,
                             g._widemap, pv)
        kernels.sharded_fold_plain(ref, base, V, M, slots, m, R, K,
                                   g._colmap, g._widemap, pv)
    torch.cuda.synchronize()
    _same_fold(got, ref)
    assert kernels.LAUNCHES["sharded_fold"] == 2
    assert float(got["act"].sum()) > 0
