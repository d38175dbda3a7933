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
