"""Parity of the one-launch fold (#1 `groupby_fold`) and the sharded fold
(#23 / #24 `sharded_fold`), through their plain PyTorch versions on CPU
tensors, against the JAX package's DeviceGroupBy fold (`_fold`) and
ShardedGroupBy fold on the CPU, and against the scalar-then-wide sequence
of plain folds that the port ran before the fold was one launch.

The batches are tests/torch_fold_batches.py's edge cases, made from a
numpy seed and given to both packages: uniform, Zipf-skewed and one-slot
slots, the last key slot and slots past it, uint16 and int32 slots, a
per-row pane vector with panes past the last, a 255-pane vector, NaN,
±inf and ±0 values, a touch column near 2^32, zero rows, row counts that
are not a multiple of a block, an empty column map (hll alone), an empty
widemap (scalar columns alone) and hh, hll and hist in one rule. The
card's kernels are held to these plain versions with the same batches in
tests/test_torch_kernels_cuda.py.

Tolerance: act, n, mn, mx, touch and the hll / hist / hh counters
bit-equal to the reference (counts below 2^24 in any order; min / max pick
an input; the touch column wraps modulo 2^32 in both), compared by value
(JAX and torch need not order -0 and +0 alike; the kernels keep the
sign-split order, held on the card); s1 and s2 within rtol 1e-5 (XLA's
scatter-add against torch's index_put_). On the mesh the hll registers
leave out the cells a jnp.log2 miss reaches (tests/test_torch_groupby.py).
"""
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekuiper_tpu.ops.aggspec import extract_kernel_plan as jax_plan_of
from ekuiper_tpu.ops.aggspec import materialize_hll_columns
from ekuiper_tpu.ops.groupby import DeviceGroupBy
from ekuiper_tpu.parallel import mesh as jax_mesh
from ekuiper_tpu.parallel.sharded import ShardedGroupBy as JaxSharded
from ekuiper_tpu.sql.parser import parse_select as jax_parse
from ekuiper_tpu_torch.ops import kernels
from ekuiper_tpu_torch.ops.aggspec import (encode_hll_column,
                                           extract_kernel_plan)
from ekuiper_tpu_torch.ops.groupby import TorchGroupBy
from ekuiper_tpu_torch.parallel import mesh as port_mesh
from ekuiper_tpu_torch.parallel.sharded import ShardedGroupBy
from ekuiper_tpu_torch.sql.parser import parse_select

import torch_fold_batches as fb
from test_torch_groupby import _assert_sketch_state, _hll_miss_cells

CAP, PANES = 64, 2
#: rows of a batch: not a multiple of a 256-thread block
ROWS = 333
#: touch counters a few rows below 2^32
TOUCH_NEAR_WRAP = 2 ** 32 - 5


@pytest.fixture(scope="module", autouse=True)
def _no_cyclic_gc_inside_jax_locks():
    """The JAX package's devwatch registry prunes its weakrefs under a lock
    that a dying watch's __del__ also takes, so a cyclic collection inside
    the prune deadlocks the process: this module runs with the cyclic
    collector off and collects once at its end, outside any lock."""
    enabled = gc.isenabled()
    gc.disable()
    yield
    if enabled:
        gc.enable()
    gc.collect()


def _jax_hll(col, n):
    return materialize_hll_columns(["__hll__x"], {"x": col}, n)["__hll__x"]


def _port_inputs(tgb, b, rows):
    cols = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
            fb.plan_columns(tgb.plan.columns, b["cols"],
                            encode_hll_column).items()}
    base, V, M = tgb.spec_inputs(cols, rows)
    return base, V, M, torch.from_numpy(b["slots"])


def _assert_state(got, want):
    assert set(got) == set(want)
    for comp, r in want.items():
        g = got[comp]
        assert g.shape == r.shape and g.dtype == r.dtype, comp
        if comp in ("s1", "s2"):
            np.testing.assert_allclose(g, r, rtol=1e-5, err_msg=comp)
        else:
            np.testing.assert_array_equal(g, r, err_msg=comp)


#: each mode: (panes, pane argument, touch, rows)
MODES = {"pane": (PANES, 1, False, ROWS),
         "vec": (PANES, "vec", False, ROWS),
         "vec255": (255, "vec", False, ROWS),
         "touch": (PANES, 1, True, ROWS),
         "empty": (PANES, 1, True, 0)}
#: the plans a 255-pane state holds at test size (hh's is 175 MB)
VEC255_PLANS = ("scalar", "hll")


def _fold_both(plan, kind, slot_dtype, mode, seeds=(0, 1)):
    """Fold the batches of `seeds` by both packages; both states on the
    host."""
    P, pane, touch, rows = MODES[mode]
    sql = fb.PLANS[plan]
    jgb = DeviceGroupBy(jax_plan_of(jax_parse(sql)), capacity=CAP,
                        n_panes=P, micro_batch=max(rows, 1),
                        track_touch=touch)
    tgb = TorchGroupBy(extract_kernel_plan(parse_select(sql)), capacity=CAP,
                       n_panes=P, micro_batch=max(rows, 1), device="cpu",
                       track_touch=touch)
    js, ts = jgb.init_state(), tgb.init_state()
    if touch:
        near = np.full(CAP, TOUCH_NEAR_WRAP, dtype=np.uint32)
        js["touch"] = jnp.asarray(near)
        ts["touch"] = torch.from_numpy(near.copy())
    for seed in seeds:
        b = fb.fold_batch(seed, rows, CAP, P, kind, slot_dtype)
        jcols = {k: jnp.asarray(v) for k, v in fb.plan_columns(
            jgb.plan.columns, b["cols"], _jax_hll).items()}
        for name in jgb.plan.columns:
            jcols["__valid_" + name] = None
        if pane == "vec":
            j_pane, t_pane = jnp.asarray(b["pane_vec"]), 0
            pv = torch.from_numpy(b["pane_vec"])
        else:
            j_pane, t_pane, pv = jnp.asarray(pane, dtype=jnp.int32), pane, None
        if rows:
            js = jgb._fold(js, jcols, jnp.asarray(b["slots"]),
                           jnp.asarray(rows, dtype=jnp.int32), j_pane)
        base, V, M, slots = _port_inputs(tgb, b, rows)
        kernels.groupby_fold(ts, base, V, M, slots, t_pane, tgb._colmap,
                             tgb._widemap, pv)
    return jgb.state_to_host(js), tgb.state_to_host(ts)


CASES = [(plan, kind, dt, mode)
         for plan in sorted(fb.PLANS) for kind in fb.SLOT_KINDS
         for dt in ("uint16", "int32") for mode in MODES
         if mode != "vec255" or plan in VEC255_PLANS]


@pytest.mark.parametrize("plan,kind,slot_dtype,mode", CASES,
                         ids=["-".join(c) for c in CASES])
def test_fold_matches_reference(plan, kind, slot_dtype, mode):
    """groupby_fold's plain version against the JAX DeviceGroupBy fold: the
    whole state after two batches."""
    want, got = _fold_both(plan, kind, getattr(np, slot_dtype), mode)
    _assert_state(got, want)
    if MODES[mode][3]:
        assert got["act"].sum() > 0
    if mode == "touch":  # rows past the WHERE wrapped their slot's count
        assert (got["touch"] < TOUCH_NEAR_WRAP).any()


@pytest.mark.parametrize("mode", ["pane", "vec"])
@pytest.mark.parametrize("plan", sorted(fb.PLANS))
def test_fold_plain_is_the_scalar_then_wide_sequence(plan, mode):
    """The one-launch fold's plain version equals the two plain folds the
    port ran before (fold_scalar_plain, then fold_wide_plain) bit for bit,
    the touch column included."""
    P = PANES
    tgb = TorchGroupBy(extract_kernel_plan(parse_select(fb.PLANS[plan])),
                       capacity=CAP, n_panes=P, micro_batch=ROWS,
                       device="cpu", track_touch=True)
    a, b_st = tgb.init_state(), tgb.init_state()
    for seed in (3, 4):
        b = fb.fold_batch(seed, ROWS, CAP, P, "zipf")
        base, V, M, slots = _port_inputs(tgb, b, ROWS)
        pv = torch.from_numpy(b["pane_vec"]) if mode == "vec" else None
        pane = 0 if pv is not None else 1
        kernels.groupby_fold(a, base, V, M, slots, pane, tgb._colmap,
                             tgb._widemap, pv)
        kernels.fold_scalar_plain(b_st, base, V, M, slots, pane, tgb._colmap,
                                  pv)
        if len(tgb._widemap):
            kernels.fold_wide_plain(b_st, V, M, slots, pane, tgb._widemap,
                                    pv)
    for comp in a:
        assert torch.equal(a[comp].view(-1).view(torch.uint8),
                           b_st[comp].view(-1).view(torch.uint8)), comp


def test_fold_batches_cover_the_edges():
    """The batches hold what the parity cases claim: ±inf, ±0 and NaN
    values, the last slot and slots past it (the slot type's largest value
    among them), panes past the last (255 for a 255-pane state), and a
    one-slot kind."""
    for dt in (np.uint16, np.int32):
        b = fb.fold_batch(0, 4000, CAP, PANES, "uniform", dt)
        v = b["cols"]["v"]
        assert np.isnan(v).any() and np.isposinf(v).any()
        assert np.isneginf(v).any()
        assert (np.signbit(v) & (v == 0)).any()
        assert (~np.signbit(v) & (v == 0)).any()
        assert (b["slots"] == CAP - 1).any()
        assert (b["slots"] == np.iinfo(dt).max).any()
        assert (b["pane_vec"] >= PANES).any()
    one = fb.fold_batch(0, 100, CAP, PANES, "one")
    assert (one["slots"] == fb.ONE_SLOT).all()
    b255 = fb.fold_batch(0, 4000, CAP, 255, "zipf")  # 255: past the last
    assert (b255["pane_vec"] == 254).any() and (b255["pane_vec"] == 255).any()


def test_fold_plans_cover_the_column_maps():
    """An empty colmap (hll alone), an empty widemap (scalar alone), and
    hh, hll and hist in one rule."""
    def maps(plan):
        g = TorchGroupBy(extract_kernel_plan(parse_select(fb.PLANS[plan])),
                         capacity=CAP, n_panes=PANES, micro_batch=ROWS,
                         device="cpu")
        return g._colmap, g._widemap

    assert len(maps("hll")[0]) == 0 and len(maps("scalar")[1]) == 0
    wide = set(maps("mixed")[1][:, 0].tolist())
    assert wide == set(kernels.WIDE_IDS.values())


# ------------------------------------------------------------ the mesh
CPU8 = ["cpu"] * 8
MESH_MB = 128


@pytest.mark.parametrize("vec", [False, True], ids=["pane", "pane_vec"])
@pytest.mark.parametrize("kind", fb.SLOT_KINDS)
@pytest.mark.parametrize("plan", fb.MESH_PLANS)
def test_sharded_fold_matches_reference(plan, kind, vec):
    """ShardedGroupBy.fold (the plain sharded fold and merge) on a 2x4 mesh
    of ["cpu"] * 8 against the JAX ShardedGroupBy on the same mesh shape:
    the edge batches (their slots and panes inside the state) over chunks
    of 128 rows, a touch column, a scalar pane or a per-row pane
    vector."""
    R, K, P, n = 2, 4, 3, 300
    sql = fb.PLANS[plan]
    jgb = JaxSharded(jax_plan_of(jax_parse(sql)),
                     jax_mesh.make_mesh(rows=R, keys=K), capacity=CAP,
                     n_panes=P, micro_batch=MESH_MB, track_touch=True)
    tgb = ShardedGroupBy(extract_kernel_plan(parse_select(sql)),
                         port_mesh.make_mesh(R, K, CPU8), capacity=CAP,
                         n_panes=P, micro_batch=MESH_MB, track_touch=True)
    js, ts, miss = jgb.init_state(), tgb.init_state(), set()
    for seed in (5, 6):
        b = fb.fold_batch(seed, n, CAP, P, kind)
        # the hosts' folds refuse slots and panes outside the state (the
        # kernels' drops are held on the card)
        b["slots"] = np.minimum(b["slots"], CAP - 1)
        b["pane_vec"] = np.minimum(b["pane_vec"], P - 1)
        cols = dict(b["cols"])
        pane = b["pane_vec"] if vec else 1
        js = jgb.fold(js, cols, b["slots"], None, pane)
        ts = tgb.fold(ts, cols, b["slots"], None, pane)
        if "hll" in tgb.comp_specs:
            from ekuiper_tpu_torch.ops.aggspec import \
                materialize_hll_columns as port_hll
            full = port_hll(tgb.plan.columns, cols, n)
            panes = b["pane_vec"] if vec else np.full(n, pane)
            for p in np.unique(panes).tolist():
                sel = np.nonzero(panes == p)[0]
                miss |= _hll_miss_cells(
                    tgb, {k: v[sel] for k, v in full.items()},
                    b["slots"][sel], p)
    _assert_sketch_state(tgb.state_to_host(ts), jgb.state_to_host(js), miss)
    assert tgb.state_to_host(ts)["act"].sum() > 0
    del jgb, js
