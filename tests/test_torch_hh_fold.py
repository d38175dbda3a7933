"""Parity of the heavy-hitters fold (the hh role of #1 `groupby_fold`
and #2 `groupby_fold_masked`, through their plain PyTorch versions on
CPU tensors) against the JAX package's DeviceGroupBy fold and masked fold
on the CPU.

The batches are tests/torch_hh_batches.py's edge cases, made from a numpy
seed and given to both packages: the codes 0, 1, 2^19 and 2^20 - 1 among
skewed codes, NaN codes, two heavy_hitters columns (one under a FILTER)
beside a WHERE, the last key slot and slots past it, a per-row pane vector
with panes past the last, a row mask, uint16 and int32 slots, and hll and
hist columns in the same widemap. The card's kernels are held to these
plain versions with the same batches in tests/test_torch_kernels_cuda.py.

Tolerance: every state component bit-equal (act, the counts and the hh
counters add 1.0 below 2^24, so their order does not matter; the hll
registers are maxima; the hist bins counts).
"""
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekuiper_tpu.ops.aggspec import extract_kernel_plan as jax_plan_of
from ekuiper_tpu.ops.aggspec import materialize_hll_columns
from ekuiper_tpu.ops.groupby import DeviceGroupBy
from ekuiper_tpu.sql.parser import parse_select as jax_parse
from ekuiper_tpu_torch.ops import kernels
from ekuiper_tpu_torch.ops.aggspec import (encode_hll_column,
                                           extract_kernel_plan)
from ekuiper_tpu_torch.ops.groupby import TorchGroupBy
from ekuiper_tpu_torch.sql.parser import parse_select

import torch_finalize_cases as fc
import torch_hh_batches as hb

CAP, ROWS, PANES = 64, 512, 2


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


def _fold_both(plan, mode, slot_dtype, seeds=(0, 1)):
    """Fold the batches of `seeds` by both packages; return both states
    on the host. mode: "pane" (pane 1), "vec" (the per-row pane vector)
    or "masked" (#2 into pane 1 under the batch's row mask)."""
    sql = hb.PLANS[plan]
    jgb = DeviceGroupBy(jax_plan_of(jax_parse(sql)), capacity=CAP,
                        n_panes=PANES, micro_batch=ROWS)
    tgb = TorchGroupBy(extract_kernel_plan(parse_select(sql)), capacity=CAP,
                       n_panes=PANES, micro_batch=ROWS, device="cpu")
    js, ts = jgb.init_state(), tgb.init_state()
    for seed in seeds:
        b = hb.hh_batch(seed, ROWS, CAP, PANES, slot_dtype)
        jcols = {k: jnp.asarray(v) for k, v in hb.plan_columns(
            jgb.plan.columns, b["cols"], _jax_hll).items()}
        tcols = {k: torch.from_numpy(v) for k, v in hb.plan_columns(
            tgb.plan.columns, b["cols"], encode_hll_column).items()}
        for name in tgb.plan.columns:
            jcols["__valid_" + name] = tcols["__valid_" + name] = None
        j_slots = jnp.asarray(b["slots"])
        t_slots = torch.from_numpy(b["slots"])
        if mode == "masked":
            js = jgb._fold_m(js, jcols, j_slots, jnp.asarray(b["mask"]),
                             jnp.asarray(1, dtype=jnp.int32))
            ts = tgb.fold_masked(ts, tcols, t_slots, b["mask"], 1)
            continue
        if mode == "vec":
            j_pane, t_pane, pv = jnp.asarray(b["pane_vec"]), 0, \
                torch.from_numpy(b["pane_vec"])
        else:
            j_pane, t_pane, pv = jnp.asarray(1, dtype=jnp.int32), 1, None
        js = jgb._fold(js, jcols, j_slots, jnp.asarray(ROWS, dtype=jnp.int32),
                       j_pane)
        tc = {k: v for k, v in tcols.items() if v is not None}
        base, V, M = tgb.spec_inputs(tc, ROWS)
        kernels.groupby_fold(ts, base, V, M, t_slots, t_pane, tgb._colmap,
                             tgb._widemap, pv)
    return jgb.state_to_host(js), tgb.state_to_host(ts)


@pytest.mark.parametrize("slot_dtype", [np.uint16, np.int32],
                         ids=["uint16", "int32"])
@pytest.mark.parametrize("mode", ["pane", "vec", "masked"])
@pytest.mark.parametrize("plan", sorted(hb.PLANS))
def test_hh_fold_matches_reference(plan, mode, slot_dtype):
    want, got = _fold_both(plan, mode, slot_dtype)
    assert set(got) == set(want)
    for comp, r in want.items():
        assert got[comp].shape == r.shape and got[comp].dtype == r.dtype
        np.testing.assert_array_equal(got[comp], r, err_msg=comp)
    hh = got["hh"]
    assert hh[:, :, 1].sum() > 0  # the FILTERed column folded rows
    assert hh[:, CAP - 1].sum() > 0  # the last key slot
    if mode == "vec":
        assert hh[0].sum() > 0 and hh[1].sum() > 0
    else:
        assert hh[0].sum() == 0


def test_hh_batches_cover_the_edges():
    """The batches hold what the parity cases claim: every edge code, NaN
    codes, slots past the last and panes past the last."""
    b = hb.hh_batch(0, ROWS, CAP, PANES, np.uint16)
    code = b["cols"]["code"]
    assert set(hb.EDGE_CODES) <= set(code[~np.isnan(code)].astype(int))
    assert np.isnan(code).any() and np.isnan(b["cols"]["code2"]).any()
    assert (b["slots"] == CAP - 1).any() and (b["slots"] >= CAP).any()
    assert (b["slots"] == np.iinfo(np.uint16).max).any()
    assert (b["pane_vec"] >= PANES).any() and not b["mask"].all()


@pytest.mark.parametrize("mask", list(fc.HH_MASKS))
def test_hh_finalize_matches_reference(mask):
    """#8 as the group-by calls it (TorchGroupBy._finalize: the scalar
    finalize and groupby_hh_finalize into one result, their plain versions
    here) against the reference's _hh_finalize_impl, on
    tests/torch_finalize_cases.py's hh edge slots in two heavy_hitters
    columns (k2 6 and 128) of four panes, under no, one, two, three and
    every pane live: every row bit-equal."""
    sql = fc.HH_SQL
    jgb = DeviceGroupBy(jax_plan_of(jax_parse(sql)), capacity=fc.HH_CAP,
                        n_panes=fc.HH_PANES, micro_batch=ROWS)
    tgb = TorchGroupBy(extract_kernel_plan(parse_select(sql)),
                       capacity=fc.HH_CAP, n_panes=fc.HH_PANES,
                       micro_batch=ROWS, device="cpu")
    host = {k: np.array(v) for k, v in
            jgb.state_to_host(jgb.init_state()).items()}
    host["hh"] = fc.hh_state(host["hh"].shape, seed=12)
    host["n"][:] = np.arange(fc.HH_CAP, dtype=np.float32)[None, :, None]
    host["act"][:] = host["n"][..., 0]
    pm = np.asarray(fc.HH_MASKS[mask])
    want = np.asarray(jgb._hh_finalize_impl(jgb.state_from_host(host),
                                            jnp.asarray(pm)))
    kernels.reset_launches()
    got = tgb._finalize(tgb.state_from_host(host),
                        tgb._mask_tensor(pm)).numpy()
    assert kernels.LAUNCHES["groupby_hh_finalize"] == 0  # the plain version
    assert sorted(tgb._hhtab[:, 1].tolist()) == [6, 128]
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
