"""Parity of the rule group's fold (#15 `multirule_fold` /
`multirule_fold_wide`), its row order (`multirule_fold_order`) and its
pane reset (#17 `multirule_reset_pane`), through their plain PyTorch
versions on CPU tensors, against the JAX package's BatchedGroupBy
(`_batched_fold_impl`, `_batched_reset_impl`) on the CPU.

The batches are tests/torch_group_batches.py's edge cases, made from a
numpy seed and given to both packages: Zipf-skewed slots, one slot taking
every row, the last key slot and slots past it, a per-row pane vector
with panes past the last, NaN and ±inf values, groups of 1 and 63 rules
whose last rule passes no row. The card's kernels are held to these plain
versions with the same batches in tests/test_torch_kernels_cuda.py.

Tolerance: s1 and s2 within rtol 1e-5 (float32 sums in another order:
XLA's scatter-add against torch's index_put_, and the kernels' register
sums); act, n, mn, mx, the hll registers, the hist counters and the reset
state bit-equal (counts below 2^24, min / max pick an input, registers
are maxima). The order: its segment counts equal the act of a group
without a WHERE (every kept row counted at its (pane, slot)), its rows
a stable order of the kept rows, the dropped ones last.
"""
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekuiper_tpu.ops.aggspec import materialize_hll_columns
from ekuiper_tpu.parallel.multirule import BatchedGroupBy as JaxBatched
from ekuiper_tpu.parallel.multirule import build_rule_batch as jax_build
from ekuiper_tpu.sql.parser import parse_select as jax_parse
from ekuiper_tpu_torch.ops import kernels
from ekuiper_tpu_torch.ops.aggspec import encode_hll_column
from ekuiper_tpu_torch.parallel.multirule import (BatchedGroupBy,
                                                  build_rule_batch)
from ekuiper_tpu_torch.sql.parser import parse_select

import torch_group_batches as gbt

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


def _groups(sqls):
    ids = [f"r{i}" for i in range(len(sqls))]
    tgb = BatchedGroupBy(build_rule_batch(ids, [parse_select(q)
                                                for q in sqls]),
                         capacity=CAP, n_panes=PANES, micro_batch=ROWS,
                         device="cpu")
    jgb = JaxBatched(jax_build(ids, [jax_parse(q) for q in sqls]),
                     capacity=CAP, n_panes=PANES, micro_batch=ROWS)
    return tgb, jgb


def _jax_hll(col, n):
    return materialize_hll_columns(["__hll__x"], {"x": col}, n)["__hll__x"]


def _columns(plan_cols, raw, encode):
    out = {}
    for name in plan_cols:
        if name.startswith("__hll__"):
            out[name] = encode(raw[name[len("__hll__"):]], ROWS)
        else:
            out[name] = raw[name]
    return out


def _fold_both(tgb, jgb, kind, mode, seeds=(0, 1)):
    """Fold the batches of `seeds` by both packages (mode "pane": into
    pane 1; "vec": by the batch's pane vector); return both states."""
    ts, js = tgb.init_state(), jgb.init_state()
    for seed in seeds:
        b = gbt.group_batch(seed, ROWS, CAP, PANES, kind)
        jcols = {k: jnp.asarray(v) for k, v in _columns(
            jgb.plan.columns, b["cols"], _jax_hll).items()}
        for name in list(jcols):
            jcols["__valid_" + name] = None
        tcols = {k: torch.from_numpy(v) for k, v in _columns(
            tgb.plan.columns, b["cols"], encode_hll_column).items()}
        if mode == "vec":
            j_pane, t_pane = jnp.asarray(b["pane_vec"]), 0
            pv = torch.from_numpy(b["pane_vec"])
        else:
            j_pane, t_pane, pv = jnp.asarray(1, dtype=jnp.int32), 1, None
        js = jgb._fold(js, jcols, jnp.asarray(b["slots"]),
                       jnp.asarray(ROWS, dtype=jnp.int32), j_pane)
        base, V, M = tgb.rule_inputs(tcols, ROWS)
        slots = torch.from_numpy(b["slots"])
        kernels.multirule_fold_plain(ts, base, V, M, slots, t_pane,
                                     tgb._colmap, pv)
        if len(tgb._widemap):
            kernels.multirule_fold_wide_plain(ts, base, V, M, slots, t_pane,
                                              tgb._widemap, pv)
    return ts, js


def _assert_state(got, ref):
    assert set(got) == set(ref)
    for comp, r in ref.items():
        g = got[comp]
        assert g.shape == r.shape and g.dtype == r.dtype, comp
        if comp in ("s1", "s2"):
            np.testing.assert_allclose(g, r, rtol=1e-5, err_msg=comp)
        else:
            np.testing.assert_array_equal(g, r, err_msg=comp)


@pytest.mark.parametrize("mode", ["pane", "vec"])
@pytest.mark.parametrize("kind", gbt.SLOT_KINDS)
@pytest.mark.parametrize("n_rules", gbt.RULE_COUNTS)
@pytest.mark.parametrize("plan", sorted(gbt.PLANS))
def test_group_fold_and_reset_match_reference(plan, n_rules, kind, mode):
    """The plain folds (scalar, and wide where the plan has sketches) into
    both packages' states, then the reset of pane 1: equal to the JAX
    BatchedGroupBy's within the module's tolerance, a rule that passes no
    row left at the identity."""
    tgb, jgb = _groups(gbt.group_sqls(plan, n_rules))
    ts, js = _fold_both(tgb, jgb, kind, mode)
    got, want = tgb.state_to_host(ts), jgb.state_to_host(js)
    _assert_state(got, want)
    act = got["act"]
    assert act.sum() > 0
    assert act[:, :, CAP - 1].sum() > 0 or kind == "one"
    if n_rules > 1:
        assert act[-1].sum() == 0 and act[0].sum() > 0
    if kind == "one":
        assert act[:, :, gbt.ONE_SLOT].sum() == act.sum()
    if mode == "vec":
        assert act[:, 0].sum() > 0 and act[:, 1].sum() > 0
    else:
        assert act[:, 0].sum() == 0
    ts = tgb.reset_pane(ts, 1)
    js = jgb._reset_pane(js, jnp.asarray(1, dtype=jnp.int32))
    got, want = tgb.state_to_host(ts), jgb.state_to_host(js)
    for comp, r in want.items():
        np.testing.assert_array_equal(got[comp], r, err_msg=comp)
    assert got["act"][:, 1].sum() == 0


@pytest.mark.parametrize("mode", ["pane", "vec"])
@pytest.mark.parametrize("kind", gbt.SLOT_KINDS)
def test_fold_order_matches_reference(kind, mode):
    """The plain order's segments: each (pane, slot)'s count equals the act
    of a one-rule group without a WHERE folding the same batch in the JAX
    package; the rows a stable order of the rows kept, the dropped rows
    (slots past C, panes past P) last in arrival order."""
    tgb, jgb = _groups([gbt.COUNT_SQL])
    b = gbt.group_batch(5, ROWS, CAP, PANES, kind)
    slots = torch.from_numpy(b["slots"])
    if mode == "vec":
        pane, pv, j_pane = 0, torch.from_numpy(b["pane_vec"]), \
            jnp.asarray(b["pane_vec"])
    else:
        pane, pv, j_pane = 1, None, jnp.asarray(1, dtype=jnp.int32)
    order = kernels.multirule_fold_order_plain(slots, pane, PANES, CAP, pv)
    js = jgb._fold(jgb.init_state(), {"__valid_k": None},
                   jnp.asarray(b["slots"]), jnp.asarray(ROWS,
                                                        dtype=jnp.int32),
                   j_pane)
    act = np.asarray(js["act"])[0]
    offsets, rows = order.offsets.numpy(), order.rows.numpy()
    assert offsets.dtype == np.int32 and rows.dtype == np.int32
    np.testing.assert_array_equal(np.diff(offsets).reshape(PANES, CAP), act)
    p = b["pane_vec"].astype(np.int64) if mode == "vec" else \
        np.full(ROWS, pane)
    s = b["slots"].astype(np.int64)
    kept = (s < CAP) & (p < PANES)
    key = np.where(kept, p * CAP + s, PANES * CAP)
    np.testing.assert_array_equal(rows, np.argsort(key, kind="stable"))
    assert offsets[-1] == kept.sum() and offsets[0] == 0
    assert (np.diff(rows[offsets[-1]:]) > 0).all()


@pytest.mark.parametrize("n_rules", gbt.RULE_COUNTS + (64, 65))
def test_fold_order_packs_where_bits(n_rules):
    """An order built with the chunk's WHERE masks carries them packed,
    (n, ceil(R / 32)) int32 words, bit q of word w rule 32 w + q's mask
    (the words both folds read); the rows and offsets as without them."""
    tgb, _ = _groups(gbt.group_sqls("scalar", n_rules))
    b = gbt.group_batch(6, ROWS, CAP, PANES, "zipf")
    cols = {k: torch.from_numpy(v) for k, v in _columns(
        tgb.plan.columns, b["cols"], encode_hll_column).items()}
    base, _, _ = tgb.rule_inputs(cols, ROWS)
    slots = torch.from_numpy(b["slots"])
    order = kernels.multirule_fold_order_plain(slots, 1, PANES, CAP,
                                               base=base)
    bare = kernels.multirule_fold_order_plain(slots, 1, PANES, CAP)
    assert bare.bits is None
    assert torch.equal(order.rows, bare.rows)
    assert torch.equal(order.offsets, bare.offsets)
    nw = (n_rules + 31) // 32
    assert order.bits.dtype == torch.int32
    assert order.bits.shape == (ROWS, nw)
    words = order.bits.numpy().view(np.uint32)
    got = (words[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    got = got.reshape(ROWS, nw * 32).T
    want = np.zeros((nw * 32, ROWS), dtype=np.uint32)
    want[:n_rules] = base.numpy()
    np.testing.assert_array_equal(got, want)
    assert base.any() and not base.all()


def test_fold_order_with_no_rows():
    order = kernels.multirule_fold_order_plain(
        torch.zeros(0, dtype=torch.int32), 0, PANES, CAP)
    assert order.rows.shape == (0,)
    assert order.offsets.shape == (PANES * CAP + 1,)
    assert not order.offsets.any()


@pytest.mark.parametrize("fold", ["scalar", "wide"])
def test_pane_bound_from_the_host(fold):
    """A pane vector's host bound: at or above P it is refused before any
    fold (no read-back needed); below P the fold takes it and the given
    order, as the plain version folds without them."""
    tgb, _ = _groups(gbt.group_sqls("wide", 2))
    b = gbt.group_batch(9, ROWS, CAP, PANES, "uniform")
    pv_np = np.minimum(b["pane_vec"], PANES - 1)
    pv = torch.from_numpy(pv_np)
    cols = {k: torch.from_numpy(v) for k, v in _columns(
        tgb.plan.columns, b["cols"], encode_hll_column).items()}
    base, V, M = tgb.rule_inputs(cols, ROWS)
    slots = torch.from_numpy(b["slots"])
    fn, cmap = ((kernels.multirule_fold, tgb._colmap) if fold == "scalar"
                else (kernels.multirule_fold_wide, tgb._widemap))
    st = tgb.init_state()
    with pytest.raises(ValueError, match="outside"):
        fn(st, base, V, M, slots, 0, cmap, pv, PANES)
    assert float(st["act"].sum()) == 0.0
    order = kernels.multirule_fold_order(slots, 0, PANES, CAP, pv)
    fn(st, base, V, M, slots, 0, cmap, pv, int(pv_np.max()), order)
    ref = tgb.init_state()
    plain = (kernels.multirule_fold_plain if fold == "scalar"
             else kernels.multirule_fold_wide_plain)
    plain(ref, base, V, M, slots, 0, cmap, pv)
    for comp in ref:
        assert torch.equal(st[comp], ref[comp]), comp
