"""Parity of the port's group-by (ekuiper_tpu_torch/ops/groupby.py, through
the plain PyTorch versions of its kernels on the CPU) against the JAX
package's DeviceGroupBy: fold, finalize under the full and a subset pane
mask, pane reset, grow, integer inputs, and a state handed over from JAX
to the port half-way through a window.

Inputs are made from a seed with numpy and given to both packages.
Tolerances, each against the JAX result:
- counts, act, min, max: exact (both add exact small integers; min/max
  pick one of the inputs);
- sum, avg: rtol 1e-5 (float32 scatter-add order differs between XLA and
  torch);
- stddev(s), var(s): rtol 1e-4 (the cancellation in s2/n - mean² can
  amplify the sum-order difference of s1 and s2 by ~|mean|²/var), plus
  the absolute floor that cancellation leaves where the true variance is
  ~0 (a key with one or two rows): 16·ε32·mean² for var(s), its square
  root for stddev(s). XLA and torch round s2/n - mean² differently there.
"""
import numpy as np
import pytest
import torch

from ekuiper_tpu.ops.aggspec import extract_kernel_plan as jax_plan_of
from ekuiper_tpu.ops.groupby import DeviceGroupBy
from ekuiper_tpu.sql.parser import parse_select as jax_parse
from ekuiper_tpu_torch.ops import kernels
from ekuiper_tpu_torch.ops.aggspec import extract_kernel_plan
from ekuiper_tpu_torch.ops.groupby import TorchGroupBy
from ekuiper_tpu_torch.sql.parser import parse_select

# all nine scalar kinds, an inc_ form, WHERE, FILTER, a column with a
# validity mask (w) and an integer column (iv)
SQL = (
    "SELECT k, count(*) AS c, sum(v) AS s, avg(v) AS a, min(v) AS mn, "
    "max(v) AS mx, stddev(v) AS sd, stddevs(v) AS sds, var(v) AS va, "
    "vars(v) AS vas, count(v) FILTER (WHERE w > 0) AS cf, "
    "inc_sum(w) AS sw, avg(iv) AS ai, max(iv) AS mi "
    "FROM s WHERE v > 5 OR w < 0 GROUP BY k, TUMBLINGWINDOW(ss, 10)"
)
KINDS_EXACT = ("count", "min", "max")
KINDS_SUM = ("sum", "avg")
CAP, MB, KEYS = 256, 512, 200


def _build(n_panes: int, sql: str = SQL, cap: int = CAP):
    jplan = jax_plan_of(jax_parse(sql))
    tplan = extract_kernel_plan(parse_select(sql))
    jgb = DeviceGroupBy(jplan, capacity=cap, n_panes=n_panes,
                        micro_batch=MB)
    tgb = TorchGroupBy(tplan, capacity=cap, n_panes=n_panes,
                       micro_batch=MB, device="cpu")
    return jgb, tgb


def _batch(rng, n: int, keys: int = KEYS):
    v = rng.normal(20, 5, n).astype(np.float32)
    v[rng.random(n) < 0.05] = np.nan
    cols = {
        "v": v,
        "w": rng.normal(0, 1, n).astype(np.float32),
        "iv": rng.integers(-50, 50, n),
    }
    valid = {"w": rng.random(n) > 0.1}
    slots = rng.integers(0, keys, n).astype(np.int32)
    return cols, valid, slots


def _assert_outs(specs, got, ref, mean):
    """`mean`: the per-key mean of the variance specs' argument."""
    floor = 16 * np.finfo(np.float32).eps * np.nan_to_num(mean) ** 2
    for spec, g, r in zip(specs, got, ref):
        assert g.dtype == r.dtype, spec.kind
        if spec.kind in KINDS_EXACT:
            np.testing.assert_array_equal(g, r, err_msg=spec.kind)
        elif spec.kind in KINDS_SUM:
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=0,
                                       equal_nan=True, err_msg=spec.kind)
        else:
            atol = floor if spec.kind in ("var", "vars") else np.sqrt(floor)
            assert (np.isnan(g) == np.isnan(r)).all(), spec.kind
            ok = np.isnan(r) | (np.abs(g - r) <= 1e-4 * np.abs(r) + atol)
            assert ok.all(), (spec.kind, g[~ok], r[~ok])


def _assert_state(got: dict, ref: dict):
    assert set(got) == set(ref)
    for comp in ref:
        g, r = got[comp], np.asarray(ref[comp])
        assert g.shape == r.shape and g.dtype == r.dtype, comp
        if comp in ("s1", "s2"):
            np.testing.assert_allclose(g, r, rtol=1e-5, err_msg=comp)
        else:
            np.testing.assert_array_equal(g, r, err_msg=comp)


def _fold_both(jgb, tgb, js, ts, rng, panes, keys=KEYS):
    for pane in panes:
        cols, valid, slots = _batch(rng, 700, keys)  # > MB: two chunks
        js = jgb.fold(js, cols, slots, valid, pane)
        ts = tgb.fold(ts, cols, slots, valid, pane)
    return js, ts


@pytest.mark.parametrize("n_panes", [1, 2])
def test_fold_finalize_match_reference(n_panes):
    rng = np.random.default_rng(7)
    jgb, tgb = _build(n_panes)
    cols, _, _ = _batch(rng, 4)
    jgb.observe_dtypes(cols)
    tgb.observe_dtypes(cols)
    js, ts = _fold_both(jgb, tgb, jgb.init_state(), tgb.init_state(), rng,
                        [p % n_panes for p in range(3)])
    _assert_state(tgb.state_to_host(ts), jgb.state_to_host(js))
    masks = [None] + ([[1]] if n_panes == 2 else [])
    for panes in masks:  # full mask, then a subset mask
        got, got_act = tgb.finalize(ts, KEYS, panes)
        ref, ref_act = jgb.finalize(js, KEYS, panes)
        np.testing.assert_array_equal(got_act, ref_act)
        _assert_outs(tgb.plan.specs, got, ref, ref[2])
    # integer inputs: truncating avg, integral max
    assert [s.int_input for s in tgb.plan.specs] == \
        [s.int_input for s in jgb.plan.specs]
    assert tgb.plan.specs[-1].int_input


@pytest.mark.parametrize("n_panes", [1, 2])
def test_reset_pane_matches_reference(n_panes):
    rng = np.random.default_rng(3)
    jgb, tgb = _build(n_panes)
    js, ts = _fold_both(jgb, tgb, jgb.init_state(), tgb.init_state(), rng,
                        list(range(n_panes)))
    js = jgb.reset_pane(js, n_panes - 1)
    ts = tgb.reset_pane(ts, n_panes - 1)
    _assert_state(tgb.state_to_host(ts), jgb.state_to_host(js))
    _assert_state(tgb.state_to_host(tgb.reset_all(ts)),
                  jgb.state_to_host(jgb.reset_all(js)))


def test_grow_matches_reference():
    rng = np.random.default_rng(5)
    jgb, tgb = _build(2, cap=128)
    js, ts = _fold_both(jgb, tgb, jgb.init_state(), tgb.init_state(), rng,
                        [0], keys=128)
    js, ts = jgb.grow(js, 256), tgb.grow(ts, 256)
    assert tgb.capacity == jgb.capacity == 256
    cols, valid, slots = _batch(rng, 300, keys=256)
    js = jgb.fold(js, cols, slots, valid, 1)
    ts = tgb.fold(ts, cols, slots, valid, 1)
    _assert_state(tgb.state_to_host(ts), jgb.state_to_host(js))


def test_state_handover_from_reference():
    """A window begun in the JAX package and finished in the port emits
    what the JAX package emits for the whole window."""
    rng = np.random.default_rng(11)
    jgb, tgb = _build(2)
    js = jgb.init_state()
    for pane in (0, 1):
        cols, valid, slots = _batch(rng, 400)
        js = jgb.fold(js, cols, slots, valid, pane)
    ts = tgb.state_from_host(jgb.state_to_host(js))
    _assert_state(tgb.state_to_host(ts), jgb.state_to_host(js))
    for pane in (1, 0):
        cols, valid, slots = _batch(rng, 400)
        js = jgb.fold(js, cols, slots, valid, pane)
        ts = tgb.fold(ts, cols, slots, valid, pane)
    got, got_act = tgb.finalize(ts, KEYS)
    ref, ref_act = jgb.finalize(js, KEYS)
    np.testing.assert_array_equal(got_act, ref_act)
    _assert_outs(tgb.plan.specs, got, ref, ref[2])
    # and back: the port's snapshot restores into the JAX package
    _assert_state(jgb.state_to_host(jgb.state_from_host(
        tgb.state_to_host(ts))), tgb.state_to_host(ts))


def test_snapshot_components_must_match_plan():
    _, tgb = _build(1)
    host = tgb.state_to_host(tgb.init_state())
    del host["s2"]
    with pytest.raises(ValueError):
        tgb.state_from_host(host)


def test_fold_rejects_out_of_range_slot():
    _, tgb = _build(1)
    cols, valid, slots = _batch(np.random.default_rng(0), 8)
    slots[3] = CAP
    with pytest.raises(ValueError):
        tgb.fold(tgb.init_state(), cols, slots, valid, 0)


def test_cpu_state_takes_plain_versions_only():
    """On CPU tensors every wrapper runs its plain version: no kernel is
    launched and none is built."""
    kernels.reset_launches()
    rng = np.random.default_rng(1)
    _, tgb = _build(2)
    cols, valid, slots = _batch(rng, 300)
    st = tgb.fold(tgb.init_state(), cols, slots, valid, 1)
    tgb.finalize(st, KEYS, [1])
    tgb.reset_pane(st, 1)
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)
    assert kernels._lib is None
    assert all(t.device.type == "cpu" and t.dtype == torch.float32
               for t in st.values())
