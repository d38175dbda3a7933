"""Parity of the port's segmented-scan analytics (ekuiper_tpu_torch/ops/
segscan.py SegScan with the `segscan_shift` and `segscan_sort` kernels'
plain PyTorch versions on the CPU) against the JAX package's SegScan and
its numpy twins `shift_host` / `sort_host`.

Inputs are made from a seed (values among 1.5, 2.5, 7.0, -0.0, 0.0 and
NULL, so ties, signed zeros and NULLs all occur). Tolerances: row numbers,
lag and lead values and their has-flags, ranks, dense ranks and rank
flags, the carry's counts, last values and flags, the continued-partition
counter and the capacity are exact (NaN where NULL); running sums and the
carry's sums within rtol 1e-5 of the JAX values (the reference sums by a
tree scan, the port's plain version in float64 rounded once, the kernel
in arrival order). The checks run across batches, through capacity
growth, and through a snapshot crossing each way between the packages.
"""
import gc
import json
import random

import numpy as np
import pytest

from ekuiper_tpu.ops.segscan import SegScan as JSegScan
from ekuiper_tpu.ops.segscan import shift_host as jshift_host
from ekuiper_tpu.ops.segscan import sort_host as jsort_host
from ekuiper_tpu_torch.ops.segscan import SegScan, shift_host, sort_host

EXACT_SHIFT = ("row_number", "lag", "lag_has")
RANK_KEYS = ("row_number", "rank", "dense_rank", "rank_has", "lead",
             "lead_has")


@pytest.fixture(scope="module", autouse=True)
def _no_cyclic_gc_inside_jax_locks():
    """As in test_torch_event.py: the JAX package's devwatch registry
    deadlocks when a cyclic collection lands inside its weakref prune, so
    this module runs with the cyclic collector off and collects at end."""
    enabled = gc.isenabled()
    gc.disable()
    yield
    if enabled:
        gc.enable()
    gc.collect()


def _batch(rng, n, n_slots):
    slots = np.array([rng.randrange(n_slots) for _ in range(n)],
                     dtype=np.int32)
    vals = np.array([rng.choice([1.5, 2.5, 7.0, -0.0, 0.0, np.nan])
                     for _ in range(n)], dtype=np.float32)
    return slots, vals


def _same(got, want, key):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, key
    if got.dtype.kind == "f":
        np.testing.assert_array_equal(got, want.astype(got.dtype),
                                      err_msg=key)
    else:
        assert got.dtype == want.dtype, (key, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=key)


def _shift_equal(got, want):
    for key in EXACT_SHIFT:
        _same(got[key], want[key], key)
    np.testing.assert_allclose(got["run_sum"], np.asarray(want["run_sum"]),
                               rtol=1e-5, err_msg="run_sum")


def _carry_equal(port, jax):
    got, want = port.peek_carry(), jax.peek_carry()
    for key in ("cnt", "last", "has"):
        _same(got[key], want[key], key)
    np.testing.assert_allclose(got["acc"], np.asarray(want["acc"]),
                               rtol=1e-5, err_msg="acc")
    assert port.capacity == jax.capacity


def test_shift_matches_jax_and_twin_across_batches():
    """tests/test_segscan.py::test_stateful_lag_matches_host_across_batches
    held to the JAX package: six batches, the carry after each."""
    rng = random.Random(3)
    port, jax = SegScan(capacity=16, device="cpu"), JSegScan(capacity=16)
    carry = {"cnt": np.zeros(16, np.int64), "last": np.zeros(16, np.float64),
             "has": np.zeros(16, bool), "acc": np.zeros(16, np.float64)}
    for _ in range(6):
        n = rng.randint(1, 300)
        slots, vals = _batch(rng, n, 12)
        got = port.shift(slots, vals, n)
        _shift_equal(got, jax.shift(slots, vals, n))
        twin = shift_host(carry, slots, vals, n)
        for key in EXACT_SHIFT:
            _same(got[key], twin[key], key)
        np.testing.assert_allclose(got["run_sum"], twin["run_sum"],
                                   rtol=1e-5)
        _carry_equal(port, jax)
    assert port.rows_total == jax.rows_total
    assert port.spills_total == jax.spills_total > 0


def test_shift_host_twin_is_the_reference():
    rng = random.Random(4)
    slots, vals = _batch(rng, 80, 9)
    a = {k: np.zeros(9, dt) for k, dt in (("cnt", np.int64),
                                          ("last", np.float64),
                                          ("has", bool),
                                          ("acc", np.float64))}
    b = {k: v.copy() for k, v in a.items()}
    got, want = shift_host(a, slots, vals, 80), jshift_host(b, slots, vals, 80)
    for key in got:
        _same(got[key], want[key], key)


def test_fresh_partition_has_no_lag():
    port = SegScan(capacity=8, device="cpu")
    out = port.shift(np.array([0, 1, 0], np.int32),
                     np.array([1.0, 2.0, 3.0], np.float32), 3)
    assert list(out["lag_has"]) == [False, False, True]
    assert float(out["lag"][2]) == 1.0
    assert np.isnan(out["lag"][:2]).all()


def test_spill_counter_counts_continued_partitions():
    port, jax = SegScan(capacity=8, device="cpu"), JSegScan(capacity=8)
    for ss in (port, jax):
        ss.shift(np.array([0, 1], np.int32),
                 np.array([1.0, 2.0], np.float32), 2)
        assert ss.spills_total == 0
        ss.shift(np.array([0, 2], np.int32),
                 np.array([3.0, 4.0], np.float32), 2)
        assert ss.spills_total == 1


def test_capacity_grows_and_preserves_carry():
    """Through `grow`: slot 40 doubles the capacity 4 → 64, and the carry of
    slot 0 survives, in both packages."""
    port, jax = SegScan(capacity=4, device="cpu"), JSegScan(capacity=4)
    for ss in (port, jax):
        ss.shift(np.array([0], np.int32), np.array([9.0], np.float32), 1)
    slots = np.array([40, 0, 40, 3], np.int32)
    vals = np.array([1.0, 2.0, np.nan, 5.0], np.float32)
    got = port.shift(slots, vals, 4)
    _shift_equal(got, jax.shift(slots, vals, 4))
    assert port.capacity == 64
    assert bool(got["lag_has"][1]) and float(got["lag"][1]) == 9.0
    _carry_equal(port, jax)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshot_crosses_packages(direction):
    """A carry snapshot (the reference's JSON form) taken in one package
    restores into the other; the next batches give equal outputs."""
    rng = random.Random(5 if direction == "jax_to_port" else 6)
    port, jax = SegScan(capacity=8, device="cpu"), JSegScan(capacity=8)
    src = jax if direction == "jax_to_port" else port
    for _ in range(3):
        slots, vals = _batch(rng, 60, 20)
        src.shift(slots, vals, 60)
    snap = json.loads(json.dumps(src.snapshot()))
    dst = port if src is jax else jax
    dst.restore(snap)
    assert dst.capacity == src.capacity == 32
    for _ in range(3):
        slots, vals = _batch(rng, 60, 40)
        got = port.shift(slots, vals, 60)
        _shift_equal(got, jax.shift(slots, vals, 60))
    _carry_equal(port, jax)
    assert json.loads(json.dumps(port.snapshot()))["cnt"] == \
        json.loads(json.dumps(jax.snapshot()))["cnt"]


def _inf_batch(rng, n, first):
    """Slots 0-5 with +inf in slot 1, -inf in slot 2, both in slot 3 (the
    first batch's head rows set them), NaN and finite values elsewhere;
    slot 4 sees +inf only in the second batch."""
    slots = np.array([rng.randrange(6) for _ in range(n)], dtype=np.int32)
    vals = np.array([rng.choice([1.5, 2.5, 7.0, -0.0, np.nan])
                     for _ in range(n)], dtype=np.float32)
    if first:
        slots[:5] = [1, 2, 3, 3, 0]
        vals[:5] = [np.inf, -np.inf, np.inf, -np.inf, 2.0]
    else:
        slots[:3] = [4, 1, 2]
        vals[:3] = [np.inf, np.nan, 1.0]
        slots[-2:] = [5, 5]
        vals[-2:] = [-np.inf, 3.0]
    return slots, vals


@pytest.mark.parametrize("direction", ["none", "jax_to_port",
                                       "port_to_jax"])
def test_shift_infinities_stay_in_their_segment(direction):
    """Running sums over ±inf and NULL: +inf and -inf in earlier and later
    slots, both in one slot (NaN from there on), across two batches, with
    the carry crossing the packages between them; sums and the carry's
    acc equal the JAX package's (inf and NaN positions exactly)."""
    rng = random.Random({"none": 7, "jax_to_port": 8, "port_to_jax": 9}[
        direction])
    port, jax = SegScan(capacity=8, device="cpu"), JSegScan(capacity=8)
    slots, vals = _inf_batch(rng, 40, True)
    got = port.shift(slots, vals, 40)
    _shift_equal(got, jax.shift(slots, vals, 40))
    assert np.isinf(got["run_sum"]).any() and np.isnan(got["run_sum"]).any()
    assert np.isfinite(got["run_sum"][slots == 0]).all()
    _carry_equal(port, jax)
    if direction != "none":
        src, dst = (jax, port) if direction == "jax_to_port" else (port, jax)
        dst.restore(json.loads(json.dumps(src.snapshot())))
    slots, vals = _inf_batch(rng, 40, False)
    _shift_equal(port.shift(slots, vals, 40), jax.shift(slots, vals, 40))
    _carry_equal(port, jax)
    acc = port.peek_carry()["acc"]
    assert np.isposinf(acc[[1, 4]]).all() and np.isneginf(acc[5])
    assert np.isnan(acc[3]) and np.isfinite(acc[0])


def test_ranks_match_jax_and_twin():
    """tests/test_segscan.py::test_randomized_ranks_match_host held to the
    JAX package: collections up to 600 rows (past one pad of 256)."""
    rng = random.Random(5)
    port, jax = SegScan(capacity=8, device="cpu"), JSegScan(capacity=8)
    for _ in range(10):
        n = rng.randint(1, 600)
        seg = np.array([rng.randrange(6) for _ in range(n)], dtype=np.int32)
        vals = np.array([rng.choice([1.0, 2.0, 2.0, 5.0, -0.0, 0.0, np.inf,
                                     np.nan]) for _ in range(n)],
                        dtype=np.float32)
        got = port.ranks(seg, vals, n)
        want = jax.ranks(seg, vals, n)
        twin = sort_host(seg, vals, n)
        jtwin = jsort_host(seg, vals, n)
        for key in RANK_KEYS:
            _same(got[key], want[key], key)
            _same(got[key], twin[key], key)
            _same(twin[key], jtwin[key], key)
    assert port.rows_total == jax.rows_total


def test_rank_semantics():
    port = SegScan(capacity=8, device="cpu")
    out = port.ranks(np.zeros(4, np.int32),
                     np.array([2.0, 1.0, 2.0, np.nan], np.float32), 4)
    assert [int(r) for r in out["rank"][:3]] == [2, 1, 2]
    assert [int(r) for r in out["dense_rank"][:3]] == [2, 1, 2]
    assert not out["rank_has"][3]  # NULL ranks as NULL


def test_lead_is_next_row_within_segment():
    port = SegScan(capacity=8, device="cpu")
    out = port.ranks(np.array([0, 1, 0, 1], np.int32),
                     np.array([1.0, 2.0, 3.0, 4.0], np.float32), 4)
    assert float(out["lead"][0]) == 3.0
    assert float(out["lead"][1]) == 4.0
    assert not out["lead_has"][2] and not out["lead_has"][3]
