"""The port's CountMinSketch (ekuiper_tpu_torch ops/sketches.py, the
cms_update / cms_query kernels' plain versions in ops/kernels.py) against
the JAX package's on the CPU.

Both sketches take the same updates, made from a seed with numpy: values
of a skewed mix with a uniform tail, across the depth and width pairs the
reference's tests use and one width that is not a power of two, with
-0.0, +0.0 and NaN among them. Tolerances: none. The counts stay integers
below 2^24, so any order of the adds gives the same bits: counts
bit-equal; candidate maps (saturation included), heavy-hitter lists and
estimates equal.
"""
import gc

import numpy as np
import pytest
import torch

from ekuiper_tpu.ops.sketches import CountMinSketch as JaxCMS
from ekuiper_tpu_torch.ops import kernels
from ekuiper_tpu_torch.ops.sketches import CountMinSketch

#: (depth, width, max_candidates): the reference tests' shapes
#: (tests/test_sketches.py, tests/test_sketch_udfs.py), and a width that
#: is not a power of two
SHAPES = [(4, 2048, 4096), (2, 64, 4096), (4, 8192, 8), (2, 128, 4096),
          (3, 1000, 64)]


@pytest.fixture(scope="module", autouse=True)
def _no_cyclic_gc_inside_jax_locks():
    """The JAX sketch registers with the devwatch registry, which deadlocks
    when a cyclic collection lands inside its weakref prune: this module
    runs with the cyclic collector off and collects at its end."""
    enabled = gc.isenabled()
    gc.disable()
    yield
    if enabled:
        gc.enable()
    gc.collect()


def skewed(rng, n):
    """7 at 35 %, 13 at 20 %, 99 at 15 %, the rest uniform over [100, 400),
    with -0.0, +0.0 and a NaN in every batch."""
    u = rng.random(n)
    v = np.where(u < 0.35, 7, np.where(u < 0.55, 13, np.where(
        u < 0.70, 99, rng.integers(100, 400, n)))).astype(np.float32)
    v[:3] = [-0.0, 0.0, np.nan]
    return v


def _keys(cands):
    """A candidate map's keys in order, NaN-safe (NaN != NaN)."""
    return np.array(list(cands), dtype=np.float32)


def assert_same(t, j):
    np.testing.assert_array_equal(t.counts.numpy(), np.asarray(j.counts))
    np.testing.assert_array_equal(_keys(t.candidates), _keys(j.candidates))


@pytest.mark.parametrize("depth,width,max_cand", SHAPES)
def test_updates_and_hitters_match_reference(depth, width, max_cand):
    """Counts, candidates and heavy hitters after each of a run of updates
    (batch sizes that the reference pads and the port does not) equal the
    JAX sketch's; the top three are the mix's."""
    rng = np.random.default_rng(depth * 10_007 + width)
    j = JaxCMS(depth=depth, width=width, max_candidates=max_cand)
    t = CountMinSketch(depth=depth, width=width, max_candidates=max_cand,
                       device="cpu")
    for n in (1000, 4096, 777):
        v = skewed(rng, n)
        j.update(v)
        t.update(v)
        assert_same(t, j)
        assert t.heavy_hitters(5) == j.heavy_hitters(5)
    assert len(t.candidates) <= max_cand
    top = {v for v, _ in t.heavy_hitters(3)}
    assert top == {7.0, 13.0, 99.0}
    assert kernels.LAUNCHES["cms_update"] == 0  # CPU: the plain versions


def test_saturated_candidates_keep_the_frequent_values():
    """Past max_candidates the map keeps the values of highest estimate, as
    the reference's: a late frequent value displaces a rare incumbent."""
    j = JaxCMS(depth=4, width=2048, max_candidates=8)
    t = CountMinSketch(depth=4, width=2048, max_candidates=8, device="cpu")
    first = np.arange(1, 9, dtype=np.float32)  # eight rare values
    late = np.full(500, 42.0, dtype=np.float32)
    for v in (first, late, np.arange(100, 140, dtype=np.float32)):
        j.update(v)
        t.update(v)
        assert_same(t, j)
    assert 42.0 in t.candidates and len(t.candidates) == 8
    assert t.heavy_hitters(1) == j.heavy_hitters(1) == [(42.0, 500.0)]


def test_signed_zero_and_nan_behave_as_reference():
    """-0.0 and +0.0 hash apart (the float's bits), as in JAX, and share one
    candidate (they compare equal); each update's NaN is a new candidate
    (NaN equals nothing), in both packages."""
    j = JaxCMS(depth=2, width=64)
    t = CountMinSketch(depth=2, width=64, device="cpu")
    for v in (np.array([-0.0, -0.0, 0.0, np.nan], np.float32),
              np.array([np.nan, 0.0], np.float32)):
        j.update(v)
        t.update(v)
        assert_same(t, j)
    cells = kernels._cms_cells_plain(torch.tensor([-0.0, 0.0]), 2, 64)
    assert (cells[:, 0] != cells[:, 1]).any()
    assert int(t.counts.sum()) == 2 * 6
    assert len(t.candidates) == len(j.candidates) == 3
    assert np.isnan(_keys(t.candidates)).sum() == 2


def test_reset_and_query():
    """reset zeroes the counts and the candidates; a point query is the min
    over the rows, never under the count of the value's bit pattern."""
    rng = np.random.default_rng(3)
    j = JaxCMS(depth=4, width=512)
    t = CountMinSketch(depth=4, width=512, device="cpu")
    v = skewed(rng, 5000)
    for s in (j, t):
        s.update(v)
    cand = np.unique(v[~np.isnan(v)])
    est = t._query(cand)
    np.testing.assert_array_equal(est, j._query_padded(cand))
    bits = v.view(np.uint32)
    true = np.array([(bits == c).sum() for c in cand.view(np.uint32)])
    assert (est >= true).all()
    for s in (j, t):
        s.reset()
    assert_same(t, j)
    assert not t.candidates and t.heavy_hitters(3) == j.heavy_hitters(3) == []
    assert float(t.counts.abs().sum()) == 0.0


def test_plain_versions_match_the_reference_kernels():
    """cms_update / cms_query on CPU tensors (their plain versions) against
    the JAX sketch's jitted update and query on the same counts."""
    rng = np.random.default_rng(11)
    j = JaxCMS(depth=3, width=1000)
    counts = torch.zeros((3, 1000))
    v = skewed(rng, 2048)
    kernels.cms_update(counts, torch.from_numpy(v))
    j.update(v)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j.counts))
    q = skewed(rng, 256)
    np.testing.assert_array_equal(
        kernels.cms_query(counts, torch.from_numpy(q)).numpy(),
        j._query_padded(q))
    kernels.cms_update(counts, torch.zeros(0))
    assert kernels.cms_query(counts, torch.zeros(0)).shape == (0,)
