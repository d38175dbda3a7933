"""Parity of the port's sketch primitives (ekuiper_tpu_torch/ops/sketches.py,
the plain versions of the sketch kernels) against the JAX package's
ekuiper_tpu/ops/sketches.py on the CPU. Inputs are made from a seed with
numpy and given to both.

The reference functions run jitted, as the JAX package runs them (XLA
turns their divisions by constants into multiplies by reciprocals, which
the port follows). Tolerances, each against the JAX function:
- hashes, register indices, histogram bins, heavy-hitters scatter
  indices and weights, recovered candidates (codes, estimates and their
  order): exact;
- rho: exact wherever jnp.log2 gives the exact floor(log2) of float32(h2);
  the port reads that from the float's exponent field, so at the values
  where XLA's log2 misses (found in float64 here, and counted) the two
  differ by design — the port then equals the exact rule;
- hll_estimate: rtol 1e-6 (a 256-term float32 sum in another order);
- hist_quantile: the same bin, and the value within 4 ulp (torch.exp and
  XLA's exp differ by up to 3 ulp on some of the 511 bin centres).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekuiper_tpu.ops import sketches as ref
from ekuiper_tpu_torch.ops import sketches as port


# the reference functions as the JAX package runs them: inside one jitted
# program (an eager call compiles each of its many small ops)
_hash_f32 = jax.jit(ref.hash_f32, static_argnums=1)
_hll_parts = jax.jit(ref.hll_parts)
_hll_estimate = jax.jit(ref.hll_estimate)
_hist_bin = jax.jit(ref.hist_bin)
_hist_quantile = jax.jit(ref.hist_quantile, static_argnums=1)
_hh_update_parts = jax.jit(ref.hh_update_parts)
_hh_candidates = jax.jit(ref.hh_candidates, static_argnums=1)


def _values(seed, n=20_000):
    rng = np.random.default_rng(seed)
    v = np.concatenate([
        rng.normal(20, 5, n // 2),
        rng.lognormal(0, 6, n // 4) * rng.choice([-1, 1], n // 4),
        rng.integers(-3000, 3000, n // 4),
    ]).astype(np.float32)
    v[:8] = [0.0, -0.0, np.inf, -np.inf, 1e-30, 3e38, 1e-9, 1e12]
    return v


@pytest.mark.parametrize("salt", [0, 1, 5])
def test_hash_matches_reference(salt):
    v = _values(salt)
    got = port.hash_f32(torch.from_numpy(v), salt).numpy()
    want = np.asarray(_hash_f32(jnp.asarray(v), salt)).astype(np.int64)
    np.testing.assert_array_equal(got, want)


def test_hll_parts_follow_the_exact_rule():
    # with two integers whose h2 lies just below 2^32, where XLA's CPU
    # log2 of float32(h2) rounds up to 32 (reference rho 0, exact rho 1)
    v = np.concatenate([_values(3, 50_000),
                        np.array([198745, 226765], dtype=np.float32)])
    reg, rho = port.hll_parts(torch.from_numpy(v))
    jreg, jrho = (np.asarray(a) for a in _hll_parts(jnp.asarray(v)))
    np.testing.assert_array_equal(reg.numpy(), jreg.astype(np.int64))
    h2 = np.asarray(_hash_f32(jnp.asarray(v), 1))
    hv = np.maximum(h2, 1).astype(np.float32)
    exact = 33.0 - (np.floor(np.log2(hv.astype(np.float64))) + 1.0)
    np.testing.assert_array_equal(rho.numpy(), exact.astype(np.float32))
    miss = jrho != exact  # where jnp.log2 itself misses floor(log2)
    np.testing.assert_array_equal(rho.numpy()[~miss], jrho[~miss])
    assert miss.sum() <= 0.001 * len(v), int(miss.sum())


def test_hist_bin_matches_reference():
    v = _values(4, 50_000)
    np.testing.assert_array_equal(
        port.hist_bin(torch.from_numpy(v)).numpy(),
        np.asarray(_hist_bin(jnp.asarray(v))).astype(np.int64))


def test_hh_update_parts_match_reference():
    rng = np.random.default_rng(5)
    codes = rng.integers(0, ref.HH_MAX_CODES, 3000).astype(np.float32)
    codes[rng.random(3000) < 0.1] = np.nan
    mf = (rng.random(3000) > 0.2).astype(np.float32)
    idx, wts = port.hh_update_parts(torch.from_numpy(codes),
                                    torch.from_numpy(mf))
    jidx, jwts = _hh_update_parts(jnp.asarray(codes), jnp.asarray(mf))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(wts.numpy(), np.asarray(jwts))


def test_hll_estimate_matches_reference():
    rng = np.random.default_rng(6)
    regs = rng.integers(0, 12, (400, port.HLL_M)).astype(np.float32)
    regs[:200] *= rng.random((200, port.HLL_M)) < 0.3  # linear counting
    regs[0] = 0.0
    got = port.hll_estimate(torch.from_numpy(regs)).numpy()
    want = np.asarray(_hll_estimate(jnp.asarray(regs)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@functools.lru_cache(maxsize=None)
def _histograms():
    rng = np.random.default_rng(7)
    v = _values(8, 40_000)
    keys = rng.integers(0, 64, len(v))
    hist = np.zeros((65, port.HIST_BINS), dtype=np.float32)
    np.add.at(hist, (keys, np.asarray(_hist_bin(jnp.asarray(v)))), 1.0)
    hist[64] = 0.0  # an empty key: NaN
    return hist


@pytest.mark.parametrize("frac", [0.0, 0.5, 0.9, 1.0])
def test_hist_quantile_matches_reference(frac):
    hist = _histograms()
    got = port.hist_quantile(torch.from_numpy(hist), frac).numpy()
    want = np.asarray(_hist_quantile(jnp.asarray(hist), frac))
    assert np.isnan(got[64]) and np.isnan(want[64])
    np.testing.assert_array_equal(np.sign(got), np.sign(want))
    np.testing.assert_allclose(got, want, rtol=4 * 2.0 ** -23)


@functools.lru_cache(maxsize=None)
def _hh_sketches():
    """Skewed codes over 40 keys, so candidates tie (equal estimates, and
    the invalid cells' zeros)."""
    rng = np.random.default_rng(9)
    n, cap = 6000, 40
    p = rng.random(n)
    codes = np.where(p < 0.35, 7, np.where(p < 0.55, 13, rng.integers(
        100, 2100, n))).astype(np.float32)
    keys = rng.integers(0, cap, n)
    idx, wts = _hh_update_parts(jnp.asarray(codes), jnp.ones(n, jnp.float32))
    hh = np.zeros((cap, ref.HH_SIZE), dtype=np.float32)
    np.add.at(hh, (keys[:, None], np.asarray(idx)), np.asarray(wts))
    return hh


@pytest.mark.parametrize("k2", [2, 6, 128])
def test_hh_candidates_match_reference(k2):
    """The recovery, ties ordered as lax.top_k orders them."""
    hh = _hh_sketches()
    got = [t.numpy() for t in port.hh_candidates(torch.from_numpy(hh), k2)]
    want = [np.asarray(t) for t in _hh_candidates(jnp.asarray(hh), k2)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[0][:, 0] == 7).mean() > 0.9
