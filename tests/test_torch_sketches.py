"""Parity of the port's sketch primitives (ekuiper_tpu_torch/ops/sketches.py,
the plain versions of the sketch kernels) against the JAX package's
ekuiper_tpu/ops/sketches.py on the CPU. Inputs are made from a seed with
numpy and given to both.

The reference functions run jitted, as the JAX package runs them (XLA
turns their divisions by constants into multiplies by reciprocals, which
the port follows). Tolerances, each against the JAX function:
- hashes, register indices, histogram bins, heavy-hitters scatter
  indices and weights, recovered candidates (codes, estimates and their
  order), the heavy-hitters finalize's rows (#8's plain version,
  hh_finalize_plain, on tests/torch_finalize_cases.py's edge states): exact;
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
from ekuiper_tpu_torch.ops import kernels
from ekuiper_tpu_torch.ops import sketches as port

import torch_finalize_cases as fc


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


@pytest.mark.parametrize("k2", [1, 2, 6, 128])
def test_hh_candidates_match_reference(k2):
    """The recovery, ties ordered as lax.top_k orders them."""
    hh = _hh_sketches()
    got = [t.numpy() for t in port.hh_candidates(torch.from_numpy(hh), k2)]
    want = [np.asarray(t) for t in _hh_candidates(jnp.asarray(hh), k2)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[0][:, 0] == 7).mean() > 0.9


@functools.lru_cache(maxsize=None)
def _hh_edge_state():
    return fc.hh_state((fc.HH_PANES, fc.HH_CAP, 2, ref.HH_SIZE), seed=11)


def test_hh_edge_state_codes_hash_like_the_reference():
    """The cases' numpy hash is the sketch's: each kind-2 code lands where
    the reference's hh_update_parts puts it."""
    idx, _ = _hh_update_parts(jnp.asarray([91_001.0, 0.0, 1048575.0],
                                          dtype=jnp.float32),
                              jnp.ones(3, jnp.float32))
    cells = np.asarray(idx)[:, ::1 + ref.HH_BITS] // (1 + ref.HH_BITS)
    for row, code in zip(cells, (91_001, 0, (1 << 20) - 1)):
        assert row.tolist() == [d * ref.HH_WIDTH + fc.hh_slot(code, d)
                                for d in range(ref.HH_DEPTH)]


@pytest.mark.parametrize("mask", list(fc.HH_MASKS))
@pytest.mark.parametrize("k2s", [(6, 128), (1, 2), (128, 1)])
def test_hh_finalize_edge_states_match_reference(mask, k2s):
    """#8's plain version (hh_finalize_plain: the pane merge, then
    hh_candidates for each of two heavy_hitters columns) against the
    reference's merge (DeviceGroupBy._merged's where + sum) and its
    hh_candidates, on tests/torch_finalize_cases.py's edge slots: an
    all-zero slot, fewer positive estimates than k2, a valid code of
    estimate 0 tying the invalid cells, codes 0 and 2^20 - 1, ties, k2 =
    1 and 128, under no, one, two, three and every pane live. Rows
    exact; rows outside the specs untouched."""
    hh = _hh_edge_state()
    pm = np.asarray(fc.HH_MASKS[mask])
    rows = 2 * sum(k2s) + 3
    hhtab = np.array([[1, k2s[0], 1], [0, k2s[1], 2 + 2 * k2s[0]]],
                     dtype=np.int32)
    P, C = hh.shape[:2]
    state = {"hh": torch.from_numpy(hh), "act": torch.zeros((P, C))}
    out = torch.full((rows, C), -1.0)
    kernels.hh_finalize_plain(state, torch.from_numpy(pm), hhtab, out)
    want = np.full((rows, C), -1.0, dtype=np.float32)
    jpm = jnp.asarray(pm).reshape(-1, 1, 1)
    for k, k2, row in hhtab.tolist():
        merged = jnp.sum(jnp.where(jpm, jnp.asarray(hh[:, :, k]), 0.0),
                         axis=0)
        codes, est = (np.asarray(t) for t in _hh_candidates(merged, k2))
        want[row:row + k2] = codes.T
        want[row + k2:row + 2 * k2] = est.T
    got = out.numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    if mask == "all" and k2s[0] == 128:  # the kinds did what they are for
        codes, est = got[1:129], got[129:257]  # column 1: kind (c + 1) % 8
        assert (codes[:, 7] == 0).all() and (est[:, 7] == 0).all()  # kind 0
        assert 0 < (est[:, 0] > 0).sum() < 6  # kind 1
        assert ((codes[:, 1] == 91_001) & (est[:, 1] == 0)).any()  # kind 2
