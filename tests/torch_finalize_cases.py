"""Edge states of the wide finalize (#16 multirule_finalize_wide, #3
groupby_finalize_wide) and of the tier demote (#18 tier_demote), built
with numpy from a seed. The CPU tests hold the port's plain versions to
the JAX package on them (tests/test_torch_multirule.py,
tests/test_torch_tierstore.py); the card tests hold the kernels to their
plain versions (tests/test_torch_kernels_cuda.py). Nothing here imports
torch or jax.

Wide finalize: a 3-rule group over two hopping panes, two hll and three
percentile_approx specs (fractions 0, 1 and 0.5, so K = 2 register and 3
bin columns), capacity 64, finalized on the first 45 keys (not a multiple
of 32). Register values stay in [0, 15], so a key's Σ 2^-r spans at most
24 bits and every order of the sum gives the same bits; bin counts are
integers below 2^24.

Tier demote: blocks of 2,048 rows over 2,100 slots of a scalar plan
(three panes, 18 floats a row), an hll plan (three panes, 774) and a
percentile plan (one pane, 1,027): no row width a multiple of 4, one real
row with 2,047 pad rows, a full block, with and without the touch column.
"""
import numpy as np

# ------------------------------------------------------- wide finalize
FIN_SQL = ("SELECT k, hll(v) AS u1, hll(w) AS u2, "
           "percentile_approx(v, 0.0) AS p_lo, "
           "percentile_approx(w, 1.0) AS p_hi, "
           "percentile_approx(v, 0.5) AS p_mid FROM s WHERE v > {lo} "
           "GROUP BY k, HOPPINGWINDOW(ss, 10, 5)")
FIN_RULES, FIN_CAP, FIN_PANES, FIN_COLS = 3, 64, 2, 45
#: pane masks: both panes live, the second only, none
FIN_MASKS = {"all": [True, True], "second": [False, True],
             "none": [False, False]}
#: hll registers (pane 0, pane 1) by key: all zero (linear counting to
#: 0), 2 with 12 zeros (raw 644.7, just above 2.5·M = 640, kept), 2 with
#: 13 zeros (raw 638.2, linear counting), no zero register (raw), data
#: in the second pane only; the other keys random
HLL_KEYS = 5
#: bins (a count each, both panes merged) by key, from key 1: a target
#: on the 31 / 32 lane boundary, on 991 / 992, on the 127 / 128 chunk
#: boundary, the extremes and the zero bin, the top bin alone; key 0 is
#: empty (NaN), then runs of 32 ones either side of 31 / 32 and 991 / 992
#: (frac 0.5 lands on bin 31 / 991 exactly), then large counts; the other
#: keys random
HIST_PAIRS = ((31, 32), (991, 992), (127, 128), (0, 511, 1023), (1023,))
HIST_RUNS = ((0, 64), (960, 1024))


def fin_sqls(n=FIN_RULES):
    return [FIN_SQL.format(lo=10.0 + 0.5 * i) for i in range(n)]


def _registers(rng, key, rule):
    """(2, 256) registers of both panes for one key of one rule."""
    r = np.zeros((2, 256), dtype=np.float32)
    if key == 0:
        return r
    if key in (1, 2):
        r[0] = 2.0
        r[0, :12 + (key - 1)] = 0.0
        return r
    if key == 3:
        r[0] = rng.integers(1, 16, 256)
        r[1] = rng.integers(1, 16, 256)
        return r
    if key == 4:
        r[1] = rng.integers(0, 16, 256)
        return r
    geo = np.minimum(rng.geometric(0.5, (2, 256)), 15) - (rule % 2)
    r[:] = np.where(rng.random((2, 256)) < 0.2, 0, np.maximum(geo, 0))
    return r


def _bins(rng, key, rule):
    """(2, 1024) bin counts of both panes for one key of one rule."""
    h = np.zeros((2, 1024), dtype=np.float32)
    if key == 0:
        return h
    if key <= len(HIST_PAIRS):
        for i, b in enumerate(HIST_PAIRS[key - 1]):
            h[i % 2, b] += 1.0 + rule
        return h
    if key <= len(HIST_PAIRS) + len(HIST_RUNS):
        lo, hi = HIST_RUNS[key - len(HIST_PAIRS) - 1]
        h[0, lo:(lo + hi) // 2] = 1.0
        h[1, (lo + hi) // 2:hi] = 1.0
        return h
    if key == len(HIST_PAIRS) + len(HIST_RUNS) + 1:
        h[:] = rng.integers(0, 4000, (2, 1024))
        return h
    sparse = rng.random((2, 1024)) < 0.02
    h[sparse] = rng.integers(1, 9, int(sparse.sum()))
    return h


def fin_state(shapes, seed=0):
    """The group's hll, hist and act (numpy float32 arrays of `shapes`,
    (R, P, C, K, W) and (R, P, C)): the edge keys above, each of its
    register or bin columns alike for the edge keys and drawn apart for
    the random ones."""
    rng = np.random.default_rng(seed)
    out = {c: np.zeros(s, dtype=np.float32) for c, s in shapes.items()}
    R, P, C = shapes["act"]
    for r in range(R):
        for c in range(C):
            for k in range(shapes["hll"][3]):
                out["hll"][r, :, c, k] = _registers(rng, c, r)
            for k in range(shapes["hist"][3]):
                out["hist"][r, :, c, k] = _bins(rng, c, r)
    out["act"][:] = rng.integers(0, 50, shapes["act"])
    return out


# ---------------------------------------------------------- tier demote
TIER_D, TIER_CAP = 2048, 2100
TIER_SQL = {
    "scalar": ("SELECT deviceId, sum(v) AS s, count(*) AS c, min(v) AS mn "
               "FROM demo GROUP BY deviceId, HOPPINGWINDOW(ss, 6, 2)", 3),
    "hll": ("SELECT deviceId, distinct_count_approx(v) AS u, count(*) AS c "
            "FROM demo GROUP BY deviceId, HOPPINGWINDOW(ss, 6, 2)", 3),
    "pct": ("SELECT deviceId, percentile_approx(v, 0.9) AS p, max(v) AS mx "
            "FROM demo GROUP BY deviceId, TUMBLINGWINDOW(ss, 10)", 1),
}
#: case -> (plan, real rows, touch column)
TIER_CASES = {
    "scalar-one-row-touch": ("scalar", 1, True),
    "scalar-full-touch": ("scalar", TIER_D, True),
    "scalar-half": ("scalar", 1000, False),
    "hll-one-row-touch": ("hll", 1, True),
    "hll-half": ("hll", 1000, False),
    "pct-full-touch": ("pct", TIER_D, True),
    "pct-one-row": ("pct", 1, False),
}


def tier_fill(host, seed=0):
    """A copy of `host` (a group-by's state as numpy arrays) filled with
    seeded values: float components normal, hll registers and counts
    integers, the touch column uint32."""
    rng = np.random.default_rng(seed)
    host = {comp: np.array(arr) for comp, arr in host.items()}
    for comp, arr in host.items():
        if arr.dtype == np.uint32:
            arr[:] = rng.integers(0, 1 << 20, arr.shape)
        elif comp in ("hll", "hist", "n", "act"):
            arr[:] = rng.integers(0, 30, arr.shape)
        else:
            arr[:] = rng.normal(20, 5, arr.shape)
    return host


def tier_slots(n, seed=0):
    """n distinct real slots of TIER_CAP."""
    return np.random.default_rng(seed).choice(
        TIER_CAP, size=n, replace=False).astype(np.int32)
