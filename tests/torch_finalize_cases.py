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
The tier promote runs on the same blocks, its state and rows also holding
+/-0.0 and +/-inf in mn, mx and hll, and -0.0 in slots[0]'s additive
elements and in row 0's.

Heavy-hitters finalize (#8 groupby_hh_finalize): two heavy_hitters specs
(topk 3 and 64: k2 6 and 128, so K = 2 hh columns) over four hopping
panes, slots of eight kinds (below), pane masks with no, one, two, three
and every pane live; counts are whole numbers, so every pane sum is
exact.
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


SPECIALS = np.array([0.0, -0.0, np.inf, -np.inf], dtype=np.float32)


def promote_specials(arr, comp, rng, zero_cols=None):
    """`arr` (a component's state, (P, C, ...), or a packed block's
    columns) with a quarter of its mn / mx / hll elements set to +/-0.0 or
    +/-inf, in place; an additive component's elements at `zero_cols`
    (an index of the slot axis) set to -0.0."""
    if comp in ("mn", "mx", "hll"):
        hit = rng.random(arr.shape) < 0.25
        arr[hit] = rng.choice(SPECIALS, int(hit.sum()))
    elif zero_cols is not None:
        arr[:, zero_cols] = -0.0
    return arr


def promote_rows(block, blocks, n, rng):
    """Rows [0, n) of a demoted block (numpy (D, Wp)) reversed, with
    promote_specials in the mn / mx / hll columns, and -0.0 in half of
    row 0's additive columns; `blocks` the store's (comp, offset, tail)."""
    rows = block[:n][::-1].copy()
    for comp, off, width in _block_columns(blocks, rows.shape[1]):
        cols = rows[:, off:off + width]
        if comp in ("mn", "mx", "hll"):
            promote_specials(cols, comp, rng)
        else:
            cols[0, ::2] = -0.0
    return rows


def _block_columns(blocks, wp):
    """(comp, first column, columns) of each block of a packed row."""
    offs = [off for _, off, _ in blocks] + [wp]
    return [(comp, off, offs[i + 1] - off)
            for i, (comp, off, _) in enumerate(blocks)]


# ---------------------------------------------------------- hh finalize
HH_SQL = ("SELECT k, heavy_hitters(a, 3) AS t1, count(*) AS c, "
          "heavy_hitters(b, 64) AS t2 FROM s "
          "GROUP BY k, HOPPINGWINDOW(ss, 8, 2)")
HH_PANES, HH_CAP = 4, 40
HH_MASKS = {"all": [True] * 4, "three": [True, True, False, True],
            "two": [False, True, False, True], "one": [False, False, True,
                                                      False],
            "none": [False] * 4}
#: slot kinds, by slot % 8: 0 all zero; 1 two codes (fewer positive
#: estimates than k2); 2 a valid code whose other depth's cell is empty
#: (estimate 0, tying the invalid cells); 3 many codes, Zipf counts (more
#: positive cells than 128's half); 4 random counts (mostly invalid
#: cells); 5 code 0 and code 2^20 - 1; 6 four codes of equal count (ties
#: by cell index); 7 a different code in each pane
HH_KINDS = 8
_HH_DEPTH, _HH_WIDTH, _HH_BITS = 2, 64, 20
_HH_CELL = 1 + _HH_BITS
HH_SIZE = _HH_DEPTH * _HH_WIDTH * _HH_CELL


def _splitmix32(x):
    x = np.asarray(x, dtype=np.uint64) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x7FEB352D) & 0xFFFFFFFF
    x ^= x >> 15
    x = (x * 0x846CA68B) & 0xFFFFFFFF
    x ^= x >> 16
    return x


def hh_slot(code, d):
    """The width slot of `code` at depth d (the sketch's hash)."""
    salt = (0x9E3779B9 * (d + 7)) & 0xFFFFFFFF
    return int(_splitmix32(int(code) ^ salt)) & (_HH_WIDTH - 1)


def hh_add(col, code, count, depths=range(_HH_DEPTH)):
    """Add `count` rows of `code` to one hh column (HH_SIZE,) in place."""
    for d in depths:
        base = (d * _HH_WIDTH + hh_slot(code, d)) * _HH_CELL
        col[base] += count
        for b in range(_HH_BITS):
            if (code >> b) & 1:
                col[base + 1 + b] += count


def _hh_slot_panes(rng, kind, P):
    """(P, HH_SIZE) columns of one slot of `kind`."""
    cols = np.zeros((P, HH_SIZE), dtype=np.float32)
    if kind == 1:
        hh_add(cols[1], 7, 5)
        hh_add(cols[3], 4242, 2)
    elif kind == 2:
        code = 91_001
        hh_add(cols[2], code, 4, depths=(0,))
        hh_add(cols[0], 5, 1)
    elif kind == 3:
        codes = rng.integers(0, 1 << _HH_BITS, 300)
        for p in range(P):
            for code in codes[rng.zipf(1.6, 60) % 300]:
                hh_add(cols[p], int(code), 1)
    elif kind == 4:
        cells = cols.reshape(P, -1, _HH_CELL)
        tot = rng.integers(0, 20, cells.shape[:2])
        cells[..., 0] = tot
        cells[..., 1:] = rng.integers(0, tot[..., None] + 1,
                                      cells[..., 1:].shape)
    elif kind == 5:
        hh_add(cols[0], 0, 3)
        hh_add(cols[1], (1 << _HH_BITS) - 1, 3)
        hh_add(cols[3], 0, 1)
    elif kind == 6:
        for code in (11, 222, 3333, 44444):
            hh_add(cols[int(rng.integers(0, P))], code, 6)
    elif kind == 7:
        for p in range(P):
            hh_add(cols[p], 1000 + 17 * p, 2 + p)
            hh_add(cols[p], 77, 1)
    return cols


def hh_state(shape, seed=0):
    """An hh component (numpy float32 of `shape` (P, C, K, HH_SIZE)): slot
    c of column k of kind (c + k) % HH_KINDS."""
    rng = np.random.default_rng(seed)
    P, C, K, _ = shape
    hh = np.zeros(shape, dtype=np.float32)
    for c in range(C):
        for k in range(K):
            hh[:, c, k] = _hh_slot_panes(rng, (c + k) % HH_KINDS, P)
    return hh
