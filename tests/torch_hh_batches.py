"""Edge-case batches for the heavy-hitters fold (the hh role of #1
`groupby_fold` and #2 `groupby_fold_masked`), made from a numpy
seed. tests/test_torch_hh_fold.py holds the port's plain versions to the
JAX package with them on the CPU. tests/test_torch_kernels_cuda.py holds
the kernels to the plain versions with them on the card.

Each batch mixes chip_smoke.py's skewed codes (7 at 35 %, 13 at 20 %, 99
at 15 %, the rest over [100, 2100)) with the codes 0, 1, 2^19 and
2^20 - 1 and with NaN codes. Its slots crowd few keys and take the last
key slot C - 1. A few slots lie past it, up to the slot type's largest
value, and those rows are dropped. The batch has a per-row pane vector
with a few panes past the last, also dropped, and a row mask for the
masked fold. Negative slots are left out: the key table never makes them,
JAX wraps a negative index, and the port drops it.
"""
from __future__ import annotations

import numpy as np

#: two heavy_hitters columns, one under a FILTER, beside a WHERE
HH2_SQL = (
    "SELECT k, heavy_hitters(code, 3) AS t1, heavy_hitters(code2, 2) "
    "FILTER (WHERE w > 0) AS t2, count(*) AS c FROM s WHERE w > -1.5 "
    "GROUP BY k, HOPPINGWINDOW(ss, 10, 5)"
)
#: hll, hist and hh columns in one widemap (two launches on the card)
MIXED_SQL = (
    "SELECT k, hll(v) AS u, percentile_approx(v, 0.5) AS p, "
    "heavy_hitters(code, 3) AS t1, heavy_hitters(code2, 2) "
    "FILTER (WHERE w > 0) AS t2 FROM s GROUP BY k, HOPPINGWINDOW(ss, 10, 5)"
)
PLANS = {"hh2": HH2_SQL, "mixed": MIXED_SQL}
#: the codes at the edges of the 20-bit code range
EDGE_CODES = (0, 1, 1 << 19, (1 << 20) - 1)
#: codes outside it, which the dictionary never makes: their bits at 20
#: and above (for a negative code, of its 32-bit two's complement) count
#: in the hash and nowhere else
PAST_CODES = (1 << 20, (1 << 20) + 5, (1 << 24) - 1, -1, -3)
HH_PREFIX, HLL_PREFIX = "__hhc__", "__hll__"


def skewed_codes(rng, n):
    p = rng.random(n)
    return np.where(p < 0.35, 7, np.where(p < 0.55, 13, np.where(
        p < 0.70, 99, rng.integers(100, 2100, n))))


def hh_batch(seed, rows, cap, n_panes, slot_dtype, keys=40,
             edge_codes=EDGE_CODES):
    """One batch: raw columns `cols` (code, code2, v, w), `slots` of
    slot_dtype, a uint8 `pane_vec` and a bool row `mask`; a tenth of the
    codes drawn from `edge_codes`."""
    rng = np.random.default_rng(seed)
    codes = []
    for _ in range(2):
        c = skewed_codes(rng, rows)
        edge = rng.random(rows) < 0.1
        c[edge] = rng.choice(edge_codes, int(edge.sum()))
        c = c.astype(np.float32)
        c[rng.random(rows) < 0.03] = np.nan
        codes.append(c)
    v = rng.normal(20, 5, rows).astype(np.float32)
    v[rng.random(rows) < 0.05] = np.nan
    w = rng.normal(0, 1, rows).astype(np.float32)
    slots = rng.integers(0, keys, rows).astype(np.int64)
    slots[rng.random(rows) < 0.05] = cap - 1
    past = rng.random(rows) < 0.04
    slots[past] = rng.choice([cap, cap + 1, np.iinfo(slot_dtype).max],
                             int(past.sum()))
    pane_vec = rng.integers(0, n_panes, rows)
    pane_vec[rng.random(rows) < 0.03] = n_panes
    return {"cols": {"code": codes[0], "code2": codes[1], "v": v, "w": w},
            "slots": slots.astype(slot_dtype),
            "pane_vec": pane_vec.astype(np.uint8),
            "mask": rng.random(rows) < 0.7}


def plan_columns(plan_cols, raw, encode_hll):
    """The plan's columns from the raw ones: the heavy-hitters codes as
    they are, the hll encoding by `encode_hll(col, n)`."""
    out = {}
    for name in plan_cols:
        if name.startswith(HH_PREFIX):
            out[name] = raw[name[len(HH_PREFIX):]]
        elif name.startswith(HLL_PREFIX):
            col = raw[name[len(HLL_PREFIX):]]
            out[name] = encode_hll(col, len(col))
        else:
            out[name] = raw[name]
    return out
