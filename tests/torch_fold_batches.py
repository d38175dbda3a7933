"""Edge-case batches for the one-launch fold (#1 `groupby_fold`) and the
sharded fold (#23 / #24 `sharded_fold`), made from a numpy seed.
tests/test_torch_fold.py holds the port's plain versions to the JAX
package's DeviceGroupBy / ShardedGroupBy folds with them on the CPU;
tests/test_torch_kernels_cuda.py holds the kernels to the plain versions
with them on the card.

Each batch has:
- slots of one of SLOT_KINDS: "uniform" over a few dozen keys, "zipf"
  (a few keys hold most rows, many hold one or two) or "one" (one slot
  takes every row); the uniform and Zipf batches also put rows on the
  last slot C - 1 and past it (C, C + 1 and the slot type's largest
  value), which are dropped;
- a per-row pane vector with a few panes past the last, also dropped;
- values v ~ N(20, 5) with NaN, +inf, -inf, -0.0 and +0.0 among them
  (NaN is masked out of every column; a slot holding both infinities sums
  to NaN in any order; min / max order -0 below +0), w ~ N(0, 1) under a
  FILTER and a WHERE, and heavy-hitters codes.
Negative slots are left out of the JAX comparisons: the key table never
makes them, JAX wraps a negative index, and the port drops it (the card
tests add them, where kernel and plain version both drop them).
"""
from __future__ import annotations

import numpy as np

_WINDOW = "GROUP BY k, HOPPINGWINDOW(ss, 10, 5)"
#: every scalar component (n, s1, s2, mn, mx) and a FILTERed count; no
#: sketch column (an empty widemap)
SCALAR_SQL = (
    "SELECT k, count(*) AS c, sum(v) AS s, avg(v) AS a, min(v) AS mn, "
    "max(v) AS mx, stddev(v) AS sd, count(v) FILTER (WHERE w > 0) AS cf "
    "FROM s WHERE w < 1.5 " + _WINDOW)
#: one sketch column and no scalar one (an empty colmap: act alone)
HLL_SQL = "SELECT k, hll(v) AS u FROM s " + _WINDOW
#: hll and hist beside scalar columns (the mesh's sketches)
WIDE_SQL = (
    "SELECT k, hll(v) AS u, percentile_approx(v, 0.9) AS p, count(*) AS c, "
    "min(v) AS mn FROM s WHERE w > -1.5 " + _WINDOW)
#: hh, hll and hist in one rule beside scalar columns
MIXED_SQL = (
    "SELECT k, count(*) AS c, avg(v) AS a, max(v) AS mx, hll(v) AS u, "
    "percentile_approx(v, 0.5) AS p, heavy_hitters(code, 3) AS t "
    "FROM s WHERE w > -1.5 " + _WINDOW)
PLANS = {"scalar": SCALAR_SQL, "hll": HLL_SQL, "wide": WIDE_SQL,
         "mixed": MIXED_SQL}
#: the plans a mesh takes (it refuses heavy_hitters)
MESH_PLANS = ("scalar", "hll", "wide")
SLOT_KINDS = ("uniform", "zipf", "one")
#: the slot that takes every row of a "one" batch
ONE_SLOT = 3
HH_PREFIX, HLL_PREFIX = "__hhc__", "__hll__"


def fold_slots(rng, rows, cap, kind, slot_dtype=np.int32, keys=40):
    """Slots of one kind (SLOT_KINDS) as slot_dtype."""
    if kind == "one":
        return np.full(rows, ONE_SLOT, dtype=slot_dtype)
    if kind == "zipf":
        slots = np.minimum(rng.zipf(1.3, rows) - 1, cap - 2)
    else:
        slots = rng.integers(0, min(keys, cap), rows)
    slots[rng.random(rows) < 0.05] = cap - 1
    past = rng.random(rows) < 0.04
    slots[past] = rng.choice([cap, cap + 1, np.iinfo(slot_dtype).max],
                             int(past.sum()))
    return slots.astype(slot_dtype)


def fold_batch(seed, rows, cap, n_panes, kind, slot_dtype=np.int32):
    """One batch: raw columns `cols` (v, w, code), `slots` of `kind` and
    slot_dtype, and a uint8 `pane_vec` (a few panes at n_panes, past the
    last, where n_panes < 256)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(20, 5, rows).astype(np.float32)
    special = rng.random(rows)
    v[special < 0.04] = np.nan
    v[(special >= 0.04) & (special < 0.05)] = np.inf
    v[(special >= 0.05) & (special < 0.06)] = -np.inf
    v[(special >= 0.06) & (special < 0.08)] = -0.0
    v[(special >= 0.08) & (special < 0.10)] = 0.0
    w = rng.normal(0, 1, rows).astype(np.float32)
    code = np.where(rng.random(rows) < 0.5, 7,
                    rng.integers(0, 2000, rows)).astype(np.float32)
    pane_vec = rng.integers(0, n_panes, rows)
    if n_panes < 256:
        pane_vec[rng.random(rows) < 0.03] = n_panes
    return {"cols": {"v": v, "w": w, "code": code},
            "slots": fold_slots(rng, rows, cap, kind, slot_dtype),
            "pane_vec": pane_vec.astype(np.uint8)}


def plan_columns(plan_cols, raw, encode_hll):
    """The kernel plan's columns from a batch's raw ones: `__hll__x` by the
    package's own hll encoding, `__hhc__x` as the codes themselves (a
    dictionary's codes), every other column as it is."""
    out = {}
    for name in plan_cols:
        if name.startswith(HLL_PREFIX):
            out[name] = encode_hll(raw[name[len(HLL_PREFIX):]],
                                   len(raw["v"]))
        elif name.startswith(HH_PREFIX):
            out[name] = raw[name[len(HH_PREFIX):]]
        else:
            out[name] = raw[name]
    return out
