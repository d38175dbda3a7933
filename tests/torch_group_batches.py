"""Edge-case batches for the rule group's fold (#15 `multirule_fold` /
`multirule_fold_wide`, their row order `multirule_fold_order`) and pane
reset (#17 `multirule_reset_pane`), made from a numpy seed.
tests/test_torch_group_fold.py holds the port's plain versions to the JAX
package with them on the CPU; tests/test_torch_kernels_cuda.py holds the
kernels to the plain versions with them on the card.

Each batch has:
- slots of one of SLOT_KINDS: "uniform" over a few dozen keys, "zipf"
  (Zipf-skewed: a few keys hold most rows, many hold one or two) or "one"
  (one slot takes every row); the uniform and Zipf batches also put rows
  on the last slot C - 1 and past it (C, C + 1, the int32 maximum),
  which are dropped;
- a per-row pane vector with a few panes past the last, also dropped;
- values v ~ N(20, 5) with NaN, +inf and -inf among them (NaN is masked
  out of every column; a slot holding both infinities sums to NaN in any
  order), and w ~ N(0, 1) under a FILTER.
The rules of group_sqls step their WHERE threshold over v's range; with
more than one rule the last passes no row (its w bound lies below every
w). Negative slots are left out: the key table never makes them, JAX
wraps a negative index, and the port drops it.
"""
from __future__ import annotations

import numpy as np

#: every scalar component (n, s1, s2, mn, mx) and a FILTERed count
SCALAR_SQL = (
    "SELECT k, count(*) AS c, sum(v) AS s, avg(v) AS a, min(v) AS mn, "
    "max(v) AS mx, stddev(v) AS sd, count(v) FILTER (WHERE w > 0) AS cf "
    "FROM s WHERE v > {lo} AND w < {hi} GROUP BY k, HOPPINGWINDOW(ss, 10, 5)"
)
#: the wide components (hll, hist) beside a scalar one
WIDE_SQL = (
    "SELECT k, hll(v) AS u, percentile_approx(v, 0.9) AS p, count(*) AS c "
    "FROM s WHERE v > {lo} AND w < {hi} GROUP BY k, HOPPINGWINDOW(ss, 10, 5)"
)
#: a group without a WHERE: act counts every row a (pane, slot) keeps
COUNT_SQL = ("SELECT k, count(*) AS c FROM s "
             "GROUP BY k, HOPPINGWINDOW(ss, 10, 5)")
PLANS = {"scalar": SCALAR_SQL, "wide": WIDE_SQL}
SLOT_KINDS = ("uniform", "zipf", "one")
#: rule counts: one rule, a 63-rule family (not a multiple of 32)
RULE_COUNTS = (1, 63)
#: the slot that takes every row of a "one" batch
ONE_SLOT = 3


def group_sqls(plan: str, n_rules: int):
    """n_rules statements of one plan: rule i keeps v > 10 + 0.25 i; with
    more than one rule, the last keeps no row (w < -100)."""
    sql = PLANS[plan]
    out = []
    for i in range(n_rules):
        hi = -100.0 if n_rules > 1 and i == n_rules - 1 else 100.0
        out.append(sql.format(lo=10.0 + 0.25 * i, hi=hi))
    return out


def group_slots(rng, rows, cap, kind, keys=40):
    """int32 slots of one kind (SLOT_KINDS)."""
    if kind == "one":
        return np.full(rows, ONE_SLOT, dtype=np.int32)
    if kind == "zipf":
        slots = np.minimum(rng.zipf(1.3, rows) - 1, cap - 2)
    else:
        slots = rng.integers(0, keys, rows)
    slots[rng.random(rows) < 0.05] = cap - 1
    past = rng.random(rows) < 0.04
    slots[past] = rng.choice([cap, cap + 1, np.iinfo(np.int32).max],
                             int(past.sum()))
    return slots.astype(np.int32)


def group_batch(seed, rows, cap, n_panes, kind):
    """One batch: raw columns `cols` (v, w), int32 `slots` of `kind` and a
    uint8 `pane_vec` (a few panes at n_panes, past the last)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(20, 5, rows).astype(np.float32)
    special = rng.random(rows)
    v[special < 0.04] = np.nan
    v[(special >= 0.04) & (special < 0.05)] = np.inf
    v[(special >= 0.05) & (special < 0.06)] = -np.inf
    w = rng.normal(0, 1, rows).astype(np.float32)
    pane_vec = rng.integers(0, n_panes, rows)
    pane_vec[rng.random(rows) < 0.03] = n_panes
    return {"cols": {"v": v, "w": w},
            "slots": group_slots(rng, rows, cap, kind),
            "pane_vec": pane_vec.astype(np.uint8)}
