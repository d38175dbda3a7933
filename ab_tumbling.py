#!/usr/bin/env python3
"""Rows of chip_smoke.py from two checkouts of the repository, alternately
A B B A, each run in a process of its own started in its checkout (so
each builds and imports its own kernels and port). Both run the same
work. `--phase` picks the rows:

- `tumbling` (the default): phase 3, the tumbling rule end to end on one
  card: rows/s, emit p50/p99 and the host's encode and fold ms a batch.
- `multirule`: the rule group's kernel rows of phase 2 (#15's fold and
  wide fold, their pane-vector forms, #16's finalizes, #17's reset, and
  in a tree that has it the folds' row order), and beside them each
  tree's #15 wrapper on E1's batch with Zipf-skewed slots and with one
  slot taking every row, timed by the same code.
- `fold`: #1, #23 and #24 at phase 2's shapes, by code both trees run:
  each rule's fold chunk as the group-by calls it (`_fold_chunk`: the
  closures, then the fold's launches; on the mesh also the merge), the
  fold's wrapper calls alone on the same inputs (the tree's own: one
  `groupby_fold` / `sharded_fold`, or the parent's scalar and wide
  wrappers), the fold kernels' bodies a chunk from a profiler trace, and
  their launches a chunk. Rules: tumbling and hopping (#1's scalar fold),
  the percentile, hll and heavy-hitters rules, the D1 percentile and D2
  scalar plans on a pane vector, G1's touch column at 1,048,576 slots,
  and on a 2x4 mesh of the card the tumbling rule with touch (#23), the
  percentile rule and I3's rule on its 8-pane vector (#24).
- `tier`: the tier store's kernel rows of phase 2 (#18's demote and #19's
  promote at G1's, G2's, the hll and the percentile plans' state), then
  `TierStore.promote` whole as `TierManager.admit` calls it (host block
  and slots in, ending in a synchronize) at G2's and the percentile
  plan's row width, with 2,000 rows and with one.
- `sketch`: the sketch kernel rows of phase 2 (the sketch folds, #3's
  wide finalize on the pct and hll rules and #4's hll subset mask, the
  heavy-hitters finalize, the pane reset over hh state), then #8 at F1's
  plan (53 panes, the refold's scratch pane the only live one).
- `refold`: #2, the masked fold: its kernel rows of phase 2 (F2's scalar,
  F1's heavy-hitters and F3's hll plans, the touch branch at L2's plan,
  and in a tree that has it a stale refold's segment group), then F4 (D2's
  delayed rule through phase F's backlog, which forces a stale
  whole-window refold) with the node's masked-fold calls instrumented:
  per call the host time of its stages (the WHERE and spec closures,
  the row masks' packing, upload and unpacking, the segments' column
  concatenation,
  the kernel wrappers) and its device span by CUDA events, summed per
  trigger, beside each trigger's stall.
- `countmin`: #10 and #11's kernel rows of phase 2 (in a tree that has
  it, #10 on a uniform stream beside phase M's), then phase M's update
  values/s.
- `join`: #20 at J1's 2,048² and J3's 16,384² (with the (PL, PR)
  residual l.v > r.w and without one: kernel ms, body, host), then the
  stages of one J1 and one J3 match (the key encode, the rebase, the
  upload, the residual's torch pass, the kernel, the copy back, the
  unpack or the byte mask's numpy and count) and the whole match, host
  ms each a median of three calls ending in a synchronize; then phase J
  of chip_smoke.py end to end (J1's match rows/s, J2's window p50 / p99,
  J3's match wall); then, in a tree with the packed mask, the unpack at
  256², 2,048² and 16,384² by task size and on one thread, beside the
  (i, j) pairs read straight from the packed words.
- `merge`: #23 / #24's `shard_merge` rows of phase 2 (the flagship
  rule with touch, I3's 8-pane vector, the percentile and hll rules on a
  2x4 mesh of the card: kernel, body, host, plain, library, bound).
- `trace`: #16's wide finalize at H5's shapes (hll and pct families)
  timed by CUDA events alone, then on the same launches inside one
  profiler session by events and by the trace (after an idle sleep and
  back to back: chip_smoke.py `same_launch_ms` of checkout B), with the
  card's clocks after each: what a trace costs each tree's launches.
- `host`: the tumbling rule's fold stage (`TorchGroupBy.fold`: the
  closures, the upload and the fold's launch) on the host at phase 3's
  shapes, median ms a call after an idle card (`fold_idle_ms`) and a
  mean back to back (`fold_b2b_ms`), and `process` ms a 65,536-row batch
  (`process_ms`): the host time behind phase 3's rows/s, each a median
  or mean of many calls in one process.

Run from the repository root on a machine with a card, the parent
checkout unpacked into a directory that .gitignore lists:

    git archive HEAD~1 | (mkdir -p _archive/parent && tar -x -C _archive/parent)
    python3 ab_tumbling.py _archive/parent . --windows 6
    python3 ab_tumbling.py _archive/parent . --phase multirule --out DIR
    python3 ab_tumbling.py _archive/parent . --phase fold --out DIR
    python3 ab_tumbling.py _archive/parent . --phase host
    python3 ab_tumbling.py _archive/parent . --phase tier --out DIR
    python3 ab_tumbling.py _archive/parent . --phase sketch --out DIR
    python3 ab_tumbling.py _archive/parent . --phase trace --out DIR
    python3 ab_tumbling.py _archive/parent . --phase refold --out DIR
    python3 ab_tumbling.py _archive/parent . --phase countmin --out DIR
    python3 ab_tumbling.py _archive/parent . --phase join --out DIR
    python3 ab_tumbling.py _archive/parent . --phase merge --out DIR

With --out, each run's result is written to DIR/ab_<phase>_<tag><i>.json.
The last line of the output is one JSON object {"a": [...], "b": [...]},
one entry per run (for `multirule`, `fold`, `tier` and `sketch`, each
row's headline numbers: ms, body_ms, host_ms, plain_ms, library_ms,
bound_ms and the like).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

PRELUDE = r"""
import functools, json, sys, time
sys.path.insert(0, ".")
import numpy as np
import torch
import chip_smoke as cs
from ekuiper_tpu_torch.ops import kernels

if not torch.cuda.is_available():
    sys.exit("no CUDA device")
kernels.build_library()
"""

TUMBLING = r"""
from ekuiper_tpu_torch.data.batch import ColumnBatch
from ekuiper_tpu_torch.planner.fused import plan_fused_rule
from ekuiper_tpu_torch.runtime.events import Trigger

cs.WINDOWS = int(sys.argv[1])
_, rps, emit_ms, err, st = cs.run_rule(
    torch, 0, cs.TUMBLING, 10_000, 1, kernels,
    (plan_fused_rule, ColumnBatch, Trigger))
n_b = cs.WINDOWS * cs.BATCHES
print(json.dumps(dict(
    rows_per_s=rps, emit_p50_ms=cs.pct(emit_ms, 50),
    emit_p99_ms=cs.pct(emit_ms, 99), max_abs_err=err,
    encode_ms=st["encode"] / n_b * 1e3, fold_ms=st["fold"] / n_b * 1e3)))
"""

MULTIRULE = r"""
from ekuiper_tpu_torch.ops import sketches
from ekuiper_tpu_torch.planner.rulegroup import plan_rule_group

dev = torch.device("cuda")
rows = {}
rows.update(cs.group_kernel_checks(torch, 0, kernels, plan_rule_group, dev))
rows.update(cs.wide_group_kernel_checks(torch, 0, kernels, sketches,
                                        plan_rule_group, dev))
rows.update(cs.event_group_kernel_checks(torch, 0, kernels, sketches, dev))
torch.cuda.empty_cache()
# E1's batch on skewed slots through this tree's wrapper
node = plan_rule_group(cs.rule_ids("e1_", cs.E1_RULES), cs.e1_sqls(),
                       key_slots=cs.SLOTS, micro_batch=cs.ROWS, device=dev)
gb = node.gb
r = np.random.default_rng(41)
temp = torch.from_numpy(r.normal(20, 5, cs.ROWS).astype(np.float32)).to(dev)
base, V, M = gb.rule_inputs({"temperature": temp}, cs.ROWS)
# every kernel either tree's #15 wrapper launches, the row order's memset
# among them (the parent's one kernel is multirule_fold_kernel)
names = ("Memset", "multirule_fold_kernel", "multirule_fold_keys_kernel",
         "multirule_fold_pieces_kernel", "pack_rule_bits_kernel",
         "fold_gather_kernel", "radix_hist_kernel", "radix_pass_kernel",
         "fold_order_finish_kernel")
zipf = np.minimum(r.zipf(1.3, cs.ROWS) - 1, cs.N_KEYS - 1)
for tag, sl in (("zipf", zipf), ("one_slot", np.full(cs.ROWS, 7))):
    s = torch.from_numpy(sl.astype(np.int32)).to(dev)
    st = gb.init_state()
    fn = functools.partial(kernels.multirule_fold, st, base, V, M, s, 0,
                           gb._colmap)
    rows["ab_skew/" + tag] = dict(
        ms=cs.time_ms(torch, fn, cs.REPS),
        body_ms=cs.body_ms(torch, fn, names, cs.REPS, per_call=True))
    print("ab_skew", tag, rows["ab_skew/" + tag], flush=True)
print(json.dumps(rows))
"""

FOLD = r"""
from ekuiper_tpu_torch.ops.groupby import TorchGroupBy
from ekuiper_tpu_torch.parallel.mesh import make_mesh
from ekuiper_tpu_torch.parallel.sharded import ShardedGroupBy
from ekuiper_tpu_torch.planner.fused import plan_fused_rule

dev = torch.device("cuda")
#: every fold kernel either tree launches (the parent's per-branch
#: kernels, the change's one kernel)
NAMES = ("groupby_fold_kernel", "sharded_fold_kernel", "fold_scalar_kernel",
         "fold_wide_kernel", "fold_hh_kernel", "sharded_fold_scalar_kernel",
         "sharded_fold_wide_kernel")
one_launch = hasattr(kernels, "groupby_fold")
mesh = make_mesh(2, 4, [dev] * 8)
D_OPTS = {"slidingImpl": "daba"}
CASES = (  # tag, SQL, options, slots, pane vector, touch, mesh
    ("tumbling", cs.TUMBLING, None, cs.SLOTS, False, False, False),
    ("hopping", cs.HOPPING, None, cs.SLOTS, False, False, False),
    ("pct", cs.PCT_RULE, None, cs.SLOTS, False, False, False),
    ("hll", cs.HLL_RULE, None, cs.SLOTS, False, False, False),
    ("hh", cs.HH_RULE, None, cs.SLOTS, False, False, False),
    ("d1_pane_vec", cs.D1_RULE, D_OPTS, cs.SLOTS, True, False, False),
    ("d2_pane_vec", cs.D2_RULE, D_OPTS, cs.SLOTS, True, False, False),
    ("g1_touch", cs.TUMBLING, None, 1 << 20, False, True, False),
    ("n1_mesh", cs.TUMBLING, None, cs.SLOTS, False, True, True),
    ("n3_pct_mesh", cs.PCT_RULE, None, cs.SLOTS, False, False, True),
    ("n4_pane_vec_mesh", cs.I3_RULE, cs.I_OPTS, cs.SLOTS, True, False,
     True))
rows = {}
for i, (tag, sql, opts, C, vec, touch, on_mesh) in enumerate(CASES):
    node = plan_fused_rule(sql, key_slots=cs.SLOTS, micro_batch=cs.ROWS,
                           device=dev, options=opts)
    P = node.n_panes
    if on_mesh:
        gb = ShardedGroupBy(node.plan, mesh, capacity=C, n_panes=P,
                            micro_batch=cs.ROWS, track_touch=touch)
    else:
        gb = TorchGroupBy(node.plan, capacity=C, n_panes=P,
                          micro_batch=cs.ROWS, device=dev, track_touch=touch)
    node.on_close()
    r = np.random.default_rng(200 + i)
    host = {"__hhc__code": cs.skewed_codes(r, cs.ROWS).astype(np.float32),
            "temperature": r.normal(20, 5, cs.ROWS).astype(np.float32),
            "__hll__humidity": (r.integers(0, 1000, cs.ROWS) / 10).astype(
                np.float32)}
    cols = {k: torch.from_numpy(v).to(dev) for k, v in host.items()
            if k in gb.plan.columns}
    keys = cs.N_KEYS if C == cs.SLOTS else C
    slots = torch.from_numpy(r.integers(0, keys, cs.ROWS).astype(
        np.int32)).to(dev)
    pv = (torch.from_numpy(np.where(np.arange(cs.ROWS) < 0.4 * cs.ROWS,
                                    P - 2, P - 1).astype(np.uint8)).to(dev)
          if vec else None)
    pane = 0 if vec else P - 1
    state = gb.init_state()
    chunk = functools.partial(gb._fold_chunk, state, cols, cs.ROWS, slots,
                              pane, pv)
    base, V, M = gb.spec_inputs(cols, cs.ROWS)
    if on_mesh:
        parts = gb._partials(P if vec else 1)
        R, K, m = gb.n_row_shards, gb.n_keys_shards, gb.rows_per_shard
        if one_launch:
            fold = functools.partial(kernels.sharded_fold, parts, base, V,
                                     M, slots, m, R, K, gb._colmap,
                                     gb._widemap, pv)
        else:
            def fold():
                kernels.sharded_fold_scalar(parts, base, V, M, slots, m, R,
                                            K, gb._colmap, pv)
                if len(gb._widemap):
                    kernels.sharded_fold_wide(parts, V, M, slots, m, R,
                                              gb._widemap, pv)
    elif one_launch:
        fold = functools.partial(kernels.groupby_fold, state, base, V, M,
                                 slots, pane, gb._colmap, gb._widemap, pv)
    else:
        def fold():
            kernels.groupby_fold_scalar(state, base, V, M, slots, pane,
                                        gb._colmap, pv)
            if len(gb._widemap):
                kernels.groupby_fold_wide(state, V, M, slots, pane,
                                          gb._widemap, pv)
    from torch.profiler import ProfilerActivity, profile
    chunk()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(cs.REPS):
            chunk()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    n_fold = sum(1 for e in prof.events()
                 if e.device_type == cuda and any(n in e.name for n in NAMES))
    rows[tag] = dict(
        chunk_ms=cs.time_ms(torch, chunk, cs.REPS),
        ms=cs.time_ms(torch, fold, cs.REPS),
        body_ms=cs.body_ms(torch, fold, NAMES, cs.REPS, per_call=True),
        host_ms=cs.host_ms(torch, fold, cs.REPS),
        launches_a_chunk=n_fold / cs.REPS)
    print("ab_fold", tag, rows[tag], flush=True)
    del state, gb
    torch.cuda.empty_cache()
print(json.dumps(rows))
"""

TIER = r"""
import statistics
from ekuiper_tpu_torch.planner.fused import plan_fused_rule

dev = torch.device("cuda")
rows = cs.tier_kernel_checks(torch, 0, kernels, plan_fused_rule, dev)
# TierStore.promote whole, as TierManager.admit calls it: a host block of
# n rows and host slots in, host ms a call ending in a synchronize
# (median of 30 after 3 warm-up calls), at G2's plan (Wp 60) and the
# percentile plan's (Wp 1,026), a block of D - 48 rows and of one
for tag, sql, opts, cap in (
        ("g2", cs.G2_RULE, {"tierHotMb": cs.G_HOT_MB}, cs.G_SLOTS),
        ("pct", cs.PCT_RULE, {"tierHotMb": 128}, cs.SLOTS)):
    node = plan_fused_rule(sql, key_slots=cap, micro_batch=cs.ROWS,
                           device=dev, options=opts)
    store, gb = node.tier.ts, node.gb
    st = gb.init_state()
    r = np.random.default_rng(5)
    for n in (store.demote_batch - 48, 1):
        block = r.normal(0, 1, (n, store.packed_w)).astype(np.float32)
        slots = r.choice(gb.capacity, n, replace=False).astype(np.int32)
        times = []
        for _ in range(33):
            torch.cuda.synchronize()
            t = time.perf_counter()
            store.promote(st, block, slots)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        rows[f"tier_store_promote/{tag}/n{n}"] = dict(
            call_host_ms=statistics.median(times[3:]))
    del node, st
    torch.cuda.empty_cache()
print(json.dumps(rows))
"""

SKETCH = r"""
from ekuiper_tpu_torch.ops import sketches
from ekuiper_tpu_torch.ops.groupby import TorchGroupBy
from ekuiper_tpu_torch.planner.fused import plan_fused_rule

dev = torch.device("cuda")
rows = cs.sketch_kernel_checks(torch, 0, kernels, sketches, plan_fused_rule,
                               TorchGroupBy, dev)
# #8 at F1's plan: the refold's scratch pane of 53 the only live one
node = plan_fused_rule(cs.F1_RULE, key_slots=cs.SLOTS, micro_batch=cs.ROWS,
                       device=dev)
plan, P, pane = node.plan, node.n_panes, node._scratch_pane
del node
torch.cuda.empty_cache()
gb = TorchGroupBy(plan, capacity=cs.SLOTS, n_panes=P, micro_batch=cs.ROWS,
                  device=dev)
st = gb.init_state()
base, V, M, s_dev, _ = cs.sketch_inputs(torch, gb, 7, dev)
kernels.fold_plain(st, base, V, M, s_dev, pane, gb._colmap, gb._widemap)
pm = gb._pane_mask([pane])
out = torch.full((gb._rows, cs.SLOTS), -1.0, device=dev)
ref = out.clone()
fin = functools.partial(kernels.groupby_hh_finalize, st, pm, gb._hhtab, out)
fin()
kernels.hh_finalize_plain(st, pm, gb._hhtab, ref)
torch.cuda.synchronize()
nbytes = (st["hh"][0].numel() * 4
          + int(gb._hhtab[:, 1].sum()) * 2 * cs.SLOTS * 4)
rows["groupby_hh_finalize/f1"] = dict(
    ms=cs.time_ms(torch, fin, cs.REPS),
    **cs.launch_split(torch, fin, "hh_finalize_kernel", cs.REPS),
    bound_ms=cs.bound(nbytes, 0)[0], panes=P,
    equal=bool(torch.equal(out, ref)))
print(json.dumps(rows))
"""

TRACE = r"""
import importlib.util, os, subprocess
from ekuiper_tpu_torch.planner.rulegroup import plan_rule_group

spec = importlib.util.spec_from_file_location(
    "cs_b", os.path.join(sys.argv[2], "chip_smoke.py"))
cs_b = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs_b)
dev = torch.device("cuda")
NAME = "multirule_finalize_wide_kernel"


def clocks():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()


r = np.random.default_rng(70)
cols = cs.h5_columns(r, cs.ROWS)
slots = torch.from_numpy(
    r.integers(0, cs.N_KEYS, cs.ROWS).astype(np.int32)).to(dev)
rows = {}
for fam in ("hll", "pct"):
    node = plan_rule_group(cs.rule_ids(f"h5{fam}_", cs.H5_RULES),
                           cs.h5_sqls(fam), key_slots=cs.SLOTS,
                           micro_batch=cs.ROWS, device=dev)
    gb = node.gb
    dcols = {c: torch.from_numpy(v.astype(np.float32)).to(dev)
             for c, v in cols.items()}
    dcols["__hll__humidity"] = dcols["humidity"]
    base, V, M = gb.rule_inputs(dcols, cs.ROWS)
    st = gb.init_state()
    for pane in range(gb.n_panes):
        kernels.multirule_fold_wide(st, base, V, M, slots, pane, gb._widemap)
    K = gb._slice_keys(cs.N_KEYS)
    pm = gb._pane_mask(None)
    out = kernels.multirule_finalize(st, pm, gb._spectab, K, gb._rows)
    fin = functools.partial(kernels.multirule_finalize_wide, st, pm,
                            gb._widetab, gb._fracs, out)
    ms = cs.time_ms(torch, fin, cs.REPS)
    after = clocks()
    same = cs_b.same_launch_ms(torch, fin, NAME, cs.REPS)
    rows["trace/" + fam] = dict(
        ms=ms, idle_ms=same["idle"][0], idle_body_ms=same["idle"][1],
        b2b_ms=same["b2b"][0], b2b_body_ms=same["b2b"][1],
        ms_again=cs.time_ms(torch, fin, cs.REPS), clocks_after_ms=after,
        clocks_after_trace=clocks())
    print("ab_trace", fam, rows["trace/" + fam], flush=True)
    del st, out, node, gb
    torch.cuda.empty_cache()
print(json.dumps(rows))
"""

REFOLD = r"""
import statistics
from ekuiper_tpu_torch.data.batch import ColumnBatch
from ekuiper_tpu_torch.ops import sketches
from ekuiper_tpu_torch.ops.groupby import TorchGroupBy
from ekuiper_tpu_torch.planner.fused import plan_fused_rule
from ekuiper_tpu_torch.runtime.events import Trigger

dev = torch.device("cuda")
rows = cs.masked_kernel_checks(torch, 0, kernels, sketches, plan_fused_rule,
                               TorchGroupBy, dev)
rows.update(cs.masked_touch_check(torch, 0, kernels, plan_fused_rule,
                                  TorchGroupBy, dev))
torch.cuda.empty_cache()
#: host stages of a masked-fold call, by the function that runs each (a
#: tree has the ones it has): the closures, the masks' upload, the
#: segments' concatenation, the kernel wrappers
STAGES = {"closures": ("_where", "_spec_values"),
          "mask_upload": ("upload", "_upload_masks", "_unpack_rows"),
          "concat": ("_concat_columns",)}
WRAPPERS = ("groupby_fold_masked_scalar", "groupby_fold_masked_wide",
            "groupby_fold_masked")  # the parent's two, this tree's one
calls = []  # per call: segments, host ms by stage, total ms, device span
inside = [None]


def timed(fn, stage):
    def run(*a, **k):
        if inside[0] is None:
            return fn(*a, **k)
        t = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            inside[0][stage] = inside[0].get(stage, 0.0) + (
                time.perf_counter() - t) * 1e3
    return run


def hook(node):
    gb = node.gb
    for stage, names in STAGES.items():
        for name in names:
            if hasattr(gb, name):
                setattr(gb, name, timed(getattr(gb, name), stage))
    for name in WRAPPERS:
        if hasattr(kernels, name):
            setattr(kernels, name, timed(getattr(kernels, name), "wrapper"))
    entry = "fold_masked_many" if hasattr(gb, "fold_masked_many") else         "fold_masked"
    call = getattr(gb, entry)

    def masked(state, *a, **k):
        segs = len(a[0]) if entry == "fold_masked_many" else 1
        inside[0] = {}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t = time.perf_counter()
        out = call(state, *a, **k)
        total = (time.perf_counter() - t) * 1e3
        end.record()
        calls.append((segs, inside[0], total, start, end))
        inside[0] = None
        return out

    setattr(gb, entry, masked)
    # the trigger's walk over its buckets (the masks' numpy, the host-row
    # folds, and in a tree that folds there, its masked-fold calls)
    walk = node._refold_bucket

    def bucket(*a, **k):
        t = time.perf_counter()
        try:
            return walk(*a, **k)
        finally:
            buckets_ms[0] += (time.perf_counter() - t) * 1e3

    node._refold_bucket = bucket


buckets_ms = [0.0]
rng = np.random.default_rng(63)
stream = cs.SlidingStream(rng, cs.F_BATCHES)
mods = (plan_fused_rule, ColumnBatch, Trigger)
node, em, rps, launches, _ = cs.run_sliding(
    torch, kernels, mods, cs.D2_DELAY_RULE, stream, "f4",
    options=cs.REFOLD, impl="refold", sources=("device-async",),
    hold=cs.F4_HOLD, hook=hook)
torch.cuda.synchronize()
stalls = [st * 1e3 for _, _, st, _, _, _ in em]
segs = sum(c[0] for c in calls)
host = {}
for _, st, _, _, _ in calls:
    for k, v in st.items():
        host[k] = host.get(k, 0.0) + v
total = sum(c[2] for c in calls)
span = [c[3].elapsed_time(c[4]) for c in calls]
big = max(range(len(calls)), key=lambda i: calls[i][0]) if calls else None
masked = {k: v for k, v in launches.items() if "masked" in k}
rows["f4"] = dict(
    stall_p50_ms=cs.pct(stalls, 50), stall_p99_ms=cs.pct(stalls, 99),
    stall_max_ms=max(stalls), triggers=len(stalls), rows_per_s=rps,
    routes=dict(node.refold_counts), masked_calls=len(calls),
    masked_segments=segs, masked_launches=masked,
    call_host_ms=total / max(len(calls), 1),
    segment_host_ms=total / max(segs, 1),
    stage_ms_a_segment={k: v / max(segs, 1) for k, v in host.items()},
    other_ms_a_segment=(total - sum(host.values())) / max(segs, 1),
    device_span_ms=sum(span), refold_bucket_ms=buckets_ms[0],
    biggest_call=None if big is None else dict(
        segments=calls[big][0], host_ms=calls[big][2],
        stages_ms=calls[big][1], device_span_ms=span[big]))
print("ab_refold f4", rows["f4"], flush=True)
print(json.dumps(rows))
"""

COUNTMIN = r"""
import statistics
from ekuiper_tpu_torch.ops.sketches import CountMinSketch

dev = torch.device("cuda")
rows = cs.countmin_kernel_checks(torch, 0, kernels, dev)
m = cs.run_phase_m(torch, 0, kernels, CountMinSketch)
rows["m"] = dict(values_per_s=m["values_per_s"],
                 query_ms=statistics.median(m["query_ms"]),
                 launches={k: v for k, v in m["launches"].items() if v})
print(json.dumps(rows))
"""

JOIN = r"""
from ekuiper_tpu_torch.planner import relational
from ekuiper_tpu_torch.sql.parser import parse_select

dev = torch.device("cuda")
rows = {}
rng = np.random.default_rng(2000)
lo, hi = -cs.J_BAND, cs.J_BAND
for n in (cs.J1_ROWS, cs.J3_ROWS):
    (left, v), (right, w) = (cs.join_inputs(torch, rng, n, dev),
                             cs.join_inputs(torch, rng, n, dev))
    for tag, resid in (("resid", v[:, None] > w[None, :]), ("none", None)):
        call = functools.partial(kernels.join_match, *left, *right, lo, hi,
                                 resid)
        rows[f"join_match/{n}/{tag}"] = dict(
            ms=cs.time_ms(torch, call, cs.REPS),
            **cs.launch_split(torch, call, "join_match_kernel", cs.REPS))
    del left, right, v, w, resid
    torch.cuda.empty_cache()


def timed(fn, reps=3):
    walls, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return out, sorted(walls)[len(walls) // 2]


def byte_mask_stages(ring, lb, rb):
    # the stages of a match that returns the byte mask (the parent's)
    st = {}
    (sl, sr), st["slots"] = timed(lambda: (ring._slots(lb), ring._slots(rb)))
    (tl, tr), st["ts32"] = timed(lambda: ring._ts32(lb, rb))
    pl, pr = (1 << (n - 1).bit_length() for n in (lb.n, rb.n))

    def upload():
        return [ring._to_dev(np.pad(a, (0, p - len(a))))
                for a, p in ((sl, pl), (tl, pl), (np.arange(pl) < lb.n, pl),
                             (sr, pr), (tr, pr), (np.arange(pr) < rb.n, pr))]

    sides, st["upload"] = timed(upload)
    res, st["residual"] = timed(lambda: ring._residual_mask(lb, rb, pl, pr))
    mask, st["kernel"] = timed(lambda: kernels.join_match(
        *sides, ring.lo, ring.hi, res))
    host, st["copy"] = timed(lambda: mask[:lb.n, :rb.n].cpu())
    _, st["unpack"] = timed(lambda: np.count_nonzero(host.numpy()))
    _, st["match"] = timed(lambda: ring.match(lb, rb))
    return st


# one match's stages at J1's and J3's windows (J1's rule)
stmt = parse_select(cs.J_RULE.format(jt="INNER"))
ring = relational.lower_join(stmt, stmt.joins).build_ring()
for tag, n, seed in (("j1", cs.J1_ROWS, 3000), ("j3", cs.J3_ROWS, 3200)):
    r = np.random.default_rng(seed)
    lb, rb = cs.j_batches(cs.j_side(r, n), cs.j_side(r, n))
    ring.match(lb, rb)  # warm: the key table, the pinned buffer
    st = (cs.j3_stages(torch, kernels, ring, lb, rb)
          if hasattr(cs, "j3_stages") else byte_mask_stages(ring, lb, rb))
    rows[f"{tag}_stages"] = {f"{k}_ms": v for k, v in st.items()}
del ring
torch.cuda.empty_cache()

# phase J end to end, as chip_smoke.py runs it: J1's match leg, J2's rules
from ekuiper_tpu_torch.data.batch import ColumnBatch
from ekuiper_tpu_torch.planner.planner import plan_host_rule
from ekuiper_tpu_torch.runtime.node import Node

j = cs.run_phase_j(torch, 0, kernels, plan_host_rule, ColumnBatch, Node)
rows["j1"] = dict(rows_per_s=j["j1"]["rows_per_s"],
                  window_ms=2e3 * cs.J1_ROWS / j["j1"]["rows_per_s"])
for jt, r in j["j2"].items():
    rows[f"j2/{jt}"] = dict(p50_ms=r["p50"], p99_ms=r["p99"],
                            rows_per_s=r["rows_per_s"])
rows["j3"] = dict(match_ms=max(j["j3"]["match_ms"]),
                  match_min_ms=min(j["j3"]["match_ms"]))

# the unpack of packed masks at J2's, J1's and J3's widths (a density of
# J1's pairs) by the tree's unpack_mask, with tasks of 2^20 to 2^26 bits
# on its pool and on the calling thread alone (2^40), and the (i, j) pairs
# read straight from the packed words (what a join step without the
# unpack would need on the host)
try:
    from ekuiper_tpu_torch.ops import joinring
    unpack_mask = joinring.unpack_mask
except (ImportError, AttributeError):
    unpack_mask = None


def pairs_of(packed):
    w = packed.view(np.uint64)
    i, c = np.nonzero(w)
    bits = np.unpackbits(w[i, c].view(np.uint8).reshape(-1, 8), axis=1,
                         bitorder="little")
    k, b = np.nonzero(bits)
    return i[k], c[k] * 64 + b


r = np.random.default_rng(7)
for n in (256, cs.J1_ROWS, cs.J3_ROWS) if unpack_mask else ():
    packed = np.zeros((n, n // 8), dtype=np.uint8)
    hit = r.integers(0, n * n, n * n // 6000)
    np.bitwise_or.at(packed.reshape(-1), hit // 8,
                     (1 << (hit % 8)).astype(np.uint8))
    (pi, pj), pairs_ms = timed(lambda: pairs_of(packed), 5)
    rows[f"pairs/{n}"] = dict(pairs_ms=pairs_ms, hits=len(pi))
    kept = joinring.UNPACK_TASK_BITS
    for log2 in (20, 22, 24, 26, 40):
        joinring.UNPACK_TASK_BITS = 1 << log2
        (mask, hits), ms = timed(lambda: unpack_mask(packed, n), 5)
        assert hits == len(pi) and mask[pi, pj].all()
        rows[f"unpack/{n}/2^{log2}"] = dict(unpack_ms=ms)
        del mask
    joinring.UNPACK_TASK_BITS = kept
print(json.dumps(rows))
"""

MERGE = r"""
from ekuiper_tpu_torch.ops import sketches
from ekuiper_tpu_torch.ops.groupby import TorchGroupBy
from ekuiper_tpu_torch.planner.fused import plan_fused_rule

dev = torch.device("cuda")
rows = cs.sharded_kernel_checks(torch, 0, kernels, sketches, plan_fused_rule,
                                TorchGroupBy, dev)
print(json.dumps({k: v for k, v in rows.items()
                  if k.startswith("shard_merge")}))
"""

HOST = r"""
import statistics
from ekuiper_tpu_torch.data.batch import ColumnBatch
from ekuiper_tpu_torch.planner.fused import plan_fused_rule

batches, _, _ = cs.make_batches(np.random.default_rng(0), ColumnBatch, 16)
node = plan_fused_rule(cs.TUMBLING, key_slots=cs.SLOTS, micro_batch=cs.ROWS,
                       options=cs.SYNC)
node.broadcast = lambda item: None
calls, fold = [], node.gb.fold
node.gb.fold = lambda *a, **k: (calls.append((a, k)), fold(*a, **k))[1]
for b in batches:
    node.process(b)
torch.cuda.synchronize()
a, k = calls[-1]
idle = []
for _ in range(300):
    torch.cuda.synchronize()
    t = time.perf_counter()
    fold(*a, **k)
    idle.append((time.perf_counter() - t) * 1e3)
torch.cuda.synchronize()
t = time.perf_counter()
for _ in range(300):
    fold(*a, **k)
torch.cuda.synchronize()
b2b = (time.perf_counter() - t) / 300 * 1e3
proc = []
for _ in range(3):
    t = time.perf_counter()
    for b in batches:
        node.process(b)
    torch.cuda.synchronize()
    proc.append((time.perf_counter() - t) / len(batches) * 1e3)
print(json.dumps(dict(fold_idle_ms=statistics.median(idle), fold_b2b_ms=b2b,
                      process_ms=statistics.median(proc))))
"""

PHASES = {"tumbling": (TUMBLING, 600), "multirule": (MULTIRULE, 1500),
          "fold": (FOLD, 600), "host": (HOST, 600), "tier": (TIER, 900),
          "sketch": (SKETCH, 900), "trace": (TRACE, 900),
          "refold": (REFOLD, 900), "countmin": (COUNTMIN, 600),
          "join": (JOIN, 600), "merge": (MERGE, 600)}
#: the numbers of a multirule or fold row the summary keeps
KEYS = ("chunk_ms", "ms", "fold_only_ms", "readback_ms", "scalar_pane_ms",
        "body_ms", "launches_a_chunk", "kernels_a_call", "one_row_ms",
        "merge_only_ms", "bound_all_rows_ms", "equal", "panes",
        "host_ms", "plain_ms", "library_ms", "library_idx_ms", "bound_ms",
        "bound_inputs_ms", "kernel_rounds_ms", "library_rounds_ms",
        "idle_ms", "idle_body_ms", "b2b_ms", "b2b_body_ms", "ms_again",
        "segments", "stall_p50_ms", "stall_p99_ms",
        "stall_max_ms", "masked_calls", "masked_segments", "call_host_ms",
        "segment_host_ms", "device_span_ms", "refold_bucket_ms",
        "values_per_s", "query_ms", "slots_ms", "ts32_ms", "upload_ms",
        "residual_ms", "kernel_ms", "copy_ms", "unpack_ms", "unpack_1t_ms",
        "match_ms", "match_min_ms", "window_ms", "p50_ms", "p99_ms",
        "rows_per_s", "pairs_ms")


def _fmt(v) -> str:
    return (" ".join(f"{x:.4f}" for x in v) if isinstance(v, list)
            else f"{v:.4f}")


def summary(phase: str, label: str, res: dict) -> dict:
    """Print one run's headline and return what the last line keeps."""
    if phase == "tumbling":
        print(f"{label}: rows/s={res['rows_per_s']:.0f} "
              f"encode_ms={res['encode_ms']:.3f} fold_ms={res['fold_ms']:.3f}"
              f" emit_p50_ms={res['emit_p50_ms']:.3f} emit_p99_ms="
              f"{res['emit_p99_ms']:.3f}", flush=True)
        return res
    if phase == "host":
        print(f"{label}: " + " ".join(f"{k}={v:.4f}" for k, v in res.items()),
              flush=True)
        return res
    head = {name: {k: row[k] for k in KEYS if row.get(k) is not None}
            for name, row in res.items()}
    for name in sorted(head):
        print(f"{label} {name}: " + " ".join(
            f"{k}={_fmt(v)}" for k, v in head[name].items()), flush=True)
    return head


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("a", help="checkout A (the parent)")
    ap.add_argument("b", help="checkout B (the change)")
    ap.add_argument("--phase", choices=sorted(PHASES), default="tumbling",
                    help="the rows to run (default: tumbling)")
    ap.add_argument("--windows", type=int, default=6,
                    help="tumbling: windows of 16 batches of 65,536 rows a "
                         "run")
    ap.add_argument("--out", help="directory for each run's result (JSON)")
    args = ap.parse_args()
    code, limit = PHASES[args.phase]
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    out = {"a": [], "b": []}
    for i, tag in enumerate(("a", "b", "b", "a")):
        root = os.path.abspath(getattr(args, tag))
        res = subprocess.run(
            [sys.executable, "-c", PRELUDE + code, str(args.windows),
             os.path.abspath(args.b)],
            cwd=root, capture_output=True, text=True, timeout=limit)
        if res.returncode:
            print(res.stdout[-8000:] + res.stderr[-8000:], file=sys.stderr)
            return res.returncode
        result = json.loads(res.stdout.strip().splitlines()[-1])
        if args.out:
            with open(os.path.join(args.out, f"ab_{args.phase}_{tag}{i}.json"),
                      "w") as f:
                json.dump(result, f)
        out[tag].append(summary(args.phase, f"{tag}{i} {root}", result))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
