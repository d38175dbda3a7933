#!/usr/bin/env python3
"""Proof on one CUDA card that the PyTorch/CUDA port (ekuiper_tpu_torch)
builds, runs its main path and gives right answers.

Run from the repository root on a machine with a card:

    python3 chip_smoke.py [--seed 0]

Phases (each prints its own lines; any failure exits non-zero and prints
no result):

1. the card (nvidia-smi name and power limit) and the kernels' build time
   (csrc/groupby.cu, csrc/sketches.cu, csrc/prefinalize.cu,
   csrc/slidingring.cu, csrc/multirule.cu, csrc/tierstore.cu,
   csrc/relational.cu, csrc/countmin.cu and csrc/sharded.cu, one nvcc
   each for sm_90a, run together);
2. each kernel against its plain PyTorch version on the card, at the main
   path's shapes (65,536 rows, 16,384 slots; the one-launch fold #1 as the
   node calls it on each rule (tumbling, hopping, the sketch rules, a rule
   with hh, hll and hist columns together), each of its branches on its
   own, and a profiler trace that shows one kernel launch a chunk for
   every mix of columns, on one chip and on the mesh; the sketch kernels at the
   sketch rules' state, up to 2 panes x 16,384 x 2,688 floats; the
   components merge and the absorb at the phase C rules' state, up to
   16,384 x 1,028 floats; the sliding ring's advance, flip and query and
   the folds with a per-row pane vector at the phase D rules' state, up
   to 53 panes x 16,384 x 1,026 floats; the rule group's fold, finalize
   and reset at E1's 256 rules x 16,384 slots, the fold also on
   Zipf-skewed slots and on one slot taking every row and timed as the
   node calls it (its row order built in the call) and alone on a given
   order, the row order against its plain version (rows and offsets
   equal), the finalize also at E3's two panes; the masked fold at
   phase F's batches, a 65,536-row padded batch with uint16 slots under
   a refold's row mask, into each rule's scratch pane at its own pane
   count, F1's 53 x 16,384 x 2,688 floats, one kernel a call with act,
   the scalar and the wide columns, and at F2's plan a stale refold's
   group of 21 such segments in one launch;
   the tier demote and promote at G1's state (1 pane, a 4-float packed
   row, 1,048,576 slots), G2's (10 panes, 60 floats, 262,144 slots), phase
   B's hll hopping state and the percentile hist, a block of 2,000 real
   slots and 48 pad rows; the fold's touch column at G1's state; the
   sketch group's wide fold, wide finalize and pane reset at H5's two
   63-rule families, 16,384 slots: hll on two hopping panes, 2.1 GB of
   registers, and the percentile on one tumbling pane, 4.2 GB of bins;
   the wide fold bit-equal to its plain version, the wide finalize's hll
   bit-equal and its percentile within 4 ulp; the group folds with a
   per-row pane vector, a batch across a bucket edge, at I5's shape (E1's
   256 rules on 4 event-time panes) and I6's (the hll family on 5 panes,
   5.3 GB of registers): n, act, min, max and the registers bit-equal, s1
   and s2 within rtol 1e-5, a constant vector equal to the scalar pane,
   timed with the vector's bound from the host (as the node calls them)
   and without it (the read-back, readback_ms), beside the scalar pane;
   the relational tier's join match at 2,048 and 16,384 rows a side (J1's
   and J3's windows, bit-equal), segmented shift at 8,192 and 131,072
   rows over 10,000 slots and at 131,072 rows in one slot (row numbers,
   lag, flags and the carry exact, running sums rtol 1e-5) and segmented
   sort at 65,536 rows over 10,000 segments and in one (all exact); the
   masked fold's touch branch at D2's refold plan with a touch column,
   16,384 slots, a 65,536-row cached batch under one bucket's time cut
   (touch, counts, act, min and max bit-equal, s1 within rtol 1e-5); the
   count-min update at 65,536 values into (4, 8192) counts, on phase M's
   stream and on a uniform one, and its query at
   4,096 and 8,192 candidates (bit-equal)):
   error, kernel time (CUDA
   events), the kernel body's own device time (profiler trace) and the
   host time of one wrapper call, plain time, a library yardstick (for
   the wide folds also with its index build, library_idx_ms) and the
   bytes/operations bound (#15's over its inputs and the touched state
   sectors, counted from the batch, beside the inputs-only one,
   bound_inputs_ms);
3. end to end, tumbling: the flagship rule
   `SELECT deviceId, avg(temperature), count(*), min(temperature),
   max(temperature) FROM demo GROUP BY deviceId, TUMBLINGWINDOW(ss, 10)`
   over 10,000 device keys, temperature ~ N(20, 5), 65,536-row batches,
   every emitted row held against an independent numpy float64 group-by;
4. end to end, hopping: the same with HOPPINGWINDOW(ss, 10, 5) and
   stddev(temperature);
A. heavy hitters (BASELINE config #2, bench.py:459):
   `SELECT deviceId, heavy_hitters(code, 3) AS top, count(*) AS c FROM demo
   GROUP BY deviceId, HOPPINGWINDOW(ss, 10, 5)` over 10,000 keys, skewed
   codes (7 at 35 %, 13 at 20 %, 99 at 15 %, a 2,000-value tail), 65,536-row
   batches, 9 hop boundaries; the state grows from 2,048 to 16,384 slots;
   every emitted top list held against an independent numpy twin of the
   sketch (its own dictionary, fold, recovery, dedupe and trim);
B. the wide finalize: bench.py:1623 (`stddev` + `percentile_approx
   (temperature, 0.9)`, tumbling) and bench.py:1626 (`hll(humidity)`,
   hopping), every emitted value held against numpy twins of the bins and
   registers (the percentile in the same bin, hll within ±1), and the
   sketches' error against exact quantiles and distinct counts printed;
   (phases 3, 4, A and B plan with prefinalizeLeadMs 0, the synchronous
   boundary, and drive on_trigger by hand);
C. the boundary as the reference runs it by default (prefinalizeLeadMs
   250, tailMode device, the tumbling backstop): each rule opened on the
   mock clock, whose timers fire the pre-triggers and boundaries, with
   two of every 16 batches in a window's tail. C1 the flagship tumbling
   rule three times (backstop on; backstop off, where every boundary must
   be served by its device fetch; tailMode host with a snapshot inside
   the frozen span, whose absorbed partials must equal a lead-0 twin's),
   C2 the hopping stddev rule (every other window's pre-issue held on the
   card past its boundary, so the emit worker delivers it), C3 the
   percentile and hll rules, C4 the heavy-hitters rule on the async emit.
   Every emitted row is held against the same references as phases
   3/4/A/B; any boundary served by a recovery route fails the run. Per run:
   rows/s, the boundary's stall on the fold thread, delivery latency, the
   fetches' copy time and size, shadow fold time, boundaries by source;
D. SLIDINGWINDOW rules on the DABA ring, each opened on the mock clock
   at full size and fed the BASELINE ingest rate: 65,536-row batches of
   62.5 ms of stream each (16 a second), row timestamps rising evenly
   across the batch, temperature ~ N(20, 5), a trigger row (temperature
   99 at a random row) in every 20th batch. D1 BASELINE config #3
   (bench.py:268-282), `percentile_approx(temperature, 0.99)` +
   `count(*)` over `SLIDINGWINDOW(ss, 10) OVER (WHEN temperature > 44.5)`,
   720 batches (45 s, so that the ring's periodic re-anchor, which needs
   ~655, falls in it; checked); D2 avg/min/max/count of temperature on
   the same window, 480 batches with one 12 s gap; D2 delay, the same
   rule on SLIDINGWINDOW(ss, 10, 1) (the timer route); D3 `hll(humidity)`
   on the coarsened ring, 240 batches. Every emitted window is held
   against a numpy reference over exactly the rows in (t - L, t + delay]
   the node had received: the float64 group-by (D2), the percentile
   twin's bin (D1), hll within ±1 (D3). Per rule: rows/s, the trigger's
   stall on the fold thread, the delivery, triggers by route and flips;
E. rule groups (BASELINE config #5), each group one node opened on the
   mock clock with its default boundary. E1, bench.py:197-246: 256 rules
   `SELECT deviceId, avg(temperature) AS a, count(*) AS c FROM demo
   WHERE temperature > {10.0 + 0.1 r} GROUP BY deviceId,
   TUMBLINGWINDOW(ss, 10)`, 10,000 keys, 16,384 slots, 65,536-row batches,
   temperature ~ N(20, 5), 16 batches a window, 4 windows (the tumbling
   group's boundaries on the emit worker); E2, bench.py:1595-1666: the
   four families fa, fb, fc, fd (63 rules each: avg/count, min/max,
   sum/stddev, count/avg under a `<` WHERE), one node each fed the same
   32,768-row micro-batches of 4,096 keys, temperature N(20, 5) and
   humidity N(50, 15) rounded to 2 decimals, pressure U(0, 1) rounded to
   3, 2 windows (the bench's four solo rules and its shared-source
   subtopology are out of scope); E3: E1's rules on HOPPINGWINDOW(ss, 10,
   5), 4 slides (the synchronous group emit over two panes). Every rule's
   every window is held against an independent numpy float64 group-by
   over the rows passing that rule's WHERE, compared in float32. Per run:
   rows/s and rule-rows/s, the fold kernel's time per batch, the
   boundary's stall on the fold thread, delivery p50/p99, the stacked
   result's size and its copy time;
F. the sliding refold path (slidingImpl "refold" and the cases that fall
   back to it) on phase D's stream, 240 batches a run, each opened on the
   mock clock: F1 `SELECT deviceId, heavy_hitters(code, 3) AS top FROM
   demo GROUP BY deviceId, SLIDINGWINDOW(ss, 10) OVER (WHEN temperature >
   44.5)` over phase A's skewed codes (state 2,048 -> 16,384 slots; the
   synchronous finalize and host dedupe), every top list against a numpy
   twin of the sketch over exactly (t - 10 s, t]; F2 D2's rule under
   slidingImpl "refold" with the 12 s gap half-way, every window against
   the float64 twin and against the DABA ring's window of the same
   trigger (a second run on the same stream); F3 D3's hll rule with
   slidingDevRingMb 48, under its ring's ~201 MB, so it falls back, and
   the device batch cache (capped by the same budget) holds less than a
   window: triggers refold edges from cached batches and from host rows
   (both must run), hll within ±1; F4 D2's delayed rule under refold
   through a backlog (the 26 batches after batch 179's trigger row folded
   with the engine clock held, so its pending window's panes are recycled
   before its timer fires): that window refolds whole from the cache (the
   stale route must run), every window against the float64 twin over
   (t - 10 s, t + 1 s]. Per run: rows/s, stall and delivery,
   refold routes (cached, host, stale, evicted), the masked fold's
   launches, its calls, their segments and segment groups, each call one
   launch a group (F4's stale refold more segments than launches);
G. tiered key state (the tier's budget from tierHotMb), each run with
   every emitted window (the device groups and the spilled keys' share)
   held against a numpy float64 group-by over integer key ids: keys,
   counts and min exact, sums within the float32 bound. G1, the
   reference's key-cardinality bench (bench.py:690-858): first its
   sub-budget parity segment (the tier at 0.01 MB against the untiered
   rule, 4,096 slots, 1,000 keys, 8,192-row batches, 3 windows: keys and
   counts byte-identical, the sums within the bound, their differing bits
   counted, since float atomics fix no order between two runs); then
   `SELECT deviceId, sum(v) AS s, count(*) AS c FROM demo GROUP BY
   deviceId, TUMBLINGWINDOW(ss, 1)` at tierHotMb 64, 1<<20 key slots,
   tierScanMs 1, the synchronous boundary: 65,536-row batches of 63,488
   rows over 262,144 hot keys and 2,048 fresh keys, v ~ N(50, 10), a
   boundary every 4 batches, to 2,000,000 distinct keys (the bench's 1M
   checkpoint; its 3M and 10M ones cut to 2M for time), the device slots held
   at the layout's hot capacity (2,097,152, one growth from 1,048,576).
   G2, the reference's tier tests' rule `SELECT deviceId, sum(v) AS s,
   count(*) AS c, min(v) AS mn FROM demo GROUP BY deviceId,
   HOPPINGWINDOW(ss, 10, 1)` at tierHotMb 64 (a hot target of 137,518
   slots): 240 batches of 57,344 rows over 65,536 hot keys, 2,048 new keys
   and 6,144 rows over the keys first seen 4-9 slides earlier, 4 batches
   a 1 s slide; G2a on the synchronous boundary, G2b on the default one
   on the mock clock, whose keys back in a window's tail after its
   pre-issue carry their tail rows only in that window (the reference's
   rule, ROADMAP Queue 3), counted, and otherwise equal G2a's windows.
   Per run: rows/s, host encode time, emit or stall and delivery, device
   slots, demoted / promoted / recycled keys, cold rows and host-store
   MB, the tier kernels' launches;
H. the non-time windows and the sketch rule groups, each run from its
   own launch counts. H1, BASELINE config #4 (bench.py:540-600):
   `SELECT deviceId, hll(uid) AS uniq FROM demo GROUP BY deviceId,
   COUNTWINDOW(2097152)` at 1<<20 slots on the default boundary (the
   count window's finalize delivered by the emit worker): 32 distinct
   65,536-row batches of ids drawn from 1M (uid in [0, 5M), ~878k
   distinct keys), cycled for 3 windows, every key's estimate within ±1 of
   a numpy register twin (a sort and maximum.reduceat); rows/s, host
   encode ms a batch, delivery p50/p99 and distinct keys. H2, E2's count
   rule (bench.py:1628-1629) on 50,000-row batches (window edges inside
   batches), 10,000 keys, then EOF: counts and max exact. H3, the
   reference's session rule `SESSIONWINDOW(ss, 10, 2)` (count, avg) on
   the mock clock: bursts ended by gaps and one past the 10 s cap, each
   session against the float64 twin over exactly its batches. H4,
   `STATEWINDOW(st = 1, st = 0)` with st toggling at random rows (windows
   inside a batch and across batches, both required). H5, E2's two solo
   sketch rules (bench.py:1622-1627) as 63-rule families with E2's
   WHERE-step pattern: hll(humidity) WHERE temperature > {14.0 + 0.05 r}
   on HOPPINGWINDOW(ss, 10, 5), and stddev + percentile_approx(
   temperature, 0.9) WHERE humidity > {30.0 + 0.1 r} on
   TUMBLINGWINDOW(ss, 10); 10,000 keys, 16,384 slots, 16 batches a window,
   3 windows each, every rule's every window against per-rule twins (hll
   ±1, the percentile in the twin's bin or one over within D_EDGE, stddev
   within the float32 bound); rows/s, rule-rows/s, the fold kernels' ms a
   batch, stall and delivery. H6, H3's rule as a 63-rule session group
   (WHERE v > {10.0 + 0.25 r}) on H3's stream, every rule's every
   session against the float64 twin;
I. event time, each rule fed through the port's WatermarkNode entry
   (plan_fused_rule with isEventTime, lateTolerance 1000 ms; a group built
   at the node behind its WatermarkNode): 65,536-row batches over 10,000
   keys, 16,384 slots, batch i stamped 5 s + i s, each row plus U(-1200,
   300) ms and 1 % of rows a further 3 s late. I1 bench.py:2889-2944's
   bench_event_time: the flagship rule, every row of batch i at i s
   (single-bucket batches, the scalar pane); I2 the flagship rule on the
   disordered stream (the watermark node drops the late rows; batches
   across a 10 s edge take the pane vector); I3 the flagship rule on
   HOPPINGWINDOW(ss, 10, 2) (8 panes); I4 the reference's event-time
   session rule SESSIONWINDOW(ss, 30, 5) with an 8 s gap every 20 batches
   (sessions closed by watermarks, the rest at EOF); I5 E1's 256 rules as
   an event-time group; I6 H5's 63-rule hll family as an event-time group
   on HOPPINGWINDOW(ss, 10, 5); I7 G2's tiered rule (tierHotMb 64),
   stamped by slide, with demotions and promotions. Every window against
   an independent numpy float64 twin of event-time semantics: the
   watermark node's drop, a window emitted with the batch whose watermark
   first passes its end (or at EOF), its rows those kept with a time in
   it (groups: past each rule's WHERE; hll within ±1; I7: the device and
   spilled keys together). Per run: rows/s (and rule-rows/s), the
   watermark node's host ms a batch, emit p50/p99 of a watermark-driven
   window, rows dropped by the watermark node and by the fold, pane-vector
   against scalar-pane folds, launches;
J. interval joins (bench.py:2500-2598 bench_join_heavy: 512 keys, times
   uniform on [0, 60,000) ms, band ±5,000 ms, residual l.v > r.w): J1 the
   match leg, 40 JoinRing.match calls cycling 4 windows of 2,048 rows a
   side, every mask against an independent numpy twin; J2 the rule
   `SELECT l.v, r.w FROM l {INNER|LEFT|FULL} JOIN r ON ...
   GROUP BY TUMBLINGWINDOW(ss, 10)` through plan_host_rule, 40 windows of
   256 rows a side on the mock clock, every window's rows against a
   Python nested loop in the reference's emission order; J3 J1's rule at
   16,384 rows a side (a 268 MB mask, packed to 33.5 MB on the card),
   its kernel time beside its bound and the host ms of each stage of a
   match;
   0 fallback windows everywhere. Per run: match rows/s and pairs a
   window, window p50/p99, match ms;
K. analytics over the flagship stream (10,000 devices): K1 `lag(
   temperature) OVER (PARTITION BY deviceId)`, 16 batches of 8,192 rows,
   every prev against the previous value per device across batches; K2
   rank / dense_rank / lead of temperature on TUMBLINGWINDOW(ss, 10)
   windows of 65,536 rows (values in halves, float32-exact), every value
   against scipy.stats.rankdata (min / dense) within devices and the next
   row's value. Per run: rows/s and continued partitions, window ms;
L. tiered sliding rules: D2's rule at 262,144 key slots under tierHotMb
   350 (a hot target of 82,956 slots, the state at its hot capacity of
   131,072) and tierScanMs 500, fed a churning fleet on the mock clock:
   640 batches of 65,536 rows, 62.5 ms each, 49,152 rows over 10,000
   steady keys and 16,384 over the current cohort of 8,192 new keys (a new
   cohort every 2 s, silent for good after it; 173,840 distinct keys).
   L1 on the DABA ring, L2 on the refold path (its edge refolds bump the
   touch column through the masked fold). Every window against the
   float64 twin over exactly (t - 10 s, t] (L1's sums also within the
   bound of the ring's running totals, which add and subtract pane sums
   since their last rebuild: a key whose window has thinned out reads the
   residue of its earlier rows, ROADMAP Queue 3), the two paths' windows
   of each trigger with equal keys, counts, min and max; the state never
   grows past the
   hot capacity; keys are demoted (pure slot recycles: demoted = recycled
   + promoted + requeued), at least 10 triggers after the first
   demotion, no recovery route. Per run: rows/s, stall, delivery, tier
   counters, routes, launches;
M. the count-min sketch, `CountMinSketch(depth=4, width=8192,
   max_candidates=4096)` on the card: 64 updates of 65,536 values of
   phase A's mix with the tail widened to [100, 20,100) (the candidate
   map saturates), heavy_hitters(3) after every 16th; counts bit-equal to
   a numpy twin (the same hash, np.add.at), the candidate map and the
   hitters equal to the twin's host logic on its counts, top 3 {7, 13,
   99}, no estimate under its true count. Update values/s and
   heavy_hitters ms;
N. the device mesh (#23, #24) on a 2x4 mesh whose eight devices are the
   card (`device=["cuda"] * 8`, planOptimizeStrategy.mesh): first its
   kernels at the main path's shapes, sharded_fold (the flagship rule with
   a touch column; I3's rule on its 8-pane vector; phase B's percentile
   and hll rules, each branch also on its own) and shard_merge of each,
   against their plain versions (the fold's sums rtol 1e-5,
   everything else and the merge of the same partials bit-equal) and the
   fold + merge against #1's single-chip fold of the same batch, timed as
   phase 2 times its kernels (the merge's partials restored before each
   run, outside the interval); N1 the flagship tumbling rule on 2x4 and,
   beside it, single-chip, on phase 3's shape (6 windows of 16 batches),
   every window against the float64 twin and the two legs against each
   other, rows/s and emit p50/p99 of each leg, the mesh leg's 96 sharded
   folds and merges and no #1 fold, shard_stats; N2 N1's batches, windows
   1-3 on 2x4, a snapshot restored single-chip for window 4, its snapshot
   restored on shards 8 (1x8) for windows 5-6, every window against the
   twin and N1's; N3 phase B's rules on 2x4 (3 windows each, cut for
   time) against their twins; N4 I3 on 2x4 through the watermark entry
   (the sharded pane vector must fold), every window against its twin;
   N5 D2's sliding rule on 2x4 (160 batches, cut for time): the refold
   path with sliding_fallback "sharded_kernel", edge refolds from host
   rows (no masked fold), every window against D2's twin; then a rule
   planned with shards "auto" on the default device list (single-chip on
   one card, with its reason);
5. each kernel's launch count on the paths that use it (each must be
   > 0; the fold's touch branch on the G paths, I7, L1 and L2; the masked
   fold's on L2; the per-row pane vector on the sliding paths and I2, I3,
   I5, I6, and the sharded one on N4), then the JSON kernel table
   (twenty-six kernels: the 25 that replace the reference's programs and
   the rule group's row order) and the one-line result.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np

TUMBLING = (
    "SELECT deviceId, avg(temperature) AS avg_t, count(*) AS cnt, "
    "min(temperature) AS min_t, max(temperature) AS max_t "
    "FROM demo GROUP BY deviceId, TUMBLINGWINDOW(ss, 10)"
)
HOPPING = (
    "SELECT deviceId, avg(temperature) AS avg_t, count(*) AS cnt, "
    "min(temperature) AS min_t, max(temperature) AS max_t, "
    "stddev(temperature) AS sd_t "
    "FROM demo GROUP BY deviceId, HOPPINGWINDOW(ss, 10, 5)"
)
#: the main path's sizes (bench.py's 10k-device tumbling GROUP BY)
N_KEYS, ROWS, SLOTS = 10_000, 65_536, 16_384
HH_RULE = (
    "SELECT deviceId, heavy_hitters(code, 3) AS top, count(*) AS c "
    "FROM demo GROUP BY deviceId, HOPPINGWINDOW(ss, 10, 5)"
)
PCT_RULE = (
    "SELECT deviceId, stddev(temperature) AS sd, percentile_approx"
    "(temperature, 0.9) AS p90 FROM demo "
    "GROUP BY deviceId, TUMBLINGWINDOW(ss, 10)"
)
HLL_RULE = (
    "SELECT deviceId, hll(humidity) AS u FROM demo "
    "GROUP BY deviceId, HOPPINGWINDOW(ss, 10, 5)"
)
#: emitted windows per end-to-end phase, 65,536-row batches per trigger
#: interval, timed runs per kernel
WINDOWS, BATCHES, REPS = 6, 16, 30
#: phases A and B: hop boundaries / windows, and batches per interval
#: (bench.py's heavy-hitters rule: one boundary per 16 batches)
SKETCH_WINDOWS, SKETCH_BATCHES = 9, 16
#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 (non-tensor)
#: operations/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
EPS32 = float(np.finfo(np.float32).eps)
#: elements of a state component state_err compares at a time
STATE_ERR_CHUNK = 1 << 27
#: the synchronous boundary (prefinalizeLeadMs 0): phases 3, 4, A and B
#: measure the finalize route as they did before phase C existed
SYNC = {"prefinalizeLeadMs": 0}
#: phase D: the sliding rules (D1 is BASELINE config #3, bench.py:268-282)
TRIGGER = "OVER (WHEN temperature > 44.5)"
D1_RULE = ("SELECT deviceId, percentile_approx(temperature, 0.99) AS p99, "
           "count(*) AS c FROM demo GROUP BY deviceId, SLIDINGWINDOW(ss, 10) "
           + TRIGGER)
D2_RULE = ("SELECT deviceId, avg(temperature) AS avg_t, count(*) AS cnt, "
           "min(temperature) AS min_t, max(temperature) AS max_t FROM demo "
           "GROUP BY deviceId, SLIDINGWINDOW(ss, 10) " + TRIGGER)
D2_DELAY_RULE = D2_RULE.replace("SLIDINGWINDOW(ss, 10)",
                                "SLIDINGWINDOW(ss, 10, 1)")
D3_RULE = ("SELECT deviceId, hll(humidity) AS u FROM demo GROUP BY deviceId, "
           "SLIDINGWINDOW(ss, 10) " + TRIGGER)
#: batches per run, the trigger every 20th batch, the gap in D2
D_BATCHES = {"d1": 720, "d2": 480, "d2_delay": 240, "d3": 240}
#: phase F: the sliding refold path on phase D's stream. F1: the
#: heavy_hitters sliding rule (the refold fallback); F2: D2's rule under
#: slidingImpl "refold", with the 12 s gap half-way; F3: D3's hll rule
#: with a slidingDevRingMb too small for its ring (~201 MB at 16,384
#: slots), which also caps the device batch cache (~128 batches of 384 KB
#: at 48 MB, under the ~160 batches a window spans), so later triggers
#: refold their low edge from host rows
F1_RULE = ("SELECT deviceId, heavy_hitters(code, 3) AS top FROM demo "
           "GROUP BY deviceId, SLIDINGWINDOW(ss, 10) " + TRIGGER)
F_BATCHES, F_GAP_AT, F3_RING_MB = 240, 120, 48
#: F4's backlog: the 26 batches (1.625 s of stream) after the trigger row
#: of batch 179, folded with the engine clock held. With 78 ms buckets and
#: R = 145 ring panes, rows past about t + 1.4 s recycle a pane inside the
#: pending window (t - 10 s, t + 1 s]; the row ring keeps a bucket until
#: the newest is R + 8 buckets past it, so a backlog past about t + 1.9 s
#: would drop the window's oldest rows before its refold (the reference
#: does the same; ROADMAP Queue 3)
F4_HOLD = range(180, 206)
REFOLD = {"slidingImpl": "refold"}
TRIGGER_EVERY, GAP_AT, GAP_MS = 20, 360, 12_000
#: stream time per 65,536-row batch: 125/2 ms (16 batches a second)
BATCH_MS_NUM, BATCH_MS_DEN = 125, 2
#: the stream's first row time: off the bucket grid, so that batches cross
#: bucket edges on every ring (D3's 1,250 ms buckets hold exactly 20
#: batches, which a start on the grid would never cross)
T0_MS = 100_031
#: phase D1's near-edge band of the percentile twin, in bin positions: the
#: float32 position of the reference's compiled arithmetic (and the
#: port's) is within ~4.4e-5 of the float64 one at |x| ~ 20 (c / lo
#: rounded: 6e-7; logf's ulp at ~24: 2e-5; the float32 1/log_gamma: 1.5e-5;
#: the product's rounding: 7.6e-6). Over D1's 580,000 percentiles a value
#: 1.04e-5 from an edge was binned one over, past the 1e-5 band that
#: phases B and C keep.
D_EDGE = 5e-5
#: phase E: rule groups. E1 is BASELINE config #5 (bench.py:197-246): 256
#: rules, rule r keeping temperature > 10.0 + 0.1 r
E1_SQL = ("SELECT deviceId, avg(temperature) AS a, count(*) AS c FROM demo "
          "WHERE temperature > {x} GROUP BY deviceId, {window}")
E1_RULES, E1_BASE, E1_STEP = 256, 10.0, 0.1
E_TUMBLING, E_HOPPING = "TUMBLINGWINDOW(ss, 10)", "HOPPINGWINDOW(ss, 10, 5)"
#: E2: the four rule families of bench.py:1595-1610, 63 rules each
#: (name, SQL, first threshold, step)
E2_FAMILIES = (
    ("fa", "SELECT deviceId, avg(temperature) AS a, count(*) AS c "
           "FROM sensors WHERE temperature > {x} "
           "GROUP BY deviceId, TUMBLINGWINDOW(ss, 10)", 14.0, 0.05),
    ("fb", "SELECT deviceId, min(pressure) AS mn, max(pressure) AS mx "
           "FROM sensors WHERE pressure > {x} "
           "GROUP BY deviceId, TUMBLINGWINDOW(ss, 10)", 0.4, 0.002),
    ("fc", "SELECT deviceId, sum(humidity) AS s, stddev(humidity) AS sd "
           "FROM sensors WHERE humidity > {x} "
           "GROUP BY deviceId, TUMBLINGWINDOW(ss, 10)", 30.0, 0.1),
    ("fd", "SELECT deviceId, count(*) AS c, avg(pressure) AS ap "
           "FROM sensors WHERE temperature < {x} "
           "GROUP BY deviceId, TUMBLINGWINDOW(ss, 10)", 26.0, 0.05),
)
#: E2's rules a family, keys and rows a micro-batch (bench.py:1620, 1650)
E2_RULES, E2_KEYS, E2_ROWS = 63, 4096, 32_768
#: per family: the WHERE column and comparison, and each output column's
#: aggregate and argument (what the numpy twin recomputes)
E_TWIN = {
    "e1": ("temperature", ">", {"a": ("avg", "temperature"),
                                "c": ("count", None)}),
    "e3": ("temperature", ">", {"a": ("avg", "temperature"),
                                "c": ("count", None)}),
    "fa": ("temperature", ">", {"a": ("avg", "temperature"),
                                "c": ("count", None)}),
    "fb": ("pressure", ">", {"mn": ("min", "pressure"),
                             "mx": ("max", "pressure")}),
    "fc": ("humidity", ">", {"s": ("sum", "humidity"),
                             "sd": ("stddev", "humidity")}),
    "fd": ("temperature", "<", {"c": ("count", None),
                                "ap": ("avg", "pressure")}),
    # phase H: the sketch families (their sketches are checked apart) and
    # the session group
    "h5_hll": ("temperature", ">", {}),
    "h5_pct": ("humidity", ">", {"sd": ("stddev", "temperature")}),
    "h6": ("v", ">", {"c": ("count", None), "a": ("avg", "v")}),
}
#: windows per phase E run (E1 tumbling, E2 tumbling, E3 hop slides)
E_WINDOWS = {"e1": 4, "e2": 2, "e3": 4}
#: phase G: tiered key state. G1 is the reference's key-cardinality bench
#: (bench.py:690-858): a tumbling 1 s sum/count GROUP BY under a fixed
#: 64 MB budget (the bench's default), 1<<20 key slots, a 1 ms scan, the
#: synchronous boundary; its parity segment first (the tier at 0.01 MB on
#: 4,096 slots against the untiered rule, 1,000 keys, 8,192-row batches,
#: 3 windows). G2 is the reference's tier tests' rule
#: (tests/test_tierstore.py:21-22, tools/probe_tiering.py:34-35) on ten
#: panes, so keys demoted a few boundaries after their last row still hold
#: live panes: G2a on the synchronous boundary, G2b on the default one
G1_RULE = ("SELECT deviceId, sum(v) AS s, count(*) AS c FROM demo "
           "GROUP BY deviceId, TUMBLINGWINDOW(ss, 1)")
G2_RULE = ("SELECT deviceId, sum(v) AS s, count(*) AS c, min(v) AS mn "
           "FROM demo GROUP BY deviceId, HOPPINGWINDOW(ss, 10, 1)")
G_SLOTS, G_HOT_MB, G_PER_WINDOW = 1 << 20, 64, 4
G1_OPTS = {"tierHotMb": G_HOT_MB, "tierScanMs": 1, "prefinalizeLeadMs": 0}
#: G1's hot keys and fresh keys a batch; its distinct-key checkpoints (the
#: bench's 1M, and 2M where the bench has 3M and 10M: cut for the run's
#: time limit; past the 1,677,721 hot slots, so the tier still demotes)
G1_HOT, G1_FRESH, G1_TARGETS = 1 << 18, 2048, (1_000_000, 2_000_000)
G1_PAR_KEYS, G1_PAR_ROWS, G1_PAR_WINDOWS = 1000, 8192, 3
G1_PAR_SLOTS, G1_PAR_MB = 4096, 0.01
#: G2's batch: rows over the hot keys, new keys, rows over the keys first
#: seen G2_BACK slides earlier; batches a run
G2_HOT, G2_HOT_ROWS, G2_NEW, G2_BACK_ROWS = 65_536, 57_344, 2048, 6144
G2_BACK, G2_BATCHES = (4, 9), 240
#: batch times in each 1 s slide: two before the 2x-lead pre-trigger (at
#: 500 ms), one between it and the 1x-lead one (750), one after
G2B_OFFSETS = (100, 350, 600, 850)
#: phase H: the non-time windows (count, session, state) on the fused
#: node, and the sketch rule groups. H1 is BASELINE config #4
#: (bench.py:540-600): hll over COUNTWINDOW(2097152) at 1<<20 slots, one
#: count window of 32 distinct 65,536-row batches of ids drawn from 1M
#: (uid in [0, 5M)), cycled for 3 windows, on the default boundary (the
#: async count emit)
H1_RULE = ("SELECT deviceId, hll(uid) AS uniq FROM demo GROUP BY deviceId, "
           "COUNTWINDOW(2097152)")
H1_SLOTS, H1_KEY_SPACE, H1_UIDS, H1_BATCHES, H1_WINDOWS = (
    1 << 20, 1_000_000, 5_000_000, 32, 3)
#: H2: E2's solo count rule (bench.py:1628-1629) on 50,000-row batches,
#: so that window edges fall inside batches, 10,000 keys
H2_RULE = ("SELECT deviceId, max(temperature) AS m, count(*) AS c FROM demo "
           "GROUP BY deviceId, COUNTWINDOW(262144)")
H2_COUNT, H2_ROWS, H2_BATCHES = 262_144, 50_000, 16
#: H3: the reference's session rule (tests/test_session_device.py:17-18),
#: cap 10 s, gap 2 s, on the mock clock: a burst ended by a gap, a burst
#: past the cap, a last burst ended by a gap (batch times in ms)
H3_RULE = ("SELECT deviceId, count(*) AS c, avg(v) AS a FROM demo "
           "GROUP BY deviceId, SESSIONWINDOW(ss, 10, 2)")
H3_GAP_MS, H3_CAP_MS = 2_000, 10_000
H3_TIMES = ([250 * i for i in range(8)] + [5_000 + 400 * i for i in range(30)]
            + [22_000 + 500 * i for i in range(6)])
H3_END_MS = 30_000
#: H4: the reference's state rule (tests/test_state_device.py:19), st at 1
#: or 0 on random rows (each with this probability), 2 elsewhere
H4_RULE = ("SELECT deviceId, count(*) AS c, avg(v) AS a FROM demo "
           "GROUP BY deviceId, STATEWINDOW(st = 1, st = 0)")
H4_BATCHES, H4_TOGGLE_P = 24, 2e-5
#: H5: E2's two solo sketch rules (bench.py:1622-1627) as 63-rule families
#: with E2's WHERE-step pattern (SQL, first threshold, step), 16 batches a
#: window (the hll family: a 5 s slide), 3 windows each
H5_FAMILIES = {
    "hll": ("SELECT deviceId, hll(humidity) AS u FROM demo WHERE "
            "temperature > {x} GROUP BY deviceId, HOPPINGWINDOW(ss, 10, 5)",
            14.0, 0.05),
    "pct": ("SELECT deviceId, stddev(temperature) AS sd, percentile_approx"
            "(temperature, 0.9) AS p90 FROM demo WHERE humidity > {x} "
            "GROUP BY deviceId, TUMBLINGWINDOW(ss, 10)", 30.0, 0.1),
}
H5_RULES, H5_WINDOWS = 63, 3
#: H6: H3's rule as a 63-rule session group, a WHERE literal per rule, on
#: H3's stream
H6_SQL = ("SELECT deviceId, count(*) AS c, avg(v) AS a FROM demo WHERE "
          "v > {x} GROUP BY deviceId, SESSIONWINDOW(ss, 10, 2)")
H6_RULES, H6_BASE, H6_STEP = 63, 10.0, 0.25
#: phase I: event time. Each run feeds 65,536-row batches over 10,000 keys
#: to the port's WatermarkNode entry (isEventTime, lateTolerance 1000 ms):
#: batch i stamped I_T0 + i s, each row plus U(-1200, 300) ms and 1 % of
#: them a further 3 s late (I1, bench.py:2889-2944: every row of batch i
#: at i s). I3: the flagship rule on 2 s buckets; I4: the reference's
#: event-time session rule (tests/test_event_fused.py:136-137) with an 8 s
#: gap every 20 batches; I5: E1's 256 rules as an event-time group; I6:
#: H5's hll family; I7: G2's tiered rule, stamped by slide. Batches a run
#: (cut from the ~100 the windows would fill to keep the phase in its
#: time; no route lost)
I_TOL, I_STEP_MS, I_T0 = 1000, 1000, 5000
I_JITTER, I_LATE_P, I_LATE_MS = (-1200, 300), 0.01, 3000
I_OPTS = {"isEventTime": True, "lateTolerance": I_TOL}
I3_RULE = TUMBLING.replace("TUMBLINGWINDOW(ss, 10)",
                           "HOPPINGWINDOW(ss, 10, 2)")
I4_RULE = ("SELECT deviceId, count(*) AS c, avg(temperature) AS a FROM demo "
           "GROUP BY deviceId, SESSIONWINDOW(ss, 30, 5)")
I4_GAP_EVERY, I4_GAP_MS, I4_SESSION_GAP_MS = 20, 8000, 5000
I_BATCHES = {"i1": 40, "i2": 40, "i3": 40, "i4": 60, "i5": 40, "i6": 40,
             "i7": 80}
#: the event-time panes of I5's tumbling and I6's hopping group (the
#: window's buckets, the tolerance's, two of slack; at least four)
I5_PANES, I6_PANES = 4, 5
#: phase J: interval joins (bench.py:2500-2598 bench_join_heavy): 512 keys,
#: times uniform on [0, 60,000) ms, a ±5,000 ms band and l.v > r.w. J1 the
#: match leg (2,048 rows a side, 4 windows cycled), J2 the full rule through
#: plan_host_rule (40 windows of 256 rows a side, the bench's emission leg,
#: INNER / LEFT / FULL), J3 J1's rule at 16,384 rows a side
#: phase L: tiered sliding rules. D2's rule at L_SLOTS key slots (its
#: ring coarsens to 156 ms buckets, 68 ring panes) under tierHotMb
#: L_HOT_MB, a hot target of 82,956 slots (hot capacity 131,072), with a
#: 500 ms scan; the churning fleet, 640 batches (40 s of stream) of
#: D2's shape, each 49,152 rows over the 10,000 steady keys and 16,384
#: over the current cohort of 8,192 new keys (a new cohort every 32
#: batches, silent for good after it): 173,840 distinct keys, ~59,000
#: live in the policy's idle span, (68 + 10) x 156 = 12,168 ms. L1 on the
#: DABA ring, L2 on the refold path (the masked fold's touch branch)
L_SLOTS, L_HOT_MB, L_SCAN_MS = 1 << 18, 350, 500
L_OPTS = {"tierHotMb": L_HOT_MB, "tierScanMs": L_SCAN_MS}
L_BATCHES = {"l1": 640, "l2": 640}
L_COHORT, L_COHORT_ROWS, L_COHORT_EVERY = 8192, 16_384, 32
#: phase M: CountMinSketch(depth=4, width=8192, max_candidates=4096), 64
#: updates of 65,536 values of phase A's mix with the tail widened to
#: [100, 20,100) (~20,000 distinct values: the candidate map saturates),
#: heavy_hitters(3) after every 16th update
M_DEPTH, M_WIDTH, M_CAND, M_UPDATES, M_HH_EVERY = 4, 8192, 4096, 64, 16
#: phase N: the device mesh, on a 2x4 mesh whose eight devices are the one
#: card (the counterpart of the reference's 8-device virtual mesh,
#: MULTICHIP_r05.json): N1 the flagship tumbling rule beside a single-chip
#: leg of the same batches, N2 its windows across snapshots (2x4 ->
#: single-chip -> shards 8), N3 phase B's sketch rules (3 windows each,
#: cut for time), N4 I3 (event-time hopping, the pane vector), N5 D2's
#: sliding rule on the refold path (160 batches, cut for time)
N_MESH, N_DEVICES = {"rows": 2, "keys": 4}, 8
N3_WINDOWS, N5_BATCHES = 3, 160
J_RULE = ("SELECT l.v, r.w FROM l {jt} JOIN r ON l.k = r.k "
          "AND l.ts - r.ts >= -5000 AND l.ts - r.ts <= 5000 AND l.v > r.w "
          "GROUP BY TUMBLINGWINDOW(ss, 10)")
J_KEYS, J_TS, J_BAND, J_WINDOW_MS = 512, 60_000, 5_000, 10_000
J_KEY_NAMES = np.array([f"k{i}" for i in range(J_KEYS)], dtype=object)
J1_ROWS, J1_CALLS = 2_048, 40
J2_ROWS, J2_WINDOWS, J2_TYPES = 256, 40, ("INNER", "LEFT", "FULL")
J3_ROWS, J3_WINDOWS = 16_384, 2
#: phase K: analytics over the flagship stream (10,000 devices). K1 lag,
#: 16 batches of 8,192 rows; K2 rank / dense_rank / lead on 10 s tumbling
#: windows of 65,536 rows (values in halves: float32-exact, with ties)
K1_RULE = ("SELECT deviceId, temperature, lag(temperature) OVER "
           "(PARTITION BY deviceId) AS prev FROM demo")
K2_RULE = ("SELECT deviceId, temperature, "
           "rank(temperature) OVER (PARTITION BY deviceId) AS rk, "
           "dense_rank(temperature) OVER (PARTITION BY deviceId) AS dr, "
           "lead(temperature) OVER (PARTITION BY deviceId) AS nx "
           "FROM demo GROUP BY TUMBLINGWINDOW(ss, 10)")
K_SHIFT_SMALL, K_SHIFT_ROWS, K_WINDOW_ROWS = 8_192, 131_072, 65_536
K1_BATCHES, K2_WINDOWS, K_WINDOW_MS = 16, 3, 10_000
DEVICE_NAMES = np.array([f"d{i}" for i in range(10_000)], dtype=object)
#: the kernels (and the scratch's memset) one segscan_shift /
#: segscan_sort call launches
SHIFT_KERNELS = ("Memset", "radix_hist_kernel", "radix_pass_kernel",
                 "seg_scan_kernel", "carry_apply_kernel")
SORT_KERNELS = ("Memset", "radix_hist_kernel", "radix_pass_kernel",
                "seg_scan_kernel")
SOURCE = {
    "groupby_fold": "ekuiper_tpu_torch/csrc/groupby.cu",
    "groupby_finalize_scalar": "ekuiper_tpu_torch/csrc/groupby.cu",
    "groupby_reset_pane": "ekuiper_tpu_torch/csrc/groupby.cu",
    "groupby_finalize_wide": "ekuiper_tpu_torch/csrc/sketches.cu",
    "groupby_hh_finalize": "ekuiper_tpu_torch/csrc/sketches.cu",
    "groupby_components": "ekuiper_tpu_torch/csrc/prefinalize.cu",
    "groupby_absorb": "ekuiper_tpu_torch/csrc/prefinalize.cu",
    "ring_advance": "ekuiper_tpu_torch/csrc/slidingring.cu",
    "ring_flip": "ekuiper_tpu_torch/csrc/slidingring.cu",
    "ring_query": "ekuiper_tpu_torch/csrc/slidingring.cu",
    "multirule_fold": "ekuiper_tpu_torch/csrc/multirule.cu",
    "multirule_fold_order": "ekuiper_tpu_torch/csrc/multirule.cu",
    "multirule_finalize": "ekuiper_tpu_torch/csrc/multirule.cu",
    "multirule_reset_pane": "ekuiper_tpu_torch/csrc/multirule.cu",
    "groupby_fold_masked": "ekuiper_tpu_torch/csrc/groupby.cu",
    "tier_demote": "ekuiper_tpu_torch/csrc/tierstore.cu",
    "tier_promote": "ekuiper_tpu_torch/csrc/tierstore.cu",
    "multirule_fold_wide": "ekuiper_tpu_torch/csrc/multirule.cu",
    "multirule_finalize_wide": "ekuiper_tpu_torch/csrc/multirule.cu",
    "join_match": "ekuiper_tpu_torch/csrc/relational.cu",
    "segscan_shift": "ekuiper_tpu_torch/csrc/relational.cu",
    "segscan_sort": "ekuiper_tpu_torch/csrc/relational.cu",
    "cms_update": "ekuiper_tpu_torch/csrc/countmin.cu",
    "cms_query": "ekuiper_tpu_torch/csrc/countmin.cu",
    "sharded_fold": "ekuiper_tpu_torch/csrc/sharded.cu",
    "shard_merge": "ekuiper_tpu_torch/csrc/sharded.cu",
}
REPLACES = {
    "groupby_fold": "ekuiper_tpu/ops/groupby.py:348",
    "groupby_finalize_scalar": "ekuiper_tpu/ops/groupby.py:459",
    "groupby_reset_pane": "ekuiper_tpu/ops/groupby.py:763",
    "groupby_finalize_wide": "ekuiper_tpu/ops/groupby.py:510",
    "groupby_hh_finalize": "ekuiper_tpu/ops/groupby.py:628",
    "groupby_components": "ekuiper_tpu/ops/groupby.py:541",
    "groupby_absorb": "ekuiper_tpu/ops/groupby.py:729",
    "ring_advance": "ekuiper_tpu/ops/slidingring.py:283",
    "ring_flip": "ekuiper_tpu/ops/slidingring.py:303",
    "ring_query": "ekuiper_tpu/ops/slidingring.py:332",
    "multirule_fold": "ekuiper_tpu/parallel/multirule.py:196",
    # a helper kernel of the port: the row order of #15's folds (the
    # reference's scatters need none)
    "multirule_fold_order": "ekuiper_tpu/parallel/multirule.py:196",
    "multirule_finalize": "ekuiper_tpu/parallel/multirule.py:210",
    "multirule_reset_pane": "ekuiper_tpu/parallel/multirule.py:256",
    "groupby_fold_masked": "ekuiper_tpu/ops/groupby.py:353",
    "tier_demote": "ekuiper_tpu/ops/tierstore.py:263",
    "tier_promote": "ekuiper_tpu/ops/tierstore.py:278",
    "multirule_fold_wide": "ekuiper_tpu/parallel/multirule.py:196",
    "multirule_finalize_wide": "ekuiper_tpu/parallel/multirule.py:210",
    "join_match": "ekuiper_tpu/ops/joinring.py:186",
    "segscan_shift": "ekuiper_tpu/ops/segscan.py:124",
    "segscan_sort": "ekuiper_tpu/ops/segscan.py:165",
    "cms_update": "ekuiper_tpu/ops/sketches.py:282",
    "cms_query": "ekuiper_tpu/ops/sketches.py:288",
    "sharded_fold": "ekuiper_tpu/parallel/sharded.py:208",
    "shard_merge": "ekuiper_tpu/parallel/sharded.py:208",
}
#: which end-to-end paths launch each kernel (phase 5 checks each > 0)
PATHS = {
    "groupby_fold": ("tumbling", "hopping", "hh", "pct", "hll", "d1",
                            "d2", "d2_delay", "d3", "f1", "f2", "f3", "f4",
                            "g1", "g2a", "g2b", "h1", "h2", "h3", "h4",
                            "i1", "i2", "i3", "i4", "i7", "l1", "l2"),
    "groupby_finalize_scalar": ("tumbling", "hopping", "hh", "pct", "hll",
                                "f1", "f2", "f3", "f4", "g1", "g2a", "h1",
                                "h2", "h3", "h4", "i1", "i2", "i3", "i4",
                                "i7", "l2", "n1"),
    "groupby_reset_pane": ("tumbling", "hopping", "hh", "pct", "hll", "d1",
                           "d2", "d3", "f1", "f2", "f3", "f4", "g1", "g2a",
                           "g2b", "h1", "h2", "h3", "h4", "i1", "i2", "i3",
                           "i4", "i7", "l1", "l2", "n1"),
    "groupby_finalize_wide": ("pct", "hll", "f3", "h1"),
    "groupby_hh_finalize": ("hh", "f1"),
    "groupby_components": ("c1", "c1_nobackstop", "c1_host", "c2", "c3_pct",
                           "c3_hll", "d2", "d2_delay", "g2b"),
    "groupby_absorb": ("c1_host",),
    "ring_advance": ("d1", "d2", "d2_delay", "d3", "l1"),
    "ring_flip": ("d1", "d2", "d3", "l1"),
    "ring_query": ("d1", "d2", "d3", "l1"),
    "multirule_fold": ("e1", "e2", "e3", "h5_hll", "h5_pct", "h6", "i5",
                       "i6"),
    "multirule_finalize": ("e1", "e2", "e3", "h5_hll", "h5_pct", "h6", "i5",
                           "i6"),
    "multirule_reset_pane": ("e1", "e2", "e3", "h5_hll", "h5_pct", "h6",
                             "i5", "i6"),
    "groupby_fold_masked": ("f1", "f2", "f3", "f4", "l2"),
    "tier_demote": ("g1", "g2a", "g2b", "i7", "l1", "l2"),
    "tier_promote": ("g2a", "g2b", "i7"),
    "multirule_fold_wide": ("h5_hll", "h5_pct", "i6"),
    "multirule_finalize_wide": ("h5_hll", "h5_pct", "i6"),
    "join_match": ("j1", "j2_inner", "j2_left", "j2_full", "j3"),
    "segscan_shift": ("k1",),
    "segscan_sort": ("k2",),
    "cms_update": ("m",),
    "cms_query": ("m",),
    "sharded_fold": ("n1", "n2", "n3_pct", "n3_hll", "n4", "n5"),
    "shard_merge": ("n1", "n2", "n3_pct", "n3_hll", "n4", "n5"),
    "multirule_fold_order": ("e1", "e2", "e3", "h5_hll", "h5_pct", "h6",
                             "i5", "i6"),
}
#: the folds that must bump the touch column on each tiered path (the
#: masked fold: on the refold path's edge refolds)
TOUCH_PATHS = {"groupby_fold": ("g1", "g2a", "g2b", "i7", "l1", "l2"),
               "groupby_fold_masked": ("l2",)}
#: the folds that must take a per-row pane vector on each sliding and
#: event-time path (a batch that crosses a bucket edge; on the F paths
#: from the cached upload)
ROW_PANE_PATHS = {"groupby_fold": ("d1", "d2", "d2_delay", "d3", "f1", "f2",
                                   "f3", "f4", "i2", "i3", "l1", "l2"),
                  "multirule_fold_order": ("i5", "i6"),
                  "multirule_fold": ("i5", "i6"),
                  "multirule_fold_wide": ("i6",),
                  "sharded_fold": ("n4",)}


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ------------------------------------------------------------------ timing
def time_ms(torch, fn, reps: int, prep=None) -> float:
    """Median device time of `fn` over `reps` runs, by CUDA events. Each run
    is queued behind a device-side sleep, so the host has enqueued the whole
    of `fn` before the start event executes: the interval is device time,
    not host enqueue time. `prep`, where given, is enqueued before each
    run's start event (outside the interval): it restores what `fn`
    consumes."""
    for _ in range(3):
        if prep is not None:
            prep()
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        if prep is not None:
            prep()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def alternating_ms(torch, fns, reps: int, rounds: int = 5):
    """time_ms of each of `fns`, taken in turn for `rounds` rounds, so that
    a drift of the card's clock falls on each alike: each fn's list of
    round times."""
    out = [[] for _ in fns]
    for _ in range(rounds):
        for times, fn in zip(out, fns):
            times.append(time_ms(torch, fn, reps))
    return out


def body_ms(torch, fn, kernel, reps: int, per_call: bool = False,
            prep=None):
    """Device time of the CUDA kernel `kernel` (a name, or a tuple of
    names any of which matches) inside `fn`, from the profiler's CUPTI
    trace: the kernel bodies alone, without the launch and the timing
    events around them. By default the median of the last `reps` launches
    the trace holds (a trace can also hold a launch of an earlier session,
    or miss one); with `per_call`, every matching launch of the `reps`
    calls summed and divided by `reps`, for a call that launches several
    kernels. None when the trace holds no such kernel. `prep`: as
    time_ms's (its kernels are not `kernel`)."""
    from torch.profiler import ProfilerActivity, profile

    names = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    if prep is not None:
        prep()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if prep is not None:
                prep()
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    ev = sorted((e.time_range.start, e.time_range.elapsed_us())
                for e in prof.events()
                if e.device_type == cuda and any(n in e.name for n in names))
    if not ev:
        return None
    if per_call:
        return sum(d for _, d in ev) / reps / 1e3
    return statistics.median(d for _, d in ev[-reps:]) / 1e3


def same_launch_ms(torch, fn, kernel, reps: int) -> dict:
    """CUDA-event and trace times of the SAME launches: `reps` calls of
    `fn` inside one profiler session, each between two CUDA events,
    queued behind a device-side sleep as time_ms's calls are (`idle`) and
    back to back (`b2b`). Per mode (median event ms, median body ms of
    the kernels named `kernel`, None when the trace holds none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    out = {}
    for mode in ("idle", "b2b"):
        marks = []
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                if mode == "idle":
                    torch.cuda._sleep(2_000_000)
                start.record()
                fn()
                end.record()
                marks.append((start, end))
            torch.cuda.synchronize()
        bodies = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                  if e.device_type == cuda and kernel in e.name]
        out[mode] = (statistics.median(a.elapsed_time(b) for a, b in marks),
                     statistics.median(bodies) if bodies else None)
    return out


def same_launch_text(same: dict) -> str:
    return " ".join(
        f"{mode}: kernel_ms={k:.4f} body_ms="
        f"{'not measured' if b is None else f'{b:.4f}'}"
        for mode, (k, b) in same.items())


def one_kernel_a_call(torch, fn, kernel, what: str, calls: int = 3) -> float:
    """Fail unless each of `calls` calls of `fn` launches one CUDA kernel,
    named `kernel`, and nothing else on the card (a profiler trace);
    the kernels a call. A trace that holds no device event at all (the
    CUPTI trace now and then records none) is taken again, up to three
    times; three empty traces fail as a wrong count does."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == cuda]
        if names:
            break
    check(len(names) == calls and all(kernel in n for n in names),
          f"{what}: {calls} calls launched {names}, want one {kernel} each")
    return len(names) / calls


def host_ms(torch, fn, reps: int) -> float:
    """Median host wall time of one call of `fn` (the wrapper's checks,
    the ctypes call and the enqueue), each queued behind a device-side
    sleep so the call never waits for the card."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
    return statistics.median(times)


def launch_split(torch, fn, kernel, reps: int, prep=None,
                 per_call: bool = False) -> dict:
    """The kernel's body time (body_ms's `kernel` and `per_call`) and the
    host time of one wrapper call."""
    return {"body_ms": body_ms(torch, fn, kernel, reps, per_call=per_call,
                               prep=prep),
            "host_ms": host_ms(torch, fn, reps)}


def split_text(split: dict) -> str:
    b = split["body_ms"]
    return (f"body_ms={'not measured' if b is None else f'{b:.4f}'} "
            f"host_ms={split['host_ms']:.4f}")


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------- phase 2
def clone_state(state):
    return {k: v.clone() for k, v in state.items()}


def worst_errs(worst, d, r):
    """(max abs, max rel) of `worst` updated with differences d against
    reference values r (rel over r != 0)."""
    nz = r != 0
    rel = d[nz] / np.abs(r[nz]).astype(np.float64)
    return (max(worst[0], float(d.max(initial=0.0))),
            max(worst[1], float(rel.max(initial=0.0))))


def state_err(got, ref, exact=("n", "act", "mn", "mx"), rtol=1e-5):
    """(max abs, max rel) |got - ref| over every component; exact
    components must be bit-equal, summed ones (float32 atomics in another
    order than the plain version's index_put_) within rtol. Compared where
    the tensors lie, a chunk at a time (a state can hold billions of
    floats); integer components (uint32 touch counters) as int64."""
    worst_abs = worst_rel = 0.0
    for comp in ref:
        g_all, r_all = got[comp].reshape(-1), ref[comp].reshape(-1)
        check(g_all.shape == r_all.shape, f"{comp}: shapes differ")
        comp_max, bad = 0.0, False
        for lo in range(0, r_all.numel(), STATE_ERR_CHUNK):
            g = g_all[lo:lo + STATE_ERR_CHUNK]
            r = r_all[lo:lo + STATE_ERR_CHUNK]
            if not r.is_floating_point():
                g, r = g.long(), r.long()
            fin = r.isfinite()
            check(bool((g.isfinite() == fin).all()),
                  f"{comp}: non-finite mismatch")
            check(bool((g[~fin] == r[~fin]).all()), f"{comp}: identity mismatch")
            r = r[fin]
            rd = r.double()
            d = (g[fin].double() - rd).abs()
            if not d.numel():
                continue
            comp_max = max(comp_max, float(d.max()))
            nz = rd != 0
            if bool(nz.any()):
                worst_rel = max(worst_rel, float((d[nz] / rd[nz].abs()).max()))
            bad |= not bool(((d == 0) if comp in exact
                             else (d <= rtol * r.abs())).all())
        worst_abs = max(worst_abs, comp_max)
        check(not bad, f"{comp}: differs (max {comp_max})" if comp in exact
              else f"{comp}: beyond rtol {rtol} (max {comp_max})")
    return worst_abs, worst_rel


def kernel_checks(torch, seed, kernels, plan_fused_rule, dev):
    """Each kernel against its plain version at the main path's shapes."""
    rows = {}

    def path_inputs(node, seed_off):
        gb = node.gb
        r = np.random.default_rng(seed + seed_off)
        temp = r.normal(20, 5, ROWS).astype(np.float32)
        slots = r.integers(0, N_KEYS, ROWS).astype(np.int32)
        cols = {"temperature": torch.from_numpy(temp).to(dev)}
        base, V, M = gb.spec_inputs(cols, ROWS)
        return gb, base, V, M, torch.from_numpy(slots).to(dev), slots

    fold_errs = []
    for sql, P in ((TUMBLING, 1), (HOPPING, 2)):
        node = plan_fused_rule(sql, key_slots=SLOTS, micro_batch=ROWS,
                               device=dev)
        gb, base, V, M, s_dev, s_host = path_inputs(node, P)
        colmap, widemap = gb._colmap, gb._widemap
        pane = P - 1
        st = gb.init_state()
        if P == 2:  # both panes hold data, the fold lands in pane 1
            kernels.fold_plain(st, base, V, M, s_dev, 0, colmap, widemap)
        ref = clone_state(st)
        got = clone_state(st)
        kernels.fold_plain(ref, base, V, M, s_dev, pane, colmap, widemap)
        kernels.groupby_fold(got, base, V, M, s_dev, pane, colmap, widemap)
        torch.cuda.synchronize()
        err = state_err(got, ref)
        fold = functools.partial(kernels.groupby_fold, got, base, V, M,
                                 s_dev, pane, colmap, widemap)
        t_k = time_ms(torch, fold, REPS)
        split = launch_split(torch, fold, FOLD_KERNEL, REPS)
        t_p = time_ms(torch, lambda: kernels.fold_plain(
            ref, base, V, M, s_dev, pane, colmap, widemap), REPS)
        upd = fold_updates(torch, ref, base, V, M, s_dev, pane, colmap,
                           kernels)
        t_l = time_ms(torch, lambda: library_fold(torch, ref, upd), REPS)
        S, R = V.shape
        touched = len(np.unique(s_host))
        width = sum(a.shape[2] for k, a in st.items() if k != "act") + 1
        nbytes = V.numel() * 4 + M.numel() + R * 4 + R + touched * width * 8
        b_ms, b_by = bound(nbytes, R * (len(colmap) + 1))
        tag = "tumbling" if P == 1 else "hopping"
        print(f"kernel groupby_fold {tag} P={P} R={R} C={SLOTS} "
              f"cols={len(colmap)}: max_abs_err={err[0]:.3g} "
              f"max_rel_err={err[1]:.3g} "
              f"kernel_ms={t_k:.4f} {split_text(split)} plain_ms={t_p:.4f} "
              f"library_ms={t_l:.4f} bound_ms={b_ms:.5f} ({b_by})")
        rows["groupby_fold" if P == 1 else "groupby_fold/hopping"] = dict(
            max_abs_err=err[0], max_rel_err=err[1], ms=t_k, **split,
            plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=t_l)
        fold_errs.append(err)

        # finalize: full mask, and (P=2) a subset mask, on the folded state
        spectab = gb._spectab
        masks = [None] + ([[1]] if P == 2 else [])
        for panes in masks:
            pm = gb._pane_mask(panes)
            out_k = kernels.groupby_finalize_scalar(got, pm, spectab)
            out_p = kernels.finalize_scalar_plain(got, pm, spectab)
            err = finalize_err(out_k, out_p, spectab, kernels)
            fin = functools.partial(kernels.groupby_finalize_scalar, got,
                                    pm, spectab)
            t_k = time_ms(torch, fin, REPS)
            split = launch_split(torch, fin, "finalize_scalar_kernel", REPS)
            t_p = time_ms(torch, lambda: kernels.finalize_scalar_plain(
                got, pm, spectab), REPS)
            n_live = int(pm.sum().item())
            nbytes = (n_live * SLOTS * width * 4
                      + out_k.numel() * 4 + P)
            b_ms, b_by = bound(nbytes, SLOTS * (len(spectab) * 8
                                                + width * n_live))
            tag = "full" if panes is None else f"subset{panes}"
            print(f"kernel groupby_finalize_scalar P={P} mask={tag} "
                  f"S={len(spectab)} C={SLOTS}: "
                  f"max_abs_err={err[0]:.3g} max_rel_err={err[1]:.3g} "
                  f"kernel_ms={t_k:.4f} {split_text(split)} "
                  f"plain_ms={t_p:.4f} library_ms=null "
                  f"bound_ms={b_ms:.5f} ({b_by})")
            if P == 1:
                rows["groupby_finalize_scalar"] = dict(
                    max_abs_err=err[0], max_rel_err=err[1], ms=t_k, **split,
                    plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                    library_ms=None)

        # reset: one pane of every component
        a, b = clone_state(got), clone_state(got)
        kernels.groupby_reset_pane(a, pane)
        kernels.reset_pane_plain(b, pane)
        torch.cuda.synchronize()
        err = state_err(a, b, exact=tuple(a))
        reset = functools.partial(kernels.groupby_reset_pane, a, pane)
        t_k = time_ms(torch, reset, REPS)
        split = launch_split(torch, reset, "reset_pane_kernel", REPS)
        t_p = time_ms(torch, lambda: kernels.reset_pane_plain(b, pane),
                      REPS)
        t_l = time_ms(torch, lambda: library_reset(b, pane, kernels), REPS)
        b_ms, b_by = bound(SLOTS * width * 4, 0)
        print(f"kernel groupby_reset_pane P={P} C={SLOTS}: "
              f"max_abs_err={err[0]:.3g} max_rel_err={err[1]:.3g} "
              f"kernel_ms={t_k:.4f} {split_text(split)} plain_ms={t_p:.4f} "
              f"library_ms={t_l:.4f} bound_ms={b_ms:.5f} ({b_by})")
        if P == 1:
            rows["groupby_reset_pane"] = dict(
                max_abs_err=err[0], max_rel_err=err[1], ms=t_k, **split,
                plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=t_l)
    rows["groupby_fold"]["max_abs_err"] = max(e[0] for e in fold_errs)
    rows["groupby_fold"]["max_rel_err"] = max(e[1] for e in fold_errs)
    return rows


#: the port's fold kernels a trace can hold (#1, #23 / #24; #2's own)
FOLD_KERNEL_NAMES = re.compile(
    r"\b(groupby_fold_kernel|sharded_fold_kernel|fold_\w*_kernel)\b")


def fold_launch_trace(torch, seed, kernels, plan_fused_rule, dev):
    """One kernel launch a fold chunk, for every mix of columns: a
    profiler trace of the group-by's `_fold_chunk` (the closures, then
    the fold) on the tumbling, hopping, percentile, hll, heavy-hitters and
    mixed (hh + hll + hist + scalar) rules at the main path's shapes, on
    one chip and, for the rules a mesh takes, on the 2x4 mesh (whose
    chunk also launches shard_merge, a kernel of its own): the port's fold
    kernels in the trace, by name, three chunks each. Each chunk must
    launch exactly one."""
    from torch.profiler import ProfilerActivity, profile

    from ekuiper_tpu_torch.parallel.mesh import make_mesh
    from ekuiper_tpu_torch.parallel.sharded import ShardedGroupBy

    out = {"groupby_fold": {}, "sharded_fold": {}}
    mesh = make_mesh(N_MESH["rows"], N_MESH["keys"], [dev] * N_DEVICES)
    cuda = torch.autograd.DeviceType.CUDA
    for i, (tag, sql) in enumerate((
            ("tumbling", TUMBLING), ("hopping", HOPPING), ("pct", PCT_RULE),
            ("hll", HLL_RULE), ("hh", HH_RULE), ("mixed", MIXED_RULE))):
        node = plan_fused_rule(sql, key_slots=SLOTS, micro_batch=ROWS,
                               device=dev)
        gbs = [("groupby_fold", node.gb)]
        if "hh" not in node.gb.comp_specs:  # the mesh refuses heavy_hitters
            gbs.append(("sharded_fold", ShardedGroupBy(
                node.plan, mesh, capacity=SLOTS, n_panes=node.n_panes,
                micro_batch=ROWS)))
        node.on_close()
        r = np.random.default_rng(seed + 160 + i)
        host = {"__hhc__code": skewed_codes(r, ROWS).astype(np.float32),
                "temperature": r.normal(20, 5, ROWS).astype(np.float32),
                "__hll__humidity": (r.integers(0, 1000, ROWS) / 10).astype(
                    np.float32)}
        for name, gb in gbs:
            cols = {k: torch.from_numpy(v).to(dev) for k, v in host.items()
                    if k in gb.plan.columns}
            slots = torch.from_numpy(r.integers(
                0, min(N_KEYS, gb.capacity), ROWS).astype(np.int32)).to(dev)
            state = gb.init_state()
            chunk = functools.partial(gb._fold_chunk, state, cols, ROWS,
                                      slots, gb.n_panes - 1, None)
            chunk()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    chunk()
                torch.cuda.synchronize()
            found = [m.group(1) for e in prof.events()
                     if e.device_type == cuda
                     for m in [FOLD_KERNEL_NAMES.search(e.name)] if m]
            kernel = FOLD_KERNEL if name == "groupby_fold" else \
                SHARDED_FOLD_KERNEL
            check(found == [kernel] * 3,
                  f"{name} {tag}: a chunk launched {found} (three chunks), "
                  f"want one {kernel} each")
            out[name][tag] = len(found) / 3
            del state
        torch.cuda.empty_cache()
    print("phase 2 fold launches a chunk (profiler trace): " + " ".join(
        f"{name}/{tag}={n:g}" for name, v in out.items()
        for tag, n in v.items()))
    return out


def fold_updates(torch, state, base, V, M, slots, pane, colmap, kernels):
    """Act's and each scalar column's (state key, flat index, value, reduce
    op) of their updates, built ahead of the timed region as wide_updates'
    are, so that the library yardstick times PyTorch's scatters alone;
    `pane` an int or a per-row int64 tensor."""
    C = state["act"].shape[1]
    pc = pane * C + slots.long()
    b = base.bool()
    out = [("act", pc[b], torch.ones(int(b.sum()), device=pc.device),
            "sum")]
    names = {j: c for c, j in kernels.COMP_IDS.items()}
    for comp_id, k, s in colmap.tolist():
        comp = names[comp_id]
        m = M[s]
        idx = (pc * state[comp].shape[2] + k)[m]
        v = V[s][m]
        if comp == "n":
            out.append((comp, idx, torch.ones_like(v), "sum"))
        elif comp in ("s1", "s2"):
            out.append((comp, idx, v if comp == "s1" else v * v, "sum"))
        else:
            out.append((comp, idx, v, "amin" if comp == "mn" else "amax"))
    return out


def library_fold(torch, state, updates):
    """Yardstick, never called by the port: the fold as PyTorch's own
    scatter calls on precomputed updates (fold_updates, wide_updates):
    index_add_ for the counters and sums, scatter_reduce_ amin / amax for
    min, max and the hll registers."""
    for comp, idx, val, op in updates:
        flat = state[comp].view(-1)
        if op == "sum":
            flat.index_add_(0, idx, val)
        else:
            flat.scatter_reduce_(0, idx, val, op, include_self=True)


def finalize_err(out_k, out_p, spectab, kernels):
    """Kernel vs plain finalize: count, min, max and act bit-equal; the
    others rtol 1e-6 (the kernel rounds each step as the plain version
    does; the slack covers torch's own reduction order)."""
    kinds = {v: k for k, v in kernels.KIND_IDS.items()}
    g, r = out_k.cpu().numpy(), out_p.cpu().numpy()
    check(g.shape == r.shape, "finalize shape")
    worst = (0.0, 0.0)
    for i in range(len(r)):
        kind = kinds[int(spectab[i, 0])] if i < len(spectab) else "act"
        nan = np.isnan(r[i])
        check((np.isnan(g[i]) == nan).all(), f"finalize {kind}: NaN mismatch")
        d = np.abs(g[i][~nan].astype(np.float64) - r[i][~nan])
        worst = worst_errs(worst, d, r[i][~nan])
        if kind in ("count", "min", "max", "act"):
            check((d == 0).all(), f"finalize {kind}: differs")
        else:
            check((d <= 1e-6 * np.abs(r[i][~nan])).all(),
                  f"finalize {kind}: beyond rtol 1e-6 (max {d.max(initial=0.0)})")
    return worst


# ------------------------------------------------- phase 2, the sketches
WIDE = ("hll", "hist", "hh")
#: the one kernel of a #1 fold (csrc/groupby.cu, csrc/fold.cuh) and of a
#: #23 / #24 one (csrc/sharded.cu)
FOLD_KERNEL = "groupby_fold_kernel"
SHARDED_FOLD_KERNEL = "sharded_fold_kernel"
#: a rule with hh, hll and hist columns beside scalar ones: the fold's
#: three roles in one launch
MIXED_RULE = (
    "SELECT deviceId, count(*) AS c, avg(temperature) AS a, "
    "hll(humidity) AS u, percentile_approx(temperature, 0.5) AS p, "
    "heavy_hitters(code, 3) AS top FROM demo "
    "GROUP BY deviceId, HOPPINGWINDOW(ss, 10, 5)"
)
#: the empty column maps of a branch timed on its own
NO_COLS = np.zeros((0, 3), dtype=np.int32)


def wide_split(torch, fn, names, widemap, kernels, reps):
    """launch_split of a wide fold: both kernels' bodies summed per call
    where the widemap launches two, else the one kernel's median."""
    hh = widemap[:, 0] == kernels.WIDE_IDS["hh"]
    return launch_split(torch, fn, names, reps,
                        per_call=bool(hh.any() and not hh.all()))


def skewed_codes(rng, n):
    """bench.py's heavy-hitters codes: 7 at 35 %, 13 at 20 %, 99 at 15 %,
    the rest uniform over a 2,000-value tail."""
    p = rng.random(n)
    return np.where(p < 0.35, 7, np.where(p < 0.55, 13, np.where(
        p < 0.70, 99, rng.integers(100, 2100, n)))).astype(np.int64)


def sketch_inputs(torch, gb, seed, dev):
    """The sketch rules' kernel inputs for one 65,536-row batch: codes as
    dictionary codes, temperature N(20, 5), humidity on 1,000 one-decimal
    values (its hll encoding is the value itself)."""
    r = np.random.default_rng(seed)
    host = {"__hhc__code": skewed_codes(r, ROWS).astype(np.float32),
            "temperature": r.normal(20, 5, ROWS).astype(np.float32),
            "__hll__humidity": (r.integers(0, 1000, ROWS) / 10).astype(
                np.float32)}
    cols = {k: torch.from_numpy(v).to(dev) for k, v in host.items()
            if k in gb.plan.columns}
    base, V, M = gb.spec_inputs(cols, ROWS)
    slots = r.integers(0, N_KEYS, ROWS).astype(np.int32)
    return base, V, M, torch.from_numpy(slots).to(dev), slots


def wide_updates(torch, gb, V, M, slots, pane, sketches):
    """Per wide column: (flat state tensor, flat index, value, reduce op)
    of its nonzero updates, as the library yardstick scatters them; `pane`
    an int or a per-row int64 tensor."""
    C = gb.capacity
    pc = pane * C + slots.long()
    out = []
    for comp_id, k, s in gb._widemap.tolist():
        comp = WIDE[comp_id]
        m = M[s]
        v = V[s][m]
        W = {"hll": sketches.HLL_M, "hist": sketches.HIST_BINS,
             "hh": sketches.HH_SIZE}[comp]
        row = (pc[m] * len(gb.comp_specs[comp]) + k) * W
        if comp == "hll":
            reg, rho = sketches.hll_parts(v)
            out.append((comp, row + reg, rho, "amax"))
        elif comp == "hist":
            out.append((comp, row + sketches.hist_bin(v),
                        torch.ones_like(v), "sum"))
        else:
            idx, wts = sketches.hh_update_parts(v, torch.ones_like(v))
            flat = (row[:, None] + idx).reshape(-1)
            w = wts.reshape(-1)
            nz = w != 0
            out.append((comp, flat[nz], w[nz], "sum"))
    return out


def library_idx_ms(torch, gb, state, V, M, slots, pane, sketches):
    """Device time of the yardstick with its index build: wide_updates
    (the hashes, the indices, the zero updates dropped) and then
    library_fold, which PyTorch takes for the same function from the
    batch as the kernels get it. The boolean indexing waits for the card,
    so the time holds those waits too."""
    return time_ms(torch, lambda: library_fold(torch, state, wide_updates(
        torch, gb, V, M, slots, pane, sketches)), REPS)


EXACT = ("n", "act", "mn", "mx") + WIDE


def sketch_kernel_checks(torch, seed, kernels, sketches, plan_fused_rule,
                         TorchGroupBy, dev):
    """The one-launch fold (#1) on the sketch rules and on a rule with hh,
    hll and hist columns together, as the node calls it and each branch
    on its own; the two sketch finalizes and the pane reset over wide
    state; each against its plain version at the sketch rules' full
    state."""
    rows = {}
    for tag, sql in (("hh", HH_RULE), ("pct", PCT_RULE), ("hll", HLL_RULE),
                     ("mixed", MIXED_RULE)):
        node = plan_fused_rule(sql, key_slots=SLOTS, micro_batch=ROWS,
                               device=dev)
        gb = TorchGroupBy(node.plan, capacity=SLOTS, n_panes=node.n_panes,
                          micro_batch=ROWS, device=dev)
        P = gb.n_panes
        pane = P - 1
        cmap, wmap = gb._colmap, gb._widemap
        st = gb.init_state()
        if P == 2:  # both panes hold data, the fold lands in pane 1
            base, V, M, s_dev, _ = sketch_inputs(torch, gb, seed + 40, dev)
            kernels.fold_plain(st, base, V, M, s_dev, 0, cmap, wmap)
        base, V, M, s_dev, s_host = sketch_inputs(torch, gb, seed + 41, dev)
        ref, got = clone_state(st), clone_state(st)
        kernels.fold_plain(ref, base, V, M, s_dev, pane, cmap, wmap)
        kernels.groupby_fold(got, base, V, M, s_dev, pane, cmap, wmap)
        torch.cuda.synchronize()
        err = state_err(got, ref, exact=EXACT)
        # as the node calls it: every column in one launch
        fold = functools.partial(kernels.groupby_fold, got, base, V, M,
                                 s_dev, pane, cmap, wmap)
        t_k = time_ms(torch, fold, REPS)
        split = launch_split(torch, fold, FOLD_KERNEL, REPS)
        t_p = time_ms(torch, lambda: kernels.fold_plain(
            ref, base, V, M, s_dev, pane, cmap, wmap), REPS)
        upd = wide_updates(torch, gb, V, M, s_dev, pane, sketches)
        u_act, *u_sc = fold_updates(torch, ref, base, V, M, s_dev, pane,
                                    cmap, kernels)
        t_l = time_ms(torch, lambda: library_fold(
            torch, ref, [u_act] + u_sc + upd), REPS)
        t_li = library_idx_ms(torch, gb, ref, V, M, s_dev, pane, sketches)
        # each branch on its own: act and the scalar columns, and the
        # sketch columns (with act, which every launch adds), each beside
        # its library call
        branches = {}
        for branch, cm, wm, lib_upd in (
                ("scalar", cmap, NO_COLS, [u_act] + u_sc),
                ("sketch", NO_COLS, wmap, [u_act] + upd)):
            fn = functools.partial(kernels.groupby_fold, got, base, V, M,
                                   s_dev, pane, cm, wm)
            lib = functools.partial(library_fold, torch, ref, lib_upd)
            branches[branch] = dict(ms=time_ms(torch, fn, REPS),
                                    **launch_split(torch, fn, FOLD_KERNEL,
                                                   REPS),
                                    library_ms=time_ms(torch, lib, REPS))
        # bytes: V, M, base and slots read once, each touched state float
        # read and written once; operations: one atomic per nonzero update
        touched = sum(len(torch.unique(idx)) for _, idx, _, _ in upd)
        n_upd = sum(len(idx) for _, idx, _, _ in upd)
        width = 1 + sum(a.shape[2] for k, a in st.items()
                        if k in kernels.COMP_IDS)
        touched += len(np.unique(s_host)) * width
        n_upd += ROWS * (len(cmap) + 1)
        nbytes = V.numel() * 4 + M.numel() + ROWS * 5 + touched * 8
        b_ms, b_by = bound(nbytes, n_upd)
        print(f"kernel groupby_fold {tag} P={P} R={ROWS} C={SLOTS} "
              f"cols={len(cmap)}+{len(wmap)} updates={n_upd}: "
              f"max_abs_err={err[0]:.3g} kernel_ms={t_k:.4f} "
              f"{split_text(split)} plain_ms={t_p:.4f} library_ms={t_l:.4f} "
              f"library_idx_ms={t_li:.4f} bound_ms={b_ms:.5f} ({b_by}) "
              + " ".join(f"{k}_only: kernel_ms={v['ms']:.4f} "
                         f"{split_text(v)} library_ms={v['library_ms']:.4f}"
                         for k, v in branches.items()))
        rows[f"groupby_fold/{tag}"] = dict(
            max_abs_err=err[0], ms=t_k, **split, plain_ms=t_p, bound_ms=b_ms,
            bound_by=b_by, library_ms=t_l, library_idx_ms=t_li,
            branches=branches)
        if tag == "mixed":  # a fold check: its finalizes are the others'
            del st, ref, got
            torch.cuda.empty_cache()
            continue

        for panes in [None] + ([[1]] if P == 2 else []):
            pm = gb._pane_mask(panes)
            live = int(pm.sum().item())
            mtag = "full" if panes is None else f"subset{panes}"
            if len(gb._widetab):
                out_k = torch.full((gb._rows, SLOTS), -1.0, device=dev)
                out_p = out_k.clone()
                kernels.groupby_finalize_wide(got, pm, gb._widetab,
                                              gb._fracs, out_k)
                kernels.finalize_wide_plain(got, pm, gb._widetab, gb._fracs,
                                            out_p)
                err = wide_finalize_err(out_k, out_p, gb._widetab, kernels)
                fin = functools.partial(kernels.groupby_finalize_wide, got,
                                        pm, gb._widetab, gb._fracs, out_k)
                t_k = time_ms(torch, fin, REPS)
                split = launch_split(torch, fin, "finalize_wide_kernel", REPS)
                a_call = one_kernel_a_call(torch, fin, "finalize_wide_kernel",
                                           f"groupby_finalize_wide {tag}")
                t_p = time_ms(torch, lambda: kernels.finalize_wide_plain(
                    got, pm, gb._widetab, gb._fracs, out_p), REPS)
                nbytes = sum(live * got[c][0].numel() * 4
                             for c in ("hll", "hist") if c in got)
                nbytes += len(gb._widetab) * SLOTS * 4
                b_ms, b_by = bound(nbytes, 0)
                print(f"kernel groupby_finalize_wide {tag} P={P} mask={mtag} "
                      f"C={SLOTS}: max_abs_err={err:.3g} kernel_ms={t_k:.4f} "
                      f"{split_text(split)} kernels_a_call={a_call:g} "
                      f"plain_ms={t_p:.4f} "
                      f"library_ms=null bound_ms={b_ms:.5f} ({b_by})")
                key = f"groupby_finalize_wide/{tag}/{mtag}"
                rows[key] = dict(max_abs_err=err, ms=t_k, **split,
                                 kernels_a_call=a_call,
                                 plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                                 library_ms=None)
            if len(gb._hhtab):
                out_k = torch.full((gb._rows, SLOTS), -1.0, device=dev)
                out_p = out_k.clone()
                kernels.groupby_hh_finalize(got, pm, gb._hhtab, out_k)
                kernels.hh_finalize_plain(got, pm, gb._hhtab, out_p)
                g, r = out_k.cpu().numpy(), out_p.cpu().numpy()
                check((g == r).all(), f"hh finalize {mtag}: differs from plain "
                      f"at {int((g != r).sum())} places")
                fin = functools.partial(kernels.groupby_hh_finalize, got, pm,
                                        gb._hhtab, out_k)
                t_k = time_ms(torch, fin, REPS)
                split = launch_split(torch, fin, "hh_finalize_kernel", REPS)
                t_p = time_ms(torch, lambda: kernels.hh_finalize_plain(
                    got, pm, gb._hhtab, out_p), REPS)
                nbytes = (live * got["hh"][0].numel() * 4
                          + int(gb._hhtab[:, 1].sum()) * 2 * SLOTS * 4)
                b_ms, b_by = bound(nbytes, 0)
                print(f"kernel groupby_hh_finalize P={P} mask={mtag} "
                      f"C={SLOTS}: max_abs_err=0 kernel_ms={t_k:.4f} "
                      f"{split_text(split)} plain_ms={t_p:.4f} "
                      f"library_ms=null bound_ms={b_ms:.5f} ({b_by})")
                rows[f"groupby_hh_finalize/{mtag}"] = dict(
                    max_abs_err=0.0, ms=t_k, **split, plain_ms=t_p,
                    bound_ms=b_ms, bound_by=b_by, library_ms=None)

        if tag == "hh":  # the pane reset over the widest state
            a, b = clone_state(got), clone_state(got)
            kernels.groupby_reset_pane(a, pane)
            kernels.reset_pane_plain(b, pane)
            torch.cuda.synchronize()
            state_err(a, b, exact=tuple(a))
            reset = functools.partial(kernels.groupby_reset_pane, a, pane)
            t_k = time_ms(torch, reset, REPS)
            split = launch_split(torch, reset, "reset_pane_kernel", REPS)
            t_p = time_ms(torch, lambda: kernels.reset_pane_plain(b, pane),
                          REPS)
            t_l = time_ms(torch, lambda: library_reset(b, pane, kernels),
                          REPS)
            b_ms, b_by = bound(sum(x[0].numel() for x in a.values()) * 4, 0)
            print(f"kernel groupby_reset_pane hh P={P} C={SLOTS}: "
                  f"max_abs_err=0 kernel_ms={t_k:.4f} {split_text(split)} "
                  f"plain_ms={t_p:.4f} library_ms={t_l:.4f} "
                  f"bound_ms={b_ms:.5f} ({b_by})")
            rows["groupby_reset_pane/hh"] = dict(
                max_abs_err=0.0, ms=t_k, **split, plain_ms=t_p,
                bound_ms=b_ms, bound_by=b_by, library_ms=t_l)
        del st, ref, got
        torch.cuda.empty_cache()
    return rows


def library_reset(state, pane, kernels):
    """Yardstick: one fill_ per component."""
    for comp, arr in state.items():
        arr[pane].fill_(kernels.INIT[comp])


def wide_finalize_err(out_k, out_p, widetab, kernels):
    """Kernel vs plain wide finalize: hll within ±1 (a 256-term sum in
    another order), the percentile within 4 ulp (the same bin; expf in
    both, rounded alike in every other step). Returns max abs error."""
    g, r = out_k.cpu().numpy(), out_p.cpu().numpy()
    worst = 0.0
    for kind, _, row in widetab.tolist():
        nan = np.isnan(r[row])
        check((np.isnan(g[row]) == nan).all(), "wide finalize: NaN mismatch")
        d = np.abs(g[row][~nan].astype(np.float64) - r[row][~nan])
        worst = max(worst, float(d.max(initial=0.0)))
        if kind == kernels.WIDE_KIND_IDS["hll"]:
            check((d <= 1).all(), f"hll estimate off by {d.max()}")
        else:
            check((d <= 4 * 2.0 ** -23 * np.abs(r[row][~nan])).all(),
                  f"percentile beyond 4 ulp (max {d.max(initial=0.0)})")
    untouched = np.setdiff1d(np.arange(len(g)), widetab[:, 2])
    check((g[untouched] == -1.0).all(), "wide finalize wrote another row")
    return worst


# ------------------------------------------------------------ phases 3, 4
def make_batches(rng, ColumnBatch, n_batches):
    ids = np.array([f"dev_{i}" for i in range(N_KEYS)], dtype=np.object_)
    idx = rng.integers(0, N_KEYS, (n_batches, ROWS))
    temp = rng.normal(20, 5, (n_batches, ROWS)).astype(np.float32)
    batches = [ColumnBatch(n=ROWS,
                           columns={"deviceId": ids[idx[b]],
                                    "temperature": temp[b]},
                           emitter="demo")
               for b in range(n_batches)]
    return batches, idx, temp


def reference_aggs(idx, temp, keys):
    """Independent numpy float64 group-by of one span of rows."""
    i = idx.ravel()
    t = temp.ravel().astype(np.float64)
    agg = {"cnt": np.zeros(keys), "sum": np.zeros(keys),
           "sumsq": np.zeros(keys), "sumabs": np.zeros(keys),
           "min": np.full(keys, np.inf), "max": np.full(keys, -np.inf)}
    np.add.at(agg["cnt"], i, 1.0)
    np.add.at(agg["sum"], i, t)
    np.add.at(agg["sumsq"], i, t * t)
    np.add.at(agg["sumabs"], i, np.abs(t))
    np.minimum.at(agg["min"], i, t)
    np.maximum.at(agg["max"], i, t)
    return agg


def merge_aggs(parts):
    out = {k: sum(p[k] for p in parts) for k in ("cnt", "sum", "sumsq",
                                                  "sumabs")}
    out["min"] = np.minimum.reduce([p["min"] for p in parts])
    out["max"] = np.maximum.reduce([p["max"] for p in parts])
    return out


def check_window(cb, ref, with_sd: bool, what: str, ring=None) -> float:
    """Every emitted row against the float64 reference. Tolerances are the
    float32 rounding bounds of the device arithmetic: keys and counts
    exact; min/max exact (they pick an input); avg within
    ε·(Σ|x| + |mean|) — a float32 sum of n terms in any order is within
    (n-1)·ε·Σ|x| of the exact sum; stddev within the same bound carried
    through s2/n - mean². `ring` (per key id, run_l): a further bound on
    the sum from a DABA ring's running totals, which add and subtract pane
    sums outside the window."""
    live = np.nonzero(ref["cnt"] > 0)[0]
    check(cb is not None and cb.n == len(live),
          f"{what}: {0 if cb is None else cb.n} rows, want {len(live)}")
    keys = np.array([int(k[4:]) for k in cb.columns["deviceId"].tolist()])
    order = np.argsort(keys)
    keys = keys[order]
    check((keys == live).all(), f"{what}: emitted keys differ")
    col = {k: np.asarray(v)[order] for k, v in cb.columns.items()}
    n = ref["cnt"][keys]
    check((col["cnt"].astype(np.float64) == n).all(), f"{what}: count")
    check((col["min_t"].astype(np.float64) == ref["min"][keys]).all(),
          f"{what}: min")
    check((col["max_t"].astype(np.float64) == ref["max"][keys]).all(),
          f"{what}: max")
    mean = ref["sum"][keys] / n
    sumabs = ref["sumabs"][keys]
    d_avg = np.abs(col["avg_t"].astype(np.float64) - mean)
    tol_avg = EPS32 * (sumabs + np.abs(mean))
    if ring is not None:
        tol_avg = tol_avg + ring[keys] / n
    check((d_avg <= tol_avg).all(),
          f"{what}: avg beyond bound (max {d_avg.max()})")
    worst = float(d_avg.max())
    if with_sd:
        s2n = ref["sumsq"][keys] / n
        var = np.maximum(s2n - mean * mean, 0.0)
        tol_var = EPS32 * (ref["sumsq"][keys] + s2n
                           + 2 * np.abs(mean) * (sumabs + np.abs(mean))
                           + mean * mean + var)
        sd = col["sd_t"].astype(np.float64)
        d_sd = np.abs(sd * sd - var)  # compare in variance: |a²-b²| bound
        check((d_sd <= tol_var + 2 * EPS32 * sd * sd).all(),
              f"{what}: stddev beyond bound (max {d_sd.max()})")
        worst = max(worst, float(np.abs(sd - np.sqrt(var)).max()))
    return worst


def timed(fn, acc: dict, key: str):
    """`fn` with its host wall time added to acc[key]."""
    def run(*a, **k):
        t = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            acc[key] += time.perf_counter() - t
    return run


def run_rule(torch, seed, sql, interval_ms, span, kernels, mods):
    """Drive `sql` through process/on_trigger on the card; return
    (launch counts, rows/s, emit ms samples, worst abs error, host seconds
    by stage)."""
    plan_fused_rule, ColumnBatch, Trigger = mods
    rng = np.random.default_rng(seed)
    n_int, per = WINDOWS, BATCHES
    batches, idx, temp = make_batches(rng, ColumnBatch, n_int * per)
    parts = [reference_aggs(idx[w * per:(w + 1) * per],
                            temp[w * per:(w + 1) * per], N_KEYS)
             for w in range(n_int)]
    node = plan_fused_rule(sql, key_slots=SLOTS, micro_batch=ROWS,
                           options=SYNC)
    check(node.gb.device.type == "cuda", "rule is not on the card")
    emitted = []
    node.broadcast = emitted.append
    # host time by stage: key encode + column build, upload + closures +
    # fold launch (the rest of the wall is the boundary emit)
    stages = {"encode": 0.0, "fold": 0.0}
    node._build_kernel_inputs = timed(node._build_kernel_inputs, stages,
                                      "encode")
    node.gb.fold = timed(node.gb.fold, stages, "fold")
    # warm the path (allocator, pinned pool) on a throwaway node
    warm = plan_fused_rule(sql, key_slots=SLOTS, micro_batch=ROWS,
                           options=SYNC)
    warm.broadcast = lambda item: None
    warm.process(batches[0])
    warm.on_trigger(Trigger(ts=interval_ms))
    torch.cuda.synchronize()
    kernels.reset_launches()
    emit_ms = []
    t0 = time.perf_counter()
    for w in range(n_int):
        for b in batches[w * per:(w + 1) * per]:
            node.process(b)
        te = time.perf_counter()
        node.on_trigger(Trigger(ts=(w + 1) * interval_ms))
        torch.cuda.synchronize()
        emit_ms.append((time.perf_counter() - te) * 1e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    check(len(emitted) == n_int, f"{len(emitted)} windows, want {n_int}")
    worst = 0.0
    for w, cb in enumerate(emitted):
        ref = merge_aggs(parts[max(0, w - span + 1):w + 1])
        worst = max(worst, check_window(cb, ref, "sd_t" in cb.columns,
                                        f"window {w}"))
    return counts, n_int * per * ROWS / wall, emit_ms, worst, stages


# ------------------------------------------------------- phases A and B
# numpy twins of the sketches, written from their definitions (numpy has
# native uint32 shifts and wrapping products)
U32 = np.uint32
HH_DEPTH, HH_WIDTH, HH_BITS = 2, 64, 20
HH_CELL = 1 + HH_BITS
HH_SIZE = HH_DEPTH * HH_WIDTH * HH_CELL
HLL_M, HIST_BINS, HIST_HALF = 256, 1024, 511
HIST_LO, HIST_HI = 1e-9, 1e12
LOG_GAMMA = np.log((HIST_HI / HIST_LO) ** (1.0 / (HIST_HALF - 1)))


def np_splitmix32(x):
    x = x ^ (x >> U32(16))
    x = x * U32(0x7FEB352D)
    x = x ^ (x >> U32(15))
    x = x * U32(0x846CA68B)
    return x ^ (x >> U32(16))


def np_hh_slot(code, d):
    salt = U32((0x9E3779B9 * (d + 7)) & 0xFFFFFFFF)
    return np_splitmix32(code ^ salt) & U32(HH_WIDTH - 1)


class TwinCodes:
    """The dictionary of a heavy_hitters column: new values of a batch
    take the next codes in sorted order (np.unique), as the node's
    dictionary assigns them to an integer column."""

    def __init__(self):
        self.codes = {}
        self.values = []

    def encode(self, col):
        uniq, inv = np.unique(col, return_inverse=True)
        for u in uniq.tolist():
            if u not in self.codes:
                self.codes[u] = len(self.values)
                self.values.append(u)
        return np.array([self.codes[u] for u in uniq.tolist()],
                        dtype=np.uint32)[inv]


def twin_hh_fold(counters, keys, codes):
    """Add one batch into counters (n_keys * HH_SIZE,) float64: per depth,
    the cell total and the code's set bits."""
    flat = []
    for d in range(HH_DEPTH):
        base = (keys * HH_SIZE + (d * HH_WIDTH + np_hh_slot(codes, d)
                                  .astype(np.int64)) * HH_CELL)
        flat.append(base)
        for b in range(HH_BITS):
            bit = ((codes >> U32(b)) & U32(1)).astype(bool)
            flat.append(base[bit] + 1 + b)
    counters += np.bincount(np.concatenate(flat), minlength=len(counters))


def twin_hh_top(merged, k):
    """Top-k (code, count) lists per key from a pane-merged sketch
    (n_keys, HH_SIZE): bit-majority codes, hash-back validation, count-min
    estimates, estimate-descending order with the lower cell first among
    ties, dedupe, trim."""
    n = len(merged)
    a = merged.reshape(n, HH_DEPTH, HH_WIDTH, HH_CELL)
    tot = a[..., 0]
    bits = (a[..., 1:] * 2.0) > tot[..., None]
    codes = (bits.astype(np.uint32) << np.arange(HH_BITS, dtype=U32)).sum(
        axis=-1, dtype=U32)
    ok = np.stack([(tot[:, d] > 0) & (np_hh_slot(codes[:, d], d)
                                      == np.arange(HH_WIDTH, dtype=U32))
                   for d in range(HH_DEPTH)], axis=1).reshape(n, -1)
    flat = codes.reshape(n, -1)
    est = np.full(flat.shape, np.inf)
    for d2 in range(HH_DEPTH):
        s = np_hh_slot(flat, d2).astype(np.int64)
        est = np.minimum(est, np.take_along_axis(tot[:, d2], s, axis=1))
    est = np.where(ok, est, 0.0)
    order = np.argsort(-est, axis=1, kind="stable")[:, :2 * k]
    top_c = np.take_along_axis(flat, order, axis=1)
    top_e = np.take_along_axis(est, order, axis=1)
    out = []
    for cs, es in zip(top_c.tolist(), top_e.tolist()):
        row, seen = [], set()
        for c, e in zip(cs, es):
            if e <= 0:
                break
            if c not in seen:
                seen.add(c)
                row.append((c, int(round(e))))
                if len(row) == k:
                    break
        out.append(row)
    return out


def key_ids(col):
    return np.array([int(k[4:]) for k in col.tolist()])


class HHTwin:
    """The heavy-hitters rule's numpy twin over its hop windows: its own
    value dictionary, two pane sketches, exact counts and exact rows of
    code 7; `close_window` returns the expected (top lists, counts,
    sevens) of the window that ends and expires its oldest pane."""

    def __init__(self):
        self.codes = TwinCodes()
        self.panes = [np.zeros(N_KEYS * HH_SIZE), np.zeros(N_KEYS * HH_SIZE)]
        self.counts = [np.zeros(N_KEYS), np.zeros(N_KEYS)]
        self.sevens = [np.zeros(N_KEYS), np.zeros(N_KEYS)]

    def close_window(self, w, idx, code):
        cur = w % 2
        # the codes are assigned batch by batch, as the node assigns them;
        # the sketch is linear, so the batches fold in one pass
        codes = np.concatenate([self.codes.encode(c) for c in code])
        keys = np.concatenate(list(idx))
        twin_hh_fold(self.panes[cur], keys, codes)
        self.counts[cur] += np.bincount(keys, minlength=N_KEYS)
        self.sevens[cur] += np.bincount(
            keys[np.concatenate(list(code)) == 7], minlength=N_KEYS)
        merged = (self.panes[0] + self.panes[1]).reshape(N_KEYS, HH_SIZE)
        out = (twin_hh_top(merged, 3), self.counts[0] + self.counts[1],
               self.sevens[0] + self.sevens[1])
        for x in (self.panes, self.counts, self.sevens):
            x[1 - cur][:] = 0.0  # the pane that expires now
        return out


def check_hh_windows(emitted, expect, values, what):
    """Every emitted heavy-hitters row against the twin: keys, counts and
    top lists equal; returns (rows, lists led by code 7)."""
    check(len(emitted) == len(expect),
          f"{what}: {len(emitted)} windows, want {len(expect)}")
    n_rows, led = 0, 0
    for w, (cb, (tops, cnt, seven)) in enumerate(zip(emitted, expect)):
        keys = key_ids(cb.columns["deviceId"])
        live = np.nonzero(cnt > 0)[0]
        check(cb.n == len(live) and (np.sort(keys) == live).all(),
              f"{what} window {w}: emitted keys differ")
        check((cb.columns["c"] == cnt[keys]).all(),
              f"{what} window {w}: count")
        for key, top in zip(keys.tolist(), cb.columns["top"].tolist()):
            want = [{"value": values[c], "count": n} for c, n in tops[key]]
            check(top == want, f"{what} window {w} key {key}: {top} != "
                  f"{want}")
            led += bool(top) and top[0]["value"] == 7
            # another code leads only where 7's exact count does not
            # exceed the leader's (over-)estimate
            check(top[0]["value"] == 7 or seven[key] <= top[0]["count"],
                  f"{what} window {w} key {key}: 7 ({seven[key]:.0f} rows) "
                  f"behind {top[0]}")
        n_rows += cb.n
    check(led >= 0.99 * n_rows, f"{what}: 7 leads only {led} of {n_rows} "
          "lists")
    return n_rows, led


def run_hh_rule(torch, seed, kernels, mods):
    """Phase A: the heavy-hitters hopping rule on the card, every emitted
    row held against the numpy twin."""
    plan_fused_rule, ColumnBatch, Trigger = mods
    rng = np.random.default_rng(seed + 7)
    ids = np.array([f"dev_{i}" for i in range(N_KEYS)], dtype=np.object_)
    node = plan_fused_rule(HH_RULE, key_slots=SLOTS, micro_batch=ROWS,
                           options=SYNC)
    check(node.gb.device.type == "cuda", "rule is not on the card")
    check(node.gb.capacity == 2048, "heavy-hitters state does not start "
          f"at 2,048 slots ({node.gb.capacity})")
    emitted = []
    node.broadcast = emitted.append
    # host time by stage: key encode + the value dictionary + column build,
    # upload + closures + fold launches; at each boundary the finalize
    # (kernels, one copy, the top-k dedupe), its dedupe alone, the value
    # decode
    stages = dict.fromkeys(("encode", "fold", "finalize", "assemble",
                            "decode"), 0.0)
    node._build_kernel_inputs = timed(node._build_kernel_inputs, stages,
                                      "encode")
    node.gb.fold = timed(node.gb.fold, stages, "fold")
    node.gb.finalize = timed(node.gb.finalize, stages, "finalize")
    node.gb.hh_assemble = timed(node.gb.hh_assemble, stages, "assemble")
    node._decode_hh = timed(node._decode_hh, stages, "decode")
    twin = HHTwin()
    expect = []
    kernels.reset_launches()
    emit_ms, wall = [], 0.0
    for w in range(SKETCH_WINDOWS):
        idx = rng.integers(0, N_KEYS, (SKETCH_BATCHES, ROWS))
        code = skewed_codes(rng, SKETCH_BATCHES * ROWS).reshape(idx.shape)
        last = w == SKETCH_WINDOWS - 1
        with device_trace(torch, last) as trace:
            t0 = time.perf_counter()
            for b in range(SKETCH_BATCHES):
                node.process(ColumnBatch(n=ROWS, columns={
                    "deviceId": ids[idx[b]], "code": code[b]},
                    emitter="demo"))
            t = time.perf_counter()
            node.on_trigger(Trigger(ts=(w + 1) * 5_000))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        emit_ms.append((t1 - t) * 1e3)
        wall += t1 - t0
        if last:
            busy = trace.busy_us() / ((t1 - t0) * 1e6)
        expect.append(twin.close_window(w, idx, code))
    launches = dict(kernels.LAUNCHES)
    check(node.gb.capacity == SLOTS and node.state["hh"].shape[1] == SLOTS,
          f"heavy-hitters state at {node.gb.capacity} slots, want {SLOTS}")
    n_rows, led = check_hh_windows(emitted, expect, twin.codes.values,
                                   "phase A")
    n_b = SKETCH_WINDOWS * SKETCH_BATCHES
    return launches, dict(
        rows=n_rows, led_by_7=led, rows_per_s=n_b * ROWS / wall,
        emit_ms=emit_ms, busy=busy,
        stages={k: v * 1e3 / (n_b if k in ("encode", "fold")
                              else SKETCH_WINDOWS)
                for k, v in stages.items()})


class device_trace:
    """Optionally profile the card's activity (CUPTI) over a block;
    busy_us() sums the device time of its kernels and copies."""

    def __init__(self, torch, on: bool):
        self.torch, self.on, self.prof = torch, on, None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def busy_us(self) -> float:
        cuda = self.torch.autograd.DeviceType.CUDA
        return float(sum(e.time_range.elapsed_us() for e in self.prof.events()
                         if e.device_type == cuda))


def twin_hll(values):
    """(register, rho) per float32 value, from the definition: two salted
    splitmix32 hashes of the bits; rho = 33 - (highest set bit of
    float32(max(h2, 1)))."""
    bits = values.view(U32)
    h1 = np_splitmix32(bits ^ U32(0x9E3779B9))
    h2 = np_splitmix32(bits ^ U32((0x9E3779B9 * 2) & 0xFFFFFFFF))
    hv = np.maximum(h2, U32(1)).astype(np.float32)
    rho = 159 - ((hv.view(U32) >> U32(23)) & U32(0xFF)).astype(np.int64)
    return (h1 & U32(HLL_M - 1)).astype(np.int64), rho


def twin_registers(flat, rho):
    """(N_KEYS, HLL_M) registers: the largest rho at each flat index."""
    regs = np.zeros(N_KEYS * HLL_M, dtype=np.int64)
    np.maximum.at(regs, flat, rho)
    return regs.reshape(N_KEYS, HLL_M)


def twin_hll_estimate(regs):
    """float32 HLL estimate, rounded half to even, per row of regs."""
    regs = regs.astype(np.float32)
    m = np.float32(HLL_M)
    z = np.exp2(-regs).sum(axis=1, dtype=np.float32)
    raw = np.float32(0.7213 / (1.0 + 1.079 / HLL_M) * HLL_M * HLL_M) / z
    zeros = (regs == 0).sum(axis=1)
    small = m * np.log(m / np.maximum(zeros, 1).astype(np.float32))
    return np.rint(np.where((raw < 2.5 * HLL_M) & (zeros > 0), small, raw))


def twin_bins(values, edge=1e-5):
    """(bin, near_edge) per value: the signed log bin from the float64
    bin position, and whether that position lies within `edge` of a bin
    edge (where the card's float32 log may land one bin over)."""
    mag = np.clip(np.abs(values.astype(np.float64)), HIST_LO,
                  HIST_HI * 0.999)
    pos = np.log(mag / HIST_LO) / LOG_GAMMA
    idx = np.clip(np.floor(pos), 0, HIST_HALF - 1).astype(np.int64)
    near = np.abs(pos - np.round(pos)) < edge
    b = np.where(values > 0, HIST_HALF + 1 + idx,
                 np.where(values < 0, HIST_HALF - 1 - idx, HIST_HALF))
    return b, near


def twin_quantile_bin(hist, frac):
    total = hist.sum(axis=1).astype(np.float32)
    cum = np.cumsum(hist, axis=1)
    target = np.maximum(np.float32(frac) * total, np.float32(1e-9))
    return np.argmax(cum >= target[:, None], axis=1), total


def value_bin(v):
    """The bin whose centre the card's percentile value is (nearest centre
    in float64; centres lie ~5 % apart)."""
    mag = np.arange(HIST_HALF)
    centre = HIST_LO * np.exp(mag * LOG_GAMMA) * np.sqrt(np.exp(LOG_GAMMA))
    a = np.maximum(np.abs(v.astype(np.float64)), HIST_LO)
    m = np.abs(np.log(a[:, None] / centre[None, :])).argmin(axis=1)
    return np.where(v > 0, HIST_HALF + 1 + m,
                    np.where(v < 0, HIST_HALF - 1 - m, HIST_HALF))


def wide_data(rng, tag):
    """One interval of a sketch rule's rows: key indices and values
    (temperature N(20, 5), or humidity on its 1,000 one-decimal values)."""
    idx = rng.integers(0, N_KEYS, (SKETCH_BATCHES, ROWS))
    if tag == "pct":
        vals = rng.normal(20, 5, (SKETCH_BATCHES, ROWS)).astype(np.float32)
    else:
        vals = (rng.integers(0, 1000, (SKETCH_BATCHES, ROWS))
                / 10).astype(np.float32)
    return idx, vals


def check_wide_windows(tag, emitted, spans, span, what):
    """Every emitted value of a sketch rule against the twins: the
    percentile in the twin's bin (one over only at a bin edge), hll within
    ±1. Returns (rows, rows one bin over, mean sketch error)."""
    check(len(emitted) == len(spans),
          f"{what}: {len(emitted)} windows, want {len(spans)}")
    n_rows, edge_rows, errs = 0, 0, []
    for w, cb in enumerate(emitted):
        ks = np.concatenate([s[0] for s in spans[max(0, w - span + 1):
                                                 w + 1]])
        vs = np.concatenate([s[1] for s in spans[max(0, w - span + 1):
                                                 w + 1]])
        keys = key_ids(cb.columns["deviceId"])
        live = np.nonzero(np.bincount(ks, minlength=N_KEYS))[0]
        check(cb.n == len(live) and (np.sort(keys) == live).all(),
              f"{what} window {w}: emitted keys differ")
        if tag == "pct":
            b, near = twin_bins(vs)
            hist = np.bincount(ks * HIST_BINS + b,
                               minlength=N_KEYS * HIST_BINS).reshape(
                                   N_KEYS, HIST_BINS)
            qb, _ = twin_quantile_bin(hist, 0.9)
            edge_key = np.zeros(N_KEYS, dtype=bool)
            edge_key[ks[near]] = True
            got = value_bin(np.asarray(cb.columns["p90"], dtype=np.float32))
            d = np.abs(got - qb[keys])
            check(((d == 0) | ((d == 1) & edge_key[keys])).all(),
                  f"{what} window {w}: percentile bin differs")
            edge_rows += int((d == 1).sum())
            errs.append(exact_quantile_err(ks, vs, keys, cb.columns["p90"],
                                           0.9))
        else:
            reg, rho = twin_hll(vs)
            regs = twin_registers(ks * HLL_M + reg, rho)
            est = twin_hll_estimate(regs)
            u = np.asarray(cb.columns["u"], dtype=np.float64)
            check((np.abs(u - est[keys]) <= 1).all(),
                  f"{what} window {w}: estimate beyond ±1 "
                  f"(max {np.abs(u - est[keys]).max()})")
            exact = (np.bincount(ks * 1000 + np.rint(vs * 10).astype(
                np.int64), minlength=N_KEYS * 1000).reshape(N_KEYS, 1000)
                > 0).sum(axis=1)
            errs.append(float(np.mean(np.abs(u - exact[keys])
                                      / exact[keys])))
        n_rows += cb.n
    return n_rows, edge_rows, float(np.mean(errs))


def run_wide_rules(torch, seed, kernels, mods, windows=SKETCH_WINDOWS):
    """Phase B: the percentile tumbling rule and the hll hopping rule on
    the card against the twins, `windows` windows (hop boundaries) each;
    prints the sketches' error against exact quantiles and distinct counts
    (not gated)."""
    plan_fused_rule, ColumnBatch, Trigger = mods
    rng = np.random.default_rng(seed + 8)
    ids = np.array([f"dev_{i}" for i in range(N_KEYS)], dtype=np.object_)
    out = {}
    for tag, sql, interval, span in (("pct", PCT_RULE, 10_000, 1),
                                     ("hll", HLL_RULE, 5_000, 2)):
        node = plan_fused_rule(sql, key_slots=SLOTS, micro_batch=ROWS,
                               options=SYNC)
        check(node.gb.device.type == "cuda", "rule is not on the card")
        emitted = []
        node.broadcast = emitted.append
        spans = []  # per interval: (key idx, values)
        kernels.reset_launches()
        emit_ms = []
        col = "temperature" if tag == "pct" else "humidity"
        for w in range(windows):
            idx, vals = wide_data(rng, tag)
            for b in range(SKETCH_BATCHES):
                node.process(ColumnBatch(n=ROWS, columns={
                    "deviceId": ids[idx[b]], col: vals[b]}, emitter="demo"))
            t = time.perf_counter()
            node.on_trigger(Trigger(ts=(w + 1) * interval))
            torch.cuda.synchronize()
            emit_ms.append((time.perf_counter() - t) * 1e3)
            spans.append((idx.ravel(), vals.ravel()))
        launches = dict(kernels.LAUNCHES)
        n_rows, edge_rows, err = check_wide_windows(tag, emitted, spans,
                                                    span, tag)
        out[tag] = dict(launches=launches, rows=n_rows, edge_rows=edge_rows,
                        sketch_err=err, emit_ms=emit_ms)
    return out


def exact_quantile_err(ks, vs, keys, got, q):
    """Mean relative error of the card's percentile against np.quantile
    of each emitted key's values (linear interpolation)."""
    order = np.lexsort((vs, ks))
    ks, vs = ks[order], vs[order].astype(np.float64)
    start = np.searchsorted(ks, keys)
    n = np.searchsorted(ks, keys, side="right") - start
    pos = q * (n - 1)
    lo, hi = np.floor(pos).astype(np.int64), np.ceil(pos).astype(np.int64)
    exact = vs[start + lo] + (vs[start + hi] - vs[start + lo]) * (pos - lo)
    return float(np.mean(np.abs(np.asarray(got, dtype=np.float64) - exact)
                         / np.abs(exact)))


# ---------------------------------------- phase 2, the prefinalize kernels
def library_components(torch, state, pm, comps, kernels):
    """Yardstick, never called by the port: the pane merge as PyTorch's
    own calls, where + sum/amin/amax over the pane axis per component,
    then one cat."""
    C = state["act"].shape[1]
    parts = []
    for comp in comps:
        arr = state[comp]
        m = pm.view(-1, *([1] * (arr.dim() - 1)))
        if comp == "mn":
            r = torch.where(m, arr, float("inf")).amin(dim=0)
        elif comp in ("mx", "hll"):
            r = torch.where(m, arr, float("-inf")).amax(dim=0)
        else:
            r = torch.where(m, arr, 0.0).sum(dim=0)
        parts.append(r.reshape(C, -1))
    return torch.cat(parts, dim=1)


def library_absorb(torch, state, shadow, pane):
    """Yardstick: one in-place add_ / minimum / maximum per component."""
    for comp, sh in shadow.items():
        dst = state[comp][pane, :sh.shape[0]]
        if comp == "mn":
            torch.minimum(dst, sh, out=dst)
        elif comp in ("mx", "hll"):
            torch.maximum(dst, sh, out=dst)
        else:
            dst.add_(sh)


def random_shadow(torch, gb, state, rng, dev):
    """A shadow's components over every slot: small integer counters and
    registers, N(20, 5) sums, mins and maxes."""
    C = gb.capacity
    out = {}
    for comp, arr in state.items():
        shape = (C, *arr.shape[2:])
        if comp in ("s1", "s2", "mn", "mx"):
            host = rng.normal(20, 5, shape).astype(np.float32)
        else:
            host = rng.integers(0, 5, shape).astype(np.float32)
        out[comp] = torch.from_numpy(host).to(dev)
    return out


def prefinalize_kernel_checks(torch, seed, kernels, plan_fused_rule, dev):
    """groupby_components and groupby_absorb against their plain versions
    at the phase C rules' full state: the merge bit-equal under the full,
    a subset and the empty mask (the -inf / +inf identities); the absorb
    bit-equal (one add, min or max per element)."""
    rows = {}
    for tag, sql in (("tumbling", TUMBLING), ("hopping", HOPPING),
                     ("pct", PCT_RULE), ("hll", HLL_RULE)):
        node = plan_fused_rule(sql, key_slots=SLOTS, micro_batch=ROWS,
                               device=dev)
        gb = node.gb
        P = gb.n_panes
        st = gb.init_state()
        for pane in range(P):
            base, V, M, s_dev, _ = sketch_inputs(torch, gb, seed + 70 + pane,
                                                 dev)
            kernels.fold_scalar_plain(st, base, V, M, s_dev, pane,
                                      gb._colmap)
            if len(gb._widemap):
                kernels.fold_wide_plain(st, V, M, s_dev, pane, gb._widemap)
        comps = gb._comp_order
        width = sum(st[c][0, 0].numel() for c in comps)
        for panes in [None, []] + ([[1]] if P == 2 else []):
            pm = gb._pane_mask(panes)
            mtag = ("full" if panes is None else
                    f"subset{panes}" if panes else "empty")
            got = kernels.groupby_components(st, pm, comps)
            ref = kernels.components_plain(st, pm, comps)
            torch.cuda.synchronize()
            g, r = got.cpu().numpy(), ref.cpu().numpy()
            check(g.shape == (SLOTS, width), f"components {tag}: shape "
                  f"{g.shape}")
            check(((g == r) | (np.isnan(g) & np.isnan(r))).all(),
                  f"components {tag} {mtag}: differs from plain at "
                  f"{int((g != r).sum())} places")
            if not panes and panes is not None:
                act = g[:, -1]
                check((act == 0).all(), "empty mask: act not 0")
                continue
            fn = functools.partial(kernels.groupby_components, st, pm, comps)
            t_k = time_ms(torch, fn, REPS)
            split = launch_split(torch, fn, "components_kernel", REPS)
            t_p = time_ms(torch, lambda: kernels.components_plain(
                st, pm, comps), REPS)
            t_l = time_ms(torch, lambda: library_components(
                torch, st, pm, comps, kernels), REPS)
            live = int(pm.sum().item())
            nbytes = live * SLOTS * width * 4 + SLOTS * width * 4 + P
            b_ms, b_by = bound(nbytes, live * SLOTS * width)
            print(f"kernel groupby_components {tag} P={P} mask={mtag} "
                  f"C={SLOTS} W={width}: max_abs_err=0 kernel_ms={t_k:.4f} "
                  f"{split_text(split)} plain_ms={t_p:.4f} "
                  f"library_ms={t_l:.4f} bound_ms={b_ms:.5f} ({b_by}) "
                  f"MB_moved={nbytes / 1e6:.1f}")
            rows[f"groupby_components/{tag}/{mtag}"] = dict(
                max_abs_err=0.0, ms=t_k, **split, plain_ms=t_p,
                bound_ms=b_ms, bound_by=b_by, library_ms=t_l)
        if tag in ("tumbling", "pct"):
            rng = np.random.default_rng(seed + 80)
            sh = random_shadow(torch, gb, st, rng, dev)
            a, b = clone_state(st), clone_state(st)
            kernels.groupby_absorb(a, sh, 0)
            kernels.absorb_plain(b, sh, 0)
            torch.cuda.synchronize()
            state_err(a, b, exact=tuple(a))
            fn = functools.partial(kernels.groupby_absorb, a, sh, 0)
            t_k = time_ms(torch, fn, REPS)
            split = launch_split(torch, fn, "absorb_kernel", REPS)
            t_p = time_ms(torch, lambda: kernels.absorb_plain(b, sh, 0), REPS)
            t_l = time_ms(torch, lambda: library_absorb(torch, b, sh, 0),
                          REPS)
            sh_bytes = sum(x.numel() for x in sh.values()) * 4
            b_ms, b_by = bound(3 * sh_bytes, sh_bytes // 4)
            print(f"kernel groupby_absorb {tag} P={P} C={SLOTS}: "
                  f"max_abs_err=0 kernel_ms={t_k:.4f} {split_text(split)} "
                  f"plain_ms={t_p:.4f} library_ms={t_l:.4f} "
                  f"bound_ms={b_ms:.5f} ({b_by})")
            rows[f"groupby_absorb/{tag}"] = dict(
                max_abs_err=0.0, ms=t_k, **split, plain_ms=t_p,
                bound_ms=b_ms, bound_by=b_by, library_ms=t_l)
            del a, b, sh
        del st
        torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------ phase C
#: a trigger interval's 16 batch times: 14 spread over its first 84 %,
#: then two in the tail, after the 2x-lead pre-trigger (the reference's
#: 250 ms lead: pre-triggers at interval - 500 and interval - 250)
def batch_offsets(interval):
    return [i * interval * 6 // 100 for i in range(14)] + [
        interval - 400, interval - 200]


#: device-side sleep that holds a pre-issue's copy past its boundary in
#: phase C2 (cycles of the SM clock; ~100 ms at 1.98 GHz)
SLEEP_CYCLES = 200_000_000


class BoundaryProbe:
    """What phase C reads off one node: each boundary's stall on the fold
    thread (on_trigger wall time, no synchronize: the fold thread goes on
    when it returns), each window's delivery (wall time and
    last_emit_info), every fetch the node started, and the shadow folds'
    host time, split into the backstop's and the pre-issues' shadows."""

    def __init__(self, node, prefinalize):
        self.node = node
        self.stall_ms, self.t_trigger, self.deliveries = [], [], []
        self.fetches = []
        self.folds = {"tail": [], "backstop": []}
        on_trigger = node.on_trigger

        def timed_trigger(trig):
            t = time.perf_counter()
            self.t_trigger.append(t)
            on_trigger(trig)
            self.stall_ms.append((time.perf_counter() - t) * 1e3)

        node.on_trigger = timed_trigger
        node.broadcast = lambda item: self.deliveries.append(
            (time.perf_counter(), item, dict(node.last_emit_info or {})))
        for name in ("prefinalize_begin", "finalize_begin"):
            fn = getattr(node.gb, name)

            def begin(*a, _fn=fn, **k):
                pending = _fn(*a, **k)
                self.fetches.append(pending)
                return pending

            setattr(node.gb, name, begin)
        self._pf = prefinalize
        self._fold = prefinalize.HostShadow.fold

        def fold(shadow, *a, **k):
            t = time.perf_counter()
            self._fold(shadow, *a, **k)
            pipe = node._pipeline
            kind = ("backstop" if pipe and pipe[0][1] is shadow
                    and isinstance(pipe[0][0], prefinalize.IdentityFinalize)
                    else "tail")
            self.folds[kind].append((time.perf_counter() - t) * 1e3)

        prefinalize.HostShadow.fold = fold

    def close(self):
        self._pf.HostShadow.fold = self._fold

    def summary(self):
        delivery = [t - self.t_trigger[i]
                    for i, (t, _, _) in enumerate(self.deliveries)]
        copies = [(p.nbytes, p.copy_ms()) for p in self.fetches]
        landed = [(n, c) for n, c in copies if c is not None]
        fetch = [d["fetch_ms"] for _, _, d in self.deliveries
                 if d.get("fetch_ms") is not None]
        sources = {}
        for _, _, d in self.deliveries:
            sources[d.get("source")] = sources.get(d.get("source"), 0) + 1
        return dict(
            stall_p50=pct(self.stall_ms, 50), stall_p99=pct(self.stall_ms, 99),
            delivery_p50=pct(delivery, 50) * 1e3,
            delivery_p99=pct(delivery, 99) * 1e3,
            fetch_ms_p50=pct(fetch, 50) if fetch else None,
            fetches=len(copies),
            d2h_mb=(landed[0][0] / 1e6) if landed else None,
            copy_ms_p50=pct([c for _, c in landed], 50) if landed else None,
            d2h_gb_s=(sum(n for n, _ in landed)
                      / sum(c for _, c in landed) / 1e6) if landed else None,
            fold_tail_ms=(float(np.mean(self.folds["tail"]))
                          if self.folds["tail"] else None),
            fold_backstop_ms=(float(np.mean(self.folds["backstop"]))
                              if self.folds["backstop"] else None),
            sources=sources)


def fused_node(mods, sql, opts, backstop):
    """A rule's node as plan_fused_rule builds it, but with the backstop
    switch the reference's node takes (no rule option sets it)."""
    plan_fused_rule = mods[0]
    node = plan_fused_rule(sql, key_slots=SLOTS, micro_batch=ROWS,
                           options=opts)
    if not backstop:
        from ekuiper_tpu_torch.runtime.nodes_fused import FusedWindowAggNode

        node = FusedWindowAggNode(
            node.name, node.window, node.plan, node.dims, capacity=SLOTS,
            micro_batch=ROWS, direct_emit=node.direct_emit,
            emit_columnar=True, prefinalize_lead_ms=node.prefinalize_lead_ms,
            prefinalize_backstop=False, tail_mode=node.tail_mode)
    return node


def drive_on_clock(torch, node, batches, interval, hook=None):
    """Open `node` (or each node of a list, fed alike) on a fresh mock
    clock and feed it batches[w][i] at w * interval +
    batch_offsets(interval)[i]; the boundaries and their pre-triggers fire
    from the clock. `hook(w, t)` runs before each move to t. Returns the
    wall seconds, deliveries drained, card synchronized."""
    from ekuiper_tpu_torch.utils import timex

    nodes = node if isinstance(node, list) else [node]
    clock = timex.set_mock_clock(0)
    for n in nodes:
        n.on_open()
    offs = batch_offsets(interval)
    t0 = time.perf_counter()
    for w, window in enumerate(batches):
        for i, batch in enumerate(window):
            t = w * interval + offs[i]
            if hook is not None:
                hook(w, t)
            clock.set(t)
            for n in nodes:
                n.process(batch)
        clock.set((w + 1) * interval)
    for n in nodes:
        n._drain_async_emits()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for n in nodes:
        n.on_close()
    timex.use_real_clock()
    return wall


def phase_c_run(torch, kernels, prefinalize, mods, sql, interval, batches,
                opts=None, backstop=True, hook=None, node=None):
    node = node or fused_node(mods, sql, opts, backstop)
    check(node.gb.device.type == "cuda", "rule is not on the card")
    probe = BoundaryProbe(node, prefinalize)
    kernels.reset_launches()
    try:
        wall = drive_on_clock(torch, node, batches, interval, hook)
    finally:
        probe.close()
    launches = dict(kernels.LAUNCHES)
    check(not node.recoveries, f"recovery routes taken: "
          f"{dict(node.recoveries)}")
    n_rows = sum(len(w) for w in batches) * ROWS
    out = probe.summary()
    out.update(rows_per_s=n_rows / wall, launches=launches)
    emitted = [item for _, item, _ in probe.deliveries]
    return node, emitted, out


def scalar_batches(rng, ColumnBatch):
    batches, idx, temp = make_batches(rng, ColumnBatch, WINDOWS * BATCHES)
    parts = [reference_aggs(idx[w * BATCHES:(w + 1) * BATCHES],
                            temp[w * BATCHES:(w + 1) * BATCHES], N_KEYS)
             for w in range(WINDOWS)]
    return [batches[w * BATCHES:(w + 1) * BATCHES]
            for w in range(WINDOWS)], parts


def check_scalar_windows(emitted, parts, span, what):
    check(len(emitted) == len(parts),
          f"{what}: {len(emitted)} windows, want {len(parts)}")
    worst = 0.0
    for w, cb in enumerate(emitted):
        ref = merge_aggs(parts[max(0, w - span + 1):w + 1])
        worst = max(worst, check_window(cb, ref, "sd_t" in cb.columns,
                                        f"{what} window {w}"))
    return worst


def partials_err(got, ref, what):
    """Two snapshots' partials: counts, act, min, max exact; sums rtol
    1e-5 (a host shadow's float64 bincount against float32 atomics)."""
    worst = 0.0
    for comp, r in ref["partials"].items():
        g, r = np.asarray(got["partials"][comp]), np.asarray(r)
        with np.errstate(invalid="ignore"):  # inf - inf at identities
            d = np.abs(g.astype(np.float64) - r)
        fin = np.isfinite(r)
        check((g[~fin] == r[~fin]).all(), f"{what} {comp}: identity")
        if comp in ("s1", "s2"):
            check((d[fin] <= 1e-5 * np.abs(r[fin])).all(),
                  f"{what} {comp}: beyond rtol 1e-5")
        else:
            check((d[fin] == 0).all(), f"{what} {comp}: differs")
        worst = max(worst, float(d[fin].max(initial=0.0)))
    return worst


def run_phase_c(torch, seed, kernels, prefinalize, mods):
    """Phase C: the boundary as the reference runs it by default
    (prefinalizeLeadMs 250, tailMode device, the tumbling backstop),
    timers on the mock clock, full data size."""
    plan_fused_rule, ColumnBatch, Trigger = mods
    res = {}
    ok_sources = {"device", "backstop", "device-async-late", "device-async"}

    # C1: the flagship tumbling rule, three runs
    rng = np.random.default_rng(seed + 20)
    batches, parts = scalar_batches(rng, ColumnBatch)
    node, emitted, out = phase_c_run(torch, kernels, prefinalize, mods,
                                     TUMBLING, 10_000, batches)
    out["max_abs_err"] = check_scalar_windows(emitted, parts, 1, "C1")
    res["c1"] = out
    node, emitted, out = phase_c_run(torch, kernels, prefinalize, mods,
                                     TUMBLING, 10_000, batches,
                                     backstop=False)
    out["max_abs_err"] = check_scalar_windows(emitted, parts, 1,
                                              "C1 no backstop")
    check(out["sources"] == {"device": WINDOWS},
          f"C1 no backstop: boundaries served by {out['sources']}")
    res["c1_nobackstop"] = out
    snaps = {}
    host_node = fused_node(mods, TUMBLING, {"tailMode": "host"}, True)

    def snapshot_in_frozen_span(w, t):
        # after the first tail batch (9600), before the 1x-lead refresh
        if w == 2 and t == 2 * 10_000 + 9800:
            check(host_node._device_frozen, "C1 host tail: not frozen")
            snaps["host"] = host_node.snapshot_state()

    node, emitted, out = phase_c_run(
        torch, kernels, prefinalize, mods, TUMBLING, 10_000, batches,
        hook=snapshot_in_frozen_span, node=host_node)
    check(out["launches"]["groupby_absorb"] == 1,
          f"C1 host tail: {out['launches']['groupby_absorb']} absorbs")
    out["max_abs_err"] = check_scalar_windows(emitted, parts, 1,
                                              "C1 host tail")
    # the lead-0 twin, fed the same batches up to the snapshot
    twin = plan_fused_rule(TUMBLING, key_slots=SLOTS, micro_batch=ROWS,
                           options=SYNC)
    twin.broadcast = lambda item: None
    for w in range(3):
        for b in batches[w][:15 if w == 2 else BATCHES]:
            twin.process(b)
        if w < 2:
            twin.on_trigger(Trigger(ts=(w + 1) * 10_000))
    out["absorb_partials_err"] = partials_err(snaps["host"],
                                              twin.snapshot_state(),
                                              "C1 host tail snapshot")
    res["c1_host"] = out
    del twin, batches, host_node

    # C2: the hopping stddev rule; every other window's pre-issue held on
    # the card past its boundary, so that boundary goes to the worker
    rng = np.random.default_rng(seed + 21)
    batches, parts = scalar_batches(rng, ColumnBatch)

    def hold_the_card(w, t):
        if w % 2 == 1 and t == w * 5_000 + 4_600:  # the move that fires
            torch.cuda._sleep(SLEEP_CYCLES)       # the 2x-lead pre-issue

    node, emitted, out = phase_c_run(torch, kernels, prefinalize, mods,
                                     HOPPING, 5_000, batches,
                                     hook=hold_the_card)
    out["max_abs_err"] = check_scalar_windows(emitted, parts, 2, "C2")
    check(out["sources"].get("device-async-late", 0) >= 1,
          f"C2: no boundary went to the worker ({out['sources']})")
    res["c2"] = out
    del batches

    # C3: the percentile and hll rules (wide components)
    ids = np.array([f"dev_{i}" for i in range(N_KEYS)], dtype=np.object_)
    for tag, sql, interval, span, col in (
            ("pct", PCT_RULE, 10_000, 1, "temperature"),
            ("hll", HLL_RULE, 5_000, 2, "humidity")):
        rng = np.random.default_rng(seed + 22)
        spans, batches = [], []
        for w in range(WINDOWS):
            idx, vals = wide_data(rng, tag)
            spans.append((idx.ravel(), vals.ravel()))
            batches.append([ColumnBatch(n=ROWS, columns={
                "deviceId": ids[idx[b]], col: vals[b]}, emitter="demo")
                for b in range(SKETCH_BATCHES)])
        node, emitted, out = phase_c_run(torch, kernels, prefinalize, mods,
                                         sql, interval, batches)
        out["rows"], out["edge_rows"], out["sketch_err"] = \
            check_wide_windows(tag, emitted, spans, span, f"C3 {tag}")
        res[f"c3_{tag}"] = out
        del batches, node
        torch.cuda.empty_cache()

    # C4: heavy hitters on the async emit
    rng = np.random.default_rng(seed + 23)
    twin = HHTwin()
    expect, batches = [], []
    for w in range(WINDOWS):
        idx = rng.integers(0, N_KEYS, (SKETCH_BATCHES, ROWS))
        code = skewed_codes(rng, SKETCH_BATCHES * ROWS).reshape(idx.shape)
        batches.append([ColumnBatch(n=ROWS, columns={
            "deviceId": ids[idx[b]], "code": code[b]}, emitter="demo")
            for b in range(SKETCH_BATCHES)])
        expect.append(twin.close_window(w, idx, code))
    node, emitted, out = phase_c_run(torch, kernels, prefinalize, mods,
                                     HH_RULE, 5_000, batches)
    out["rows"], out["led_by_7"] = check_hh_windows(
        emitted, expect, twin.codes.values, "C4")
    check(out["sources"] == {"device-async": WINDOWS},
          f"C4: boundaries served by {out['sources']}")
    res["c4_hh"] = out
    for tag, r in res.items():
        bad = set(r["sources"]) - ok_sources
        check(not bad, f"{tag}: boundaries served by {sorted(bad)}")
    return res


def phase_c_line(tag, r):
    f = lambda x, d=3: "n/a" if x is None else f"{x:.{d}f}"  # noqa: E731
    return (f"phase C {tag}: rows/s={r['rows_per_s']:.0f} "
            f"stall_p50_ms={r['stall_p50']:.3f} "
            f"stall_p99_ms={r['stall_p99']:.3f} "
            f"delivery_p50_ms={r['delivery_p50']:.3f} "
            f"delivery_p99_ms={r['delivery_p99']:.3f} "
            f"fetch_ms_p50(engine clock)={f(r['fetch_ms_p50'], 1)} "
            f"fetches={r['fetches']} d2h_MB={f(r['d2h_mb'])} "
            f"copy_ms_p50={f(r['copy_ms_p50'], 4)} "
            f"d2h_GB_s={f(r['d2h_gb_s'], 2)} "
            f"shadow_fold_ms tail={f(r['fold_tail_ms'])} "
            f"backstop={f(r['fold_backstop_ms'])} "
            f"sources={r['sources']} launches={r['launches']}")


def pct(xs, q):
    return float(np.percentile(np.asarray(xs), q))



# ------------------------------------------- phase 2, the sliding ring
def rand_state(torch, gen, comp, shape, dev):
    """A component's values on the card, from the generator: small integer
    counters and registers, N(20, 5) sums, min/max with some identities."""
    if comp in ("n", "act", "hist"):
        return torch.randint(0, 6, shape, generator=gen, device=dev,
                             dtype=torch.float32)
    if comp == "hll":
        return torch.randint(0, 30, shape, generator=gen, device=dev,
                             dtype=torch.float32)
    v = torch.normal(20.0, 5.0, shape, generator=gen, device=dev)
    if comp in ("mn", "mx"):
        ident = float("inf") if comp == "mn" else float("-inf")
        v = torch.where(torch.rand(shape, generator=gen, device=dev) < 0.2,
                        ident, v)
    return v


def ring_err(got, ref, sum_rtol, what):
    """Ring tensors or query columns against the plain version: bit-equal,
    except the sums (s1/s2) within sum_rtol."""
    worst = 0.0
    for key in ref:
        g, r = got[key].cpu().numpy(), ref[key].cpu().numpy()
        same = (g == r) | (np.isnan(g) & np.isnan(r))
        if key.split("_", 1)[-1] in ("s1", "s2") and sum_rtol:
            with np.errstate(invalid="ignore"):
                d = np.abs(g.astype(np.float64) - r)
            ok = same | (d <= sum_rtol * np.abs(r))
            check(ok.all(), f"{what} {key}: beyond rtol {sum_rtol}")
            worst = max(worst, float(np.nan_to_num(d[~same]).max(
                initial=0.0)))
        else:
            check(same.all(), f"{what} {key}: differs from plain at "
                  f"{int((~same).sum())} places")
    return worst


def library_advance(torch, ring, st, comps, closed, evict, kernels):
    """Yardstick: add_ / sub_ per additive component, one in-place
    minimum / maximum per two-stack one."""
    for c in comps:
        if c in kernels.MERGE_OPS:
            back = ring["back_" + c]
            (torch.minimum if c == "mn" else torch.maximum)(
                back, st[c][closed], out=back)
        else:
            ring["tot_" + c].add_(st[c][closed]).sub_(st[c][evict])


def library_flip(torch, ring, st, comps, order_t, kernels):
    """Yardstick: index_select + sum per additive component; index_select,
    flip, cummin / cummax, flip, index_copy_ per two-stack one."""
    for c in comps:
        g = st[c].index_select(0, order_t)
        if c in kernels.MERGE_OPS:
            scan = torch.cummin if c == "mn" else torch.cummax
            ring["front_" + c].index_copy_(
                0, order_t, scan(g.flip(0), dim=0).values.flip(0))
            ring["back_" + c].fill_(kernels.INIT[c])
        else:
            torch.sum(g, dim=0, out=ring["tot_" + c])


def library_query(torch, ring, st, comps, q, kernels):
    """Yardstick: where + tensordot of the weighted slices per additive
    component, where + amin/amax per two-stack one, then one cat."""
    C = st["act"].shape[1]
    parts = []
    for c in comps:
        if c in kernels.MERGE_OPS:
            stack = torch.stack([ring["front_" + c][q["f_slot"]],
                                 ring["back_" + c], st[c][q["mm_slot"]]])
            v = (stack.amin(0) if c == "mn" else stack.amax(0))
        else:
            v = torch.tensordot(q["w_t"], st[c].index_select(
                0, q["slots_t"]), dims=1) + ring["tot_" + c]
        parts.append(v.reshape(C, -1))
    return torch.cat(parts, dim=1)


def ring_kernel_checks(torch, seed, kernels, plan_fused_rule, dev):
    """ring_advance, ring_flip and ring_query against their plain versions
    at the phase D rules' full state (16,384 slots; R = 52 / 132 / 11
    ring panes), with a steady-state query (front and back, two trailing
    subtractions, the head pane)."""
    rows = {}
    for tag, sql in (("pct", D1_RULE), ("scalar", D2_RULE), ("hll", D3_RULE)):
        node = plan_fused_rule(sql, key_slots=SLOTS, micro_batch=ROWS,
                               device=dev)
        ring, gb = node.ring, node.gb
        R, P = ring.n_ring_panes, gb.n_panes
        gen = torch.Generator(device=dev).manual_seed(seed + 90)
        st = {c: rand_state(torch, gen, c, tuple(a.shape), dev)
              for c, a in gb.init_state().items()}
        rs = {k: rand_state(torch, gen, k.split("_", 1)[1], tuple(a.shape),
                            dev)
              for k, a in ring.init_state().items()}
        comps = ring._comps
        per_slot = {c: st[c][0].numel() * 4 for c in comps}  # bytes a pane
        # advance: pane 1 closes, pane R - 1 is evicted
        got, ref = clone_state(rs), clone_state(rs)
        kernels.ring_advance(got, st, comps, 1, True, R - 1, True)
        kernels.ring_advance_plain(ref, st, comps, 1, True, R - 1, True)
        torch.cuda.synchronize()
        err = ring_err(got, ref, 0, f"ring_advance {tag}")
        fn = functools.partial(kernels.ring_advance, got, st, comps, 1, True,
                               R - 1, True)
        t_k = time_ms(torch, fn, REPS)
        split = launch_split(torch, fn, "ring_advance_kernel", REPS)
        t_p = time_ms(torch, lambda: kernels.ring_advance_plain(
            ref, st, comps, 1, True, R - 1, True), REPS)
        t_l = time_ms(torch, lambda: library_advance(
            torch, ref, st, comps, 1, R - 1, kernels), REPS)
        nbytes = sum((3 if c in kernels.MERGE_OPS else 4) * per_slot[c]
                     for c in comps)
        ops = sum(per_slot[c] // 4 * (1 if c in kernels.MERGE_OPS else 2)
                  for c in comps)
        b_ms, b_by = bound(nbytes, ops)
        print(f"kernel ring_advance {tag} R={R} C={SLOTS} comps={comps}: "
              f"max_abs_err={err:.3g} kernel_ms={t_k:.4f} "
              f"{split_text(split)} plain_ms={t_p:.4f} library_ms={t_l:.4f} "
              f"bound_ms={b_ms:.5f} ({b_by}) MB_moved={nbytes / 1e6:.1f}")
        rows[f"ring_advance/{tag}"] = dict(
            max_abs_err=err, ms=t_k, **split, plain_ms=t_p, bound_ms=b_ms,
            bound_by=b_by, library_ms=t_l)

        # flip: every ring slot live, the rotation starting at slot 5
        order = ((5 + np.arange(R)) % R).astype(np.int32)
        valid = np.ones(R, dtype=bool)
        got, ref = clone_state(rs), clone_state(rs)
        kernels.ring_flip(got, st, comps, order, valid)
        kernels.ring_flip_plain(ref, st, comps, order, valid)
        torch.cuda.synchronize()
        err = ring_err(got, ref, 1e-5, f"ring_flip {tag}")
        fn = functools.partial(kernels.ring_flip, got, st, comps, order,
                               valid)
        t_k = time_ms(torch, fn, REPS)
        split = launch_split(torch, fn, "ring_flip_kernel", REPS)
        t_p = time_ms(torch, lambda: kernels.ring_flip_plain(
            ref, st, comps, order, valid), REPS)
        order_t = torch.from_numpy(order.astype(np.int64)).to(dev)
        t_l = time_ms(torch, lambda: library_flip(
            torch, ref, st, comps, order_t, kernels), REPS)
        nbytes = sum(R * per_slot[c] + ((R + 1) * per_slot[c]
                                        if c in kernels.MERGE_OPS
                                        else per_slot[c]) for c in comps)
        ops = sum(R * per_slot[c] // 4 for c in comps)
        b_ms, b_by = bound(nbytes, ops)
        print(f"kernel ring_flip {tag} R={R} C={SLOTS}: max_abs_err={err:.3g} "
              f"kernel_ms={t_k:.4f} {split_text(split)} plain_ms={t_p:.4f} "
              f"library_ms={t_l:.4f} bound_ms={b_ms:.5f} ({b_by}) "
              f"MB_moved={nbytes / 1e6:.1f}")
        rows[f"ring_flip/{tag}"] = dict(
            max_abs_err=err, ms=t_k, **split, plain_ms=t_p, bound_ms=b_ms,
            bound_by=b_by, library_ms=t_l)

        # query: front[3] and back, panes 1 and 2 subtracted, the head
        # (pane R - 1) added
        q = dict(body_on=True, f_on=bool(ring.mm_comps), f_slot=3,
                 adj_slots=np.array([1, 2, R - 1, 0], np.int32),
                 adj_w=np.array([-1, -1, 1, 0], np.float32),
                 adj_mm=np.array([0, 0, 1, 0], bool))
        qc = ring._query_comps
        args = (q["body_on"], q["f_on"], q["f_slot"], q["adj_slots"],
                q["adj_w"], q["adj_mm"])
        out_k = kernels.ring_query(rs, st, qc, *args)
        out_p = kernels.ring_query_plain(rs, st, qc, *args)
        torch.cuda.synchronize()
        err = ring_err({"q": out_k}, {"q": out_p}, 0, f"ring_query {tag}")
        fn = functools.partial(kernels.ring_query, rs, st, qc, *args)
        t_k = time_ms(torch, fn, REPS)
        split = launch_split(torch, fn, "ring_query_kernel", REPS)
        t_p = time_ms(torch, lambda: kernels.ring_query_plain(
            rs, st, qc, *args), REPS)
        lq = dict(f_slot=3, mm_slot=R - 1,
                  w_t=torch.tensor([-1.0, -1.0, 1.0, 0.0], device=dev),
                  slots_t=torch.tensor([1, 2, R - 1, 0], device=dev))
        t_l = time_ms(torch, lambda: library_query(
            torch, rs, st, qc, lq, kernels), REPS)
        # additive: tot and the 4 weighted slices read, the result written;
        # two-stack: front[f], back and the head slice read, written
        nbytes = sum((6 if c not in kernels.MERGE_OPS else 4) * per_slot[c]
                     for c in qc)
        ops = sum(per_slot[c] // 4 * (8 if c not in kernels.MERGE_OPS else 3)
                  for c in qc)
        b_ms, b_by = bound(nbytes, ops)
        print(f"kernel ring_query {tag} R={R} C={SLOTS} "
              f"W={out_k.shape[1]}: max_abs_err={err:.3g} kernel_ms={t_k:.4f} "
              f"{split_text(split)} plain_ms={t_p:.4f} library_ms={t_l:.4f} "
              f"bound_ms={b_ms:.5f} ({b_by}) MB_moved={nbytes / 1e6:.1f}")
        rows[f"ring_query/{tag}"] = dict(
            max_abs_err=err, ms=t_k, **split, plain_ms=t_p, bound_ms=b_ms,
            bound_by=b_by, library_ms=t_l)
        if tag in ("scalar", "pct"):
            rows.update(row_pane_fold_check(torch, seed, kernels, gb, tag,
                                            dev))
        del st, rs, got, ref, node
        torch.cuda.empty_cache()
    return rows


def row_pane_fold_check(torch, seed, kernels, gb, tag, dev):
    """The fold (#1) with a per-row pane vector on the scalar (D2) or
    percentile (D1) plan, against its plain version: a 65,536-row batch
    whose first 40 % of rows land in pane 7 and the rest in pane 8 (a
    bucket edge)."""
    from ekuiper_tpu_torch.ops import sketches

    r = np.random.default_rng(seed + 95)
    temp = r.normal(20, 5, ROWS).astype(np.float32)
    cols = {"temperature": torch.from_numpy(temp).to(dev)}
    base, V, M = gb.spec_inputs(cols, ROWS)
    s_host = r.integers(0, N_KEYS, ROWS).astype(np.int32)
    slots = torch.from_numpy(s_host).to(dev)
    pv_host = np.where(np.arange(ROWS) < int(0.4 * ROWS), 7, 8).astype(
        np.uint8)
    pv = torch.from_numpy(pv_host).to(dev)
    got, ref = gb.init_state(), gb.init_state()
    cmap, wmap = gb._colmap, gb._widemap
    fn = functools.partial(kernels.groupby_fold, got, base, V, M, slots, 0,
                           cmap, wmap, pv)
    plain = functools.partial(kernels.fold_plain, ref, base, V, M, slots, 0,
                              cmap, wmap, pv)
    width = sum(a.shape[2] for k, a in got.items() if k in kernels.COMP_IDS)
    fn()
    plain()
    torch.cuda.synchronize()
    err = state_err(got, ref, exact=EXACT)
    t_k = time_ms(torch, fn, REPS)
    split = launch_split(torch, fn, FOLD_KERNEL, REPS)
    t_p = time_ms(torch, plain, REPS)
    upd = wide_updates(torch, gb, V, M, slots, pv.long(), sketches)
    every = fold_updates(torch, ref, base, V, M, slots, pv.long(), cmap,
                         kernels) + upd
    t_l = time_ms(torch, lambda: library_fold(torch, ref, every), REPS)
    touched = len(np.unique(pv_host.astype(np.int64) * SLOTS + s_host))
    n_wide = sum(len(idx) for _, idx, _, _ in upd)  # one bin or register
    nbytes = (V.numel() * 4 + M.numel() + ROWS * 5 + ROWS
              + touched * (width + 1) * 8 + n_wide * 8)
    n_upd = ROWS * (len(cmap) + 1) + n_wide
    b_ms, b_by = bound(nbytes, n_upd)
    name = "groupby_fold"
    print(f"kernel {name} pane_vec {tag} P={gb.n_panes} R={ROWS} C={SLOTS}: "
          f"max_abs_err={err[0]:.3g} kernel_ms={t_k:.4f} {split_text(split)} "
          f"plain_ms={t_p:.4f} library_ms={t_l:.4f} bound_ms={b_ms:.5f} "
          f"({b_by})")
    return {f"{name}/pane_vec" + ("" if tag == "scalar" else f"_{tag}"): dict(
        max_abs_err=err[0], ms=t_k, **split, plain_ms=t_p, bound_ms=b_ms,
        bound_by=b_by, library_ms=t_l)}


# ------------------------------------------------------------ phase D
class SlidingStream:
    """One phase D run's rows, made in bulk from the seed: key indices,
    temperature ~ N(20, 5) (99 at a random row of every 20th batch), for
    D3 humidity on its 1,000 one-decimal values, and row timestamps
    rising evenly, 62.5 ms a batch (plus the gap, where there is one)."""

    def __init__(self, rng, n_batches, humidity=False, gap_at=None,
                 codes=False):
        self.n = n_batches
        self.n_keys = N_KEYS
        self.idx = rng.integers(0, N_KEYS, (n_batches, ROWS)).astype(
            np.int32)
        self.temp = rng.normal(20, 5, (n_batches, ROWS)).astype(np.float32)
        for b in range(TRIGGER_EVERY - 1, n_batches, TRIGGER_EVERY):
            self.temp[b, rng.integers(0, ROWS)] = 99.0
        self.hum = (rng.integers(0, 1000, (n_batches, ROWS)).astype(np.int16)
                    if humidity else None)
        g = np.arange(n_batches * ROWS, dtype=np.int64)
        self.ts = T0_MS + g * BATCH_MS_NUM // (BATCH_MS_DEN * ROWS)
        if gap_at is not None:
            self.ts[gap_at * ROWS:] += GAP_MS
        self.ts = self.ts.reshape(n_batches, ROWS)
        # F1: phase A's skewed heavy-hitters codes
        self.code = (skewed_codes(rng, n_batches * ROWS).reshape(
            n_batches, ROWS) if codes else None)

    def batches(self, ColumnBatch):
        ids = np.array([f"dev_{i}" for i in range(self.n_keys)],
                       dtype=np.object_)
        out = []
        for b in range(self.n):
            cols = {"deviceId": ids[self.idx[b]], "temperature": self.temp[b]}
            if self.hum is not None:
                cols["humidity"] = (self.hum[b] / 10).astype(np.float32)
            if self.code is not None:
                cols["code"] = self.code[b]
            out.append(ColumnBatch(n=ROWS, columns=cols,
                                   timestamps=self.ts[b], emitter="demo"))
        return out

    def rows(self, lo, hi, received):
        """The global row range [a, b) of the rows in (lo, hi] among the
        first `received` rows."""
        flat = self.ts.reshape(-1)
        a = int(np.searchsorted(flat, lo, side="right"))
        b = min(int(np.searchsorted(flat, hi, side="right")), received)
        return a, max(a, b)


def batch_aggs(idx, t, n_keys=N_KEYS):
    """float64 count, sum, sum of squares, sum of |x|, min, max per key of
    one span of rows over key ids [0, n_keys) (bincount, and a sort for
    min/max)."""
    t = t.astype(np.float64)
    out = {"cnt": np.bincount(idx, minlength=n_keys).astype(np.float64),
           "sum": np.bincount(idx, weights=t, minlength=n_keys),
           "sumsq": np.bincount(idx, weights=t * t, minlength=n_keys),
           "sumabs": np.bincount(idx, weights=np.abs(t), minlength=n_keys),
           "min": np.full(n_keys, np.inf), "max": np.full(n_keys, -np.inf)}
    if len(idx):
        order = np.argsort(idx, kind="stable")
        k, v = idx[order], t[order]
        starts = np.nonzero(np.r_[True, k[1:] != k[:-1]])[0]
        out["min"][k[starts]] = np.minimum.reduceat(v, starts)
        out["max"][k[starts]] = np.maximum.reduceat(v, starts)
    return out


class ScalarTwin:
    """The float64 group-by of any row range of a stream: per-batch
    partials as prefix sums (counts and sums) and per-batch min/max, the
    two partial batches at the ends from their rows."""

    def __init__(self, stream):
        self.s = stream
        parts = [batch_aggs(stream.idx[b], stream.temp[b])
                 for b in range(stream.n)]
        self.prefix = {k: np.concatenate([np.zeros((1, N_KEYS)), np.cumsum(
            [p[k] for p in parts], axis=0)]) for k in ("cnt", "sum", "sumsq",
                                                       "sumabs")}
        self.mins = np.array([p["min"] for p in parts])
        self.maxs = np.array([p["max"] for p in parts])

    def window(self, a, b):
        idx, temp = self.s.idx.reshape(-1), self.s.temp.reshape(-1)
        ba, bb = -(-a // ROWS), b // ROWS
        if ba >= bb:
            return batch_aggs(idx[a:b], temp[a:b])
        ends = [batch_aggs(idx[a:ba * ROWS], temp[a:ba * ROWS]),
                batch_aggs(idx[bb * ROWS:b], temp[bb * ROWS:b])]
        mid = {k: self.prefix[k][bb] - self.prefix[k][ba] for k in self.prefix}
        mid["min"] = self.mins[ba:bb].min(axis=0)
        mid["max"] = self.maxs[ba:bb].max(axis=0)
        return merge_aggs([mid] + ends)


class PctTwin:
    """D1's percentile twin over the sliding row range [a, b): per-key
    histogram cells, counts and rows within D_EDGE of a bin edge, kept by
    adding the rows that enter the range and taking away those that leave
    it (a trigger's range only moves forward)."""

    def __init__(self, stream):
        ks = stream.idx.reshape(-1).astype(np.int64)
        vs = stream.temp.reshape(-1)
        self.ks = ks
        self.cell = np.empty(len(ks), dtype=np.int64)
        self.near = np.empty(len(ks), dtype=np.bool_)
        step = 16 * ROWS
        for lo in range(0, len(ks), step):
            bins, near = twin_bins(vs[lo:lo + step], D_EDGE)
            self.cell[lo:lo + step] = ks[lo:lo + step] * HIST_BINS + bins
            self.near[lo:lo + step] = near
        self.a = self.b = 0
        self.hist = np.zeros(N_KEYS * HIST_BINS, dtype=np.int64)
        self.cnt = np.zeros(N_KEYS, dtype=np.int64)
        self.n_near = np.zeros(N_KEYS, dtype=np.int64)

    def _add(self, lo, hi, sign):
        if hi <= lo:
            return
        self.hist += sign * np.bincount(self.cell[lo:hi],
                                        minlength=N_KEYS * HIST_BINS)
        ks = self.ks[lo:hi]
        self.cnt += sign * np.bincount(ks, minlength=N_KEYS)
        self.n_near += sign * np.bincount(ks[self.near[lo:hi]],
                                          minlength=N_KEYS)

    def window(self, a, b):
        if a < self.a or b < self.b or a >= self.b:
            for arr in (self.hist, self.cnt, self.n_near):
                arr[:] = 0
            self._add(a, b, 1)
        else:
            self._add(self.a, a, -1)
            self._add(self.b, b, 1)
        self.a, self.b = a, b


def check_pct_window(cb, twin, a, b, what):
    """D1: count(*) exact and p99 in the twin's bin (one over only for a
    key holding a value within D_EDGE of a bin edge). Returns rows one bin
    over."""
    twin.window(a, b)
    keys = key_ids(cb.columns["deviceId"])
    live = np.nonzero(twin.cnt)[0]
    check(cb.n == len(live) and (np.sort(keys) == live).all(),
          f"{what}: emitted keys differ")
    check((np.asarray(cb.columns["c"]) == twin.cnt[keys]).all(),
          f"{what}: count")
    qb, _ = twin_quantile_bin(twin.hist.reshape(N_KEYS, HIST_BINS), 0.99)
    got = value_bin(np.asarray(cb.columns["p99"], dtype=np.float32))
    d = np.abs(got - qb[keys])
    check(((d == 0) | ((d == 1) & (twin.n_near[keys] > 0))).all(),
          f"{what}: percentile bin differs at {int((d != 0).sum())} keys")
    return int((d == 1).sum())


class HllTwin:
    """D3: registers per key from the humidity values present (a value's
    register and rank depend on the value alone)."""

    def __init__(self):
        vals = (np.arange(1000) / 10).astype(np.float32)
        self.reg, self.rho = twin_hll(vals)
        # the values grouped by register: one maximum.reduceat a window
        self.order = np.argsort(self.reg, kind="stable")
        self.cols, self.starts = np.unique(self.reg[self.order],
                                           return_index=True)

    def check(self, cb, stream, a, b, what):
        ks = stream.idx.reshape(-1)[a:b].astype(np.int64)
        hv = stream.hum.reshape(-1)[a:b].astype(np.int64)
        present = np.bincount(ks * 1000 + hv, minlength=N_KEYS * 1000
                              ).reshape(N_KEYS, 1000) > 0
        ranks = np.where(present[:, self.order],
                         self.rho[self.order].astype(np.int8)[None, :],
                         np.int8(0))
        regs = np.zeros((N_KEYS, HLL_M), dtype=np.int64)
        regs[:, self.cols] = np.maximum.reduceat(ranks, self.starts, axis=1)
        keys = key_ids(cb.columns["deviceId"])
        live = np.nonzero(present.any(axis=1))[0]
        check(cb.n == len(live) and (np.sort(keys) == live).all(),
              f"{what}: emitted keys differ")
        est = twin_hll_estimate(regs)
        u = np.asarray(cb.columns["u"], dtype=np.float64)
        d = np.abs(u - est[keys])
        check((d <= 1).all(), f"{what}: estimate beyond ±1 (max {d.max()})")
        return int((d == 1).sum())


def run_sliding(torch, kernels, mods, sql, stream, what, options=None,
                impl="daba", sources=("device-ring",), hook=None, hold=(),
                key_slots=SLOTS):
    """Open the rule's node (rule `options`, `key_slots`, sliding
    implementation `impl`, `hook(node)` before its first batch) on a fresh
    mock clock and feed it
    the stream, each batch after the clock moves to its last row's time,
    except the batches in `hold` (a backlog: they are folded while the
    engine clock, and so every timer, stands still); every trigger must be
    served by one of `sources`. Returns the node,
    the emissions [(t, rows received, stall s, delivery s, item, source)],
    rows/s and the launch counts."""
    from ekuiper_tpu_torch.utils import timex

    plan_fused_rule, ColumnBatch, _ = mods
    batches = stream.batches(ColumnBatch)
    node = plan_fused_rule(sql, key_slots=key_slots, micro_batch=ROWS,
                           options=options)
    check(node.gb.device.type == "cuda", f"{what}: rule is not on the card")
    check(node.sliding_impl == impl, f"{what}: not on the {impl} path "
          f"({node.sliding_impl})")
    if hook is not None:
        hook(node)
    received = [0]
    trig, deliveries = [], []
    emit_sliding = node._emit_sliding

    def timed_emit(t):
        t0 = time.perf_counter()
        emit_sliding(t)
        trig.append((t, received[0], t0, time.perf_counter() - t0))

    node._emit_sliding = timed_emit
    node.broadcast = lambda item: deliveries.append(
        (time.perf_counter(), item, dict(node.last_emit_info or {})))
    clock = timex.set_mock_clock(int(stream.ts[0, 0]) - 1)
    node.on_open()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    for b, batch in enumerate(batches):
        received[0] = b * ROWS
        if b not in hold:
            clock.set(int(stream.ts[b, -1]))
        received[0] = (b + 1) * ROWS
        node.process(batch)
    clock.advance(5_000)  # the last delayed emissions
    node._drain_async_emits()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    row_pane = dict(kernels.ROW_PANE_LAUNCHES)
    node.on_close()
    timex.use_real_clock()
    check(len(deliveries) == len(trig),
          f"{what}: {len(deliveries)} deliveries for {len(trig)} triggers")
    check(not node.recoveries, f"{what}: recoveries {dict(node.recoveries)}")
    emissions = [(t, n, st, tw - t_s, item, info.get("source"))
                 for (t, n, t_s, st), (tw, item, info) in zip(trig,
                                                             deliveries)]
    bad = {src for *_, src in emissions} - set(sources)
    check(not bad, f"{what}: triggers served by {bad}")
    return node, emissions, stream.n * ROWS / wall, launches, row_pane


def run_phase_d(torch, seed, kernels, mods):
    """Phase D: the sliding rules on the mock clock at full size, every
    emitted window against its numpy reference."""
    res = {}
    hll_twin = HllTwin()
    for tag, sql in (("d1", D1_RULE), ("d2", D2_RULE),
                     ("d2_delay", D2_DELAY_RULE), ("d3", D3_RULE)):
        rng = np.random.default_rng(seed + 30 + len(res))
        stream = SlidingStream(rng, D_BATCHES[tag], humidity=tag == "d3",
                               gap_at=GAP_AT if tag == "d2" else None)
        node, em, rps, launches, row_pane = run_sliding(
            torch, kernels, mods, sql, stream, tag)
        delay = node.delay_ms
        want_trig = int((stream.temp > 44.5).sum())
        check(len(em) == want_trig,
              f"{tag}: {len(em)} triggers, {want_trig} trigger rows")
        twin = (ScalarTwin(stream) if tag.startswith("d2") else
                PctTwin(stream) if tag == "d1" else None)
        worst, edge = 0.0, 0
        t_check = time.perf_counter()
        for i, (t, received, _, _, cb, _) in enumerate(em):
            a, b = stream.rows(t - node.length_ms, t + delay, received)
            what = f"{tag} trigger {i} (t={t})"
            if tag == "d1":
                edge += check_pct_window(cb, twin, a, b, what)
            elif tag == "d3":
                edge += hll_twin.check(cb, stream, a, b, what)
            else:
                worst = max(worst, check_window(cb, twin.window(a, b), False,
                                                what))
        if tag == "d1":
            # the periodic re-anchor of the ring's running totals (its
            # forced rebuild) falls inside D1's 720 batches
            check(node.ring_counts.get("reanchor", 0) > 0,
                  f"d1: no re-anchor in {D_BATCHES['d1']} batches")
        res[tag] = dict(
            rows_per_s=rps, triggers=len(em),
            stall=[st * 1e3 for _, _, st, _, _, _ in em],
            delivery=[dl * 1e3 for _, _, _, dl, _, _ in em],
            counts=dict(node.ring_counts), launches=launches,
            row_pane=row_pane, max_abs_err=worst, edge=edge,
            bucket_ms=node.bucket_ms, ring_panes=node.n_ring_panes,
            ring_mb=node.ring_dev_bytes() / 1e6,
            check_s=time.perf_counter() - t_check)
        del node, em, stream, twin
        torch.cuda.empty_cache()
    return res


def phase_d_line(tag, r):
    c = r["counts"]
    routes = {k: c.get(k, 0) for k in ("fast", "dyn", "head", "edge")}
    return (f"phase D {tag}: bucket_ms={r['bucket_ms']} "
            f"ring_panes={r['ring_panes']} ring_MB={r['ring_mb']:.1f} "
            f"rows/s={r['rows_per_s']:.0f} triggers={r['triggers']} "
            f"stall_p50_ms={pct(r['stall'], 50):.3f} "
            f"stall_p99_ms={pct(r['stall'], 99):.3f} "
            f"delivery_p50_ms={pct(r['delivery'], 50):.3f} "
            f"delivery_p99_ms={pct(r['delivery'], 99):.3f} "
            f"device-ring={r['triggers']} routes={routes} "
            f"flips={c.get('flip', 0)} reanchors={c.get('reanchor', 0)} "
            f"advances={c.get('advance', 0)} "
            f"recycled_refolds={c.get('recycled_refold', 0)} "
            f"late_rows={c.get('late_dropped', 0)} "
            f"pane_vec_folds={r['row_pane']} launches={r['launches']} "
            f"check_s={r['check_s']:.1f}")


# ------------------------------------------------------------ phase F
class HHWindowTwin:
    """F1: the heavy-hitters sketch of any row range of a stream, from the
    exact per-(key, code) counts of its rows: the sketch is linear in
    them (one occurrence of a code adds 1 to its cell's total and to each
    of its set bits' counters, at each depth), so the window's counters
    are one float64 product per depth on `dev` (integers, exact in any
    order of summation). The codes are the node's dictionary codes,
    assigned batch by batch (TwinCodes)."""

    def __init__(self, stream, torch, dev):
        codes = TwinCodes()
        self.s = stream
        self.torch, self.dev = torch, dev
        self.cid = np.stack([codes.encode(stream.code[b])
                             for b in range(stream.n)])
        self.values = codes.values
        nc = len(self.values)
        c = np.arange(nc, dtype=U32)
        self.g = []
        for d in range(HH_DEPTH):
            g = np.zeros((nc, HH_WIDTH, HH_CELL), np.float32)
            slot = np_hh_slot(c, d).astype(np.int64)
            g[np.arange(nc), slot, 0] = 1.0
            for b in range(HH_BITS):
                g[np.arange(nc), slot, 1 + b] = (c >> U32(b)) & U32(1)
            self.g.append(torch.from_numpy(g.reshape(nc, -1)).to(
                dev, torch.float64))

    def window(self, a, b):
        """(top-3 lists of every key, row count of every key) over the
        stream's rows [a, b)."""
        nc = len(self.values)
        keys = self.s.idx.reshape(-1)[a:b].astype(np.int64)
        cid = self.cid.reshape(-1)[a:b].astype(np.int64)
        C = self.torch.from_numpy(np.bincount(
            keys * nc + cid, minlength=N_KEYS * nc).reshape(N_KEYS, nc)
            .astype(np.float64)).to(self.dev)
        merged = self.torch.stack([C @ g for g in self.g], dim=1).reshape(
            N_KEYS, HH_SIZE).cpu().numpy()
        return (twin_hh_top(merged, 3),
                np.bincount(keys, minlength=N_KEYS))


def check_hh_window(cb, want, values, what):
    """F1: the emitted keys are the window's, each top list the twin's."""
    tops, cnt = want
    live = np.nonzero(cnt)[0]
    keys = key_ids(cb.columns["deviceId"])
    check(cb.n == len(live) and (np.sort(keys) == live).all(),
          f"{what}: emitted keys differ")
    for key, top in zip(keys.tolist(), cb.columns["top"].tolist()):
        exp = [{"value": values[c], "count": n} for c, n in tops[key]]
        check(top == exp, f"{what} key {key}: {top} != {exp}")
    return cb.n


def same_rows(cb, other, what, other_name="DABA"):
    """Two windows of one trigger (the refold path's and the DABA ring's,
    or `other_name`'s): keys, counts, min and max equal. Returns (keys,
    columns) of each."""
    def rows(x):
        keys = key_ids(x.columns["deviceId"])
        o = np.argsort(keys)
        return keys[o], {k: np.asarray(v)[o] for k, v in x.columns.items()}

    ka, a = rows(cb)
    kb, b = rows(other)
    check(np.array_equal(ka, kb), f"{what}: keys differ from "
          f"{other_name}'s")
    for col in ("cnt", "min_t", "max_t"):
        check(np.array_equal(a[col], b[col]), f"{what}: {col} differs "
              f"from {other_name}'s")
    return ka, a, b


def check_same_window(cb, other, ref, what, other_name="DABA"):
    """F2: the refold window against the DABA one of the same trigger (or
    two windows of `other_name`): keys, counts, min and max equal; avg
    within twice the float32 bound each keeps to the float64 reference.
    Returns the largest avg difference."""
    ka, a, b = same_rows(cb, other, what, other_name)
    n = ref["cnt"][ka]
    mean = ref["sum"][ka] / n
    d = np.abs(a["avg_t"].astype(np.float64) - b["avg_t"])
    check((d <= 2 * EPS32 * (ref["sumabs"][ka] + np.abs(mean))).all(),
          f"{what}: avg differs from {other_name}'s beyond the bound "
          f"({d.max()})")
    return float(d.max(initial=0.0))


def refold_result(node, em, rps, launches, row_pane, stream, t_check):
    c = node.refold_counts
    return dict(
        rows_per_s=rps, triggers=len(em),
        stall=[st * 1e3 for _, _, st, _, _, _ in em],
        delivery=[dl * 1e3 for _, _, _, dl, _, _ in em],
        routes={k: c.get(k, 0) for k in ("cached", "host", "stale",
                                          "evicted")},
        launches=launches, row_pane=row_pane, fallback=node.sliding_fallback,
        bucket_ms=node.bucket_ms, panes=node.n_panes,
        cache_mb=node._dev_ring_bytes / 1e6,
        budget_mb=node.dev_ring_budget_bytes / 2**20,
        rows=stream.n * ROWS, want_triggers=int((stream.temp > 44.5).sum()),
        check_s=time.perf_counter() - t_check)


def masked_spy(kernels, calls, hook=None):
    """A run_sliding hook (after `hook`): the node's fold_masked_many
    wrapped to record, a call, (its cached segments, the groups
    fold_masked_many forms of them, the #2 launches the call made)."""
    def spy_hook(node):
        if hook is not None:
            hook(node)
        gb = node.gb
        many = gb.fold_masked_many

        def spy(state, segments, pane):
            segs = list(segments)
            groups = len(list(gb._masked_groups(
                [(None, s) for _, s, _ in segs])))
            before = kernels.LAUNCHES["groupby_fold_masked"]
            out = many(state, segs, pane)
            calls.append((len(segs), groups,
                          kernels.LAUNCHES["groupby_fold_masked"] - before))
            return out

        gb.fold_masked_many = spy
    return spy_hook


def masked_summary(what, calls):
    """Fail unless every refold made one #2 launch a segment group; the
    calls' counts, and those of the call with the most segments."""
    for segs, groups, launches in calls:
        check(launches == groups, f"{what}: a refold of {segs} cached "
              f"segments made {launches} #2 launches for {groups} groups")
    most = max(calls, default=(0, 0, 0))
    return dict(masked_calls=len(calls),
                masked_segments=sum(c[0] for c in calls),
                masked_groups=sum(c[1] for c in calls),
                most_segments=most[0], most_groups=most[1])


def run_phase_f(torch, seed, kernels, mods):
    """Phase F: the sliding refold path at full size on the mock clock,
    every window against its numpy twin (and F2's against the DABA
    ring's)."""
    from ekuiper_tpu_torch.ops.slidingring import SlidingRing

    res = {}
    # F1: heavy_hitters sliding, the sync finalize with the host dedupe
    rng = np.random.default_rng(seed + 60)
    stream = SlidingStream(rng, F_BATCHES, codes=True)
    stages = {"finalize": 0.0, "assemble": 0.0}

    def hh_hook(node):
        check(node.sliding_fallback == "heavy_hitters",
              f"f1: fallback {node.sliding_fallback}")
        check(node.gb.capacity == 2048, "f1: heavy-hitters state does not "
              f"start at 2,048 slots ({node.gb.capacity})")
        node.gb.finalize = timed(node.gb.finalize, stages, "finalize")
        node.gb.hh_assemble = timed(node.gb.hh_assemble, stages, "assemble")

    calls = []
    node, em, rps, launches, row_pane = run_sliding(
        torch, kernels, mods, F1_RULE, stream, "f1", impl="refold",
        sources=("sync",), hook=masked_spy(kernels, calls, hh_hook))
    check(node.gb.capacity == SLOTS, f"f1: state at {node.gb.capacity} "
          f"slots, want {SLOTS}")
    t_check = time.perf_counter()
    twin = HHWindowTwin(stream, torch, torch.device("cuda"))
    n_rows = 0
    for i, (t, received, _, _, cb, _) in enumerate(em):
        a, b = stream.rows(t - node.length_ms, t, received)
        n_rows += check_hh_window(cb, twin.window(a, b), twin.values,
                                  f"f1 trigger {i} (t={t})")
    res["f1"] = refold_result(node, em, rps, launches, row_pane, stream,
                              t_check)
    res["f1"].update(masked_summary("f1", calls))
    res["f1"].update(checked_rows=n_rows, finalize_ms=stages["finalize"]
                     * 1e3 / max(len(em), 1),
                     assemble_ms=stages["assemble"] * 1e3 / max(len(em), 1))
    del node, em, twin, stream
    torch.cuda.empty_cache()

    # F2: D2's rule under slidingImpl "refold", and the DABA ring's run
    # of the same stream
    rng = np.random.default_rng(seed + 61)
    stream = SlidingStream(rng, F_BATCHES, gap_at=F_GAP_AT)
    calls = []
    node, em, rps, launches, row_pane = run_sliding(
        torch, kernels, mods, D2_RULE, stream, "f2", options=REFOLD,
        impl="refold", sources=("device-async",),
        hook=masked_spy(kernels, calls))
    check(node.sliding_fallback is None, "f2: a fallback on request")
    dnode, dem, drps, dlaunches, _ = run_sliding(
        torch, kernels, mods, D2_RULE, stream, "f2_daba")
    check([e[0] for e in em] == [e[0] for e in dem],
          "f2: triggers differ from the DABA run's")
    t_check = time.perf_counter()
    twin = ScalarTwin(stream)
    worst = worst_daba = 0.0
    for i, ((t, received, _, _, cb, _), dcb) in enumerate(
            zip(em, [e[4] for e in dem])):
        a, b = stream.rows(t - node.length_ms, t, received)
        what = f"f2 trigger {i} (t={t})"
        ref = twin.window(a, b)
        worst = max(worst, check_window(cb, ref, False, what))
        check_window(dcb, ref, False, what + " DABA")
        worst_daba = max(worst_daba, check_same_window(cb, dcb, ref, what))
    res["f2"] = refold_result(node, em, rps, launches, row_pane, stream,
                              t_check)
    res["f2"].update(max_abs_err=worst, vs_daba=worst_daba,
                     daba_rows_per_s=drps, **masked_summary("f2", calls))
    del node, dnode, em, dem, twin, stream
    torch.cuda.empty_cache()

    # F3: D3's hll rule over its budget: the fallback, and a device cache
    # that holds less than a window, so both refold routes run
    rng = np.random.default_rng(seed + 62)
    stream = SlidingStream(rng, F_BATCHES, humidity=True)
    est = {}

    def budget_hook(node):
        check(node.sliding_fallback == "ring_budget",
              f"f3: fallback {node.sliding_fallback}")
        est["ring"] = SlidingRing(node.gb, node._ring_layout).estimate_bytes(
            SLOTS)

    calls = []
    node, em, rps, launches, row_pane = run_sliding(
        torch, kernels, mods, D3_RULE, stream, "f3",
        options={"slidingDevRingMb": F3_RING_MB}, impl="refold",
        sources=("device-async",), hook=masked_spy(kernels, calls,
                                                    budget_hook))
    t_check = time.perf_counter()
    hll_twin = HllTwin()
    edge = 0
    for i, (t, received, _, _, cb, _) in enumerate(em):
        a, b = stream.rows(t - node.length_ms, t, received)
        edge += hll_twin.check(cb, stream, a, b, f"f3 trigger {i} (t={t})")
    c = node.refold_counts
    check(c["cached"] > 0 and c["host"] > 0 and c["evicted"] > 0,
          f"f3: both refold routes must run ({dict(c)})")
    res["f3"] = refold_result(node, em, rps, launches, row_pane, stream,
                              t_check)
    res["f3"].update(edge=edge, ring_estimate_mb=est["ring"] / 2**20,
                     **masked_summary("f3", calls))
    del node, em, stream
    torch.cuda.empty_cache()

    # F4: D2's delayed rule under refold through a backlog: the batches
    # after a trigger row are folded while the engine clock stands still,
    # so rows of bucket b + R recycle the panes of buckets inside the
    # pending window before its timer fires, and that window refolds
    # whole from the cached batches (the stale route)
    rng = np.random.default_rng(seed + 63)
    stream = SlidingStream(rng, F_BATCHES)
    calls = []
    node, em, rps, launches, row_pane = run_sliding(
        torch, kernels, mods, D2_DELAY_RULE, stream, "f4", options=REFOLD,
        impl="refold", sources=("device-async",), hold=F4_HOLD,
        hook=masked_spy(kernels, calls))
    t_check = time.perf_counter()
    twin = ScalarTwin(stream)
    worst = 0.0
    for i, (t, received, _, _, cb, _) in enumerate(em):
        a, b = stream.rows(t - node.length_ms, t + node.delay_ms, received)
        worst = max(worst, check_window(cb, twin.window(a, b), False,
                                        f"f4 trigger {i} (t={t})"))
    c = node.refold_counts
    check(c["stale"] > 0 and c["cached"] > 0,
          f"f4: no whole-window refold from the cache ({dict(c)})")
    res["f4"] = refold_result(node, em, rps, launches, row_pane, stream,
                              t_check)
    res["f4"].update(max_abs_err=worst, **masked_summary("f4", calls))
    check(res["f4"]["most_segments"] > res["f4"]["most_groups"],
          f"f4: the stale refold's {res['f4']['most_segments']} segments "
          f"took {res['f4']['most_groups']} launches")
    del node, em, twin, stream
    torch.cuda.empty_cache()
    for tag in ("f1", "f2", "f3", "f4"):
        r = res[tag]
        check(r["triggers"] == r["want_triggers"],
              f"{tag}: {r['triggers']} triggers, {r['want_triggers']} "
              "trigger rows")
    res["f2_daba"] = {"launches": dlaunches}
    return res


def phase_f_line(tag, r):
    masked = r["launches"]["groupby_fold_masked"]
    extra = ""
    if tag == "f1":
        extra = (f" top_lists={r['checked_rows']} finalize_ms_per_trigger="
                 f"{r['finalize_ms']:.3f} (hh_assemble "
                 f"{r['assemble_ms']:.3f})")
    elif tag == "f2":
        extra = (f" max_abs_err={r['max_abs_err']:.3g} "
                 f"vs_daba_max_abs={r['vs_daba']:.3g} "
                 f"daba_rows/s={r['daba_rows_per_s']:.0f}")
    elif tag == "f4":
        extra = (f" max_abs_err={r['max_abs_err']:.3g} held_batches="
                 f"{F4_HOLD.start}..{F4_HOLD.stop - 1}")
    else:
        extra = (f" ring_estimate_MB={r['ring_estimate_mb']:.1f} > "
                 f"slidingDevRingMb={r['budget_mb']:.0f} "
                 f"hll_off_by_one={r['edge']}")
    return (f"phase F {tag}: fallback={r['fallback']} "
            f"bucket_ms={r['bucket_ms']} panes={r['panes']} "
            f"rows/s={r['rows_per_s']:.0f} triggers={r['triggers']} "
            f"stall_p50_ms={pct(r['stall'], 50):.3f} "
            f"stall_p99_ms={pct(r['stall'], 99):.3f} "
            f"delivery_p50_ms={pct(r['delivery'], 50):.3f} "
            f"delivery_p99_ms={pct(r['delivery'], 99):.3f} "
            f"routes={r['routes']} cache_MB={r['cache_mb']:.1f} "
            f"masked_fold_launches={masked} masked_calls="
            f"{r['masked_calls']} segments={r['masked_segments']} "
            f"groups={r['masked_groups']} most_segments_a_call="
            f"{r['most_segments']} in {r['most_groups']} launches "
            f"pane_vec_folds={r['row_pane']} launches={r['launches']} "
            f"check_s={r['check_s']:.1f}{extra}")


def masked_segment(torch, gb, r, dev, mask_lo=0.3):
    """One cached segment as phase F's refolds fold it: a 65,536-row batch
    (61,440 real rows, the rest padding with slot 0 and mask 0) with
    uint16 slots, its row mask a refold's low-edge time cut (rows
    [mask_lo · 61,440, 61,440)). Returns (cols, slots, host mask, host
    slots)."""
    n_real = ROWS * 15 // 16
    host = {"temperature": r.normal(20, 5, ROWS).astype(np.float32),
            "__hhc__code": skewed_codes(r, ROWS).astype(np.float32),
            "__hll__humidity": (r.integers(0, 1000, ROWS) / 10).astype(
                np.float32)}
    s_host = r.integers(0, N_KEYS, ROWS)
    mask = np.zeros(ROWS, dtype=bool)
    mask[int(mask_lo * n_real):n_real] = True
    for v in host.values():
        v[n_real:] = 0.0
    s_host[n_real:] = 0
    cols = {k: torch.from_numpy(v).to(dev) for k, v in host.items()
            if k in gb.plan.columns}
    return (cols, torch.from_numpy(s_host.astype(np.uint16)).to(dev), mask,
            s_host)


def masked_inputs(torch, gb, segs, dev):
    """The masked fold's (base, V, M, slots) over segments, as
    fold_masked_many builds them for one group."""
    from ekuiper_tpu_torch.ops.groupby import concat_slots

    cols = (segs[0][0] if len(segs) == 1 else
            gb._concat_columns([(c, s) for c, s, _, _ in segs]))
    n = sum(len(s) for _, s, _, _ in segs)
    base = gb._where(cols, (n,)) & torch.from_numpy(
        np.concatenate([m for _, _, m, _ in segs])).to(dev)
    V, M = gb._spec_values(cols, n)
    return base, V, M & base, concat_slots([s for _, s, _, _ in segs])


def masked_bound(st, slots, s_hosts, masks, S, wide_upd, ops):
    """(bytes, bound_ms, bound_by) of a masked fold: summed over its
    segments, the mask of every row and the slot, V and M of each of the
    S specs the launch reads, of the masked rows only (a row off the mask
    is skipped before anything else is read); once for the launch, each
    slot a masked row touches, its scalar line and act read and written,
    and each touched wide entry read and written."""
    width = sum(a.shape[2] for k, a in st.items()
                if k in ("n", "s1", "s2", "mn", "mx")) + 1
    nbytes = sum(len(m) + int(m.sum()) * (slots.element_size() + 5 * S)
                 for m in masks)
    touched = np.unique(np.concatenate([s[m] for s, m in zip(s_hosts,
                                                             masks)]))
    nbytes += len(touched) * width * 8
    nbytes += sum(len(np.unique(idx.cpu().numpy())) * 8
                  for _, idx, _, _ in wide_upd)
    return (nbytes, *bound(nbytes, ops))


def masked_kernel_checks(torch, seed, kernels, sketches, plan_fused_rule,
                         TorchGroupBy, dev):
    """The masked fold (#2) against its plain version at phase F's
    shapes: one cached segment (masked_segment) into the node's own
    scratch pane over rows already folded there, with the node's own pane
    count, for F2's scalar rule, F1's heavy_hitters and F3's hll rules
    (act, the scalar and the wide columns in ONE launch, a profiler trace
    holding one kernel a call); and at F2's plan a stale refold's group,
    as many segments as fold_masked_many puts in one launch (one batch's
    columns and slots under a different time cut each), in ONE launch.
    F1's state is 53 panes of 176 MB, so its scratch pane starts
    past 2^31 floats and the check holds the kernel's 64-bit addressing at
    the main path's offset. The written pane is compared with the plain
    version's; every other pane must be bit-equal on the card."""
    rows = {}
    kernel = "groupby_fold_kernel"
    for tag, sql, opts in (("scalar", D2_RULE, REFOLD), ("hh", F1_RULE, {}),
                           ("hll", D3_RULE,
                            {"slidingDevRingMb": F3_RING_MB}),
                           ("segments", D2_RULE, REFOLD)):
        node = plan_fused_rule(sql, key_slots=SLOTS, micro_batch=ROWS,
                               device=dev, options=opts)
        check(node.sliding_impl == "refold", f"#2 {tag}: not on refold")
        plan, P, pane = node.plan, node.n_panes, node._scratch_pane
        del node
        torch.cuda.empty_cache()
        gb = TorchGroupBy(plan, capacity=SLOTS, n_panes=P,
                          micro_batch=ROWS, device=dev)
        r = np.random.default_rng(seed + 100)
        segs = [masked_segment(torch, gb, r, dev)]
        if tag == "segments":
            # a group as fold_masked_many forms it: as many segments as its
            # byte bound lets one launch take
            most = len(next(gb._masked_groups(
                [(None, segs[0][1])] * 1000)))
            cols, s_dev, _, s_host = segs[0]
            n_real = ROWS * 15 // 16
            for j in range(1, most):
                m = np.zeros(ROWS, dtype=bool)
                m[int(n_real * (j % 10) / 40):n_real] = True
                segs.append((cols, s_dev, m, s_host))
        base, V, M, slots = masked_inputs(torch, gb, segs, dev)
        st = gb.init_state()
        # rows already in the scratch pane (another edge bucket's)
        kernels.fold_plain(st, base.roll(7), V.roll(7, 1), M.roll(7, 1),
                           slots, pane, gb._colmap, gb._widemap)
        ref, got = clone_state(st), clone_state(st)
        kernels.reset_launches()
        kernels.fold_plain(ref, base, V, M, slots, pane, gb._colmap,
                           gb._widemap)
        kernels.groupby_fold_masked(got, base, V, M, slots, pane,
                                    gb._colmap, gb._widemap)
        torch.cuda.synchronize()
        check(kernels.LAUNCHES["groupby_fold_masked"] == 1,
              f"#2 {tag}: {kernels.LAUNCHES['groupby_fold_masked']} "
              f"launches for {len(segs)} segments")
        err = state_err({k: v[pane] for k, v in got.items()},
                        {k: v[pane] for k, v in ref.items()}, exact=EXACT)
        for k, v in got.items():
            check(torch.equal(v[:pane], ref[k][:pane])
                  and torch.equal(v[pane + 1:], ref[k][pane + 1:]),
                  f"#2 {tag} {k}: a pane other than {pane} changed")
        fn = functools.partial(kernels.groupby_fold_masked, got, base, V, M,
                               slots, pane, gb._colmap, gb._widemap)
        plain = functools.partial(kernels.fold_plain, ref, base, V, M,
                                  slots, pane, gb._colmap, gb._widemap)
        cat = slots.long()
        upd = fold_updates(torch, ref, base, V, M, cat, pane, gb._colmap,
                           kernels)
        wupd = wide_updates(torch, gb, V, M, cat, pane, sketches)
        lib = functools.partial(library_fold, torch, ref, upd + wupd)
        used = np.concatenate([gb._colmap, gb._widemap])
        S = len(set(used[:, 2].tolist()))
        m_rows = int(base.sum().item())
        n_upd = m_rows * (len(gb._colmap) + 1) + sum(
            len(idx) for _, idx, _, _ in wupd)
        nbytes, b_ms, b_by = masked_bound(
            st, slots, [sg[3] for sg in segs], [sg[2] for sg in segs], S,
            wupd, n_upd)
        calls = one_kernel_a_call(torch, fn, kernel, f"#2 {tag}")
        t_k = time_ms(torch, fn, REPS)
        split = launch_split(torch, fn, kernel, REPS)
        t_p = time_ms(torch, plain, REPS)
        t_l = time_ms(torch, lib, REPS)
        t_li = None if not len(gb._widemap) else library_idx_ms(
            torch, gb, ref, V, M, cat, pane, sketches)
        print(f"kernel groupby_fold_masked {tag} P={P} pane={pane} "
              f"segments={len(segs)} R={len(base)} S={S} "
              f"bound_bytes={nbytes} masked={m_rows} C={SLOTS} "
              f"slots=uint16 updates={n_upd} kernels_a_call="
              f"{calls:g}: "
              f"max_abs_err={err[0]:.3g} max_rel_err={err[1]:.3g} "
              f"kernel_ms={t_k:.4f} {split_text(split)} plain_ms={t_p:.4f} "
              f"library_ms={t_l:.4f} library_idx_ms="
              f"{'null' if t_li is None else f'{t_li:.4f}'} "
              f"bound_ms={b_ms:.5f} ({b_by})")
        row = dict(max_abs_err=err[0], max_rel_err=err[1], ms=t_k, **split,
                   plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                   library_ms=t_l, library_idx_ms=t_li, segments=len(segs),
                   kernels_a_call=calls)
        name = "groupby_fold_masked"
        rows[name if tag == "scalar" else f"{name}/{tag}"] = row
        del st, ref, got, gb, segs, base, V, M, slots, upd, wupd
        torch.cuda.empty_cache()
    return rows


# ----------------------------------------------- phase 2, the rule group
def e1_sqls(window=E_TUMBLING):
    """E1's 256 statements, each literal written as bench.py writes it."""
    return [E1_SQL.format(x=E1_BASE + E1_STEP * r, window=window)
            for r in range(E1_RULES)]


def rule_ids(prefix, n):
    return [f"{prefix}{r}" for r in range(n)]


def library_group_fold(torch, state, base, V, M, slots, pane, colmap,
                       kernels):
    """Yardstick, never called by the port: the group fold as PyTorch's own
    scatter calls over a rule-offset flat index (r, pane, slot):
    index_add_ for the sums, scatter_reduce_ for min/max."""
    act = state["act"]
    NR, P, C = act.shape
    rule = torch.arange(NR, device=act.device)[:, None]
    pc = ((rule * P + pane) * C + slots.long()[None, :]).reshape(-1)
    act.view(-1).index_add_(0, pc, base.reshape(-1).float())
    names = {j: c for c, j in kernels.COMP_IDS.items()}
    for comp_id, k, s in colmap.tolist():
        comp = names[comp_id]
        arr = state[comp]
        idx = pc * arr.shape[3] + k
        m = (M[s][None, :] & base).reshape(-1)
        v = V[s].repeat(NR)
        flat = arr.view(-1)
        if comp == "n":
            flat.index_add_(0, idx, m.float())
        elif comp == "s1":
            flat.index_add_(0, idx, torch.where(m, v, 0.0))
        elif comp == "s2":
            flat.index_add_(0, idx, torch.where(m, v * v, 0.0))
        else:
            ident = float("inf") if comp == "mn" else float("-inf")
            flat.scatter_reduce_(0, idx, torch.where(m, v, ident),
                                 "amin" if comp == "mn" else "amax",
                                 include_self=True)


def rows_first(out):
    """A (R, rows, K) group finalize as (rows, R * K), for finalize_err."""
    return out.permute(1, 0, 2).reshape(out.shape[1], -1)


#: the kernels of one rule-group fold call: the row order (built inside
#: where the caller gives none: its scratch's memset, the radix passes),
#: the WHERE bits' pack (in the order where it is given the WHERE masks,
#: else in the fold), the gather of the packed words, values and masks
#: into the order, then the fold
ORDER_KERNELS = ("Memset", "radix_hist_kernel", "radix_pass_kernel",
                 "fold_order_finish_kernel")
FOLD_KERNELS = ("pack_rule_bits_kernel", "fold_gather_kernel",
                "multirule_fold_keys_kernel", "multirule_fold_pieces_kernel")
WIDE_FOLD_KERNELS = ("pack_rule_bits_kernel", "multirule_fold_wide_kernel")
#: Zipf exponent of phase 2's skewed group batch (a few keys hold most
#: rows, thousands hold one)
ZIPF_A = 1.3


def sector_bytes(torch, flat):
    """Bytes of the 32-byte float32 state sectors the flat element indices
    touch, read once and written once."""
    return 2 * 32 * int(torch.unique(flat // 8).numel())


def group_touched_bytes(torch, kernels, state, base, M, slots, pane,
                        pane_vec, colmap):
    """What a group fold must read and write of the state, counted from
    the batch: the sectors of act and of each component that a (rule,
    row) past the rule's WHERE (and, for a column, its spec mask) folds
    into, once each way."""
    act = state["act"]
    NR, P, C = act.shape
    s = slots.long()
    p = (pane_vec.long() if pane_vec is not None
         else torch.full_like(s, pane))
    ok = (s >= 0) & (s < C) & (p < P)
    key = p.clamp(max=P - 1) * C + s.clamp(0, C - 1)
    elem = torch.arange(NR, device=act.device)[:, None] * (P * C) + key
    keep = base & ok[None, :]
    total = sector_bytes(torch, elem[keep])
    names = {j: c for c, j in kernels.COMP_IDS.items()}
    cols = {}
    for comp_id, k, spec in colmap.tolist():
        K = state[names[comp_id]].shape[3]
        cols.setdefault(comp_id, []).append(
            elem[keep & M[spec][None, :]] * K + k)
    for idx in cols.values():
        total += sector_bytes(torch, torch.cat(idx))
    return total


def group_fold_row(torch, kernels, st, base, V, M, slots, pane, colmap, tag,
                   pane_vec=None):
    """#15's scalar fold of one batch into a copy of `st`, against the plain
    version (n, act, mn, mx bit-equal, s1 / s2 within rtol 1e-5). Timed as
    the node calls it (the row order built inside the call, a pane
    vector's bound from the host), the fold alone on a given order, the
    bodies of every kernel of the call, the host time of one call, the
    plain version, the library scatters; with a pane vector also without
    the host bound (the wrapper reads the vector's max back). Bound: the
    inputs once, and the inputs plus the touched state sectors once each
    way (counted from the batch)."""
    ref, got = clone_state(st), clone_state(st)
    NR, P, C = st["act"].shape
    hi = None if pane_vec is None else int(pane_vec.max().item())
    kernels.multirule_fold_plain(ref, base, V, M, slots, pane, colmap,
                                 pane_vec)
    kernels.multirule_fold(got, base, V, M, slots, pane, colmap, pane_vec,
                           hi)
    torch.cuda.synchronize()
    err = state_err(got, ref)
    del ref
    fold = functools.partial(kernels.multirule_fold, got, base, V, M, slots,
                             pane, colmap, pane_vec, hi)
    order = kernels.multirule_fold_order(slots, pane, P, C, pane_vec)
    t_k = time_ms(torch, fold, REPS)
    t_f = time_ms(torch, functools.partial(
        kernels.multirule_fold, got, base, V, M, slots, pane, colmap,
        pane_vec, hi, order), REPS)
    split = launch_split(torch, fold, ORDER_KERNELS + FOLD_KERNELS, REPS,
                         per_call=True)
    t_rb = None if pane_vec is None else time_ms(torch, functools.partial(
        kernels.multirule_fold, got, base, V, M, slots, pane, colmap,
        pane_vec), REPS)
    t_p = time_ms(torch, lambda: kernels.multirule_fold_plain(
        got, base, V, M, slots, pane, colmap, pane_vec), REPS)
    lib_pane = pane if pane_vec is None else pane_vec.long()[None, :]
    t_l = time_ms(torch, lambda: library_group_fold(
        torch, got, base, V, M, slots, lib_pane, colmap, kernels), REPS)
    S, n = V.shape
    in_bytes = (V.numel() * 4 + M.numel() + base.numel() + n * 4
                + (0 if pane_vec is None else n))
    touched = group_touched_bytes(torch, kernels, st, base, M, slots, pane,
                                  pane_vec, colmap)
    # one add / min / max per (rule, row) past the WHERE for act and per
    # state column whose spec mask holds (the parent kernel's atomics)
    passing = int(base.sum().item())
    updates = passing + sum(int((M[s][None, :] & base).sum().item())
                            for s in colmap[:, 2].tolist())
    b_in, _ = bound(in_bytes, updates)
    b_ms, b_by = bound(in_bytes + touched, updates)
    print(f"kernel multirule_fold {tag} R={NR} rows={n} P={P} C={C} "
          f"cols={len(colmap)}: max_abs_err={err[0]:.3g} "
          f"max_rel_err={err[1]:.3g} kernel_ms={t_k:.4f} "
          f"fold_only_ms={t_f:.4f} {split_text(split)} "
          + ("" if t_rb is None else f"readback_ms={t_rb:.4f} ")
          + f"plain_ms={t_p:.4f} library_ms={t_l:.4f} bound_ms={b_ms:.5f} "
          f"({b_by}; inputs {in_bytes / 1e6:.2f} MB + touched state "
          f"{touched / 1e6:.2f} MB) bound_inputs_ms={b_in:.5f} "
          f"updates={updates} ({passing} rule-rows past WHERE)")
    return dict(max_abs_err=err[0], max_rel_err=err[1], ms=t_k,
                fold_only_ms=t_f, **split, readback_ms=t_rb, plain_ms=t_p,
                bound_ms=b_ms, bound_by=b_by, bound_inputs_ms=b_in,
                library_ms=t_l, input_bytes=in_bytes,
                touched_state_bytes=touched, updates=updates,
                rule_rows=passing)


def fold_order_row(torch, kernels, slots, pane, P, C, tag, base,
                   pane_vec=None):
    """The rule-group folds' row order (a helper kernel of the port) against
    its plain version (rows and offsets equal, and with the chunk's WHERE
    masks `base` their packed words too), timed without the masks (the
    sort alone); the library yardstick is torch's stable argsort of the
    precomputed keys (the offsets not included)."""
    got = kernels.multirule_fold_order(slots, pane, P, C, pane_vec, base)
    want = kernels.multirule_fold_order_plain(slots, pane, P, C, pane_vec,
                                              base)
    torch.cuda.synchronize()
    check(bool(torch.equal(got.rows, want.rows))
          and bool(torch.equal(got.offsets, want.offsets))
          and bool(torch.equal(got.bits, want.bits)),
          f"multirule_fold_order {tag}: differs from its plain version")
    fn = functools.partial(kernels.multirule_fold_order, slots, pane, P, C,
                           pane_vec)
    t_k = time_ms(torch, fn, REPS)
    split = launch_split(torch, fn, ORDER_KERNELS, REPS, per_call=True)
    t_p = time_ms(torch, lambda: kernels.multirule_fold_order_plain(
        slots, pane, P, C, pane_vec), REPS)
    s = slots.long()
    p = pane_vec.long() if pane_vec is not None else torch.full_like(s, pane)
    key = torch.where((s >= 0) & (s < C) & (p < P), p * C + s, P * C)
    t_l = time_ms(torch, lambda: torch.argsort(key, stable=True), REPS)
    n = slots.shape[0]
    nbytes = n * 4 + (0 if pane_vec is None else n) + n * 4 + (P * C + 1) * 4
    b_ms, b_by = bound(nbytes, 0)
    print(f"kernel multirule_fold_order {tag} rows={n} P={P} C={C}: "
          f"rows and offsets equal kernel_ms={t_k:.4f} {split_text(split)} "
          f"plain_ms={t_p:.4f} library_ms={t_l:.4f} (argsort stable) "
          f"bound_ms={b_ms:.5f} ({b_by})")
    return dict(max_abs_err=0.0, max_rel_err=0.0, ms=t_k, **split,
                plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=t_l)


def group_kernel_checks(torch, seed, kernels, plan_rule_group, dev):
    """The rule-group kernels against their plain versions at E1's shapes
    (256 rules, 65,536 rows, 16,384 slots, 67 MB of state): the fold (also
    on Zipf-skewed slots and on one slot taking every row) and its row
    order, the finalize (also at E3's two panes under a subset mask) and
    the reset."""
    rows = {}
    node = plan_rule_group(rule_ids("e1_", E1_RULES), e1_sqls(),
                           key_slots=SLOTS, micro_batch=ROWS, device=dev)
    gb = node.gb
    r = np.random.default_rng(seed + 40)
    temp = r.normal(20, 5, ROWS).astype(np.float32)
    s_dev = torch.from_numpy(
        r.integers(0, N_KEYS, ROWS).astype(np.int32)).to(dev)
    base, V, M = gb.rule_inputs({"temperature": torch.from_numpy(temp)
                                 .to(dev)}, ROWS)
    colmap = gb._colmap
    st = gb.init_state()
    state_bytes = sum(a.numel() * 4 for a in st.values())
    rows["multirule_fold"] = group_fold_row(
        torch, kernels, st, base, V, M, s_dev, 0, colmap, "uniform")
    rows["multirule_fold_order"] = fold_order_row(torch, kernels, s_dev, 0,
                                                  1, SLOTS, "e1", base)
    # the skewed batches: Zipf-skewed slots, one slot taking every row
    zipf = np.minimum(r.zipf(ZIPF_A, ROWS) - 1, N_KEYS - 1).astype(np.int32)
    for tag, sl in (("zipf", zipf), ("one_slot", np.full(ROWS, 7, np.int32))):
        rows[f"multirule_fold/{tag}"] = group_fold_row(
            torch, kernels, st, base, V, M, torch.from_numpy(sl).to(dev), 0,
            colmap, tag)
    got = clone_state(st)
    kernels.multirule_fold_plain(got, base, V, M, s_dev, 0, colmap)

    # finalize: every rule, the key cut of 10,000 keys (K = 16,384)
    K = gb._slice_keys(N_KEYS)
    pm = gb._pane_mask(None)
    out_k = kernels.multirule_finalize(got, pm, gb._spectab, K)
    out_p = kernels.multirule_finalize_plain(got, pm, gb._spectab, K)
    err = finalize_err(rows_first(out_k), rows_first(out_p), gb._spectab,
                       kernels)
    fin = functools.partial(kernels.multirule_finalize, got, pm, gb._spectab,
                            K)
    t_k = time_ms(torch, fin, REPS)
    split = launch_split(torch, fin, "multirule_finalize_kernel", REPS)
    t_p = time_ms(torch, lambda: kernels.multirule_finalize_plain(
        got, pm, gb._spectab, K), REPS)
    out_bytes = out_k.numel() * 4
    b_ms, b_by = bound(state_bytes * K // SLOTS + out_bytes,
                       E1_RULES * K * (len(gb._spectab) * 8 + 4))
    print(f"kernel multirule_finalize R={E1_RULES} P=1 K={K} "
          f"S={len(gb._spectab)}: max_abs_err={err[0]:.3g} "
          f"max_rel_err={err[1]:.3g} kernel_ms={t_k:.4f} "
          f"{split_text(split)} plain_ms={t_p:.4f} library_ms=null "
          f"bound_ms={b_ms:.5f} ({b_by}) out_MB={out_bytes / 1e6:.1f}")
    rows["multirule_finalize"] = dict(
        max_abs_err=err[0], max_rel_err=err[1], ms=t_k, **split,
        plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        out_bytes=out_bytes)

    # reset: pane 0 of every rule and component
    a, b = clone_state(got), clone_state(got)
    kernels.multirule_reset_pane(a, 0)
    kernels.multirule_reset_pane_plain(b, 0)
    torch.cuda.synchronize()
    err = state_err(a, b, exact=tuple(a))
    reset = functools.partial(kernels.multirule_reset_pane, a, 0)
    # the plain version is the library yardstick itself: one fill_ per
    # component over every rule's pane; the two timed in turn
    k_ms, f_ms = alternating_ms(torch, (reset, functools.partial(
        kernels.multirule_reset_pane_plain, b, 0)), REPS)
    t_k, t_p = statistics.median(k_ms), statistics.median(f_ms)
    t_l = t_p
    split = launch_split(torch, reset, "multirule_reset_kernel", REPS)
    b_ms, b_by = bound(state_bytes, 0)
    print(f"kernel multirule_reset_pane R={E1_RULES} P=1 C={SLOTS}: "
          f"max_abs_err={err[0]:.3g} max_rel_err={err[1]:.3g} "
          f"kernel_ms={t_k:.4f} {split_text(split)} plain_ms={t_p:.4f} "
          f"library_ms={t_l:.4f} bound_ms={b_ms:.5f} ({b_by}) "
          f"rounds kernel {' '.join(f'{t:.4f}' for t in k_ms)} fill_ "
          f"{' '.join(f'{t:.4f}' for t in f_ms)}")
    rows["multirule_reset_pane"] = dict(
        max_abs_err=err[0], max_rel_err=err[1], ms=t_k, **split,
        plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=t_l,
        kernel_rounds_ms=k_ms, library_rounds_ms=f_ms)
    del node, gb, st, got, a, b

    # E3's shape: two panes, the finalize under the subset mask [1]
    node = plan_rule_group(rule_ids("e3_", E1_RULES), e1_sqls(E_HOPPING),
                           key_slots=SLOTS, micro_batch=ROWS, device=dev)
    gb = node.gb
    st = gb.init_state()
    for pane in (0, 1):
        kernels.multirule_fold_plain(st, base, V, M, s_dev, pane, colmap)
    pm = gb._pane_mask([1])
    out_k = kernels.multirule_finalize(st, pm, gb._spectab, K)
    out_p = kernels.multirule_finalize_plain(st, pm, gb._spectab, K)
    err = finalize_err(rows_first(out_k), rows_first(out_p), gb._spectab,
                       kernels)
    fin = functools.partial(kernels.multirule_finalize, st, pm, gb._spectab,
                            K)
    t_k = time_ms(torch, fin, REPS)
    split = launch_split(torch, fin, "multirule_finalize_kernel", REPS)
    t_p = time_ms(torch, lambda: kernels.multirule_finalize_plain(
        st, pm, gb._spectab, K), REPS)
    b_ms, b_by = bound(state_bytes + out_bytes,
                       E1_RULES * K * (len(gb._spectab) * 8 + 4))
    print(f"kernel multirule_finalize R={E1_RULES} P=2 mask=subset[1] K={K}: "
          f"max_abs_err={err[0]:.3g} max_rel_err={err[1]:.3g} "
          f"kernel_ms={t_k:.4f} {split_text(split)} plain_ms={t_p:.4f} "
          f"library_ms=null bound_ms={b_ms:.5f} ({b_by})")
    rows["multirule_finalize/hopping_subset"] = dict(
        max_abs_err=err[0], max_rel_err=err[1], ms=t_k, **split,
        plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None)
    del node, gb, st
    torch.cuda.empty_cache()
    return rows


# ----------------------------------------- phase 2, the sketch rule group
def h5_sqls(family):
    """H5's 63 statements of one sketch family (E2's WHERE-step pattern)."""
    sql, base, step = H5_FAMILIES[family]
    return [sql.format(x=base + step * r) for r in range(H5_RULES)]


def h5_columns(rng, shape):
    """H5's columns: temperature N(20, 5) and humidity N(50, 15), rounded
    to 2 decimals as bench.py's E2 draws them."""
    return {"temperature": rng.normal(20, 5, shape).round(2),
            "humidity": rng.normal(50, 15, shape).round(2)}


def library_group_fold_wide(torch, state, idx, val, comp):
    """Yardstick, never called by the port: the sketch group fold as one
    PyTorch scatter over precomputed rule-offset flat indices
    (r, pane, slot, k, register): scatter_reduce_ amax for hll, index_add_
    of ones for hist."""
    flat = state[comp].view(-1)
    if comp == "hll":
        flat.scatter_reduce_(0, idx, val, "amax", include_self=True)
    else:
        flat.index_add_(0, idx, val)


def group_wide_updates(torch, gb, base, V, M, slots, pane, sketches):
    """The flat (rule, pane, slot, 0, register) index and value of every
    update the group's one sketch column makes (what the library yardstick
    scatters), and the number of updates."""
    comp_id, k, s = gb._widemap[0].tolist()
    comp = "hll" if comp_id == 0 else "hist"
    NR, P, C = gb.n_rules, gb.n_panes, gb.capacity
    W = 256 if comp == "hll" else 1024
    rule = torch.arange(NR, device=slots.device)[:, None]
    rp = (rule * P + pane) * C + slots.long()[None, :]
    if comp == "hll":
        reg, val = sketches.hll_parts(V[s])
        idx = rp * W + reg[None, :]
        val = val.expand(NR, -1)
    else:
        idx = rp * W + sketches.hist_bin(V[s])[None, :]
        val = torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
    keep = base & M[s][None, :]
    return comp, idx[keep], val[keep], int(keep.sum().item())


def group_wide_row(torch, kernels, sketches, gb, got, ref, base, V, M, slots,
                   pane, tag, comp, state_bytes, pane_vec=None):
    """#15's wide fold of one batch timed as the node calls it (the row
    order and the packed WHERE bits built once for both folds and given; a
    pane vector's bound from the host), with a pane vector also without the host bound; the bodies
    of its kernels, the host time of one call, the plain version, the
    library scatter on precomputed indices and with their build
    (library_idx_ms). Bound: the inputs once, and the inputs plus the
    touched state sectors once each way (counted from the batch)."""
    P, C = gb.n_panes, gb.capacity
    hi = None if pane_vec is None else int(pane_vec.max().item())
    order = kernels.multirule_fold_order(slots, pane, P, C, pane_vec, base)
    fold = functools.partial(kernels.multirule_fold_wide, got, base, V, M,
                             slots, pane, gb._widemap, pane_vec, hi, order)
    t_k = time_ms(torch, fold, REPS)
    split = launch_split(torch, fold, WIDE_FOLD_KERNELS, REPS,
                         per_call=True)
    t_rb = None if pane_vec is None else time_ms(torch, functools.partial(
        kernels.multirule_fold_wide, got, base, V, M, slots, pane,
        gb._widemap, pane_vec, None, order), REPS)
    t_p = time_ms(torch, lambda: kernels.multirule_fold_wide_plain(
        ref, base, V, M, slots, pane, gb._widemap, pane_vec), REPS)
    lib_pane = pane if pane_vec is None else pane_vec.long()[None, :]
    _, idx, val, n_upd = group_wide_updates(torch, gb, base, V, M, slots,
                                            lib_pane, sketches)
    t_l = time_ms(torch, lambda: library_group_fold_wide(
        torch, ref, idx, val, comp), REPS)
    t_li = time_ms(torch, lambda: library_group_fold_wide(
        torch, ref, *group_wide_updates(torch, gb, base, V, M, slots,
                                        lib_pane, sketches)[1:3], comp),
        REPS)
    touched = sector_bytes(torch, idx)
    s = int(gb._widemap[0, 2])
    in_bytes = (base.numel() + V[s].numel() * 4 + M[s].numel()
                + slots.numel() * 4 + (0 if pane_vec is None else ROWS))
    b_in, _ = bound(in_bytes, n_upd)
    b_ms, b_by = bound(in_bytes + touched, n_upd)
    print(f"kernel multirule_fold_wide {tag} R={gb.n_rules} "
          f"rows={slots.numel()} P={P} C={C}: bit-equal kernel_ms={t_k:.4f} "
          f"{split_text(split)} "
          + ("" if t_rb is None else f"readback_ms={t_rb:.4f} ")
          + f"plain_ms={t_p:.4f} library_ms={t_l:.4f} "
          f"library_idx_ms={t_li:.4f} bound_ms={b_ms:.5f} ({b_by}; inputs "
          f"{in_bytes / 1e6:.2f} MB + touched state {touched / 1e6:.2f} MB, "
          f"{n_upd} updates) bound_inputs_ms={b_in:.5f} "
          f"state_MB={state_bytes / 1e6:.1f}")
    return dict(max_abs_err=0.0, max_rel_err=0.0, ms=t_k, **split,
                readback_ms=t_rb, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                bound_inputs_ms=b_in, library_ms=t_l, library_idx_ms=t_li,
                input_bytes=in_bytes, touched_state_bytes=touched,
                updates=n_upd, state_bytes=state_bytes)


def wide_group_kernel_checks(torch, seed, kernels, sketches, plan_rule_group,
                             dev):
    """The batched wide fold (#15's hll / hist branches), the batched wide
    finalize (#16's hll / percentile final values) and the pane reset over
    wide state against their plain versions at H5's shapes: 63 rules,
    65,536 rows, 16,384 slots; the hll family on two hopping panes
    (2.1 GB of registers), the percentile family on one tumbling pane
    (4.2 GB of bins)."""
    rows = {}
    r = np.random.default_rng(seed + 70)
    cols = h5_columns(r, ROWS)
    s_dev = torch.from_numpy(
        r.integers(0, N_KEYS, ROWS).astype(np.int32)).to(dev)
    for fam in ("hll", "pct"):
        node = plan_rule_group(rule_ids(f"h5{fam}_", H5_RULES), h5_sqls(fam),
                               key_slots=SLOTS, micro_batch=ROWS, device=dev)
        gb = node.gb
        dcols = {c: torch.from_numpy(v.astype(np.float32)).to(dev)
                 for c, v in cols.items()}
        dcols["__hll__humidity"] = dcols["humidity"]
        base, V, M = gb.rule_inputs(dcols, ROWS)
        st = gb.init_state()
        comp = "hll" if fam == "hll" else "hist"
        state_bytes = sum(a.numel() * 4 for a in st.values())
        # the fold: every pane of the family's state, then the timed launch
        ref, got = clone_state(st), st
        for pane in range(gb.n_panes):
            kernels.multirule_fold_wide_plain(ref, base, V, M, s_dev, pane,
                                              gb._widemap)
            kernels.multirule_fold_wide(got, base, V, M, s_dev, pane,
                                        gb._widemap)
        torch.cuda.synchronize()
        check(bool(torch.equal(got[comp], ref[comp])),
              f"multirule_fold_wide {fam}: differs from its plain version")
        pane = gb.n_panes - 1
        rows[f"multirule_fold_wide/{fam}"] = group_wide_row(
            torch, kernels, sketches, gb, got, ref, base, V, M, s_dev, pane,
            fam, comp, state_bytes)
        del ref

        # the wide finalize into the scalar finalize's result, the key cut
        # of 10,000 keys (K = 16,384), every pane
        K = gb._slice_keys(N_KEYS)
        pm = gb._pane_mask(None)
        out_k = kernels.multirule_finalize(got, pm, gb._spectab, K, gb._rows)
        out_p = out_k.clone()
        kernels.multirule_finalize_wide(got, pm, gb._widetab, gb._fracs,
                                        out_k)
        kernels.multirule_finalize_wide_plain(got, pm, gb._widetab,
                                              gb._fracs, out_p)
        g, p = rows_first(out_k).cpu().numpy(), rows_first(out_p).cpu().numpy()
        worst = 0.0
        for kind, _, row in gb._widetab.tolist():
            nan = np.isnan(p[row])
            check((np.isnan(g[row]) == nan).all(),
                  f"multirule_finalize_wide {fam}: NaN mismatch")
            d = np.abs(g[row][~nan].astype(np.float64) - p[row][~nan])
            worst = max(worst, float(d.max(initial=0.0)))
            if kind == kernels.WIDE_KIND_IDS["hll"]:
                check((d == 0).all(), f"multirule_finalize_wide hll: "
                      f"{int((d > 0).sum())} estimates differ")
            else:
                check((d <= 4 * 2.0 ** -23 * np.abs(p[row][~nan])).all(),
                      "multirule_finalize_wide percentile beyond 4 ulp "
                      f"(max {d.max(initial=0.0)})")
        others = np.setdiff1d(np.arange(len(g)), gb._widetab[:, 2])
        check(np.array_equal(g[others], p[others], equal_nan=True),
              "multirule_finalize_wide wrote another row")
        fin = functools.partial(kernels.multirule_finalize_wide, got, pm,
                                gb._widetab, gb._fracs, out_k)
        t_k = time_ms(torch, fin, REPS)
        split = launch_split(torch, fin, "multirule_finalize_wide_kernel",
                             REPS)
        same = same_launch_ms(torch, fin, "multirule_finalize_wide_kernel",
                              REPS)
        a_call = one_kernel_a_call(torch, fin,
                                   "multirule_finalize_wide_kernel",
                                   f"multirule_finalize_wide {fam}")
        t_p = time_ms(torch, lambda: kernels.multirule_finalize_wide_plain(
            got, pm, gb._widetab, gb._fracs, out_p), REPS)
        W = got[comp].shape[-1]
        rd = H5_RULES * gb.n_panes * K * W * 4
        wr = H5_RULES * K * 4 * len(gb._widetab)
        b_ms, b_by = bound(rd + wr, H5_RULES * K * W * (gb.n_panes + 2))
        print(f"kernel multirule_finalize_wide {fam} R={H5_RULES} "
              f"P={gb.n_panes} K={K} W={W}: max_abs_err={worst:.3g} "
              f"(hll bit-equal, percentile within 4 ulp) kernel_ms={t_k:.4f}"
              f" {split_text(split)} kernels_a_call={a_call:g} same launches "
              f"{same_launch_text(same)} plain_ms={t_p:.4f} library_ms=null "
              f"bound_ms={b_ms:.5f} ({b_by}; reads {rd / 1e9:.3f} GB)")
        rows[f"multirule_finalize_wide/{fam}"] = dict(
            max_abs_err=worst, max_rel_err=0.0, ms=t_k, **split,
            kernels_a_call=a_call, same_launch=same,
            plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None,
            read_bytes=rd)
        del out_k, out_p

        # the pane reset over the wide state: every rule's last pane
        a = clone_state(got)
        kernels.multirule_reset_pane(a, pane)
        kernels.multirule_reset_pane_plain(got, pane)
        torch.cuda.synchronize()
        check(all(bool(torch.equal(a[c], got[c])) for c in got),
              f"multirule_reset_pane {fam}: differs over wide state")
        reset = functools.partial(kernels.multirule_reset_pane, a, pane)
        # the plain version is the library yardstick itself: one fill_ per
        # component over every rule's pane; the two timed in turn
        k_ms, f_ms = alternating_ms(torch, (reset, functools.partial(
            kernels.multirule_reset_pane_plain, got, pane)), REPS)
        t_k, t_p = statistics.median(k_ms), statistics.median(f_ms)
        t_l = t_p
        split = launch_split(torch, reset, "multirule_reset_kernel", REPS)
        b_ms, b_by = bound(state_bytes // gb.n_panes, 0)
        print(f"kernel multirule_reset_pane {fam} wide R={H5_RULES} "
              f"P={gb.n_panes} C={SLOTS}: bit-equal kernel_ms={t_k:.4f} "
              f"{split_text(split)} plain_ms={t_p:.4f} library_ms={t_l:.4f} "
              f"bound_ms={b_ms:.5f} ({b_by}; a pane of "
              f"{state_bytes / gb.n_panes / 1e9:.3f} GB) rounds kernel "
              f"{' '.join(f'{t:.4f}' for t in k_ms)} fill_ "
              f"{' '.join(f'{t:.4f}' for t in f_ms)}")
        rows[f"multirule_reset_pane/{fam}"] = dict(
            max_abs_err=0.0, max_rel_err=0.0, ms=t_k, **split, plain_ms=t_p,
            bound_ms=b_ms, bound_by=b_by, library_ms=t_l,
            kernel_rounds_ms=k_ms, library_rounds_ms=f_ms)
        del node, gb, st, got, a
        torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------ phase E
class GroupProbe:
    """What phase E reads off one group node: each boundary's stall on the
    fold thread (on_trigger wall time), each rule's windows and when they
    reached its sink, and the stacked finalize results (the async fetches'
    size and copy time; a synchronous boundary's result size)."""

    def __init__(self, node, ends):
        from ekuiper_tpu_torch.runtime.node import Node

        self.node = node
        self.ends = ends  # each boundary's window end, in trigger order
        self.stall_ms, self.t_trigger, self.fetches, self.sync_bytes = \
            [], [], [], []
        self.sync_ms = []  # synchronous finalize: launch, copy, host tail
        self.got = {rid: [] for rid in node.gb.rule_ids}
        self.t_got = {}  # window end -> arrival times at the rules' sinks
        probe = self

        class Sink(Node):
            def process(self, item):
                probe.t_got.setdefault(int(item.timestamps[0]), []).append(
                    time.perf_counter())
                probe.got[self.name].append(item)

        for rid in node.gb.rule_ids:
            node.add_rule_output(rid, Sink(rid))
        on_trigger = node.on_trigger

        def timed_trigger(trig):
            t = time.perf_counter()
            self.t_trigger.append(t)
            on_trigger(trig)
            self.stall_ms.append((time.perf_counter() - t) * 1e3)

        node.on_trigger = timed_trigger
        gb = node.gb
        begin, finalize_rules = gb.finalize_begin, gb._finalize_rules

        def finalize_begin(*a, **k):
            pending = begin(*a, **k)
            self.fetches.append(pending)
            return pending

        def timed_rules(*a, **k):
            out = finalize_rules(*a, **k)
            self.sync_bytes.append(out.numel() * 4)
            return out

        finalize = gb.finalize

        def timed_finalize(*a, **k):
            t = time.perf_counter()
            try:
                return finalize(*a, **k)
            finally:
                self.sync_ms.append((time.perf_counter() - t) * 1e3)

        gb.finalize_begin = finalize_begin
        gb._finalize_rules = timed_rules
        gb.finalize = timed_finalize

    def summary(self):
        # a window has reached every rule's sink when its last rule does
        check(len(self.t_trigger) == len(self.ends), "boundaries fired")
        delivery = [max(self.t_got[end]) - self.t_trigger[w]
                    for w, end in enumerate(self.ends)]
        copies = [(p.nbytes, p.copy_ms()) for p in self.fetches]
        landed = [(n, c) for n, c in copies if c is not None]
        return dict(
            stall_p50=pct(self.stall_ms, 50), stall_p99=pct(self.stall_ms, 99),
            delivery_p50=pct(delivery, 50) * 1e3,
            delivery_p99=pct(delivery, 99) * 1e3,
            fetches=len(copies),
            stacked_mb=(max(self.sync_bytes) / 1e6 if self.sync_bytes
                        else None),
            copy_ms_p50=pct([c for _, c in landed], 50) if landed else None,
            d2h_gb_s=(sum(n for n, _ in landed)
                      / sum(c for _, c in landed) / 1e6) if landed else None,
            sync_finalize_ms_p50=(pct(self.sync_ms, 50) if self.sync_ms
                                  else None),
            sources=dict(self.node.last_emit_info or {}).get("source"))


class FoldTimer:
    """A group fold kernel's device time per launch: CUDA events around
    each call of its wrapper (`name`; they bracket the one launch on the
    stream; nothing synchronizes until the run ends)."""

    def __init__(self, torch, kernels, name="multirule_fold"):
        self.torch, self.kernels, self.events = torch, kernels, []
        self.name = name
        self._orig = getattr(kernels, name)

    def __enter__(self):
        def timed(*a, **k):
            start = self.torch.cuda.Event(enable_timing=True)
            end = self.torch.cuda.Event(enable_timing=True)
            start.record()
            self._orig(*a, **k)
            end.record()
            self.events.append((start, end))

        setattr(self.kernels, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.kernels, self.name, self._orig)
        return False

    def ms(self):
        self.torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


def twin_check_family(tag, thresholds, emitted, rows, names, slot_keys,
                      what):
    """Every rule's window of one family against an independent numpy
    float64 group-by over exactly the rows passing that rule's WHERE: the
    float32 column against the float32 threshold, as the engine compares
    them. Rules are visited in nesting order (each one's rows are a sorted
    prefix or suffix of the column), so each adds only its delta rows.

    emitted[i]: rule i's ColumnBatch for this window, or None. rows: the
    window's key indices ("idx") and float32 columns. names: key index ->
    key string; slot_keys: each slot's key index in the node's key table
    (the order the node emits its keys in). Tolerances as check_window's:
    keys, counts, min and max exact; avg within ε·(Σ|x| + |mean|), a sum
    within ε·n·Σ|x| (a float32 sum of n terms in any order); stddev
    within the bound check_window carries through s2/n − mean². Returns
    (rows checked, max abs error of the rounded aggregates)."""
    col, op, aggs = E_TWIN[tag]
    x = rows[col]
    order = np.argsort(x, kind="stable")
    xs = x[order]
    t32 = np.asarray(thresholds, dtype=np.float32)
    if op == ">":  # rule i keeps order[bound_i:]
        bounds = np.searchsorted(xs, t32, side="right")
        visit = np.argsort(-bounds, kind="stable")
        prev = len(x)
    else:  # "<": rule i keeps order[:bound_i]
        bounds = np.searchsorted(xs, t32, side="left")
        visit = np.argsort(bounds, kind="stable")
        prev = 0
    K = len(names)
    cnt = np.zeros(K)
    args = {a for _, a in aggs.values() if a is not None}
    need_mm = any(kind in ("min", "max") for kind, _ in aggs.values())
    acc = {a: {"sum": np.zeros(K), "sumsq": np.zeros(K), "sumabs": np.zeros(K),
               "min": np.full(K, np.inf), "max": np.full(K, -np.inf)}
           for a in args}
    n_rows, worst = 0, 0.0
    for i in visit.tolist():
        b = int(bounds[i])
        delta = order[b:prev] if op == ">" else order[prev:b]
        prev = b
        k = rows["idx"][delta]
        cnt += np.bincount(k, minlength=K)
        for a, st in acc.items():
            v = rows[a][delta].astype(np.float64)
            st["sum"] += np.bincount(k, v, minlength=K)
            st["sumsq"] += np.bincount(k, v * v, minlength=K)
            st["sumabs"] += np.bincount(k, np.abs(v), minlength=K)
            if need_mm:
                np.minimum.at(st["min"], k, v)
                np.maximum.at(st["max"], k, v)
        live = np.nonzero(cnt[slot_keys] > 0)[0]
        cb = emitted[i]
        w = f"{what} rule {i}"
        if len(live) == 0:
            check(cb is None, f"{w}: a window without rows")
            continue
        check(cb is not None and cb.n == len(live),
              f"{w}: {0 if cb is None else cb.n} rows, want {len(live)}")
        keys = slot_keys[live]
        check(np.array_equal(cb.columns["deviceId"], names[keys]),
              f"{w}: emitted keys differ")
        n = cnt[keys]
        for out, (kind, a) in aggs.items():
            got = np.asarray(cb.columns[out], dtype=np.float64)
            if kind == "count":
                check((got == n).all(), f"{w}: {out} count")
                continue
            st = {name: arr[keys] for name, arr in acc[a].items()}
            if kind in ("min", "max"):
                check((got == st[kind]).all(), f"{w}: {out} {kind}")
                continue
            mean = st["sum"] / n
            if kind == "avg":
                d = np.abs(got - mean)
                check((d <= EPS32 * (st["sumabs"] + np.abs(mean))).all(),
                      f"{w}: {out} avg beyond bound (max {d.max()})")
            elif kind == "sum":
                d = np.abs(got - st["sum"])
                check((d <= EPS32 * n * st["sumabs"]).all(),
                      f"{w}: {out} sum beyond bound (max {d.max()})")
            else:  # stddev, as check_window
                s2n = st["sumsq"] / n
                var = np.maximum(s2n - mean * mean, 0.0)
                tol = EPS32 * (st["sumsq"] + s2n + 2 * np.abs(mean)
                               * (st["sumabs"] + np.abs(mean))
                               + mean * mean + var)
                d = np.abs(got * got - var)
                check((d <= tol + 2 * EPS32 * got * got).all(),
                      f"{w}: {out} stddev beyond bound (max {d.max()})")
                d = np.abs(got - np.sqrt(var))
            worst = max(worst, float(d.max()))
        n_rows += cb.n
    return n_rows, worst


def group_node(plan_rule_group, ids, sqls, slots, micro_batch):
    node = plan_rule_group(ids, sqls, key_slots=slots,
                           micro_batch=micro_batch)
    check(node.gb.device.type == "cuda", "rule group is not on the card")
    return node


def run_groups(torch, kernels, nodes, batches, interval):
    """Drive group nodes (fed alike) on the mock clock; returns the wall
    seconds, each node's probe, the fold kernel times and the launches."""
    ends = [(w + 1) * interval for w in range(len(batches))]
    probes = {tag: GroupProbe(node, ends) for tag, node in nodes.items()}
    kernels.reset_launches()
    with FoldTimer(torch, kernels) as timer:
        wall = drive_on_clock(torch, list(nodes.values()), batches, interval)
    launches = dict(kernels.LAUNCHES)
    for tag, node in nodes.items():
        check(not node.recoveries, f"{tag}: recovery routes taken")
    return wall, probes, timer.ms(), launches


def group_line(tag, r):
    f = lambda x, d=3: "n/a" if x is None else f"{x:.{d}f}"  # noqa: E731
    return (f"phase E {tag}: rules={r['rules']} rows/s={r['rows_per_s']:.0f} "
            f"rule_rows/s={r['rule_rows_per_s']:.0f} "
            f"fold_kernel_ms_per_batch p50={r['fold_p50']:.4f} "
            f"mean={r['fold_mean']:.4f} (fold kernels {r['fold_share']:.4f} "
            f"of the wall) stall_p50_ms={r['stall_p50']:.3f} "
            f"stall_p99_ms={r['stall_p99']:.3f} "
            f"delivery_p50_ms={r['delivery_p50']:.3f} "
            f"delivery_p99_ms={r['delivery_p99']:.3f} "
            f"stacked_MB={f(r['stacked_mb'])} fetches={r['fetches']} "
            f"copy_ms_p50={f(r['copy_ms_p50'], 4)} "
            f"d2h_GB_s={f(r['d2h_gb_s'], 2)} "
            f"sync_finalize_ms_p50={f(r['sync_finalize_ms_p50'])} "
            f"source={r['sources']} "
            f"windows={r['windows']} rows_checked={r['rows_checked']} "
            f"max_abs_err={r['max_abs_err']:.3g} launches="
            f"{ {k: v for k, v in r['launches'].items() if 'multirule' in k} }")


def group_result(tag, probe, node, wall, n_rows, fold_ms, launches,
                 windows_rows, check_out):
    out = probe.summary()
    n_rules = node.gb.n_rules
    out.update(rules=n_rules, rows_per_s=n_rows / wall,
               rule_rows_per_s=n_rows * n_rules / wall,
               fold_p50=pct(fold_ms, 50), fold_mean=float(np.mean(fold_ms)),
               fold_share=sum(fold_ms) / 1e3 / wall, launches=launches,
               windows=windows_rows, rows_checked=check_out[0],
               max_abs_err=check_out[1])
    return out


def check_group_windows(tag, thresholds, probe, node, spans, span, names):
    """Every rule's every window of one node against the twin; window w
    covers spans[max(0, w - span + 1) .. w]."""
    slot_keys = np.array([int(k[4:]) for k in node.kt.decode_all()])
    n_win = len(spans)
    for rid, got in probe.got.items():
        ends = [int(cb.timestamps[0]) for cb in got]
        check(len(set(ends)) == len(ends) and set(ends) <= set(probe.ends),
              f"{tag} {rid}: windows ending at {ends}")
    rows_checked, worst = 0, 0.0
    for w in range(n_win):
        part = spans[max(0, w - span + 1):w + 1]
        rows = {k: np.concatenate([p[k] for p in part]) for k in part[0]}
        # each rule's window ending at this boundary (a rule without rows
        # in a window emits none)
        emitted = [next((cb for cb in probe.got[rid]
                         if int(cb.timestamps[0]) == probe.ends[w]), None)
                   for rid in node.gb.rule_ids]
        n, d = twin_check_family(tag, thresholds, emitted, rows, names,
                                 slot_keys, f"{tag} window {w}")
        rows_checked += n
        worst = max(worst, d)
    return rows_checked, worst


def run_phase_e(torch, seed, kernels, plan_rule_group, ColumnBatch):
    """Phase E: rule groups on the card, opened on the mock clock."""
    res = {}
    names = np.array([f"dev_{i}" for i in range(N_KEYS)], dtype=np.object_)

    # E1 (tumbling, the "mr" worker) and E3 (hopping, synchronous): the
    # 256-rule group of BASELINE config #5
    for tag, window, interval, span in (("e1", E_TUMBLING, 10_000, 1),
                                        ("e3", E_HOPPING, 5_000, 2)):
        rng = np.random.default_rng(seed + (50 if tag == "e1" else 51))
        n_win = E_WINDOWS[tag]
        flat, idx, temp = make_batches(rng, ColumnBatch, n_win * BATCHES)
        batches = [flat[w * BATCHES:(w + 1) * BATCHES] for w in range(n_win)]
        spans = [{"idx": idx[w * BATCHES:(w + 1) * BATCHES].ravel(),
                  "temperature": temp[w * BATCHES:(w + 1) * BATCHES].ravel()}
                 for w in range(n_win)]
        node = group_node(plan_rule_group, rule_ids(f"{tag}_", E1_RULES),
                          e1_sqls(window), SLOTS, ROWS)
        check(node._async_mr == (tag == "e1"), f"{tag}: boundary route")
        wall, probes, fold_ms, launches = run_groups(
            torch, kernels, {tag: node}, batches, interval)
        probe = probes[tag]
        thresholds = [E1_BASE + E1_STEP * r for r in range(E1_RULES)]
        out = check_group_windows(tag, thresholds, probe, node, spans, span,
                                  names)
        res[tag] = group_result(tag, probe, node, wall,
                                n_win * BATCHES * ROWS, fold_ms, launches,
                                n_win, out)
        check(launches["multirule_fold"] == n_win * BATCHES
              and launches["multirule_fold_order"] == n_win * BATCHES,
              f"{tag}: {launches['multirule_fold']} fold launches, "
              f"{launches['multirule_fold_order']} row orders")
        check(launches["multirule_finalize"] == n_win
              and launches["multirule_reset_pane"] == n_win,
              f"{tag}: one finalize and one reset per boundary: {launches}")
        del node, probes, probe, batches, flat, spans
        torch.cuda.empty_cache()

    # E2: the four families of bench.py:1595-1610, one node each, fed the
    # same batches (bench.py:1650-1666's draws)
    rng = np.random.default_rng(seed + 52)
    n_win = E_WINDOWS["e2"]
    ids = names[:E2_KEYS]
    batches, spans = [], []
    for w in range(n_win):
        idx = rng.integers(0, E2_KEYS, (BATCHES, E2_ROWS))
        cols = {"temperature": rng.normal(20, 5, idx.shape).round(2),
                "pressure": rng.random(idx.shape).round(3),
                "humidity": rng.normal(50, 15, idx.shape).round(2)}
        batches.append([ColumnBatch(n=E2_ROWS, columns={
            "deviceId": ids[idx[b]], **{c: v[b] for c, v in cols.items()}},
            emitter="sensors") for b in range(BATCHES)])
        spans.append({"idx": idx.ravel(), **{
            c: v.ravel().astype(np.float32) for c, v in cols.items()}})
    nodes = {fam: group_node(
        plan_rule_group, rule_ids(f"{fam}", E2_RULES),
        [sql.format(x=base + step * i) for i in range(E2_RULES)], SLOTS,
        E2_ROWS) for fam, sql, base, step in E2_FAMILIES}
    wall, probes, fold_ms, launches = run_groups(torch, kernels, nodes,
                                                 batches, 10_000)
    n_rows = n_win * BATCHES * E2_ROWS
    for fam, sql, base, step in E2_FAMILIES:
        probe = probes[fam]
        thresholds = [base + step * i for i in range(E2_RULES)]
        out = check_group_windows(fam, thresholds, probe, nodes[fam], spans,
                                  1, ids)
        # the four nodes share the run: its wall, fold times and launches
        res[f"e2_{fam}"] = group_result(
            fam, probe, nodes[fam], wall, n_rows, fold_ms, launches, n_win,
            out)
    # each node folds each batch in one launch (a batch is one chunk) and
    # finalizes once a window: the shared counts are four nodes' worth
    check(launches["multirule_fold"] == 4 * n_win * BATCHES
          and launches["multirule_fold_order"] == 4 * n_win * BATCHES
          and launches["multirule_finalize"] == 4 * n_win
          and launches["multirule_reset_pane"] == 4 * n_win,
          f"e2: launches {launches}")
    return res


# ----------------------------------------------- phase 2, the tier store
def tier_state(torch, seed, node, dev):
    """A tiered node's state at its full capacity with rows in every pane
    (65,536-row batches over the whole slot range, v ~ N(50, 10), the
    sketch rules' temperature and humidity), touch counts included."""
    gb = node.gb
    st = gb.init_state()
    r = np.random.default_rng(seed)
    per_pane = 4 if gb.n_panes == 1 else 1
    for pane in range(gb.n_panes):
        for _ in range(per_pane):
            cols = {"v": r.normal(50, 10, ROWS).astype(np.float32),
                    "temperature": r.normal(20, 5, ROWS).astype(np.float32),
                    "humidity": (r.integers(0, 1000, ROWS) / 10).astype(
                        np.float32)}
            gb.fold(st, cols, r.integers(0, gb.capacity, ROWS).astype(
                np.int32), pane_idx=pane)
    torch.cuda.synchronize()
    return st


def library_demote(torch, state, idx, n, comps, kernels):
    """Yardstick, never called by the port: #18 as PyTorch's own calls
    (index_select per block, cat, index_fill_ of the real slots)."""
    D = len(idx)
    packed = torch.cat([state[c].index_select(1, idx).movedim(1, 0)
                        .reshape(D, -1) for c in comps], dim=1)
    for c in comps:
        state[c].index_fill_(1, idx[:n], kernels.INIT[c])
    return packed


def tier_kernel_checks(torch, seed, kernels, plan_fused_rule, dev):
    """#18 and #19 against their plain versions at G1's state (1 pane, Wp
    4, 1,048,576 slots), G2's (10 panes, Wp 60, 262,144 slots) and the wide
    plans' (phase B's hll hopping state, PCT_RULE's percentile hist, each
    tiered at 16,384 slots): a block of 2,000 real slots and 48 pad rows
    repeating the first, bit-equal; and the fold's touch column (#1's touch
    branch) at G1's state against the plain fold, exact."""
    rows = {}
    cases = (("g1", G1_RULE, G1_OPTS, G_SLOTS),
             ("g2", G2_RULE, {"tierHotMb": G_HOT_MB}, G_SLOTS),
             ("hll", HLL_RULE, {"tierHotMb": 64}, SLOTS),
             ("pct", PCT_RULE, {"tierHotMb": 128}, SLOTS))
    for i, (tag, sql, opts, slots_cap) in enumerate(cases):
        node = plan_fused_rule(sql, key_slots=slots_cap, micro_batch=ROWS,
                               device=dev, options=opts)
        check(node.tier is not None, f"{tag}: the tier did not engage")
        gb, ts = node.gb, node.tier.ts
        st = tier_state(torch, seed + 700 + i, node, dev)
        r = np.random.default_rng(seed + 710 + i)
        D, Wp = ts.demote_batch, ts.packed_w
        n = D - 48
        s, real = ts._slots(r.choice(gb.capacity, n, replace=False))
        s_dev = torch.from_numpy(s).to(dev)
        got, ref = clone_state(st), clone_state(st)
        packed = kernels.tier_demote(got, s_dev, real, ts.comps)
        want = kernels.tier_demote_plain(ref, s_dev, real, ts.comps)
        torch.cuda.synchronize()
        check(bool(torch.equal(packed, want)), f"{tag}: tier_demote block")
        err = state_err(got, ref, exact=tuple(ref))
        demote = functools.partial(kernels.tier_demote, got, s_dev, real,
                                   ts.comps)
        t_k = time_ms(torch, demote, REPS)
        split = launch_split(torch, demote, "tier_demote_kernel", REPS)
        a_call = one_kernel_a_call(torch, demote, "tier_demote_kernel",
                                   f"tier_demote {tag}")
        t_p = time_ms(torch, lambda: kernels.tier_demote_plain(
            ref, s_dev, real, ts.comps), REPS)
        # one real row and D - 1 pads (a boundary that demotes one key)
        s1, _ = ts._slots(s[:1])
        s1_dev = torch.from_numpy(s1).to(dev)
        t_one = time_ms(torch, functools.partial(
            kernels.tier_demote, got, s1_dev, 1, ts.comps), REPS)
        idx = s_dev.long()
        t_l = time_ms(torch, lambda: library_demote(
            torch, ref, idx, real, ts.comps, kernels), REPS)
        # the n real rows read once (the pads copy row 0) and reset, the
        # block's D rows written, the slots and the n touch counters
        nbytes = 2 * real * Wp * 4 + D * Wp * 4 + D * 4 + real * 4
        b_ms, b_by = bound(nbytes, 0)
        print(f"kernel tier_demote {tag} P={gb.n_panes} C={gb.capacity} "
              f"Wp={Wp} D={D} n={real}: max_abs_err={err[0]:.3g} "
              f"kernel_ms={t_k:.4f} {split_text(split)} "
              f"kernels_a_call={a_call:g} one_row_ms={t_one:.4f} "
              f"plain_ms={t_p:.4f} "
              f"library_ms={t_l:.4f} bound_ms={b_ms:.5f} ({b_by})")
        rows[f"tier_demote/{tag}"] = dict(
            max_abs_err=err[0], max_rel_err=err[1], ms=t_k, **split,
            kernels_a_call=a_call, one_row_ms=t_one, plain_ms=t_p,
            bound_ms=b_ms, bound_by=b_by, library_ms=t_l)

        # promote: the demoted rows back into other slots holding data,
        # identity pad rows on the repeated pad slot
        block = np.tile(ts.init_row(), (D, 1))
        block[:real] = want.cpu().numpy()[:real][::-1]
        d, _ = ts._slots(r.choice(gb.capacity, n, replace=False))
        d_dev = torch.from_numpy(d).to(dev)
        pk = torch.from_numpy(block).to(dev)
        got, ref = clone_state(st), clone_state(st)
        kernels.tier_promote(got, pk, d_dev, ts.comps)
        kernels.tier_promote_plain(ref, pk, d_dev, ts.comps)
        torch.cuda.synchronize()
        err = state_err(got, ref, exact=tuple(ref))
        promote = functools.partial(kernels.tier_promote, got, pk, d_dev,
                                    ts.comps)
        t_k = time_ms(torch, promote, REPS)
        split = launch_split(torch, promote, "tier_promote_kernel", REPS)
        # the plain version is the library yardstick itself: index_add_
        # and scatter_reduce_ (amin / amax) along the slot axis, per block
        t_p = t_l = time_ms(torch, lambda: kernels.tier_promote_plain(
            ref, pk, d_dev, ts.comps), REPS)
        # the block and the slots read, n rows of state read and written
        nbytes = D * Wp * 4 + D * 4 + 2 * real * Wp * 4
        b_ms, b_by = bound(nbytes, real * Wp)
        print(f"kernel tier_promote {tag} P={gb.n_panes} C={gb.capacity} "
              f"Wp={Wp} D={D} n={real}: max_abs_err={err[0]:.3g} "
              f"kernel_ms={t_k:.4f} {split_text(split)} plain_ms={t_p:.4f} "
              f"library_ms={t_l:.4f} bound_ms={b_ms:.5f} ({b_by})")
        rows[f"tier_promote/{tag}"] = dict(
            max_abs_err=err[0], max_rel_err=err[1], ms=t_k, **split,
            plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=t_l)
        if tag == "g1":
            rows["groupby_fold/touch"] = touch_fold_check(
                torch, seed, kernels, gb, st, dev)
    return rows


def touch_fold_check(torch, seed, kernels, gb, st, dev):
    """#1's touch branch at G1's state (1,048,576 slots): a 65,536-row
    batch folded by the kernel and by the plain fold, touch exact
    (uint32), the rest as the fold's check; timed with the touch column
    and without it."""
    r = np.random.default_rng(seed + 720)
    v = torch.from_numpy(r.normal(50, 10, ROWS).astype(np.float32)).to(dev)
    base, V, M = gb.spec_inputs({"v": v}, ROWS)
    slots = r.integers(0, gb.capacity, ROWS).astype(np.int32)
    s_dev = torch.from_numpy(slots).to(dev)
    got, ref = clone_state(st), clone_state(st)
    cmap, wmap = gb._colmap, gb._widemap
    kernels.groupby_fold(got, base, V, M, s_dev, 0, cmap, wmap)
    kernels.fold_plain(ref, base, V, M, s_dev, 0, cmap, wmap)
    torch.cuda.synchronize()
    err = state_err(got, ref)
    check(np.array_equal(got["touch"].cpu().numpy(),
                         ref["touch"].cpu().numpy()), "touch column")
    fold = functools.partial(kernels.groupby_fold, got, base, V, M, s_dev, 0,
                             cmap, wmap)
    untracked = {k: v for k, v in got.items() if k != "touch"}
    t_k = time_ms(torch, fold, REPS)
    t_u = time_ms(torch, lambda: kernels.groupby_fold(
        untracked, base, V, M, s_dev, 0, cmap, wmap), REPS)
    split = launch_split(torch, fold, FOLD_KERNEL, REPS)
    t_p = time_ms(torch, lambda: kernels.fold_plain(
        ref, base, V, M, s_dev, 0, cmap, wmap), REPS)
    t32 = torch.zeros(gb.capacity, dtype=torch.int32, device=dev)
    ones = base.int()
    idx = s_dev.long()

    upd = fold_updates(torch, ref, base, V, M, s_dev, 0, gb._colmap,
                       kernels)

    def library():
        library_fold(torch, ref, upd)
        t32.index_add_(0, idx, ones)

    t_l = time_ms(torch, library, REPS)
    S, R = V.shape
    touched = len(np.unique(slots))
    width = sum(a.shape[2] for k, a in st.items()
                if k not in ("act", "touch")) + 1
    # the fold's bytes (fold_scalar's count) and each touched counter read
    # and written
    nbytes = (V.numel() * 4 + M.numel() + R * 4 + R
              + touched * width * 8 + touched * 8)
    b_ms, b_by = bound(nbytes, R * (len(gb._colmap) + 2))
    print(f"kernel groupby_fold/touch R={R} C={gb.capacity} "
          f"cols={len(gb._colmap)}: max_abs_err={err[0]:.3g} touch exact "
          f"kernel_ms={t_k:.4f} (without touch {t_u:.4f}) {split_text(split)} "
          f"plain_ms={t_p:.4f} library_ms={t_l:.4f} bound_ms={b_ms:.5f} "
          f"({b_by})")
    return dict(max_abs_err=err[0], max_rel_err=err[1], ms=t_k,
                ms_without_touch=t_u, **split, plain_ms=t_p, bound_ms=b_ms,
                bound_by=b_by, library_ms=t_l)


# ------------------------------------------------------------ phase G
def window_cbs(emitted):
    """Emitted ColumnBatches by window end (device groups and the spilled
    keys' extras, in any order)."""
    by_end = {}
    for cb in emitted:
        if cb.n:
            by_end.setdefault(int(cb.timestamps[0]), []).append(cb)
    return by_end


def object_addresses(arr):
    """The element pointers of an object array, read from its buffer:
    no string object is touched (each touch, in the random memory order
    of an emitted key column, costs a cache miss)."""
    arr = np.ascontiguousarray(arr, dtype=np.object_)
    if not len(arr):
        return np.zeros(0, dtype=np.uintp)
    buf = (ctypes.c_size_t * len(arr)).from_address(arr.ctypes.data)
    return np.ctypeslib.as_array(buf).astype(np.uintp)


class NameIds:
    """Key names -> the stream's integer key ids, for phase G's twins.
    The names the stream made are registered as tables of their string
    objects' addresses, the objects held alive here, so that an address
    names one object: an emitted name that is one of them (the key table
    keeps the objects it was given) is found by its address, with no
    hashing; any other name is parsed by `by_value` (every name carries
    its id)."""

    def __init__(self, by_value):
        self.by_value = by_value
        self.tables = {}

    def register(self, tag, names, ids):
        names = np.asarray(names, dtype=np.object_)
        addr = object_addresses(names)
        order = np.argsort(addr)
        self.tables[tag] = (addr[order], np.asarray(ids, np.int64)[order],
                            names)

    def __call__(self, names):
        names = np.asarray(names, dtype=np.object_)
        addr = object_addresses(names)
        order = np.argsort(addr)
        q = addr[order]
        out = np.full(len(names), -1, dtype=np.int64)
        for known, ids, _held in self.tables.values():
            if len(known):
                at = np.minimum(np.searchsorted(known, q), len(known) - 1)
                hit = known[at] == q
                out[order[hit]] = ids[at[hit]]
        for j in np.nonzero(out < 0)[0].tolist():
            out[j] = self.by_value(names[j])
        return out


def window_columns(cbs, to_ids):
    """One window's rows: key ids (through to_ids) and the value columns,
    every part of the window concatenated."""
    ids = to_ids(np.concatenate([cb.columns["deviceId"] for cb in cbs]))
    cols = {c: np.concatenate([np.asarray(cb.columns[c], dtype=np.float64)
                               for cb in cbs])
            for c in cbs[0].columns if c != "deviceId"}
    return ids, cols


class GTwin:
    """A window's numpy float64 group-by over integer key ids: count, sum,
    sum of |v| (the float32 bound) and, for a rule with min, min."""

    def __init__(self, n_keys, with_min=True):
        self.n = n_keys
        self.with_min = with_min

    def agg(self, ids, v):
        v = v.astype(np.float64)
        out = {"c": np.bincount(ids, minlength=self.n),
               "s": np.bincount(ids, weights=v, minlength=self.n),
               "abs": np.bincount(ids, weights=np.abs(v), minlength=self.n)}
        if self.with_min:
            out["mn"] = np.full(self.n, np.inf)
            np.minimum.at(out["mn"], ids, v)
        return out

    @staticmethod
    def merge(parts):
        out = {k: sum(p[k] for p in parts) for k in ("c", "s", "abs")}
        if "mn" in parts[0]:
            out["mn"] = np.minimum.reduce([p["mn"] for p in parts])
        return out


def value_errs(got, ref, ids):
    """Per row of a window: count and min exact, sum within the float32
    bound of its terms ((n - 1)·ε·Σ|v|, exact for one term). Returns (ok
    mask, abs error of the sums)."""
    n = ref["c"][ids]
    d = np.abs(got["s"] - ref["s"][ids])
    ok = (got["c"] == n) & (d <= EPS32 * np.maximum(n - 1, 1)
                            * ref["abs"][ids])
    if "mn" in got:
        ok &= got["mn"] == ref["mn"][ids]
    return ok, d


def check_g_window(ids, cols, ref, what, alt=None):
    """Every row of one window (window_columns: the device groups and
    the spilled keys' share) against the twin: the keys are the twin's
    live keys; counts and min exact, sums within the float32 bound. `alt`
    (key id -> twin) gives a tail-returned key's other allowed value (the
    reference's rule, ROADMAP Queue 3). Returns (max abs sum error, rows
    on alt)."""
    live = np.nonzero(ref["c"] > 0)[0]
    srt = np.sort(ids)
    check(bool(np.all(srt[1:] != srt[:-1])), f"{what}: a key emitted twice")
    check(np.array_equal(srt, live),
          f"{what}: {len(ids)} keys emitted, want {len(live)}")
    ok, d = value_errs(cols, ref, ids)
    on_alt = 0
    if alt:
        for j in np.nonzero(~ok)[0].tolist():
            a = alt.get(int(ids[j]))
            if a is None:
                continue
            row = {k: cols[k][j:j + 1] for k in cols}
            a_ok, _ = value_errs(row, a, ids[j:j + 1])
            if a_ok[0]:
                ok[j] = True
                d[j] = 0.0
                on_alt += 1
    bad = np.nonzero(~ok)[0]
    check(len(bad) == 0, f"{what}: {len(bad)} rows off the twin (first key "
          f"id {ids[bad[0]] if len(bad) else None})")
    return float(d.max(initial=0.0)), on_alt


def tier_counters(node):
    t = node.tier
    return dict(demoted=t.demoted_total, promoted=t.promoted_total,
                recycled=t.recycled_total, resident=len(t.store),
                host_mb=t.store.nbytes() / 2 ** 20,
                slots=node.gb.capacity)


def g1_parity(torch, seed, mods):
    """The bench's sub-budget parity segment (bench.py:730-771): the tier
    engaged at 0.01 MB (hot target under its 1,024-slot floor, 1,000
    keys) against the untiered rule, 4,096 slots, 8,192-row batches, 3
    windows. Keys and counts must be byte-identical; the sums are float32
    atomics, whose order a card does not fix between two runs, so they
    are held to the float32 bound and their differing bits counted."""
    plan_fused_rule, ColumnBatch, Trigger = mods
    from ekuiper_tpu_torch.runtime.nodes_fused import FusedWindowAggNode

    plain = plan_fused_rule(G1_RULE, key_slots=G1_PAR_SLOTS,
                            micro_batch=G1_PAR_ROWS, options=SYNC)
    tiered = FusedWindowAggNode(
        plain.name, plain.window, plain.plan, plain.dims,
        capacity=G1_PAR_SLOTS, micro_batch=G1_PAR_ROWS,
        direct_emit=plain.direct_emit, emit_columnar=True,
        device=plain.gb.device, prefinalize_lead_ms=0,
        tier_budget_mb=G1_PAR_MB, tier_scan_ms=1)
    check(tiered.tier is not None and plain.tier is None,
          "G1 parity: the tier did not engage")
    out = {"t": [], "p": []}
    tiered.broadcast = out["t"].append
    plain.broadcast = out["p"].append
    rng = np.random.default_rng(seed + 13)
    par_ids = np.array([f"p{i}" for i in range(G1_PAR_KEYS)],
                       dtype=np.object_)
    for w in range(G1_PAR_WINDOWS):
        idx = rng.integers(0, G1_PAR_KEYS, G1_PAR_ROWS)
        vals = rng.normal(50, 10, G1_PAR_ROWS)
        for node in (tiered, plain):
            node.process(ColumnBatch(
                n=G1_PAR_ROWS, columns={"deviceId": par_ids[idx].copy(),
                                        "v": vals.copy()},
                timestamps=np.zeros(G1_PAR_ROWS, dtype=np.int64),
                emitter="demo"))
            node.on_trigger(Trigger(ts=(w + 1) * 1000))
    torch.cuda.synchronize()
    check(len(out["t"]) == len(out["p"]) == G1_PAR_WINDOWS,
          "G1 parity: windows")
    sum_bits = 0
    for a, b in zip(out["t"], out["p"]):
        check(a.columns["deviceId"].tolist() == b.columns["deviceId"]
              .tolist(), "G1 parity: keys differ")
        check(np.asarray(a.columns["c"]).tobytes()
              == np.asarray(b.columns["c"]).tobytes(),
              "G1 parity: counts differ")
        sa, sb = (np.asarray(x.columns["s"], np.float64) for x in (a, b))
        check(bool(np.all(np.abs(sa - sb) <= 2 * EPS32 * np.asarray(
            a.columns["c"]) * 50 * 3)), "G1 parity: sums differ")
        sum_bits += int((np.asarray(a.columns["s"]).view(np.uint32)
                         != np.asarray(b.columns["s"]).view(np.uint32)).sum())
    return dict(windows=len(out["t"]), rows=sum(cb.n for cb in out["t"]),
                sum_bits_differ=sum_bits,
                demoted=tiered.tier.demoted_total,
                slots=tiered.gb.capacity)


def run_g1(torch, seed, kernels, mods):
    """The key-cardinality sweep: 262,144 hot keys and 2,048 fresh ones a
    batch, a tumbling 1 s window every 4 batches (the engine clock moved to
    each boundary, so the 1 ms scan runs at each), to 2,000,000 distinct
    keys; every window against the numpy twin, the device slots held at
    the layout's hot capacity."""
    plan_fused_rule, ColumnBatch, Trigger = mods
    from ekuiper_tpu_torch.utils import timex

    node = plan_fused_rule(G1_RULE, key_slots=G_SLOTS, micro_batch=ROWS,
                           options=G1_OPTS)
    check(node.gb.device.type == "cuda", "G1 is not on the card")
    layout = node.tier.layout
    check((layout.hot_slots, layout.hot_capacity(), node.gb.capacity)
          == (1_677_721, 2_097_152, 1 << 20),
          f"G1 layout {layout} at {node.gb.capacity} slots")
    emitted = []
    node.broadcast = emitted.append
    stages = {"encode": 0.0}
    node._build_kernel_inputs = timed(node._build_kernel_inputs, stages,
                                      "encode")
    clock = timex.set_mock_clock(0)
    rng = np.random.default_rng(seed + 690)
    hot_names = np.array([f"hot_{i}" for i in range(G1_HOT)],
                         dtype=np.object_)
    # hot_<i> is key i, fresh k<n> is key G1_HOT + n
    to_ids = NameIds(lambda name: int(name[4:]) if name.startswith("hot_")
                     else G1_HOT + int(name[1:]))
    to_ids.register("hot", hot_names, np.arange(G1_HOT))
    n_batches = -(-(G1_TARGETS[-1] - G1_HOT) // G1_FRESH)
    n_batches += -n_batches % G_PER_WINDOW
    n_total = G1_HOT + n_batches * G1_FRESH
    twin = GTwin(n_total, with_min=False)
    kernels.reset_launches()
    node_s, emit_ms, worst, caps = 0.0, [], 0.0, []
    encode_before, batches_before = None, 0
    win_ids, win_v, win_fresh, checkpoints = [], [], [], []
    seg = {"t": 0.0, "rows": 0}
    for b in range(n_batches):
        idx = rng.integers(0, G1_HOT, ROWS - G1_FRESH)
        start = G1_HOT + b * G1_FRESH
        fresh = np.array([f"k{b * G1_FRESH + i}" for i in range(G1_FRESH)],
                         dtype=np.object_)
        win_fresh.append(fresh)
        names = np.concatenate([hot_names[idx], fresh])
        v = rng.normal(50, 10, ROWS)
        win_ids.append(np.concatenate([idx, np.arange(start, start
                                                      + G1_FRESH)]))
        win_v.append(v.astype(np.float32))
        batch = ColumnBatch(n=ROWS, columns={"deviceId": names, "v": v},
                            timestamps=np.zeros(ROWS, dtype=np.int64),
                            emitter="demo")
        t = time.perf_counter()
        node.process(batch)
        dt = time.perf_counter() - t
        if (b + 1) % G_PER_WINDOW:
            node_s += dt
            seg["t"] += dt
            seg["rows"] += ROWS
            continue
        wn = (b + 1) // G_PER_WINDOW
        clock.set(wn * 1000)
        te = time.perf_counter()
        node.on_trigger(Trigger(ts=wn * 1000))
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        emit_ms.append((t_end - te) * 1e3)
        node_s += dt + (t_end - te)
        seg["t"] += dt + (t_end - te)
        seg["rows"] += ROWS
        caps.append(node.gb.capacity)
        check(node.gb.capacity <= layout.hot_capacity(),
              f"G1: {node.gb.capacity} slots past the hot capacity")
        if encode_before is None and node.tier.demoted_total:
            encode_before, batches_before = stages["encode"], b + 1
        # a synchronous boundary (lead 0): the window was emitted before
        # on_trigger returned; the tier's harvests and scans go on on the
        # emit worker
        check(node._deliveries_queued == node._deliveries_done,
              f"G1 window {wn}: a delivery was deferred")
        cbs = window_cbs(emitted).get(wn * 1000, [])
        emitted.clear()
        ref = twin.agg(np.concatenate(win_ids), np.concatenate(win_v))
        # a tumbling window's keys: hot ones and its own fresh ones
        fresh = np.concatenate(win_fresh)
        to_ids.register("fresh", fresh, np.arange(
            start + G1_FRESH - len(fresh), start + G1_FRESH))
        win_ids, win_v, win_fresh = [], [], []
        check(bool(cbs), f"G1 window {wn}: nothing emitted")
        err, _ = check_g_window(*window_columns(cbs, to_ids), ref,
                                f"G1 window {wn}")
        worst = max(worst, err)
        distinct = G1_HOT + (b + 1) * G1_FRESH
        for target in G1_TARGETS:
            if distinct >= target and len(checkpoints) < \
                    G1_TARGETS.index(target) + 1:
                checkpoints.append(dict(
                    distinct=distinct, rows_per_s=seg["rows"] / seg["t"],
                    emit_p99_ms=pct(emit_ms, 99), **tier_counters(node),
                    demote_launches=kernels.LAUNCHES["tier_demote"],
                    promote_launches=kernels.LAUNCHES["tier_promote"]))
                seg = {"t": 0.0, "rows": 0}
    node._drain_async_emits()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    touch = dict(kernels.TOUCH_LAUNCHES)
    grows = sum(1 for a, b in zip(caps, caps[1:]) if b != a) + (
        caps[0] != 1 << 20)
    check(grows <= 1 and max(caps) <= layout.hot_capacity(),
          f"G1 capacity path {sorted(set(caps))}")
    check(node.tier.demoted_total > 0 and launches["tier_demote"] > 0,
          "G1 demoted nothing")
    n_rows = n_batches * ROWS
    after = stages["encode"] - (encode_before or 0.0)
    return dict(
        batches=n_batches, windows=n_batches // G_PER_WINDOW,
        distinct=n_total, rows_per_s=n_rows / node_s,
        encode_ms=stages["encode"] / n_batches * 1e3,
        encode_ms_before=(encode_before / batches_before * 1e3
                          if encode_before else None),
        encode_ms_after=(after / (n_batches - batches_before) * 1e3
                         if encode_before else None),
        emit_p50=pct(emit_ms, 50), emit_p99=pct(emit_ms, 99),
        max_abs_err=worst, capacities=sorted(set(caps)),
        checkpoints=checkpoints, layout=layout, launches=launches,
        touch_launches=touch, **tier_counters(node))


class G2Stream:
    """G2's rows, made in bulk from the seed: per 65,536-row batch (4 to a
    1 s slide) 57,344 rows uniform over 65,536 hot keys, 2,048 new keys,
    and 6,144 rows uniform over the keys first seen 4-9 slides earlier
    (hot keys before there are any); v ~ N(50, 10)."""

    def __init__(self, seed):
        rng = np.random.default_rng(seed + 22)
        n_new = G2_BATCHES * G2_NEW
        self.n_keys = G2_HOT + n_new
        self.names = np.array([f"hot_{i}" for i in range(G2_HOT)]
                              + [f"n{j}" for j in range(n_new)],
                              dtype=np.object_)
        # hot_<i> is key i, n<j> is key G2_HOT + j
        self.to_ids = NameIds(
            lambda name: int(name[4:]) if name.startswith("hot_")
            else G2_HOT + int(name[1:]))
        self.to_ids.register("all", self.names, np.arange(self.n_keys))
        per_slide = G_PER_WINDOW * G2_NEW
        self.ids, self.v = [], []
        for b in range(G2_BATCHES):
            s = b // G_PER_WINDOW
            lo, hi = s - G2_BACK[1], s - G2_BACK[0] + 1
            if hi > 0:
                back = rng.integers(G2_HOT + max(lo, 0) * per_slide,
                                    G2_HOT + hi * per_slide, G2_BACK_ROWS)
            else:
                back = rng.integers(0, G2_HOT, G2_BACK_ROWS)
            ids = np.concatenate([
                rng.integers(0, G2_HOT, G2_HOT_ROWS),
                G2_HOT + b * G2_NEW + np.arange(G2_NEW), back])
            self.ids.append(ids)
            self.v.append(rng.normal(50, 10, ROWS))

    def batch(self, ColumnBatch, b):
        return ColumnBatch(n=ROWS, columns={"deviceId": self.names[
            self.ids[b]], "v": self.v[b]},
            timestamps=np.zeros(ROWS, dtype=np.int64), emitter="demo")


def g2_node(plan_fused_rule, lead):
    node = plan_fused_rule(G2_RULE, key_slots=G_SLOTS, micro_batch=ROWS,
                           options={"tierHotMb": G_HOT_MB,
                                    "prefinalizeLeadMs": lead})
    layout = node.tier.layout
    check((layout.hot_slots, node.gb.capacity) == (137_518, 262_144),
          f"G2 layout {layout} at {node.gb.capacity} slots")
    return node


def run_g2a(torch, stream, kernels, mods):
    """G2a: the synchronous boundary (prefinalizeLeadMs 0), on_trigger by
    hand at each 1 s slide, the engine clock moved to it."""
    plan_fused_rule, ColumnBatch, Trigger = mods
    from ekuiper_tpu_torch.utils import timex

    node = g2_node(plan_fused_rule, 0)
    emitted = []
    node.broadcast = emitted.append
    stages = {"encode": 0.0}
    node._build_kernel_inputs = timed(node._build_kernel_inputs, stages,
                                      "encode")
    clock = timex.set_mock_clock(0)
    batches = [stream.batch(ColumnBatch, b) for b in range(G2_BATCHES)]
    kernels.reset_launches()
    emit_ms = []
    t0 = time.perf_counter()
    for b, batch in enumerate(batches):
        clock.set(b // G_PER_WINDOW * 1000
                  + G2B_OFFSETS[b % G_PER_WINDOW])
        node.process(batch)
        if (b + 1) % G_PER_WINDOW == 0:
            end = (b + 1) // G_PER_WINDOW * 1000
            clock.set(end)
            te = time.perf_counter()
            node.on_trigger(Trigger(ts=end))
            torch.cuda.synchronize()
            emit_ms.append((time.perf_counter() - te) * 1e3)
    node._drain_async_emits()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    timex.use_real_clock()
    return dict(rows_per_s=G2_BATCHES * ROWS / wall,
                encode_ms=stages["encode"] / G2_BATCHES * 1e3,
                emit_p50=pct(emit_ms, 50), emit_p99=pct(emit_ms, 99),
                launches=dict(kernels.LAUNCHES),
                touch_launches=dict(kernels.TOUCH_LAUNCHES),
                windows=window_cbs(emitted), **tier_counters(node))


def run_g2b(torch, stream, kernels, mods):
    """G2b: the default boundary (prefinalizeLeadMs 250, tailMode device),
    opened on the mock clock: batches at 100, 350, 600 and 850 ms of each
    slide, the pre-triggers at 500 and 750, the boundary at 1,000. Records
    each boundary's stall, each window's delivery (its last part) and the
    keys each batch's admission promoted."""
    plan_fused_rule, ColumnBatch, Trigger = mods
    from ekuiper_tpu_torch.utils import timex

    node = g2_node(plan_fused_rule, 250)
    deliveries, stall_ms, t_trig = [], [], {}
    node.broadcast = lambda item: deliveries.append(
        (time.perf_counter(), item))
    on_trigger = node.on_trigger

    def timed_trigger(trig):
        t = time.perf_counter()
        t_trig[int(trig.ts)] = t
        on_trigger(trig)
        stall_ms.append((time.perf_counter() - t) * 1e3)

    node.on_trigger = timed_trigger
    stages = {"encode": 0.0}
    node._build_kernel_inputs = timed(node._build_kernel_inputs, stages,
                                      "encode")
    # the keys admit promotes: each promote block's slots, decoded while
    # the fresh slots still hold the returning keys
    promoted, batch_promoted = [], []
    ts_promote = node.tier.ts.promote

    def recorded_promote(state, packed, slots):
        batch_promoted.extend(node.kt.decode(int(s)) for s in slots)
        return ts_promote(state, packed, slots)

    node.tier.ts.promote = recorded_promote
    batches = [stream.batch(ColumnBatch, b) for b in range(G2_BATCHES)]
    clock = timex.set_mock_clock(0)
    kernels.reset_launches()
    node.on_open()
    t0 = time.perf_counter()
    for b, batch in enumerate(batches):
        clock.set(b // G_PER_WINDOW * 1000 + G2B_OFFSETS[b % G_PER_WINDOW])
        node.process(batch)
        promoted.append(batch_promoted[:])
        batch_promoted.clear()
        if (b + 1) % G_PER_WINDOW == 0:
            clock.set((b + 1) // G_PER_WINDOW * 1000)
    node._drain_async_emits()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    touch = dict(kernels.TOUCH_LAUNCHES)
    node.on_close()
    timex.use_real_clock()
    check(not node.recoveries, f"G2b recovery routes: "
          f"{dict(node.recoveries)}")
    last = {}
    for t, cb in deliveries:
        if cb.n:
            end = int(cb.timestamps[0])
            last[end] = max(last.get(end, 0.0), t)
    delivery = [(last[e] - t_trig[e]) * 1e3 for e in last if e in t_trig]
    return dict(rows_per_s=G2_BATCHES * ROWS / wall,
                encode_ms=stages["encode"] / G2_BATCHES * 1e3,
                stall_p50=pct(stall_ms, 50), stall_p99=pct(stall_ms, 99),
                delivery_p50=pct(delivery, 50),
                delivery_p99=pct(delivery, 99), launches=launches,
                touch_launches=touch, promoted_by_batch=promoted,
                windows=window_cbs([cb for _, cb in deliveries]),
                **tier_counters(node))


def check_g2(stream, a, b):
    """Every G2a and G2b window against the twin over its ten slides' rows,
    and G2b against G2a. A key G2b promoted after the 500 ms pre-issue of
    the window's last slide may instead carry only its rows from that
    batch on (the reference's rule for a return in a window's tail:
    ROADMAP Queue 3, tests/test_torch_tierstore.py)."""
    twin = GTwin(stream.n_keys)
    slides = G2_BATCHES // G_PER_WINDOW
    per_slide, worst, on_alt, compared = [], 0.0, 0, 0
    for s in range(slides):
        bs = range(s * G_PER_WINDOW, (s + 1) * G_PER_WINDOW)
        per_slide.append(twin.agg(
            np.concatenate([stream.ids[b] for b in bs]),
            np.concatenate([stream.v[b].astype(np.float32) for b in bs])))
        ref = GTwin.merge(per_slide[-10:])
        end = (s + 1) * 1000
        rows = {}
        for tag, run in (("G2a", a), ("G2b", b)):
            cbs = run["windows"].get(end)
            check(bool(cbs), f"{tag} window {end}: nothing emitted")
            rows[tag] = window_columns(cbs, stream.to_ids)
            alt = None
            if tag == "G2b":
                alt = {}
                # the last slide's tail batches: a key promoted in the
                # batch at 600 ms may carry that batch and the next, one
                # promoted at 850 ms that batch only
                tail = [twin.agg(stream.ids[bt], stream.v[bt].astype(
                    np.float32)) for bt in bs[2:]]
                tail = [GTwin.merge(tail[j:]) for j in range(len(tail))]
                for j, bt in enumerate(bs[2:]):
                    keys = b["promoted_by_batch"][bt]
                    if keys:
                        alt.update(dict.fromkeys(stream.to_ids(np.array(
                            keys, dtype=np.object_)).tolist(), tail[j]))
            err, n_alt = check_g_window(*rows[tag], ref,
                                        f"{tag} window {end}", alt)
            worst = max(worst, err)
            on_alt += n_alt
        # G2b against G2a: the same keys, counts and min but the keys on
        # the reference's rule, sums within the bound of either's terms
        (ia, ca), (ib, cb_) = rows["G2a"], rows["G2b"]
        check(np.array_equal(np.sort(ia), np.sort(ib)),
              f"G2b window {end}: keys differ from G2a's")
        oa, ob = np.argsort(ia), np.argsort(ib)
        same = (ca["c"][oa] == cb_["c"][ob]) & (ca["mn"][oa] == cb_["mn"][ob])
        compared += len(ia)
        check(int((~same).sum()) <= len(b["promoted_by_batch"][bs[2]])
              + len(b["promoted_by_batch"][bs[3]]),
              f"G2b window {end}: {int((~same).sum())} rows differ from "
              "G2a's beyond the tail returns")
    return dict(max_abs_err=worst, tail_returns=on_alt, rows=compared)


def run_phase_g(torch, seed, kernels, mods):
    """Phase G: G1 (the parity segment, then the sweep), G2a, G2b."""
    t0 = time.perf_counter()
    walls = {}
    par = g1_parity(torch, seed, mods)
    g1 = run_g1(torch, seed, kernels, mods)
    walls["g1"] = time.perf_counter() - t0
    stream = G2Stream(seed)
    g2a = run_g2a(torch, stream, kernels, mods)
    walls["g2a"] = time.perf_counter() - t0 - sum(walls.values())
    g2b = run_g2b(torch, stream, kernels, mods)
    walls["g2b"] = time.perf_counter() - t0 - sum(walls.values())
    g2 = check_g2(stream, g2a, g2b)
    walls["check_g2"] = time.perf_counter() - t0 - sum(walls.values())
    for tag, r in (("G2a", g2a), ("G2b", g2b)):
        check(r["promoted"] > 0 and r["resident"] > 0
              and r["launches"]["tier_promote"] > 0,
              f"{tag}: promoted {r['promoted']}, resident {r['resident']}, "
              f"tier_promote launches {r['launches']['tier_promote']}")
        r["windows"] = len(r.pop("windows"))
    g2b.pop("promoted_by_batch")
    return dict(parity=par, g1=g1, g2a=g2a, g2b=g2b, g2=g2, walls=walls)


def phase_g_lines(g):
    par, g1 = g["parity"], g["g1"]
    lay = g1["layout"]
    yield (f"phase G1 parity: tier {G1_PAR_MB} MB vs untiered, "
           f"{G1_PAR_SLOTS} slots ({par['slots']} tiered), {G1_PAR_KEYS} "
           f"keys, {G1_PAR_ROWS}-row batches, {par['windows']} windows, "
           f"{par['rows']} rows: keys and counts byte-identical, "
           f"{par['sum_bits_differ']} sums differing in bits (float32 "
           f"atomics' order), within the bound; demoted {par['demoted']}")
    yield (f"phase G1 layout: hot_slots={lay.hot_slots} "
           f"hot_capacity={lay.hot_capacity()} demote_batch="
           f"{lay.demote_batch} scan_ms={lay.scan_interval_ms} "
           f"min_idle_scans={lay.min_idle_scans}; device slots "
           f"{g1['capacities']}")
    for c in g1["checkpoints"]:
        yield (f"phase G1 checkpoint {c['distinct']} distinct keys: "
               f"rows/s={c['rows_per_s']:.0f} emit_p99_ms="
               f"{c['emit_p99_ms']:.3f} device_slots={c['slots']} "
               f"demoted={c['demoted']} promoted={c['promoted']} "
               f"recycled={c['recycled']} resident_cold={c['resident']} "
               f"host_store_mb={c['host_mb']:.1f} tier_demote="
               f"{c['demote_launches']} tier_promote="
               f"{c['promote_launches']}")
    enc = g1["encode_ms_before"]
    enc_after = g1["encode_ms_after"]
    yield (f"phase G1 sweep: {g1['batches']} batches x {ROWS} rows, "
           f"{g1['windows']} windows, {g1['distinct']} distinct keys: "
           f"rows/s={g1['rows_per_s']:.0f} (node time) host encode "
           f"ms/batch={g1['encode_ms']:.3f} (before recycling "
           f"{'n/a' if enc is None else f'{enc:.3f}'}, after "
           f"{'n/a' if enc_after is None else f'{enc_after:.3f}'}) "
           f"emit_p50_ms={g1['emit_p50']:.3f} emit_p99_ms="
           f"{g1['emit_p99']:.3f} device_slots={g1['slots']} demoted="
           f"{g1['demoted']} promoted={g1['promoted']} recycled="
           f"{g1['recycled']} resident_cold={g1['resident']} "
           f"host_store_mb={g1['host_mb']:.1f} tier_demote="
           f"{g1['launches']['tier_demote']} tier_promote="
           f"{g1['launches']['tier_promote']} max_abs_err="
           f"{g1['max_abs_err']:.3g} (the bench's 10M checkpoint cut for "
           "time)")
    for tag in ("g2a", "g2b"):
        r = g[tag]
        lat = (f"emit_p50_ms={r['emit_p50']:.3f} emit_p99_ms="
               f"{r['emit_p99']:.3f}" if tag == "g2a" else
               f"stall_p50_ms={r['stall_p50']:.3f} stall_p99_ms="
               f"{r['stall_p99']:.3f} delivery_p50_ms="
               f"{r['delivery_p50']:.3f} delivery_p99_ms="
               f"{r['delivery_p99']:.3f}")
        yield (f"phase G {tag.upper()}: {G2_BATCHES} batches, {r['windows']} "
               f"windows: rows/s={r['rows_per_s']:.0f} host encode "
               f"ms/batch={r['encode_ms']:.3f} {lat} device_slots="
               f"{r['slots']} demoted={r['demoted']} promoted="
               f"{r['promoted']} recycled={r['recycled']} resident_cold="
               f"{r['resident']} host_store_mb={r['host_mb']:.1f} "
               f"tier_demote={r['launches']['tier_demote']} tier_promote="
               f"{r['launches']['tier_promote']}")
    yield (f"phase G checks: G1 max_abs_err {g1['max_abs_err']:.3g}; G2 "
           f"max_abs_err {g['g2']['max_abs_err']:.3g}, {g['g2']['rows']} "
           f"rows G2b vs G2a; {g['g2']['tail_returns']} G2b rows of keys "
           "back in a window's tail after its pre-issue carried their tail "
           "rows only (the reference's rule, ROADMAP Queue 3); wall s "
           + " ".join(f"{k}={v:.1f}" for k, v in g["walls"].items()))


# ------------------------------------------------------------ phase H
def sparse_hll_estimates(keys, vals, n_keys):
    """Each key's hll estimate from its rows (key index, float32 value)
    through a sort and maximum.reduceat over (key, register): the
    registers of a million keys stay sparse. float32 arithmetic of
    twin_hll_estimate, keys with no rows 0."""
    reg, rho = twin_hll(vals)
    flat = keys.astype(np.int64) * HLL_M + reg
    order = np.argsort(flat, kind="stable")
    fs = flat[order]
    starts = np.flatnonzero(np.r_[True, fs[1:] != fs[:-1]])
    rmax = np.maximum.reduceat(rho[order], starts)
    ukey = fs[starts] // HLL_M
    nz = rmax > 0
    nnz = np.bincount(ukey[nz], minlength=n_keys)
    zsum = np.bincount(ukey[nz], weights=np.exp2(-rmax[nz].astype(
        np.float64)), minlength=n_keys)
    m = np.float32(HLL_M)
    z = ((HLL_M - nnz) + zsum).astype(np.float32)
    zeros = (HLL_M - nnz).astype(np.float32)
    raw = np.float32(0.7213 / (1.0 + 1.079 / HLL_M) * HLL_M * HLL_M) / z
    small = m * np.log(m / np.maximum(zeros, np.float32(1)))
    return np.rint(np.where((raw < 2.5 * HLL_M) & (zeros > 0), small, raw))


def run_h1(torch, seed, kernels, mods):
    """H1, BASELINE config #4: hll(uid) over COUNTWINDOW(2097152) at 1<<20
    slots, the default boundary (the count window's finalize launched on
    the fold thread, delivered by the emit worker). One window of 32
    distinct batches, cycled: every window holds the same rows, so one
    sparse register twin checks all three."""
    plan_fused_rule, ColumnBatch, _ = mods
    rng = np.random.default_rng(seed + 80)
    ids = np.array([f"dev_{i}" for i in range(H1_KEY_SPACE)], dtype=np.object_)
    idx = rng.integers(0, H1_KEY_SPACE, (H1_BATCHES, ROWS))
    uid = rng.integers(0, H1_UIDS, (H1_BATCHES, ROWS))
    batches = [ColumnBatch(n=ROWS, columns={"deviceId": ids[idx[b]],
                                            "uid": uid[b]}, emitter="demo")
               for b in range(H1_BATCHES)]
    node = plan_fused_rule(H1_RULE, key_slots=H1_SLOTS, micro_batch=ROWS)
    check(node.gb.device.type == "cuda", "H1 is not on the card")
    check(node._async_count, "H1: the count window's emit is not async")
    emitted, t_got, t_disp = [], [], []
    node.broadcast = lambda cb: (emitted.append(cb),
                                 t_got.append(time.perf_counter()))
    dispatch = node._emit_count_async

    def timed_dispatch(wr):
        t_disp.append(time.perf_counter())
        dispatch(wr)

    node._emit_count_async = timed_dispatch
    stages = {"encode": 0.0}
    node._build_kernel_inputs = timed(node._build_kernel_inputs, stages,
                                      "encode")
    kernels.reset_launches()
    t0 = time.perf_counter()
    for b in range(H1_BATCHES * H1_WINDOWS):
        node.process(batches[b % H1_BATCHES])
    node._drain_async_emits()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    check(not node.recoveries, "H1: recovery routes taken")
    check(len(emitted) == H1_WINDOWS,
          f"H1: {len(emitted)} windows, want {H1_WINDOWS}")
    n_keys = node.kt.n_keys
    t_c = time.perf_counter()
    est = sparse_hll_estimates(idx.ravel(), uid.ravel().astype(np.float32),
                               H1_KEY_SPACE)
    live = np.nonzero(np.bincount(idx.ravel(), minlength=H1_KEY_SPACE))[0]
    check(n_keys == len(live), f"H1: {n_keys} keys, want {len(live)}")
    worst = 0
    for w, cb in enumerate(emitted):
        keys = key_ids(cb.columns["deviceId"])
        order = np.argsort(keys)
        check(cb.n == len(live) and (keys[order] == live).all(),
              f"H1 window {w}: emitted keys differ")
        d = np.abs(np.asarray(cb.columns["uniq"], dtype=np.float64)[order]
                   - est[live])
        check((d <= 1).all(), f"H1 window {w}: estimate beyond ±1 "
              f"(max {d.max()})")
        worst = max(worst, int(d.max()))
    delivery = [(g - d) * 1e3 for g, d in zip(t_got, t_disp)]
    return dict(rows_per_s=H1_BATCHES * H1_WINDOWS * ROWS / wall,
                encode_ms=stages["encode"] / (H1_BATCHES * H1_WINDOWS) * 1e3,
                delivery_p50=pct(delivery, 50), delivery_p99=pct(delivery, 99),
                keys=n_keys, windows=len(emitted), max_abs_err=worst,
                off_by_one=None, launches=launches,
                check_s=time.perf_counter() - t_c,
                source=(node.last_emit_info or {}).get("source"))


def run_h2(torch, seed, kernels, mods):
    """H2: E2's count rule fed 50,000-row batches (edges inside batches),
    the default boundary, then EOF (the open window flushed): counts and
    max exact against numpy over exactly each window's rows."""
    plan_fused_rule, ColumnBatch, _ = mods
    from ekuiper_tpu_torch.runtime.events import EOF

    rng = np.random.default_rng(seed + 81)
    ids = np.array([f"dev_{i}" for i in range(N_KEYS)], dtype=np.object_)
    idx = rng.integers(0, N_KEYS, H2_BATCHES * H2_ROWS)
    temp = rng.normal(20, 5, H2_BATCHES * H2_ROWS).astype(np.float32)
    node = plan_fused_rule(H2_RULE, key_slots=SLOTS, micro_batch=ROWS)
    check(node._async_count, "H2: the count window's emit is not async")
    emitted = []
    node.broadcast = emitted.append
    kernels.reset_launches()
    t0 = time.perf_counter()
    for b in range(H2_BATCHES):
        sl = slice(b * H2_ROWS, (b + 1) * H2_ROWS)
        node.process(ColumnBatch(n=H2_ROWS, columns={
            "deviceId": ids[idx[sl]], "temperature": temp[sl]},
            emitter="demo"))
    node._drain_async_emits()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    source = (node.last_emit_info or {}).get("source")
    node.on_eof(EOF())
    cbs = [cb for cb in emitted if hasattr(cb, "columns")]
    n = len(idx)
    edges = list(range(0, n, H2_COUNT)) + [n]
    check(len(cbs) == len(edges) - 1,
          f"H2: {len(cbs)} windows, want {len(edges) - 1}")
    inside = sum(e % H2_ROWS != 0 for e in edges[1:-1])
    for w, cb in enumerate(cbs):
        k = idx[edges[w]:edges[w + 1]]
        t = temp[edges[w]:edges[w + 1]]
        cnt = np.bincount(k, minlength=N_KEYS)
        mx = np.full(N_KEYS, -np.inf, dtype=np.float32)
        np.maximum.at(mx, k, t)
        live = np.nonzero(cnt)[0]
        keys = key_ids(cb.columns["deviceId"])
        order = np.argsort(keys)
        check(cb.n == len(live) and (keys[order] == live).all(),
              f"H2 window {w}: emitted keys differ")
        check((np.asarray(cb.columns["c"])[order] == cnt[live]).all(),
              f"H2 window {w}: count")
        check((np.asarray(cb.columns["m"], dtype=np.float32)[order]
               == mx[live]).all(), f"H2 window {w}: max")
    return dict(rows_per_s=n / wall, windows=len(cbs), edges_inside=inside,
                launches=launches, source=source)


def session_stream(rng, ColumnBatch):
    """H3's batches (deviceId, v ~ N(20, 5)) and the twin's sessions: the
    gap closes a session at its last batch + gap, the cap at its start +
    cap, whichever the next batch (or the end) reaches first."""
    ids = np.array([f"dev_{i}" for i in range(N_KEYS)], dtype=np.object_)
    n_b = len(H3_TIMES)
    idx = rng.integers(0, N_KEYS, (n_b, ROWS))
    v = rng.normal(20, 5, (n_b, ROWS)).astype(np.float32)
    batches = [ColumnBatch(n=ROWS, columns={"deviceId": ids[idx[b]],
                                            "v": v[b]}, emitter="demo")
               for b in range(n_b)]
    sessions, cur = [], None
    for b, t in enumerate(H3_TIMES + [H3_END_MS]):
        if cur is not None:
            end = min(cur["last"] + H3_GAP_MS, cur["start"] + H3_CAP_MS)
            if t >= end:
                cur["end"] = end
                sessions.append(cur)
                cur = None
        if b == n_b:
            break
        if cur is None:
            cur = {"start": t, "batches": []}
        cur["batches"].append(b)
        cur["last"] = t
    check(cur is None, "H3's stream ends inside a session")
    return batches, idx, v, sessions


def drive_times(torch, node, batches, times, end_ms):
    """Open `node` on a fresh mock clock, feed batches[i] at times[i], move
    to end_ms; returns the wall seconds (deliveries drained, card
    synchronized)."""
    from ekuiper_tpu_torch.utils import timex

    clock = timex.set_mock_clock(0)
    node.on_open()
    t0 = time.perf_counter()
    for t, batch in zip(times, batches):
        clock.set(t)
        node.process(batch)
    clock.set(end_ms)
    node._drain_async_emits()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    node.on_close()
    timex.use_real_clock()
    return wall


def check_avg_windows(tag, cbs, spans, idx, v):
    """Each emitted window against a float64 group-by of exactly its rows
    (spans[w]: its flat row indices): keys and counts exact, avg within
    ε·(Σ|x| + |mean|). Returns the max abs error of avg."""
    check(len(cbs) == len(spans),
          f"{tag}: {len(cbs)} windows, want {len(spans)}")
    worst = 0.0
    for w, (cb, rows) in enumerate(zip(cbs, spans)):
        k = idx[rows]
        x = v[rows].astype(np.float64)
        cnt = np.bincount(k, minlength=N_KEYS)
        tot = np.bincount(k, x, minlength=N_KEYS)
        sab = np.bincount(k, np.abs(x), minlength=N_KEYS)
        live = np.nonzero(cnt)[0]
        keys = key_ids(cb.columns["deviceId"])
        order = np.argsort(keys)
        check(cb.n == len(live) and (keys[order] == live).all(),
              f"{tag} window {w}: emitted keys differ")
        check((np.asarray(cb.columns["c"])[order] == cnt[live]).all(),
              f"{tag} window {w}: count")
        mean = tot[live] / cnt[live]
        d = np.abs(np.asarray(cb.columns["a"], dtype=np.float64)[order]
                   - mean)
        check((d <= EPS32 * (sab[live] + np.abs(mean))).all(),
              f"{tag} window {w}: avg beyond bound (max {d.max()})")
        worst = max(worst, float(d.max()))
    return worst


def run_h3(torch, seed, kernels, mods):
    """H3: the session rule on the mock clock; every session against the
    float64 twin over exactly its batches, ending where the twin ends it."""
    plan_fused_rule, ColumnBatch, _ = mods
    rng = np.random.default_rng(seed + 82)
    batches, idx, v, sessions = session_stream(rng, ColumnBatch)
    node = plan_fused_rule(H3_RULE, key_slots=SLOTS, micro_batch=ROWS)
    emitted = []
    node.broadcast = emitted.append
    kernels.reset_launches()
    wall = drive_times(torch, node, batches, H3_TIMES, H3_END_MS)
    launches = dict(kernels.LAUNCHES)
    ends = [int(cb.timestamps[0]) for cb in emitted]
    check(ends == [s["end"] for s in sessions],
          f"H3: sessions end at {ends}, want "
          f"{[s['end'] for s in sessions]}")
    spans = [(np.asarray(s["batches"])[:, None] * ROWS
              + np.arange(ROWS)[None, :]).ravel() for s in sessions]
    worst = check_avg_windows("H3", emitted, spans, idx.ravel(), v.ravel())
    caps = sum(s["end"] == s["start"] + H3_CAP_MS for s in sessions)
    return dict(rows_per_s=len(batches) * ROWS / wall, windows=len(emitted),
                by_cap=caps, by_gap=len(sessions) - caps, max_abs_err=worst,
                launches=launches, ends=ends, sessions=sessions,
                batches=batches, idx=idx, v=v)


def run_h4(torch, seed, kernels, mods):
    """H4: the state rule, st at 1 or 0 on random rows; the twin walks the
    toggles (a begin row opens, the next emit row after it closes,
    inclusive) and checks every window over exactly its rows."""
    plan_fused_rule, ColumnBatch, _ = mods
    rng = np.random.default_rng(seed + 83)
    ids = np.array([f"dev_{i}" for i in range(N_KEYS)], dtype=np.object_)
    n = H4_BATCHES * ROWS
    idx = rng.integers(0, N_KEYS, n)
    v = rng.normal(20, 5, n).astype(np.float32)
    p = rng.random(n)
    st = np.where(p < H4_TOGGLE_P, 1, np.where(p < 2 * H4_TOGGLE_P, 0, 2))
    node = plan_fused_rule(H4_RULE, key_slots=SLOTS, micro_batch=ROWS)
    emitted = []
    node.broadcast = emitted.append
    kernels.reset_launches()
    t0 = time.perf_counter()
    for b in range(H4_BATCHES):
        sl = slice(b * ROWS, (b + 1) * ROWS)
        node.process(ColumnBatch(n=ROWS, columns={
            "deviceId": ids[idx[sl]], "v": v[sl], "st": st[sl]},
            emitter="demo"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    spans, open_at = [], None
    for i in np.flatnonzero(st != 2).tolist():
        if open_at is None:
            if st[i] == 1:
                open_at = i
        elif st[i] == 0:
            spans.append(np.arange(open_at, i + 1))
            open_at = None
    worst = check_avg_windows("H4", emitted, spans, idx, v)
    within = sum(s[0] // ROWS == s[-1] // ROWS for s in spans)
    check(within > 0 and within < len(spans),
          f"H4: {within} of {len(spans)} windows inside one batch; the run "
          "needs both kinds")
    return dict(rows_per_s=n / wall, windows=len(spans), within=within,
                spanning=len(spans) - within, open_at_end=open_at is not None,
                max_abs_err=worst, launches=launches)


def check_group_sketch(tag, thresholds, emitted, rows, slot_keys, what):
    """The sketch outputs of one H5 family's window, every rule, against
    numpy twins over exactly the rows passing the rule's WHERE (float32
    column against float32 threshold): hll within ±1 of the registers'
    estimate; the percentile in the twin's bin, or one over where one of
    the key's values lies within D_EDGE of a bin edge. Rules are visited
    in nesting order, each adding only its delta rows to the cumulative
    registers or histograms. Returns (rows checked, values one off)."""
    col, op, _ = E_TWIN[tag]
    check(op == ">", f"{tag}: nesting order")
    x = rows[col]
    order = np.argsort(x, kind="stable")
    bounds = np.searchsorted(x[order], np.asarray(thresholds,
                                                  dtype=np.float32),
                             side="right")
    visit = np.argsort(-bounds, kind="stable")
    cnt = np.zeros(N_KEYS)
    if tag == "h5_hll":
        reg, rho = twin_hll(rows["humidity"])
        regs = np.zeros(N_KEYS * HLL_M, dtype=np.int64)
    else:
        b, near = twin_bins(rows["temperature"], D_EDGE)
        hist = np.zeros((N_KEYS, HIST_BINS), dtype=np.int32)
        edge = np.zeros(N_KEYS, dtype=bool)
    prev, n_rows, off = len(x), 0, 0
    for i in visit.tolist():
        delta = order[bounds[i]:prev]
        prev = bounds[i]
        k = rows["idx"][delta]
        cnt += np.bincount(k, minlength=N_KEYS)
        if tag == "h5_hll":
            np.maximum.at(regs, k * HLL_M + reg[delta], rho[delta])
        else:
            np.add.at(hist, (k, b[delta]), 1)
            edge[k[near[delta]]] = True
        live = np.nonzero(cnt[slot_keys] > 0)[0]
        if not len(live):
            continue
        keys = slot_keys[live]  # the emitted order (twin_check_family's)
        cb = emitted[i]
        if tag == "h5_hll":
            est = twin_hll_estimate(regs.reshape(N_KEYS, HLL_M)[keys])
            d = np.abs(np.asarray(cb.columns["u"], dtype=np.float64) - est)
            check((d <= 1).all(), f"{what} rule {i}: hll beyond ±1 "
                  f"(max {d.max()})")
        else:
            qb = twin_quantile_bin(hist, 0.9)[0][keys]
            vals, inv = np.unique(np.asarray(cb.columns["p90"],
                                             dtype=np.float32),
                                  return_inverse=True)
            d = np.abs(value_bin(vals)[inv] - qb)
            check(((d == 0) | ((d == 1) & edge[keys])).all(),
                  f"{what} rule {i}: percentile bin differs")
        off += int((d == 1).sum())
        n_rows += cb.n
    return n_rows, off


def run_h5(torch, seed, kernels, plan_rule_group, ColumnBatch):
    """H5: the two 63-rule sketch families, each one group node opened on
    the mock clock with its default boundary (the percentile family's
    tumbling boundaries on the emit worker, the hll family's hopping ones
    synchronously); every rule's every window against its twins."""
    res = {}
    names = np.array([f"dev_{i}" for i in range(N_KEYS)], dtype=np.object_)
    for fam, interval, span in (("hll", 5_000, 2), ("pct", 10_000, 1)):
        tag = f"h5_{fam}"
        rng = np.random.default_rng(seed + (84 if fam == "hll" else 85))
        idx = rng.integers(0, N_KEYS, (H5_WINDOWS, BATCHES, ROWS))
        cols = h5_columns(rng, idx.shape)
        batches = [[ColumnBatch(n=ROWS, columns={
            "deviceId": names[idx[w, b]],
            **{c: v[w, b] for c, v in cols.items()}}, emitter="demo")
            for b in range(BATCHES)] for w in range(H5_WINDOWS)]
        spans = [{"idx": idx[w].ravel(), **{
            c: v[w].ravel().astype(np.float32) for c, v in cols.items()}}
            for w in range(H5_WINDOWS)]
        node = group_node(plan_rule_group, rule_ids(f"{tag}_", H5_RULES),
                          h5_sqls(fam), SLOTS, ROWS)
        check(node._async_mr == (fam == "pct"), f"{tag}: boundary route")
        ends = [(w + 1) * interval for w in range(H5_WINDOWS)]
        probe = GroupProbe(node, ends)
        kernels.reset_launches()
        with FoldTimer(torch, kernels) as t_s, \
                FoldTimer(torch, kernels, "multirule_fold_wide") as t_w:
            wall = drive_on_clock(torch, node, batches, interval)
        launches = dict(kernels.LAUNCHES)
        check(not node.recoveries, f"{tag}: recovery routes taken")
        n_win = H5_WINDOWS
        # the row order built once a batch and read by both folds
        check(launches["multirule_fold_wide"] == n_win * BATCHES
              and launches["multirule_fold_order"] == n_win * BATCHES
              and launches["multirule_finalize_wide"] == n_win
              and launches["multirule_reset_pane"] == n_win,
              f"{tag}: launches {launches}")
        base, step = H5_FAMILIES[fam][1:]
        thresholds = [base + step * r for r in range(H5_RULES)]
        slot_keys = np.array([int(k[4:]) for k in node.kt.decode_all()])
        t_c = time.perf_counter()
        rows_checked, worst, off = 0, 0.0, 0
        for w in range(n_win):
            part = spans[max(0, w - span + 1):w + 1]
            rows = {k: np.concatenate([p[k] for p in part]) for k in part[0]}
            emitted = [next((cb for cb in probe.got[rid]
                             if int(cb.timestamps[0]) == ends[w]), None)
                       for rid in node.gb.rule_ids]
            n, d = twin_check_family(tag, thresholds, emitted, rows, names,
                                     slot_keys, f"{tag} window {w}")
            _, o = check_group_sketch(tag, thresholds, emitted, rows,
                                      slot_keys, f"{tag} window {w}")
            rows_checked += n
            worst = max(worst, d)
            off += o
        for rid, got in probe.got.items():
            check(len(got) == n_win, f"{tag} {rid}: {len(got)} windows")
        fold = [a + b for a, b in zip(t_s.ms(), t_w.ms())]
        out = group_result(tag, probe, node, wall, n_win * BATCHES * ROWS,
                           fold, launches, n_win, (rows_checked, worst))
        out.update(wide_fold_p50=pct(t_w.ms(), 50), off_by_one=off,
                   check_s=time.perf_counter() - t_c)
        res[tag] = out
        del node, probe, batches
        torch.cuda.empty_cache()
    return res


def run_h6(torch, kernels, plan_rule_group, h3):
    """H6: H3's rule as a 63-rule session group (a WHERE literal per rule)
    on H3's stream: the group's sessions end where H3's do, and every
    rule's every session equals the float64 twin of its rows past its
    WHERE."""
    names = np.array([f"dev_{i}" for i in range(N_KEYS)], dtype=np.object_)
    sqls = [H6_SQL.format(x=H6_BASE + H6_STEP * r) for r in range(H6_RULES)]
    node = group_node(plan_rule_group, rule_ids("h6_", H6_RULES), sqls,
                      SLOTS, ROWS)
    got = {rid: [] for rid in node.gb.rule_ids}
    from ekuiper_tpu_torch.runtime.node import Node

    class Sink(Node):
        def process(self, item):
            got[self.name].append(item)

    for rid in node.gb.rule_ids:
        node.add_rule_output(rid, Sink(rid))
    kernels.reset_launches()
    wall = drive_times(torch, node, h3["batches"], H3_TIMES, H3_END_MS)
    launches = dict(kernels.LAUNCHES)
    slot_keys = np.array([int(k[4:]) for k in node.kt.decode_all()])
    thresholds = [H6_BASE + H6_STEP * r for r in range(H6_RULES)]
    rows_checked, worst = 0, 0.0
    for w, sess in enumerate(h3["sessions"]):
        b = np.asarray(sess["batches"])
        rows = {"idx": h3["idx"][b].ravel(), "v": h3["v"][b].ravel()}
        emitted = [next((cb for cb in got[rid]
                         if int(cb.timestamps[0]) == sess["end"]), None)
                   for rid in node.gb.rule_ids]
        n, d = twin_check_family("h6", thresholds, emitted, rows, names,
                                 slot_keys, f"h6 session {w}")
        rows_checked += n
        worst = max(worst, d)
    for rid, windows in got.items():
        ends = [int(cb.timestamps[0]) for cb in windows]
        check(set(ends) <= set(h3["ends"]) and len(set(ends)) == len(ends),
              f"h6 {rid}: sessions ending at {ends}")
    n_rows = len(H3_TIMES) * ROWS
    return dict(rules=H6_RULES, rows_per_s=n_rows / wall,
                rule_rows_per_s=n_rows * H6_RULES / wall,
                windows=len(h3["sessions"]), rows_checked=rows_checked,
                max_abs_err=worst, launches=launches,
                source=(node.last_emit_info or {}).get("source"))


def run_phase_h(torch, seed, kernels, mods, plan_rule_group):
    out = {}
    for tag, run in (("h1", run_h1), ("h2", run_h2), ("h3", run_h3),
                     ("h4", run_h4)):
        t = time.perf_counter()
        out[tag] = run(torch, seed, kernels, mods)
        out[tag]["run_s"] = time.perf_counter() - t
        torch.cuda.empty_cache()
    t = time.perf_counter()
    out["h6"] = run_h6(torch, kernels, plan_rule_group, out["h3"])
    out["h6"]["run_s"] = time.perf_counter() - t
    for k in ("sessions", "batches", "idx", "v"):
        del out["h3"][k]
    t = time.perf_counter()
    out.update(run_h5(torch, seed, kernels, plan_rule_group, mods[1]))
    out["h5_run_s"] = time.perf_counter() - t
    return out


def phase_h_lines(h):
    f = lambda x, d=3: "n/a" if x is None else f"{x:.{d}f}"  # noqa: E731
    mr = lambda launches: {k: v for k, v in launches.items()  # noqa: E731
                           if v}
    a = h["h1"]
    yield (f"phase H H1 (config #4, hll over COUNTWINDOW({H1_BATCHES * ROWS})"
           f", {H1_SLOTS} slots): {a['windows']} windows, distinct keys "
           f"{a['keys']}, rows/s={a['rows_per_s']:.0f} host encode ms a "
           f"batch={a['encode_ms']:.3f} delivery_p50_ms="
           f"{a['delivery_p50']:.3f} delivery_p99_ms={a['delivery_p99']:.3f}"
           f" source={a['source']} every estimate within ±1 of the register "
           f"twin (max {a['max_abs_err']}) check_s={a['check_s']:.1f} "
           f"run_s={a['run_s']:.1f} launches={mr(a['launches'])}")
    a = h["h2"]
    yield (f"phase H H2 (COUNTWINDOW({H2_COUNT}), {H2_ROWS}-row batches): "
           f"{a['windows']} windows (the last the EOF flush), "
           f"{a['edges_inside']} edges inside a batch, counts and max exact, "
           f"rows/s={a['rows_per_s']:.0f} source={a['source']} "
           f"run_s={a['run_s']:.1f} launches={mr(a['launches'])}")
    a = h["h3"]
    yield (f"phase H H3 (SESSIONWINDOW(ss, 10, 2), {len(H3_TIMES)} batches):"
           f" {a['windows']} sessions ({a['by_gap']} by the gap, "
           f"{a['by_cap']} by the cap) ending at {a['ends']}, each equal to "
           f"the float64 twin (avg max_abs_err {a['max_abs_err']:.3g}), "
           f"rows/s={a['rows_per_s']:.0f} run_s={a['run_s']:.1f} "
           f"launches={mr(a['launches'])}")
    a = h["h4"]
    yield (f"phase H H4 (STATEWINDOW(st = 1, st = 0), {H4_BATCHES} batches):"
           f" {a['windows']} windows ({a['within']} inside one batch, "
           f"{a['spanning']} across batches), each equal to the float64 twin"
           f" (avg max_abs_err {a['max_abs_err']:.3g}), rows/s="
           f"{a['rows_per_s']:.0f} run_s={a['run_s']:.1f} "
           f"launches={mr(a['launches'])}")
    for tag in ("h5_hll", "h5_pct"):
        r = h[tag]
        yield (group_line(tag, r).replace("phase E", "phase H")
               + f" wide_fold_kernel_ms_per_batch p50={r['wide_fold_p50']:.4f}"
               f" one_off={r['off_by_one']} check_s={r['check_s']:.1f}")
    a = h["h6"]
    yield (f"phase H H6 (H3's rule as a {a['rules']}-rule session group): "
           f"{a['windows']} sessions, rows/s={a['rows_per_s']:.0f} "
           f"rule_rows/s={a['rule_rows_per_s']:.0f} rows_checked="
           f"{a['rows_checked']} max_abs_err={a['max_abs_err']:.3g} "
           f"source={a['source']} run_s={a['run_s']:.1f} "
           f"launches={mr(a['launches'])} (H5 run_s {f(h['h5_run_s'], 1)})")


# ------------------------------------------- phase 2, the group's pane vector
def pane_split(rng, n, P, lo):
    """A batch across one bucket edge, ordered by time as the watermark
    node orders it: its first rows in pane lo, the rest in lo + 1 (the
    edge at a random row in the middle half)."""
    cut = int(rng.integers(n // 4, 3 * n // 4))
    pv = np.full(n, lo, dtype=np.uint8)
    pv[cut:] = (lo + 1) % P
    return pv


def event_group_kernel_checks(torch, seed, kernels, sketches, dev):
    """#15's per-row pane vector against the plain versions at I5's shapes
    (E1's 256 rules, 65,536 rows, 16,384 slots, the event-time tumbling
    window's I5_PANES panes) and I6's (the 63-rule hll family on its
    I6_PANES panes, 5.3 GB of registers), a batch across a bucket edge:
    bit-equal on n, act, mn, mx and the registers, s1 / s2 within rtol
    1e-5, and a constant vector equal to the scalar pane. Timed as the
    node calls them (the vector's largest pane from the host, no read
    back; the row order built once a chunk), and once without the host
    bound (the wrapper reads the vector's max back: readback_ms), beside
    the same folds into one scalar pane; the kernel bodies, the plain
    version, the library scatters over the (rule, row pane, slot) flat
    index; and the row order with the pane vector."""
    from ekuiper_tpu_torch.parallel.multirule import (BatchedGroupBy,
                                                      build_rule_batch)
    from ekuiper_tpu_torch.sql.parser import parse_select

    rows = {}
    r = np.random.default_rng(seed + 95)
    s_dev = torch.from_numpy(
        r.integers(0, N_KEYS, ROWS).astype(np.int32)).to(dev)
    pv_np = pane_split(r, ROWS, I5_PANES, 1)
    pv = torch.from_numpy(pv_np).to(dev)

    # the scalar fold: I5's group
    spec = build_rule_batch(rule_ids("i5_", E1_RULES),
                            [parse_select(q) for q in e1_sqls()])
    gb = BatchedGroupBy(spec, capacity=SLOTS, n_panes=I5_PANES,
                        micro_batch=ROWS, device=dev)
    temp = r.normal(20, 5, ROWS).astype(np.float32)
    base, V, M = gb.rule_inputs(
        {"temperature": torch.from_numpy(temp).to(dev)}, ROWS)
    colmap = gb._colmap
    st = gb.init_state()
    state_bytes = sum(a.numel() * 4 for a in st.values())
    ref, got = clone_state(st), st
    kernels.multirule_fold_plain(ref, base, V, M, s_dev, 0, colmap, pv)
    kernels.multirule_fold(got, base, V, M, s_dev, 0, colmap, pv)
    torch.cuda.synchronize()
    state_err(got, ref)
    check(bool(got["act"][:, 1].any()) and bool(got["act"][:, 2].any())
          and not bool(got["act"][:, 0].any()),
          "multirule_fold pane vector: rows not in their panes")
    a, b = gb.init_state(), gb.init_state()
    kernels.multirule_fold(a, base, V, M, s_dev, 0, colmap,
                           torch.full_like(pv, 2))
    kernels.multirule_fold(b, base, V, M, s_dev, 2, colmap)
    torch.cuda.synchronize()
    state_err(a, b)
    del a, b, ref
    edge = int((pv_np == 1).sum())
    row = group_fold_row(torch, kernels, st, base, V, M, s_dev, 0, colmap,
                         f"pane_vec panes 1|2 at row {edge}", pv)
    row["scalar_pane_ms"] = t_s = time_ms(torch, functools.partial(
        kernels.multirule_fold, got, base, V, M, s_dev, 1, colmap), REPS)
    print(f"kernel multirule_fold pane_vec: scalar_pane_kernel_ms={t_s:.4f} "
          f"state_MB={state_bytes / 1e6:.1f}")
    rows["multirule_fold/pane_vec"] = row
    rows["multirule_fold_order/pane_vec"] = fold_order_row(
        torch, kernels, s_dev, 0, I5_PANES, SLOTS, "pane_vec", base, pv)
    del gb, st, got, base, V, M
    torch.cuda.empty_cache()

    # the wide fold: I6's hll family
    pv_np = pane_split(r, ROWS, I6_PANES, 2)
    pv = torch.from_numpy(pv_np).to(dev)
    spec = build_rule_batch(rule_ids("i6_", H5_RULES),
                            [parse_select(q) for q in h5_sqls("hll")])
    gb = BatchedGroupBy(spec, capacity=SLOTS, n_panes=I6_PANES,
                        micro_batch=ROWS, device=dev)
    cols = h5_columns(r, ROWS)
    dcols = {c: torch.from_numpy(v.astype(np.float32)).to(dev)
             for c, v in cols.items()}
    dcols["__hll__humidity"] = dcols["humidity"]
    base, V, M = gb.rule_inputs(dcols, ROWS)
    st = gb.init_state()
    state_bytes = sum(a.numel() * 4 for a in st.values())
    ref, got = clone_state(st), st
    kernels.multirule_fold_wide_plain(ref, base, V, M, s_dev, 0, gb._widemap,
                                      pv)
    kernels.multirule_fold_wide(got, base, V, M, s_dev, 0, gb._widemap, pv)
    torch.cuda.synchronize()
    check(bool(torch.equal(got["hll"], ref["hll"])),
          "multirule_fold_wide pane vector: differs from its plain version")
    check(bool(got["hll"][:, 2].any()) and bool(got["hll"][:, 3].any())
          and not bool(got["hll"][:, 1].any()),
          "multirule_fold_wide pane vector: rows not in their panes")
    del ref
    a = gb.init_state()
    kernels.multirule_fold_wide(a, base, V, M, s_dev, 0, gb._widemap,
                                torch.full_like(pv, 4))
    kernels.multirule_fold_wide(got, base, V, M, s_dev, 4, gb._widemap)
    torch.cuda.synchronize()
    check(bool(torch.equal(a["hll"][:, 4], got["hll"][:, 4])),
          "multirule_fold_wide: a constant vector differs from its pane")
    del a
    ref = clone_state(got)
    row = group_wide_row(torch, kernels, sketches, gb, got, ref, base, V, M,
                         s_dev, 0, "pane_vec hll panes 2|3", "hll",
                         state_bytes, pv)
    del ref
    o2 = kernels.multirule_fold_order(s_dev, 2, I6_PANES, SLOTS, None, base)
    row["scalar_pane_ms"] = t_s = time_ms(torch, functools.partial(
        kernels.multirule_fold_wide, got, base, V, M, s_dev, 2, gb._widemap,
        None, None, o2), REPS)
    print(f"kernel multirule_fold_wide pane_vec: scalar_pane_kernel_ms="
          f"{t_s:.4f}")
    rows["multirule_fold_wide/pane_vec"] = row
    del gb, st, got
    torch.cuda.empty_cache()
    return rows


# -------------------------------------------------------------- phase I
class EventStream:
    """One phase I stream, made in bulk from the seed: per 65,536-row batch
    the key indices, temperature ~ N(20, 5) (float32) and, for the hll
    family, humidity ~ N(50, 15) rounded to 2 decimals; batch i stamped
    I_T0 + i · I_STEP_MS, each row plus U(I_JITTER) ms and I_LATE_P of
    them I_LATE_MS earlier still (I1: no jitter, no late rows, batch i at
    i · 1000 ms); with `gap_every`, an I4_GAP_MS gap between the last row
    before and the first row after every gap_every-th batch. Then the
    watermark node's twin: the rows each batch keeps (ts >= the newest
    timestamp before it - lateTolerance) and the watermark after it."""

    def __init__(self, seed, n, jitter=True, gap_every=0, humidity=False):
        rng = np.random.default_rng(seed)
        self.n = n
        self.idx = rng.integers(0, N_KEYS, (n, ROWS))
        self.temp = rng.normal(20, 5, (n, ROWS)).astype(np.float32)
        self.hum = (rng.normal(50, 15, (n, ROWS)).round(2) if humidity
                    else None)
        if jitter:
            ts = (I_T0 + np.arange(n)[:, None] * I_STEP_MS
                  + rng.integers(I_JITTER[0], I_JITTER[1], (n, ROWS)))
            ts -= np.where(rng.random((n, ROWS)) < I_LATE_P, I_LATE_MS, 0)
        else:
            ts = np.repeat(np.arange(n)[:, None] * I_STEP_MS, ROWS, axis=1)
        if gap_every:
            for b in range(gap_every, n, gap_every):
                shift = int(ts[:b].max()) + I4_GAP_MS - int(ts[b].min())
                ts[b:] += max(shift, 0)
        self.ts = ts.astype(np.int64)
        self.keep = np.zeros((n, ROWS), dtype=bool)
        self.wm = np.zeros(n, dtype=np.int64)
        max_ts = 0
        for b in range(n):
            keep = self.ts[b] >= max_ts - I_TOL
            self.keep[b] = keep
            if keep.any():
                max_ts = max(max_ts, int(self.ts[b][keep].max()))
            self.wm[b] = max_ts - I_TOL
        self.dropped = int((~self.keep).sum())

    def batches(self, ColumnBatch):
        names = np.array([f"dev_{i}" for i in range(N_KEYS)],
                         dtype=np.object_)
        out = []
        for b in range(self.n):
            cols = {"deviceId": names[self.idx[b]],
                    "temperature": self.temp[b]}
            if self.hum is not None:
                cols["humidity"] = self.hum[b]
            out.append(ColumnBatch(n=ROWS, columns=cols,
                                   timestamps=self.ts[b], emitter="demo"))
        return out

    def arrival(self, close_ms):
        """The batch whose watermark first reaches close_ms (n: the EOF)."""
        hit = np.nonzero(self.wm >= close_ms)[0]
        return int(hit[0]) if len(hit) else self.n

    def kept_rows(self):
        """Flat indices of the kept rows, their timestamps."""
        flat = np.nonzero(self.keep.ravel())[0]
        return flat, self.ts.ravel()[flat]

    def windows(self, length, bucket):
        """The twin's tumbling / hopping windows, in emission order: (end
        ms, flat row indices, arrival batch) of each window ending at a
        bucket edge from the first batch's first bucket (the emission
        cursor's start) that holds a kept row; and the kept rows the fold
        drops (a bucket before that start)."""
        flat, ts = self.kept_rows()
        bk = ts // bucket
        b0 = int((self.ts[0][self.keep[0]] // bucket).min())
        order = np.argsort(bk, kind="stable")
        bs = bk[order]
        W = length // bucket
        out = []
        for b in range(b0, int(bs[-1]) + W):
            lo = np.searchsorted(bs, max(b - W + 1, b0), "left")
            hi = np.searchsorted(bs, b, "right")
            if hi > lo:
                end = (b + 1) * bucket
                out.append((end, flat[order[lo:hi]], self.arrival(end)))
        return out, int((bk < b0).sum())

    def sessions(self, gap):
        """The twin's sessions: the kept rows sorted by time, split where
        neighbours are more than `gap` apart; (rows, close ms, arrival
        batch) each, and those a watermark does not close emitted at the
        EOF as one window."""
        flat, ts = self.kept_rows()
        order = np.argsort(ts, kind="stable")
        tss = ts[order]
        cuts = [0, *(np.nonzero(np.diff(tss) > gap)[0] + 1).tolist(),
                len(tss)]
        out = []
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            close = int(tss[hi - 1]) + gap
            out.append((flat[order[lo:hi]], close, self.arrival(close)))
        closed = [s for s in out if s[2] < self.n]
        rest = [s for s in out if s[2] == self.n]
        if rest:
            closed.append((np.concatenate([s[0] for s in rest]), None,
                           self.n))
        return closed


class EventProbe:
    """What phase I reads off one event-time chain (a watermark node ahead
    of a fused or group node): each window with the batch it came in
    (len(batches): the EOF), the watermark node's own host time (its
    process less the downstream's), and each watermark-driven window's
    emit time (finalize, host tail, delivery, ending in a synchronize)."""

    def __init__(self, torch, node, group=False):
        from ekuiper_tpu_torch.runtime.node import Node

        self.torch, self.node = torch, node
        self.batch = 0
        self.down_s = 0.0
        self.emit_ms = []
        probe = self
        if group:
            self.got = {rid: [] for rid in node.gb.rule_ids}

            class Sink(Node):
                def process(self, item):
                    probe.got[self.name].append((item, probe.batch))

            for rid in node.gb.rule_ids:
                node.add_rule_output(rid, Sink(rid))
        else:
            self.got = []
            node.broadcast = lambda item: self.got.append((item, self.batch))
        for name in ("process", "on_watermark"):
            setattr(node, name, self._timed_down(getattr(node, name)))
        emit = ("_emit" if node.wt.name == "SESSION_WINDOW"
                else "_emit_panes")
        setattr(node, emit, self._timed_emit(getattr(node, emit)))

    def _timed_down(self, fn):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.down_s += time.perf_counter() - t
        return run

    def _timed_emit(self, fn):
        def run(*a, **k):
            t = time.perf_counter()
            fn(*a, **k)
            self.torch.cuda.synchronize()
            self.emit_ms.append((time.perf_counter() - t) * 1e3)
        return run

    def windows(self, items):
        return [(it, b) for it, b in items if hasattr(it, "columns")]

    def drive(self, kernels, batches, clock_at=None):
        """Feed every batch to the watermark entry, then EOF; returns the
        run's numbers (rows/s over the wall, host ms a batch, launches)."""
        from ekuiper_tpu_torch.runtime.events import EOF

        wm = self.node.watermark
        kernels.reset_launches()
        self.torch.cuda.synchronize()
        t_wm = 0.0
        t0 = time.perf_counter()
        for b, batch in enumerate(batches):
            self.batch = b
            if clock_at is not None:
                clock_at(b)
            t = time.perf_counter()
            wm.process(batch)
            t_wm += time.perf_counter() - t
        self.batch = len(batches)
        wm.put_control(EOF())
        self.node._drain_async_emits()
        self.torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = self.node.event_counts
        return dict(wall=wall, rows_per_s=len(batches) * ROWS / wall,
                    wm_host_ms=(t_wm - self.down_s) / len(batches) * 1e3,
                    emit_p50=pct(self.emit_ms, 50) if self.emit_ms else None,
                    emit_p99=pct(self.emit_ms, 99) if self.emit_ms else None,
                    wm_dropped=wm.dropped, fold_dropped=n["dropped"],
                    vector_folds=n["vector_folds"],
                    scalar_folds=n["scalar_folds"],
                    launches=dict(kernels.LAUNCHES),
                    row_pane=dict(kernels.ROW_PANE_LAUNCHES),
                    touch_launches=dict(kernels.TOUCH_LAUNCHES))


def check_event_arrivals(tag, got, want):
    """The emitted windows' ends and the batch each came in (the first
    whose watermark passed it, or the EOF) against the twin's."""
    have = [b for _, b in got]
    check(have == [w[2] for w in want],
          f"{tag}: windows came in batches {have}, want "
          f"{[w[2] for w in want]}")


def event_rule(mods, sql, opts=None, key_slots=None):
    plan_fused_rule = mods[0]
    node = plan_fused_rule(sql, key_slots=key_slots or SLOTS,
                           micro_batch=ROWS,
                           options={**I_OPTS, **(opts or {})})
    check(node.gb.device.type == "cuda" and node.watermark is not None,
          "event-time rule is not on the card behind its watermark node")
    return node


def run_i_flagship(torch, tag, stream, sql, length, bucket, kernels, mods):
    """I1-I3: the flagship rule's windows against the float64 twin over
    exactly their rows, each arriving with the batch whose watermark
    passed its end."""
    node = event_rule(mods, sql)
    probe = EventProbe(torch, node)
    out = probe.drive(kernels, stream.batches(mods[1]))
    want, fold_drop = stream.windows(length, bucket)
    got = probe.windows(probe.got)
    check(len(got) == len(want), f"{tag}: {len(got)} windows, want "
          f"{len(want)}")
    check_event_arrivals(tag, got, want)
    idx, temp = stream.idx.ravel(), stream.temp.ravel()
    worst = 0.0
    for (cb, _), (end, rows, _) in zip(got, want):
        check(int(cb.timestamps[0]) == end, f"{tag}: window end "
              f"{int(cb.timestamps[0])}, want {end}")
        worst = max(worst, check_window(
            cb, reference_aggs(idx[rows], temp[rows], N_KEYS), False,
            f"{tag} window {end}"))
    check(out["wm_dropped"] == stream.dropped and
          out["fold_dropped"] == fold_drop,
          f"{tag}: dropped {out['wm_dropped']} / {out['fold_dropped']}, the "
          f"twin {stream.dropped} / {fold_drop}")
    out.update(windows=len(got), max_abs_err=worst,
               by_eof=sum(w[2] == stream.n for w in want),
               n_panes=node.n_panes)
    node.on_close()
    return out


def run_i4(torch, stream, kernels, mods):
    """I4: event-time sessions; each against the float64 twin over exactly
    its rows, closed by the first watermark past its last row + gap, and
    the rest at the EOF as one window."""
    node = event_rule(mods, I4_RULE)
    probe = EventProbe(torch, node)
    out = probe.drive(kernels, stream.batches(mods[1]))
    want = stream.sessions(I4_SESSION_GAP_MS)
    got = probe.windows(probe.got)
    check_event_arrivals("I4", got, want)
    for (cb, _), (_, close, _) in zip(got, want):
        check(close is None or int(cb.timestamps[0]) == close,
              f"I4: session ends at {int(cb.timestamps[0])}, want {close}")
    worst = check_avg_windows("I4", [cb for cb, _ in got],
                              [w[0] for w in want], stream.idx.ravel(),
                              stream.temp.ravel())
    check(sum(w[1] is not None for w in want) >= 2 and want[-1][1] is None,
          "I4: want sessions closed by watermarks and one at the EOF")
    check(out["wm_dropped"] == stream.dropped, "I4: watermark drops")
    out.update(windows=len(got), max_abs_err=worst,
               by_watermark=sum(w[1] is not None for w in want),
               sessions=node.event_counts["sessions"])
    node.on_close()
    return out


def event_group(ids, sqls):
    """An event-time rule group at the node (plan_rule_group refuses
    isEventTime): MultiRuleFusedNode(is_event_time=True) behind its
    WatermarkNode."""
    from ekuiper_tpu_torch.ops.emit import build_direct_emit
    from ekuiper_tpu_torch.parallel.multirule import build_rule_batch
    from ekuiper_tpu_torch.runtime.nodes_multirule import MultiRuleFusedNode
    from ekuiper_tpu_torch.runtime.nodes_window import WatermarkNode
    from ekuiper_tpu_torch.sql.parser import parse_select

    spec = build_rule_batch(ids, [parse_select(q) for q in sqls])
    dims = [d.expr for d in spec.stmt.dimensions]
    node = MultiRuleFusedNode(
        "group_agg", spec.stmt.window, spec, dims, capacity=SLOTS,
        micro_batch=ROWS,
        direct_emit=build_direct_emit(spec.stmt, spec.plan,
                                      [d.name for d in dims]),
        emit_columnar=True, is_event_time=True, late_tolerance_ms=I_TOL)
    node.watermark = WatermarkNode("watermark", late_tolerance_ms=I_TOL)
    node.watermark.connect(node)
    check(node.gb.device.type == "cuda" and not node._async_mr,
          "event-time group is not on the card, synchronous")
    return node


def run_i_group(torch, tag, stream, sqls, thresholds, length, bucket,
                kernels, mods):
    """I5 / I6: an event-time group; every rule's every window against the
    twin over the window's rows past that rule's WHERE (I6: and its hll
    registers), each arriving with the batch whose watermark passed it."""
    node = event_group(rule_ids(f"{tag}_", len(sqls)), sqls)
    probe = EventProbe(torch, node, group=True)
    out = probe.drive(kernels, stream.batches(mods[1]))
    want, fold_drop = stream.windows(length, bucket)
    names = np.array([f"dev_{i}" for i in range(N_KEYS)], dtype=np.object_)
    slot_keys = np.array([int(k[4:]) for k in node.kt.decode_all()])
    by_rule = {}
    for rid, items in probe.got.items():
        got = probe.windows(items)
        ends = {int(cb.timestamps[0]): (cb, b) for cb, b in got}
        check(len(ends) == len(got), f"{tag} {rid}: a window twice")
        by_rule[rid] = ends
    cols = {"idx": stream.idx.ravel(), "temperature": stream.temp.ravel()}
    if stream.hum is not None:
        cols["humidity"] = stream.hum.ravel().astype(np.float32)
    twin_tag = "e1" if tag == "i5" else "h5_hll"
    rows_checked, worst, off = 0, 0.0, 0
    for end, rows, arrival in want:
        emitted = []
        for rid in node.gb.rule_ids:
            cb, b = by_rule[rid].pop(end, (None, arrival))
            check(b == arrival, f"{tag} {rid}: window {end} came in batch "
                  f"{b}, want {arrival}")
            emitted.append(cb)
        part = {k: v[rows] for k, v in cols.items()}
        n, d = twin_check_family(twin_tag, thresholds, emitted, part, names,
                                 slot_keys, f"{tag} window {end}")
        if tag == "i6":
            _, o = check_group_sketch(twin_tag, thresholds, emitted, part,
                                      slot_keys, f"{tag} window {end}")
            off += o
        rows_checked += n
        worst = max(worst, d)
    check(not any(by_rule.values()), f"{tag}: windows the twin lacks")
    check(out["wm_dropped"] == stream.dropped and
          out["fold_dropped"] == fold_drop, f"{tag}: dropped rows")
    out.update(rules=len(sqls), windows=len(want),
               rule_rows_per_s=out["rows_per_s"] * len(sqls),
               rows_checked=rows_checked, max_abs_err=worst, off_by_one=off,
               n_panes=node.n_panes)
    node.on_close()
    return out


def run_i7(torch, seed, kernels, mods):
    """I7: G2's tiered rule on event time, stamped by slide (4 batches a
    1 s slide, rows of a batch at one time, the engine clock moved with
    it): every window, the device groups and the spilled keys' share
    together, against the float64 twin over the window's ten slides."""
    from ekuiper_tpu_torch.utils import timex

    stream = G2Stream(seed)
    node = event_rule(mods, G2_RULE, {"tierHotMb": G_HOT_MB}, G_SLOTS)
    check(node.tier is not None, "I7: the rule is not tiered")
    probe = EventProbe(torch, node)
    n = I_BATCHES["i7"]
    stamp = [I_T0 + b // G_PER_WINDOW * 1000 + G2B_OFFSETS[b % G_PER_WINDOW]
             for b in range(n)]
    batches = []
    for b in range(n):
        cb = stream.batch(mods[1], b)
        cb.timestamps = np.full(ROWS, stamp[b], dtype=np.int64)
        batches.append(cb)
    clock = timex.set_mock_clock(0)
    out = probe.drive(kernels, batches,
                      clock_at=lambda b: clock.set(stamp[b]))
    timex.use_real_clock()
    by_end = {}
    for cb, _ in probe.windows(probe.got):
        if cb.n:
            by_end.setdefault(int(cb.timestamps[0]), []).append(cb)
    twin = GTwin(stream.n_keys)
    slides = n // G_PER_WINDOW
    per_slide = [twin.agg(np.concatenate(stream.ids[s * G_PER_WINDOW:
                                                    (s + 1) * G_PER_WINDOW]),
                          np.concatenate([stream.v[b].astype(np.float32)
                                          for b in range(s * G_PER_WINDOW,
                                                         (s + 1)
                                                         * G_PER_WINDOW)]))
                 for s in range(slides)]
    worst = 0.0
    ends = sorted(by_end)
    want = [I_T0 + (s + 1) * 1000 for s in range(slides + 9)]
    check(ends == want, f"I7: windows end at {ends[:3]}..{ends[-3:]}, want "
          f"{want[:3]}..{want[-3:]}")
    for k, end in enumerate(want):
        ref = GTwin.merge(per_slide[max(0, k - 9):k + 1])
        err, _ = check_g_window(*window_columns(by_end[end], stream.to_ids),
                                ref, f"I7 window {end}")
        worst = max(worst, err)
    t = node.tier
    check(t.demoted_total > 0 and t.promoted_total > 0,
          f"I7: demoted {t.demoted_total}, promoted {t.promoted_total}")
    out.update(windows=len(want), max_abs_err=worst, n_panes=node.n_panes,
               **tier_counters(node))
    node.on_close()
    return out


def run_phase_i(torch, seed, kernels, mods):
    """Phase I: event time, I1-I7."""
    out, walls = {}, {}
    t0 = time.perf_counter()
    s1 = EventStream(seed + 100, I_BATCHES["i1"], jitter=False)
    out["i1"] = run_i_flagship(torch, "I1", s1, TUMBLING, 10_000, 10_000,
                               kernels, mods)
    walls["i1"] = time.perf_counter() - t0
    s2 = EventStream(seed + 101, I_BATCHES["i2"])
    out["i2"] = run_i_flagship(torch, "I2", s2, TUMBLING, 10_000, 10_000,
                               kernels, mods)
    walls["i2"] = time.perf_counter() - t0 - sum(walls.values())
    out["i3"] = run_i_flagship(torch, "I3", s2, I3_RULE, 10_000, 2_000,
                               kernels, mods)
    walls["i3"] = time.perf_counter() - t0 - sum(walls.values())
    s4 = EventStream(seed + 104, I_BATCHES["i4"], gap_every=I4_GAP_EVERY)
    out["i4"] = run_i4(torch, s4, kernels, mods)
    walls["i4"] = time.perf_counter() - t0 - sum(walls.values())
    del s1, s4
    out["i5"] = run_i_group(
        torch, "i5", s2, e1_sqls(), [E1_BASE + E1_STEP * r
                                     for r in range(E1_RULES)],
        10_000, 10_000, kernels, mods)
    walls["i5"] = time.perf_counter() - t0 - sum(walls.values())
    torch.cuda.empty_cache()
    s6 = EventStream(seed + 106, I_BATCHES["i6"], humidity=True)
    base, step = H5_FAMILIES["hll"][1:]
    out["i6"] = run_i_group(
        torch, "i6", s6, h5_sqls("hll"), [base + step * r
                                          for r in range(H5_RULES)],
        10_000, 5_000, kernels, mods)
    walls["i6"] = time.perf_counter() - t0 - sum(walls.values())
    del s6
    torch.cuda.empty_cache()
    out["i7"] = run_i7(torch, seed, kernels, mods)
    walls["i7"] = time.perf_counter() - t0 - sum(walls.values())
    torch.cuda.empty_cache()
    for tag in ("i2", "i3", "i5", "i6"):
        check(out[tag]["vector_folds"] > 0, f"{tag}: no pane-vector fold")
    check(out["i1"]["vector_folds"] == 0, "I1: a pane-vector fold")
    check(out["i2"]["wm_dropped"] > 0, "I2: no row dropped as late")
    check(out["i4"]["by_watermark"] >= 2, "I4: sessions by watermark")
    check((out["i5"]["n_panes"], out["i6"]["n_panes"])
          == (I5_PANES, I6_PANES), "I5 / I6: pane counts of phase 2's rows")
    out["walls"] = walls
    return out


def phase_i_lines(i):
    f = lambda x, d=3: "n/a" if x is None else f"{x:.{d}f}"  # noqa: E731
    nz = lambda d: {k: v for k, v in d.items() if v}  # noqa: E731
    what = {"i1": "I1 bench_event_time (flagship, batch i at i s)",
            "i2": "I2 flagship, disordered + late rows",
            "i3": "I3 flagship on HOPPINGWINDOW(ss, 10, 2)",
            "i4": "I4 SESSIONWINDOW(ss, 30, 5), 8 s gaps",
            "i5": f"I5 E1's {E1_RULES} rules as an event-time group",
            "i6": f"I6 H5's {H5_RULES}-rule hll family on event time",
            "i7": "I7 G2's tiered rule on event time, by slide"}
    for tag in ("i1", "i2", "i3", "i4", "i5", "i6", "i7"):
        r = i[tag]
        line = (f"phase I {what[tag]}: batches={I_BATCHES[tag]} "
                f"rows/s={r['rows_per_s']:.0f} ")
        if "rules" in r:
            line += f"rule_rows/s={r['rule_rows_per_s']:.0f} "
        line += (f"watermark_node_host_ms_per_batch={r['wm_host_ms']:.3f} "
                 f"emit_p50_ms={f(r['emit_p50'])} "
                 f"emit_p99_ms={f(r['emit_p99'])} "
                 f"dropped_by_watermark={r['wm_dropped']} "
                 f"dropped_by_fold={r['fold_dropped']} "
                 f"vector_folds={r['vector_folds']} "
                 f"scalar_folds={r['scalar_folds']} windows={r['windows']} "
                 f"max_abs_err={r['max_abs_err']:.3g} ")
        if tag in ("i1", "i2", "i3"):
            line += f"flushed_at_eof={r['by_eof']} "
        if tag == "i4":
            line += (f"sessions_by_watermark={r['by_watermark']} "
                     "(the rest one EOF window) ")
        if tag in ("i5", "i6"):
            line += f"rows_checked={r['rows_checked']} "
        if tag == "i6":
            line += f"hll_one_off={r['off_by_one']} "
        if tag == "i7":
            line += (f"demoted={r['demoted']} promoted={r['promoted']} "
                     f"recycled={r['recycled']} resident={r['resident']} "
                     f"slots={r['slots']} ")
        line += (f"panes={r.get('n_panes', 1)} run_s={i['walls'][tag]:.1f} "
                 f"launches={nz(r['launches'])} "
                 f"pane_vec_launches={nz(r['row_pane'])}")
        yield line


# ------------------------------------------ phase 2, the relational tier
def join_bytes(n, residual_cols=1):
    """#20's bytes at n rows a side: each side's slot, time (int32),
    validity (bool) and float32 residual columns read once, the (n, n)
    mask written once, packed one bit a pair (the function's output since
    the mask is packed; a byte a pair before)."""
    return 2 * n * (9 + 4 * residual_cols) + n * n // 8


def join_inputs(torch, rng, n, dev):
    """One padded join side at J1's shape (512 keys, times uniform on [0,
    60,000) ms, so rebased int32 without a NULL), its residual column
    uniform on [0, 100) as float32, all rows valid."""
    return ([torch.from_numpy(a).to(dev) for a in (
        rng.integers(0, J_KEYS, n).astype(np.int32),
        rng.integers(0, J_TS, n).astype(np.int32), np.ones(n, dtype=bool))],
        torch.from_numpy(rng.uniform(0, 100, n).astype(np.float32)).to(dev))


def relational_kernel_checks(torch, seed, kernels, dev):
    """#20 at 2,048 and 16,384 rows a side (J1's and J3's windows, the ON
    residual l.v > r.w as the expression IR gives it, a (PL, PR) bool),
    #21 at 8,192 and 131,072 rows over 10,000 slots, at 131,072 rows over
    10,000 Zipf-skewed slots and at 131,072 rows in one slot (one segment
    over many blocks), #22 at 65,536 rows and 10,000 segments and in one
    segment: each against its plain version (#20 bit-equal; #21 row
    numbers, lag, flags and the carry's counts and last values exact,
    running sums rtol 1e-5 and their NaN / ±inf exactly; #22 all six
    outputs exact)."""
    rows = {}
    rng = np.random.default_rng(seed + 2000)
    for n in (J1_ROWS, J3_ROWS):
        (left, v), (right, w) = (join_inputs(torch, rng, n, dev),
                                 join_inputs(torch, rng, n, dev))
        resid = v[:, None] > w[None, :]
        lo, hi = -J_BAND, J_BAND
        got = kernels.join_match(*left, *right, lo, hi, resid)
        want = kernels.join_match_plain(*left, *right, lo, hi, resid)
        torch.cuda.synchronize()
        check(bool(torch.equal(got, want)), f"join_match {n}: differs")
        bare = kernels.join_match(*left, *right, lo, hi)
        check(bool(torch.equal(bare, kernels.join_match_plain(
            *left, *right, lo, hi))), f"join_match {n}, no residual: differs")
        pairs = int(np.unpackbits(got.cpu().numpy()).sum())
        del got, want, bare
        call = functools.partial(kernels.join_match, *left, *right, lo, hi,
                                 resid)
        t_k = time_ms(torch, call, REPS)
        split = launch_split(torch, call, "join_match_kernel", REPS)
        # the kernel without a residual: what a join with no (PL, PR)
        # residual to read runs
        t_bare = time_ms(torch, functools.partial(
            kernels.join_match, *left, *right, lo, hi), REPS)
        t_p = time_ms(torch, lambda: kernels.join_match_plain(
            *left, *right, lo, hi, resid), REPS)
        # the library yardstick: torch's broadcast compares and ANDs, the
        # byte mask (no PyTorch call packs bits)
        t_l = time_ms(torch, lambda: (
            (left[0][:, None] == right[0][None, :])
            & (left[1][:, None] - right[1][None, :] >= lo)
            & (left[1][:, None] - right[1][None, :] <= hi)
            & left[2][:, None] & right[2][None, :] & resid), REPS)
        # the residual's torch pass that writes the (PL, PR) bool the
        # kernel reads: part of #20's work, outside the kernel's time
        t_r = time_ms(torch, lambda: v[:, None] > w[None, :], REPS)
        b_ms, b_by = bound(join_bytes(n), 0)
        # the kernel's own bytes: the function's and the residual's read
        k_ms, _ = bound(join_bytes(n) + n * n, 0)
        print(f"kernel join_match PL=PR={n} pairs={pairs}: max_abs_err=0 "
              f"kernel_ms={t_k:.4f} no_residual_ms={t_bare:.4f} "
              f"residual_ms={t_r:.4f} {split_text(split)} "
              f"plain_ms={t_p:.4f} library_ms={t_l:.4f} "
              f"bound_ms={b_ms:.5f} ({b_by}; with the residual's read "
              f"{k_ms:.5f})")
        rows[f"join_match/{n}"] = dict(
            max_abs_err=0.0, ms=t_k, no_residual_ms=t_bare, residual_ms=t_r,
            **split, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
            bound_with_residual_ms=k_ms, library_ms=t_l, pairs=pairs)
        del resid
        torch.cuda.empty_cache()
    for tag, B, slots in (("8192", K_SHIFT_SMALL, N_KEYS),
                          ("131072", K_SHIFT_ROWS, N_KEYS),
                          ("zipf", K_SHIFT_ROWS, N_KEYS),
                          ("one_segment", K_SHIFT_ROWS, 1)):
        rows[f"segscan_shift/{tag}"] = shift_check(
            torch, rng, kernels, dev, tag, B, slots)
    for tag, slots in (("65536", N_KEYS), ("one_segment", 1)):
        rows[f"segscan_sort/{tag}"] = sort_check(
            torch, rng, kernels, dev, tag, K_WINDOW_ROWS, slots)
    return rows


def seg_inputs(torch, rng, B, slots, dev, zipf=False):
    """B rows over `slots` slots (uniform, or Zipf-skewed sizes, s = 1.2),
    temperature N(20, 5) as float32 with 1 % NULL (NaN) and, in the last
    B/64 rows, an eighth ±inf (so the sums before them stay finite), all
    valid."""
    vals = rng.normal(20, 5, B).astype(np.float32)
    vals[rng.random(B) < 0.01] = np.nan
    hit = (np.arange(B) >= B - B // 64) & (rng.random(B) < 0.125)
    vals[hit] = np.where(rng.random(B) < 0.5, np.inf, -np.inf)[hit]
    seg = ((rng.zipf(1.2, B) - 1) % slots if zipf
           else rng.integers(0, slots, B))
    return [torch.from_numpy(a).to(dev) for a in (
        seg.astype(np.int32), vals, np.ones(B, dtype=bool))]


def seg_equal(got, want, exact, rtol_idx, what):
    """Outputs `exact` equal (NaN where NaN), `rtol_idx` NaN and ±inf
    where the other is and the finite values within 1e-5; returns the
    largest absolute difference."""
    worst = 0.0
    for i in exact:
        g, w = got[i], want[i]
        if g.is_floating_point():
            check(bool(torch_equal_nan(g, w)), f"{what}: output {i} differs")
        else:
            check(bool((g == w).all()), f"{what}: output {i} differs")
    for i in rtol_idx:
        g, w = got[i].double(), want[i].double()
        fin = w.isfinite()
        check(bool(torch_equal_nan(g[~fin], w[~fin])),
              f"{what}: output {i} differs where not finite")
        d = (g[fin] - w[fin]).abs()
        check(bool((d <= 1e-5 * w[fin].abs()).all()),
              f"{what}: output {i} beyond rtol 1e-5")
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
    return worst


def torch_equal_nan(a, b):
    return ((a == b) | (a.isnan() & b.isnan())).all()


def shift_check(torch, rng, kernels, dev, tag, B, slots):
    C = SLOTS
    x = seg_inputs(torch, rng, B, slots, dev, zipf=tag == "zipf")
    carry_k = (torch.zeros(C, dtype=torch.int32, device=dev),
               torch.zeros(C, device=dev),
               torch.zeros(C, dtype=torch.bool, device=dev),
               torch.zeros(C, device=dev))
    carry_p = tuple(t.clone() for t in carry_k)
    err = 0.0
    for _ in range(2):  # the second batch continues the first's carry
        got = kernels.segscan_shift(carry_k, *x)
        want = kernels.segscan_shift_plain(carry_p, *x)
        torch.cuda.synchronize()
        err = max(err, seg_equal(got, want, (0, 1, 2, 4), (3,),
                                 f"segscan_shift {tag}"),
                  seg_equal(carry_k, carry_p, (0, 1, 2), (3,),
                            f"segscan_shift {tag} carry"))
    call = functools.partial(kernels.segscan_shift, carry_k, *x)
    t_k = time_ms(torch, call, REPS)
    split = {"body_ms": body_ms(torch, call, SHIFT_KERNELS, REPS,
                                     per_call=True),
             "host_ms": host_ms(torch, call, REPS)}
    t_p = time_ms(torch, lambda: kernels.segscan_shift_plain(carry_p, *x),
                  REPS)
    t_l = time_ms(torch, lambda: library_shift(torch, *x), REPS)
    touched = int(x[0].unique().numel())
    # the batch read once (slot, value, validity), four outputs written,
    # the touched carry slots read and written (13 bytes each way)
    nbytes = B * 9 + B * 13 + 2 * touched * 13
    b_ms, b_by = bound(nbytes, B)
    print(f"kernel segscan_shift {tag} B={B} slots={slots} C={C}: "
          f"max_abs_err={err:.3g} kernel_ms={t_k:.4f} {split_text(split)} "
          f"plain_ms={t_p:.4f} library_ms={t_l:.4f} bound_ms={b_ms:.5f} "
          f"({b_by})")
    return dict(max_abs_err=err, ms=t_k, **split, plain_ms=t_p,
                bound_ms=b_ms, bound_by=b_by, library_ms=t_l)


def library_shift(torch, slots, vals, valid):
    """Yardstick, never called by the port: #21's sort and scan as
    PyTorch's own calls (a stable sort, a gather, a cumsum, a scatter
    back)."""
    ss, order = torch.sort(torch.where(valid, slots, 1 << 30), stable=True)
    cum = torch.cumsum(torch.nan_to_num(vals[order]), 0)
    out = torch.empty_like(cum)
    out[order] = cum
    return ss, out


def sort_check(torch, rng, kernels, dev, tag, B, slots):
    x = seg_inputs(torch, rng, B, slots, dev)
    x[1] = torch.round(x[1] * 2) / 2  # float32-exact, many ties
    got = kernels.segscan_sort(*x)
    want = kernels.segscan_sort_plain(*x)
    torch.cuda.synchronize()
    seg_equal(got, want, range(6), (), f"segscan_sort {tag}")
    call = functools.partial(kernels.segscan_sort, *x)
    t_k = time_ms(torch, call, REPS)
    split = {"body_ms": body_ms(torch, call, SORT_KERNELS, REPS,
                                     per_call=True),
             "host_ms": host_ms(torch, call, REPS)}
    t_p = time_ms(torch, lambda: kernels.segscan_sort_plain(*x), REPS)
    t_l = time_ms(torch, lambda: library_sort(torch, *x), REPS)
    # the collection read once, six outputs written once (14 bytes)
    nbytes = B * 9 + B * 14
    b_ms, b_by = bound(nbytes, B)
    print(f"kernel segscan_sort {tag} B={B} segments={slots}: "
          f"max_abs_err=0 kernel_ms={t_k:.4f} {split_text(split)} "
          f"plain_ms={t_p:.4f} library_ms={t_l:.4f} bound_ms={b_ms:.5f} "
          f"({b_by})")
    return dict(max_abs_err=0.0, ms=t_k, **split, plain_ms=t_p,
                bound_ms=b_ms, bound_by=b_by, library_ms=t_l)


def library_sort(torch, seg, vals, valid):
    """Yardstick: #22's two orders as PyTorch's own calls (stable sorts by
    segment, and by value then segment, a cumsum, scatters back)."""
    s = torch.where(valid, seg, 1 << 30)
    o1 = torch.sort(s, stable=True).indices
    ov = torch.sort(torch.nan_to_num(vals, nan=float("inf")),
                    stable=True).indices
    o2 = ov[torch.sort(s[ov], stable=True).indices]
    cs = torch.cumsum(torch.ones_like(s), 0)
    a, b = torch.empty_like(cs), torch.empty_like(cs)
    a[o1] = cs
    b[o2] = cs
    return a, b


# ------------------------------------------------------------ phase J
def j_side(rng, n):
    """One join side of bench_join_heavy's shape (bench.py:2522-2556): key
    ids of k0..k511 and the keys, times uniform on [0, 60,000) ms, values
    uniform on [0, 100) (float32, the residual's type)."""
    ids = rng.integers(0, J_KEYS, n)
    ts = rng.integers(0, J_TS, n).astype(np.int64)
    vals = rng.uniform(0.0, 100.0, n).astype(np.float32)
    return ids, J_KEY_NAMES[ids], ts, vals


def j_twin_mask(ls, rs):
    """Independent numpy twin of one window's pairing: key equality (on
    the key ids), the ±5,000 ms band, l.v > r.w in float32."""
    (li, _, lt, lv), (ri, _, rt, rv) = ls, rs
    dt = lt.astype(np.int32)[:, None] - rt.astype(np.int32)[None, :]
    return ((li[:, None] == ri[None, :]) & (dt >= -J_BAND) & (dt <= J_BAND)
            & (lv[:, None] > rv[None, :]))


def j_batches(ls, rs):
    """The two sides as the join ring's SideBatches."""
    from ekuiper_tpu_torch.ops.joinring import SideBatch

    return [SideBatch(n=len(k), key_cols=[k.tolist()], band=t.tolist(),
                      cols={col: v.tolist()})
            for (_, k, t, v), col in ((ls, "__jl_v"), (rs, "__jr_w"))]


def run_j1(torch, seed, kernels, ring_of):
    """J1: bench_join_heavy's match leg, 2,048 rows a side, 4 windows
    cycled through JoinRing.match; every mask against the twin."""
    rng = np.random.default_rng(seed + 3000)
    ring = ring_of(J_RULE.format(jt="INNER"))
    wins, twins = [], []
    for _ in range(4):
        ls, rs = j_side(rng, J1_ROWS), j_side(rng, J1_ROWS)
        wins.append(j_batches(ls, rs))
        twins.append(j_twin_mask(ls, rs))
    ring.match(*wins[0])  # warm
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    masks = [ring.match(*wins[i % 4]) for i in range(J1_CALLS)]
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    for i, m in enumerate(masks):
        check(np.array_equal(m, twins[i % 4]), f"J1 window {i}: mask "
              "differs from the twin")
    check(ring.fallback_windows_total == 0, "J1: a fallback window")
    return dict(rows_per_s=J1_CALLS * 2 * J1_ROWS / wall,
                pairs=[int(t.sum()) for t in twins], launches=launches,
                fallback=ring.fallback_windows_total, calls=J1_CALLS)


def j2_twin(lrows, rrows, jt):
    """Python nested loop over one window's messages, in the reference's
    emission order (per left row its matches in right order, an unmatched
    left row at its place for LEFT / FULL, then the unmatched right rows
    for FULL)."""
    out, hit_r = [], set()
    for lm in lrows:
        hit = False
        for j, rm in enumerate(rrows):
            if (lm["k"] == rm["k"] and abs(lm["ts"] - rm["ts"]) <= J_BAND
                    and lm["v"] > rm["w"]):
                out.append({"v": lm["v"], "w": rm["w"]})
                hit = True
                hit_r.add(j)
        if not hit and jt in ("LEFT", "FULL"):
            out.append({"v": lm["v"], "w": None})
    if jt == "FULL":
        out += [{"v": None, "w": rm["w"]} for j, rm in enumerate(rrows)
                if j not in hit_r]
    return out


def run_j2(torch, seed, kernels, plan_host_rule, ColumnBatch, Node):
    """J2: the full rule through plan_host_rule, INNER / LEFT / FULL, 40
    windows of 256 rows a side on the port's mock clock; every window's
    rows against the nested-loop twin."""
    from ekuiper_tpu_torch.utils import timex

    out = {}
    for jt in J2_TYPES:
        rng = np.random.default_rng(seed + 3100 + len(jt))
        clock = timex.set_mock_clock(0)
        try:
            rule = plan_host_rule(J_RULE.format(jt=jt))
            join = rule.nodes["join"]
            check(type(join).__name__ == "DeviceJoinNode" and
                  join.ring.device.type == "cuda", f"J2 {jt}: join not on "
                  "the card")
            sink = collector(Node)
            rule.tail.connect(sink)
            rule.on_open()
            lat, n_out = [], 0
            kernels.reset_launches()
            t0 = time.perf_counter()
            for w in range(J2_WINDOWS):
                feeds = {}
                for name, col in (("l", "v"), ("r", "w")):
                    _, k, t, v = j_side(rng, J2_ROWS)
                    feeds[name] = [{"k": a, "ts": int(b), col: float(c)}
                                   for a, b, c in zip(k, t, v)]
                    rule.entries[name].process(ColumnBatch(
                        n=J2_ROWS, columns={"k": k, "ts": t, col: v}))
                sink.got.clear()
                te = time.perf_counter()
                clock.advance(J_WINDOW_MS)
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - te) * 1e3)
                got = [t.message for x in sink.got
                       for t in (x if isinstance(x, list) else [x])]
                want = j2_twin(feeds["l"], feeds["r"], jt)
                check(got == want, f"J2 {jt} window {w}: {len(got)} rows, "
                      f"the twin {len(want)}, or their order differs")
                n_out += len(got)
            wall = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            check(join.ring.fallback_windows_total == 0,
                  f"J2 {jt}: a fallback window")
            rule.on_close()
        finally:
            timex.use_real_clock()
        out[jt] = dict(p50=pct(lat, 50), p99=pct(lat, 99), rows_out=n_out,
                       rows_per_s=J2_WINDOWS * 2 * J2_ROWS / wall,
                       launches=launches,
                       fallback=join.ring.fallback_windows_total)
    return out


def run_j3(torch, seed, kernels, ring_of):
    """J3: J1's rule on windows of 16,384 rows a side (a 268 MB mask,
    33.5 MB packed on the card), through JoinRing.match; each mask against
    the twin, the kernel's body time from a profiler trace against its
    bound, then each stage of one match (j3_stages)."""
    rng = np.random.default_rng(seed + 3200)
    ring = ring_of(J_RULE.format(jt="INNER"))
    kernels.reset_launches()
    walls, pairs = [], []
    for _ in range(J3_WINDOWS):
        ls, rs = j_side(rng, J3_ROWS), j_side(rng, J3_ROWS)
        lb, rb = j_batches(ls, rs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mask = ring.match(lb, rb)
        walls.append((time.perf_counter() - t0) * 1e3)
        twin = j_twin_mask(ls, rs)
        check(np.array_equal(mask, twin), "J3: mask differs from the twin")
        pairs.append(int(twin.sum()))
        del mask, twin
    launches = dict(kernels.LAUNCHES)
    check(ring.fallback_windows_total == 0, "J3: a fallback window")
    # the kernel's device time inside three more match calls of the last
    # window (their launches counted apart from the checked windows); the
    # residual's torch pass at this shape is phase 2's residual_ms
    body = body_ms(torch, lambda: ring.match(lb, rb), "join_match_kernel",
                   3, per_call=True)
    b_ms, b_by = bound(join_bytes(J3_ROWS), 0)
    return dict(match_ms=walls, body_ms=body, bound_ms=b_ms,
                bound_by=b_by, pairs=pairs, launches=launches,
                fallback=ring.fallback_windows_total,
                stages=j3_stages(torch, kernels, ring, lb, rb))


def j3_stages(torch, kernels, ring, lb, rb, reps=3):
    """Host ms of each stage of one JoinRing.match on J3's window, each a
    median of `reps` calls that end in a synchronize: the key encode of
    both sides, the event times' rebase, the padded sides' upload, the
    residual's torch pass, the kernel, the packed rows' copy into pinned
    memory, their unpack (with the count of matches; `unpack_1t` the same
    by numpy on the calling thread alone, what the pool's tasks replace),
    and the whole match."""
    from ekuiper_tpu_torch.ops.joinring import unpack_mask

    def timed(fn):
        walls, out = [], None
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return out, statistics.median(walls)

    st = {}
    (sl, sr), st["slots"] = timed(lambda: (ring._slots(lb),
                                           ring._slots(rb)))
    (tl, tr), st["ts32"] = timed(lambda: ring._ts32(lb, rb))
    (a, b), st["upload"] = timed(lambda: ring._upload(sl, tl, sr, tr))
    res, st["residual"] = timed(lambda: ring._residual_mask(
        lb, rb, len(a[0]), len(b[0])))
    packed, st["kernel"] = timed(lambda: kernels.join_match(
        *a, *b, ring.lo, ring.hi, res))
    rows = packed[:lb.n]
    host = torch.empty(rows.shape, dtype=torch.uint8, pin_memory=True)
    _, st["copy"] = timed(lambda: host.copy_(rows, non_blocking=True))
    _, st["unpack"] = timed(lambda: unpack_mask(host.numpy(), rb.n))
    _, st["unpack_1t"] = timed(lambda: (np.unpackbits(
        host.numpy(), axis=1, count=rb.n, bitorder="little"),
        np.bitwise_count(host.numpy().view(np.uint64)).sum()))
    _, st["match"] = timed(lambda: ring.match(lb, rb))
    return st


def collector(Node):
    """A sink node: keeps what reaches its `process` in `got`."""

    class Sink(Node):
        def __init__(self):
            super().__init__("sink")
            self.got = []

        def process(self, item):
            self.got.append(item)

    return Sink()


def run_phase_j(torch, seed, kernels, plan_host_rule, ColumnBatch, Node):
    """Phase J: interval joins, J1-J3."""
    from ekuiper_tpu_torch.planner import relational
    from ekuiper_tpu_torch.sql.parser import parse_select

    def ring_of(sql):
        stmt = parse_select(sql)
        ring = relational.lower_join(stmt, stmt.joins).build_ring()
        check(ring.device.type == "cuda", "join ring not on the card")
        return ring

    t0 = time.perf_counter()
    out = {"j1": run_j1(torch, seed, kernels, ring_of)}
    out["j2"] = run_j2(torch, seed, kernels, plan_host_rule, ColumnBatch,
                       Node)
    out["j3"] = run_j3(torch, seed, kernels, ring_of)
    torch.cuda.empty_cache()
    out["wall"] = time.perf_counter() - t0
    return out


def phase_j_lines(j):
    j1 = j["j1"]
    yield (f"phase J J1 bench_join_heavy match leg: {J1_CALLS} windows of "
           f"{J1_ROWS} rows a side ({J_KEYS} keys, band ±{J_BAND} ms, l.v > "
           f"r.w): match rows/s={j1['rows_per_s']:.0f} pairs/window="
           f"{j1['pairs']} fallback_windows={j1['fallback']} every mask "
           f"equal to the twin launches={nz_dict(j1['launches'])}")
    for jt, r in j["j2"].items():
        yield (f"phase J J2 {jt} JOIN through plan_host_rule: {J2_WINDOWS} "
               f"windows of {J2_ROWS} rows a side: window_p50_ms="
               f"{r['p50']:.3f} window_p99_ms={r['p99']:.3f} rows/s="
               f"{r['rows_per_s']:.0f} rows_out={r['rows_out']} "
               f"fallback_windows={r['fallback']} every window equal to "
               f"the nested-loop twin launches={nz_dict(r['launches'])}")
    j3 = j["j3"]
    yield (f"phase J J3 {J3_WINDOWS} windows of {J3_ROWS} rows a side: "
           f"match_ms={[round(x, 3) for x in j3['match_ms']]} kernel "
           f"body_ms={j3['body_ms']} "
           f"bound_ms={j3['bound_ms']:.5f} ({j3['bound_by']}) pairs="
           f"{j3['pairs']} fallback_windows={j3['fallback']} "
           f"launches={nz_dict(j3['launches'])} stages_ms="
           + " ".join(f"{k}={v:.3f}" for k, v in j3["stages"].items())
           + f" (phase J wall {j['wall']:.1f} s)")


def nz_dict(d):
    return {k: v for k, v in d.items() if v}


# ------------------------------------------------------------ phase K
def run_k1(torch, seed, kernels, plan_host_rule, ColumnBatch, Node):
    """K1: lag over the flagship stream (10,000 devices, 16 batches of
    8,192 rows); every prev against the twin's previous value per device
    across batches."""
    rng = np.random.default_rng(seed + 4000)
    rule = plan_host_rule(K1_RULE)
    an = rule.nodes["analytic"]
    check(type(an).__name__ == "DeviceAnalyticNode", "K1: not the device "
          "analytic node")
    sink = collector(Node)
    rule.tail.connect(sink)
    batches = []
    for _ in range(K1_BATCHES):
        idx = rng.integers(0, N_KEYS, K_SHIFT_SMALL)
        temp = rng.normal(20, 5, K_SHIFT_SMALL).astype(np.float32)
        batches.append((idx, temp, ColumnBatch(n=len(idx), columns={
            "deviceId": DEVICE_NAMES[idx], "temperature": temp})))
    kernels.reset_launches()
    t0 = time.perf_counter()
    for _, _, b in batches:
        rule.entries["demo"].process(b)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    check(not an._migrated and an._seg.device.type == "cuda",
          "K1: the lag carry left the card")
    got = [t.message["prev"] for t in sink.got]
    last = np.full(N_KEYS, np.nan, dtype=np.float32)
    seen = np.zeros(N_KEYS, dtype=bool)
    want = []
    for idx, temp, _ in batches:
        for i, t in zip(idx, temp):
            want.append(float(last[i]) if seen[i] else None)
            last[i], seen[i] = t, True
    check(got == want, "K1: a prev differs from the twin")
    return dict(rows_per_s=K1_BATCHES * K_SHIFT_SMALL / wall,
                continued=an._seg.spills_total, launches=launches,
                rows=len(got))


def run_k2(torch, seed, kernels, plan_host_rule, ColumnBatch, Node):
    """K2: rank, dense_rank and lead of temperature over windows of 65,536
    rows (10,000 devices, values in halves so float32-exact with ties);
    every value against scipy.stats.rankdata (min / dense) within devices
    and the next row's value."""
    from scipy.stats import rankdata

    from ekuiper_tpu_torch.utils import timex

    rng = np.random.default_rng(seed + 4100)
    clock = timex.set_mock_clock(0)
    try:
        rule = plan_host_rule(K2_RULE)
        wf = rule.nodes["window_func"]
        check(type(wf).__name__ == "VectorWindowFuncNode" and wf.use_device,
              "K2: ranks not planned for the card")
        sink = collector(Node)
        rule.tail.connect(sink)
        rule.on_open()
        kernels.reset_launches()
        lat = []
        for w in range(K2_WINDOWS):
            idx = rng.integers(0, N_KEYS, K_WINDOW_ROWS)
            temp = (np.round(rng.normal(20, 5, K_WINDOW_ROWS) * 2)
                    / 2).astype(np.float32)
            rule.entries["demo"].process(ColumnBatch(
                n=len(idx), columns={"deviceId": DEVICE_NAMES[idx],
                                     "temperature": temp}))
            sink.got.clear()
            te = time.perf_counter()
            clock.advance(K_WINDOW_MS)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - te) * 1e3)
            got = [t.message for x in sink.got
                   for t in (x if isinstance(x, list) else [x])]
            check(len(got) == K_WINDOW_ROWS, f"K2 window {w}: {len(got)} "
                  "rows")
            order = np.argsort(idx, kind="stable")
            bounds = np.flatnonzero(np.diff(idx[order])) + 1
            rk = np.empty(len(idx), np.int64)
            dr = np.empty(len(idx), np.int64)
            nx = np.full(len(idx), np.nan)
            for sel in np.split(order, bounds):
                rk[sel] = rankdata(temp[sel], method="min")
                dr[sel] = rankdata(temp[sel], method="dense")
                nx[sel[:-1]] = temp[sel[1:]]
            check([m["rk"] for m in got] == rk.tolist(),
                  f"K2 window {w}: rank differs")
            check([m["dr"] for m in got] == dr.tolist(),
                  f"K2 window {w}: dense_rank differs")
            check([m["nx"] for m in got] ==
                  [None if np.isnan(v) else float(v) for v in nx],
                  f"K2 window {w}: lead differs")
        launches = dict(kernels.LAUNCHES)
        rule.on_close()
    finally:
        timex.use_real_clock()
    return dict(p50=pct(lat, 50), max_ms=max(lat), window_ms=lat,
                launches=launches, rank_paths=dict(wf.rank_paths))


def run_phase_k(torch, seed, kernels, plan_host_rule, ColumnBatch, Node):
    t0 = time.perf_counter()
    out = {"k1": run_k1(torch, seed, kernels, plan_host_rule, ColumnBatch,
                        Node),
           "k2": run_k2(torch, seed, kernels, plan_host_rule, ColumnBatch,
                        Node)}
    out["wall"] = time.perf_counter() - t0
    return out


def phase_k_lines(k):
    k1, k2 = k["k1"], k["k2"]
    yield (f"phase K K1 lag over {N_KEYS} devices, {K1_BATCHES} batches of "
           f"{K_SHIFT_SMALL} rows: rows/s={k1['rows_per_s']:.0f} "
           f"continued_partitions={k1['continued']} rows={k1['rows']} "
           f"every prev equal to the twin launches="
           f"{nz_dict(k1['launches'])}")
    yield (f"phase K K2 rank / dense_rank / lead over {K2_WINDOWS} "
           f"TUMBLINGWINDOW(ss, 10) windows of {K_WINDOW_ROWS} rows: "
           f"window_ms={[round(x, 1) for x in k2['window_ms']]} every value "
           f"equal to scipy rankdata and the next row's rank_paths="
           f"{k2['rank_paths']} launches={nz_dict(k2['launches'])} "
           f"(phase K wall {k['wall']:.1f} s)")


# ----------------------------------- phase 2, the masked touch, count-min
def masked_touch_check(torch, seed, kernels, plan_fused_rule, TorchGroupBy,
                       dev):
    """#2's touch branch (a tiered sliding rule's edge refolds) at D2's
    refold plan, 16,384 slots with a touch column: one 65,536-row cached
    batch (61,440 real rows, the padding on slot 0 under mask 0) with
    uint16 slots, its mask the rows of one bucket past a time cut, into
    the scratch pane over rows already folded there. Touch and the exact
    components bit-equal to the plain version, s1 within rtol 1e-5."""
    node = plan_fused_rule(D2_RULE, key_slots=SLOTS, micro_batch=ROWS,
                           device=dev, options=REFOLD)
    check(node.sliding_impl == "refold", "#2 touch: not on refold")
    plan, P, pane, B = (node.plan, node.n_panes, node._scratch_pane,
                        node.bucket_ms)
    del node
    gb = TorchGroupBy(plan, capacity=SLOTS, n_panes=P, micro_batch=ROWS,
                      device=dev, track_touch=True)
    r = np.random.default_rng(seed + 110)
    n_real = ROWS * 15 // 16
    temp = r.normal(20, 5, ROWS).astype(np.float32)
    s_host = r.integers(0, N_KEYS, ROWS)
    ts = T0_MS + np.arange(ROWS) * BATCH_MS_NUM // (BATCH_MS_DEN * ROWS)
    bucket = ts // B
    mask = (bucket == bucket[0]) & (ts > ts[ROWS // 4])
    temp[n_real:], s_host[n_real:], mask[n_real:] = 0.0, 0, False
    cols = {"temperature": torch.from_numpy(temp).to(dev)}
    slots = torch.from_numpy(s_host.astype(np.uint16)).to(dev)
    base = gb._where(cols, (ROWS,)) & torch.from_numpy(mask).to(dev)
    V, M = gb._spec_values(cols, ROWS)
    M = M & base
    st = gb.init_state()
    NW = gb._widemap
    kernels.fold_plain(st, base.roll(7), V.roll(7, 1), M.roll(7, 1), slots,
                       pane, gb._colmap, NW)
    ref, got = clone_state(st), clone_state(st)
    kernels.reset_launches()
    kernels.groupby_fold_masked(got, base, V, M, slots, pane, gb._colmap,
                                NW)
    kernels.fold_plain(ref, base, V, M, slots, pane, gb._colmap, NW)
    torch.cuda.synchronize()
    check(kernels.TOUCH_LAUNCHES["groupby_fold_masked"] == 1,
          "#2 touch: the launch bumped no touch column")
    err = state_err(got, ref, exact=("n", "act", "mn", "mx", "touch"))
    m_rows = int(base.sum().item())
    check(int(got["touch"].long().sum()) - int(st["touch"].long().sum())
          == m_rows, "#2 touch: one count per masked row")
    fn = functools.partial(kernels.groupby_fold_masked, got, base, V, M,
                           slots, pane, gb._colmap, NW)
    untracked = {k: v for k, v in got.items() if k != "touch"}
    t_k = time_ms(torch, fn, REPS)
    t_u = time_ms(torch, lambda: kernels.groupby_fold_masked(
        untracked, base, V, M, slots, pane, gb._colmap, NW), REPS)
    split = launch_split(torch, fn, "groupby_fold_kernel", REPS)
    t_p = time_ms(torch, functools.partial(
        kernels.fold_plain, ref, base, V, M, slots, pane, gb._colmap, NW),
        REPS)
    t32 = torch.zeros(SLOTS, dtype=torch.int32, device=dev)
    idx = slots.long()[base]
    ones = torch.ones_like(idx, dtype=torch.int32)

    upd = fold_updates(torch, ref, base, V, M, slots, pane, gb._colmap,
                       kernels)

    def library():
        library_fold(torch, ref, upd)
        t32.index_add_(0, idx, ones)

    t_l = time_ms(torch, library, REPS)
    S = len(set(gb._colmap[:, 2].tolist()))
    touched = len(np.unique(s_host[mask]))
    width = sum(a.shape[2] for k, a in st.items()
                if k not in ("act", "touch")) + 1
    # the mask of every row; the slot, V and M of each spec of the masked
    # rows; each touched slot's state line and touch counter read and
    # written
    nbytes = (ROWS + m_rows * (slots.element_size() + 5 * S)
              + touched * width * 8 + touched * 8)
    b_ms, b_by = bound(nbytes, m_rows * (len(gb._colmap) + 2))
    print(f"kernel groupby_fold_masked/touch P={P} pane={pane} "
          f"R={ROWS} real={n_real} masked={m_rows} C={SLOTS} slots=uint16 "
          f"bound_bytes={nbytes}: max_abs_err={err[0]:.3g} touch exact "
          f"kernel_ms={t_k:.4f} (without touch {t_u:.4f}) "
          f"{split_text(split)} plain_ms={t_p:.4f} library_ms={t_l:.4f} "
          f"bound_ms={b_ms:.5f} ({b_by})")
    row = dict(max_abs_err=err[0], max_rel_err=err[1], ms=t_k,
               ms_without_touch=t_u, **split, plain_ms=t_p, bound_ms=b_ms,
               bound_by=b_by, library_ms=t_l)
    del st, ref, got, untracked, gb
    torch.cuda.empty_cache()
    return {"groupby_fold_masked/touch": row}


def m_values(rng, n):
    """Phase M's values: phase A's mix (7 at 35 %, 13 at 20 %, 99 at 15 %)
    with the uniform tail over [100, 20,100)."""
    p = rng.random(n)
    return np.where(p < 0.35, 7, np.where(p < 0.55, 13, np.where(
        p < 0.70, 99, rng.integers(100, 20_100, n)))).astype(np.float32)


def np_cms_cells(v, depth, width):
    """(depth, n) cells of float32 values: the splitmix hash of the float's
    bits salted by row (sketches.hash_f32 with salt d + 2), modulo width."""
    bits = np.asarray(v, dtype=np.float32).view(U32)
    return np.stack([
        np_splitmix32(bits ^ U32((0x9E3779B9 * (d + 3)) & 0xFFFFFFFF))
        % U32(width) for d in range(depth)]).astype(np.int64)


def countmin_kernel_checks(torch, seed, kernels, dev):
    """#10 and #11 against their plain versions at phase M's shapes:
    65,536 values into (4, 8192) counts, point queries of 4,096 and 8,192
    candidates; counts and estimates bit-equal (integer counts below
    2^24 add alike in any order)."""
    rows = {}
    rng = np.random.default_rng(seed + 120)
    vals = torch.from_numpy(m_values(rng, ROWS)).to(dev)
    uniform = torch.from_numpy(rng.integers(0, 1 << 20, ROWS).astype(
        np.float32)).to(dev)
    # #10 on M's stream and on a uniform one; the plain and library
    # versions timed on M's only (their time does not depend on the mix)
    for tag, v in (("", vals), ("/uniform", uniform)):
        got = torch.zeros((M_DEPTH, M_WIDTH), device=dev)
        ref = got.clone()
        kernels.cms_update(got, v)
        kernels.cms_update_plain(ref, v)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"cms_update{tag}: counts differ")
        cells = torch.from_numpy(
            np_cms_cells(v.cpu().numpy(), M_DEPTH, M_WIDTH)
            + np.arange(M_DEPTH)[:, None] * M_WIDTH).to(dev)
        check(torch.equal(kernels._cms_cells_plain(v, M_DEPTH, M_WIDTH),
                          cells), "cms_update: the plain cells differ from "
              "the numpy twin's")
        flat = cells.reshape(-1)
        ones = torch.ones(flat.shape, device=dev)
        fn = functools.partial(kernels.cms_update, got, v)
        name = "cms_update_kernel"
        calls = one_kernel_a_call(torch, fn, name, f"cms_update{tag}")
        t_k = time_ms(torch, fn, REPS)
        split = launch_split(torch, fn, name, REPS)
        if tag == "":
            t_p = time_ms(torch, lambda: kernels.cms_update_plain(ref, v),
                          REPS)
            t_l = time_ms(torch, lambda: ref.view(-1).index_add_(
                0, flat, ones), REPS)
        # the values read once, the counts read and written once; one add
        # per (value, row)
        nbytes = ROWS * 4 + 2 * M_DEPTH * M_WIDTH * 4
        b_ms, b_by = bound(nbytes, ROWS * M_DEPTH)
        print(f"kernel cms_update{tag} n={ROWS} d={M_DEPTH} "
              f"w={M_WIDTH} bound_bytes={nbytes} updates={ROWS * M_DEPTH}: "
              f"max_abs_err=0 kernels_a_call={calls:g} "
              f"kernel_ms={t_k:.4f} "
              f"{split_text(split)} plain_ms={t_p:.4f} "
              f"library_ms={t_l:.4f} bound_ms={b_ms:.5f} ({b_by})")
        rows["cms_update" + tag] = dict(
            max_abs_err=0.0, ms=t_k, **split, plain_ms=t_p, bound_ms=b_ms,
            bound_by=b_by, library_ms=t_l)
        if tag == "":
            counts = got.clone()
    for n in (4096, 8192):
        q = torch.from_numpy(np.unique(m_values(rng, 4 * n))[:n]).to(dev)
        est = kernels.cms_query(counts, q)
        want = kernels.cms_query_plain(counts, q)
        torch.cuda.synchronize()
        check(torch.equal(est, want), f"cms_query {n}: estimates differ")
        qc = torch.from_numpy(
            np_cms_cells(q.cpu().numpy(), M_DEPTH, M_WIDTH)
            + np.arange(M_DEPTH)[:, None] * M_WIDTH).to(dev)
        t_k = time_ms(torch, lambda: kernels.cms_query(counts, q), REPS)
        split = launch_split(torch, lambda: kernels.cms_query(counts, q),
                             "cms_query_kernel", REPS)
        t_p = time_ms(torch, lambda: kernels.cms_query_plain(counts, q),
                      REPS)
        t_l = time_ms(torch, lambda: counts.view(-1)[qc].amin(0), REPS)
        # the values, the d cells of each, the estimates
        nbytes = n * 4 + n * M_DEPTH * 4 + n * 4
        b_ms, b_by = bound(nbytes, n * M_DEPTH)
        print(f"kernel cms_query n={n} d={M_DEPTH} w={M_WIDTH} "
              f"bound_bytes={nbytes}: max_abs_err=0 kernel_ms={t_k:.4f} "
              f"{split_text(split)} plain_ms={t_p:.4f} library_ms={t_l:.4f} "
              f"bound_ms={b_ms:.5f} ({b_by})")
        rows[f"cms_query/{n}"] = dict(max_abs_err=0.0, ms=t_k, **split,
                                      plain_ms=t_p, bound_ms=b_ms,
                                      bound_by=b_by, library_ms=t_l)
    return rows


# -------------------------------------------------------------- phase L
class LStream(SlidingStream):
    """Phase L's churning fleet, in SlidingStream's layout: per batch
    49,152 rows over the steady keys 0..9,999 and 16,384 over the current
    cohort's 8,192 keys (ids 10,000 + c·8,192 + k, cohort c = batch // 32),
    the rows shuffled; temperature, trigger rows and timestamps as phase
    D's (no gap)."""

    def __init__(self, rng, n_batches):
        self.n = n_batches
        n_cohorts = -(-n_batches // L_COHORT_EVERY)
        self.n_keys = N_KEYS + L_COHORT * n_cohorts
        steady = rng.integers(0, N_KEYS, (n_batches, ROWS - L_COHORT_ROWS))
        cohort = (N_KEYS + (np.arange(n_batches) // L_COHORT_EVERY)[:, None]
                  * L_COHORT + rng.integers(0, L_COHORT,
                                            (n_batches, L_COHORT_ROWS)))
        self.idx = rng.permuted(np.concatenate([steady, cohort], axis=1),
                                axis=1).astype(np.int32)
        self.temp = rng.normal(20, 5, (n_batches, ROWS)).astype(np.float32)
        for b in range(TRIGGER_EVERY - 1, n_batches, TRIGGER_EVERY):
            self.temp[b, rng.integers(0, ROWS)] = 99.0
        self.hum = self.code = None
        g = np.arange(n_batches * ROWS, dtype=np.int64)
        self.ts = (T0_MS + g * BATCH_MS_NUM // (BATCH_MS_DEN * ROWS)).reshape(
            n_batches, ROWS)


class LTwin:
    """The float64 group-by of any row range of an LStream: per batch the
    steady keys' and the batch's cohort's partials (dense over 10,000 and
    8,192 keys), summed or min/max-ed over a range's whole batches, the two
    partial batches at its ends from their rows."""

    SUMS = ("cnt", "sum", "sumabs")

    def __init__(self, stream):
        self.s = stream
        n = stream.n
        self.st = {k: np.zeros((n, N_KEYS)) for k in self.SUMS}
        self.co = {k: np.zeros((n, L_COHORT)) for k in self.SUMS}
        for part, w in ((self.st, N_KEYS), (self.co, L_COHORT)):
            part["min"] = np.full((n, w), np.inf)
            part["max"] = np.full((n, w), -np.inf)
        for b in range(n):
            idx, t = stream.idx[b], stream.temp[b]
            steady = idx < N_KEYS
            base = N_KEYS + b // L_COHORT_EVERY * L_COHORT
            for part, keep, off, w in ((self.st, steady, 0, N_KEYS),
                                       (self.co, ~steady, base, L_COHORT)):
                agg = batch_aggs(idx[keep] - off, t[keep], w)
                for k in part:
                    part[k][b] = agg[k]

    def window(self, a, b):
        s = self.s
        idx, temp = s.idx.reshape(-1), s.temp.reshape(-1)
        ba, bb = -(-a // ROWS), b // ROWS
        if ba >= bb:
            return batch_aggs(idx[a:b], temp[a:b], s.n_keys)
        mid = {k: np.zeros(s.n_keys) for k in self.SUMS}
        mid["sumsq"] = 0.0  # no stddev in D2's rule
        mid["min"] = np.full(s.n_keys, np.inf)
        mid["max"] = np.full(s.n_keys, -np.inf)
        spans = [(slice(0, N_KEYS), self.st, ba, bb)]
        for c in range(ba // L_COHORT_EVERY, (bb - 1) // L_COHORT_EVERY + 1):
            lo = N_KEYS + c * L_COHORT
            spans.append((slice(lo, lo + L_COHORT), self.co,
                          max(ba, c * L_COHORT_EVERY),
                          min(bb, (c + 1) * L_COHORT_EVERY)))
        for keys, part, lo, hi in spans:
            for k in self.SUMS:
                mid[k][keys] += part[k][lo:hi].sum(axis=0)
            mid["min"][keys] = part["min"][lo:hi].min(axis=0)
            mid["max"][keys] = part["max"][lo:hi].max(axis=0)
        ends = [batch_aggs(idx[a:ba * ROWS], temp[a:ba * ROWS], s.n_keys),
                batch_aggs(idx[bb * ROWS:b], temp[bb * ROWS:b], s.n_keys)]
        return merge_aggs([mid] + ends)


def run_l(torch, kernels, mods, tag, stream, twin):
    """One phase L run: D2's rule tiered (L_OPTS) on the DABA ring (l1) or
    the refold path (l2), fed the churning fleet on the mock clock; every
    window against the float64 twin over exactly (t - 10 s, t]; the state
    held at the hot capacity, keys demoted as slot recycles, at least 10
    triggers after the first demotion."""
    from ekuiper_tpu_torch.utils import timex

    impl = "daba" if tag == "l1" else "refold"
    first, flips = {}, []

    def hook(node):
        tier = node.tier
        check(tier is not None and tier.quiescent_only,
              f"{tag}: the rule is not tiered in quiescent-only mode")
        check(65_536 <= tier.layout.hot_slots <= 98_304,
              f"{tag}: hot target {tier.layout.hot_slots}")
        check(node.gb.capacity == tier.layout.hot_capacity(),
              f"{tag}: state built at {node.gb.capacity} slots")
        check(tier.min_idle_ms == (node.n_ring_panes + 10) * node.bucket_ms,
              f"{tag}: min_idle_ms {tier.min_idle_ms}")
        inner = tier._on_tier_event

        def event(kind, n=0):
            if kind == "demote":
                first.setdefault("ms", timex.now_ms())
            inner(kind, n=n)

        tier._on_tier_event = event
        if impl == "daba":
            flip = node._ring_flip

            def timed_flip(j, e):
                done = node.ring_counts["flip"]
                flip(j, e)
                if node.ring_counts["flip"] > done:
                    flips.append(timex.now_ms())

            node._ring_flip = timed_flip

    opts = dict(L_OPTS, **(REFOLD if impl == "refold" else {}))
    t_run = time.perf_counter()
    node, em, rps, launches, row_pane = run_sliding(
        torch, kernels, mods, D2_RULE, stream, tag, options=opts, impl=impl,
        sources=("device-ring",) if impl == "daba" else ("device-async",),
        hook=hook, key_slots=L_SLOTS)
    touch = dict(kernels.TOUCH_LAUNCHES)
    tier = node.tier
    hot_cap = tier.layout.hot_capacity()
    check(node.gb.capacity == hot_cap and node.kt.capacity <= hot_cap,
          f"{tag}: state grew past the hot capacity ({node.gb.capacity}, "
          f"key table {node.kt.capacity}, hot {hot_cap})")
    check(tier.demoted_total > 0 and "ms" in first, f"{tag}: no demotion")
    check(tier.demoted_total == tier.recycled_total + tier.promoted_total
          + len(tier._requeue), f"{tag}: demoted keys unaccounted for")
    want_trig = int((stream.temp > 44.5).sum())
    check(len(em) == want_trig,
          f"{tag}: {len(em)} triggers, {want_trig} trigger rows")
    after = sum(1 for t, *_ in em if t > first["ms"])
    check(after >= 10, f"{tag}: {after} triggers after the first demotion")
    t_check = time.perf_counter()
    worst = 0.0
    R, B = node.n_ring_panes, node.bucket_ms
    for i, (t, received, _, _, cb, _) in enumerate(em):
        a, b = stream.rows(t - node.length_ms, t, received)
        ring = None
        if impl == "daba":
            # the ring's running totals: since their last rebuild (a flip
            # in this trigger or an earlier one, triggers being 1.25 s
            # apart) each key's total took at most `ops` float32 adds and
            # subtracts (the flip's R panes, two a bucket advance, the
            # query's slices and edge), each rounding by at most half an
            # ulp of a value no larger than the key's Σ|x| over the rows
            # since the rebuild's oldest pane
            f = max((x for x in flips if x <= t + 1000),
                    default=int(stream.ts[0, 0]))
            ops = R + 2 * ((t - f) // B + 2) + 5
            lo, _ = stream.rows(f - (R + 1) * B, t, received)
            ring = EPS32 / 2 * ops * twin.window(lo, b)["sumabs"]
        worst = max(worst, check_window(cb, twin.window(a, b), False,
                                        f"{tag} trigger {i} (t={t})",
                                        ring=ring))
    counts = (dict(node.ring_counts) if impl == "daba"
              else {k: node.refold_counts.get(k, 0)
                    for k in ("cached", "host", "stale", "evicted")})
    res = dict(rows_per_s=rps, triggers=len(em), after_demote=after,
               first_demote_s=(first["ms"] - int(stream.ts[0, 0])) / 1e3,
               stall=[st * 1e3 for _, _, st, _, _, _ in em],
               delivery=[dl * 1e3 for _, _, _, dl, _, _ in em],
               counts=counts, launches=launches, row_pane=row_pane,
               touch_launches=touch, max_abs_err=worst,
               hot_slots=tier.layout.hot_slots, capacity=node.gb.capacity,
               keys=node.kt.n_keys, live=node.kt.n_keys
               - len(node.kt.free_slots()),
               demoted=tier.demoted_total, recycled=tier.recycled_total,
               promoted=tier.promoted_total, requeued=len(tier._requeue),
               bucket_ms=node.bucket_ms, ring_panes=node.n_ring_panes,
               flips=len(flips), windows=[e[4] for e in em],
               check_s=time.perf_counter() - t_check,
               wall_s=time.perf_counter() - t_run)
    del node, em
    torch.cuda.empty_cache()
    return res


def run_phase_l(torch, seed, kernels, mods):
    """Phase L: L1 (DABA) and L2 (refold) on one churning fleet."""
    t0 = time.perf_counter()
    stream = LStream(np.random.default_rng(seed + 130), L_BATCHES["l1"])
    twin = LTwin(stream)
    twin_s = time.perf_counter() - t0
    res = {tag: run_l(torch, kernels, mods, tag, stream, twin)
           for tag in ("l1", "l2")}
    # the two paths' windows of each trigger: keys, counts, min, max equal
    for i, (x, y) in enumerate(zip(res["l2"].pop("windows"),
                                   res["l1"].pop("windows"))):
        same_rows(x, y, f"l2 trigger {i} against l1")
    res["l1"]["twin_s"] = twin_s
    return res


def phase_l_line(tag, r):
    return (f"phase L {tag}: {'DABA ring' if tag == 'l1' else 'refold'} "
            f"bucket_ms={r['bucket_ms']} ring_panes={r['ring_panes']} "
            f"hot_slots={r['hot_slots']} capacity={r['capacity']} "
            f"keys_in_table={r['keys']} live={r['live']} "
            f"rows/s={r['rows_per_s']:.0f} triggers={r['triggers']} "
            f"(after the first demotion at {r['first_demote_s']:.3f} s of "
            f"stream: {r['after_demote']}) "
            f"stall_p50_ms={pct(r['stall'], 50):.3f} "
            f"stall_p99_ms={pct(r['stall'], 99):.3f} "
            f"delivery_p50_ms={pct(r['delivery'], 50):.3f} "
            f"delivery_p99_ms={pct(r['delivery'], 99):.3f} "
            f"demoted={r['demoted']} recycled={r['recycled']} "
            f"promoted={r['promoted']} requeued_pending={r['requeued']} "
            f"max_abs_err={r['max_abs_err']:.3g} routes={r['counts']} "
            f"ring_rebuilds_seen={r['flips']} "
            f"touch_launches={nz_dict(r['touch_launches'])} "
            f"pane_vec_folds={nz_dict(r['row_pane'])} "
            f"launches={nz_dict(r['launches'])} check_s={r['check_s']:.1f} "
            f"wall_s={r['wall_s']:.1f}")


# -------------------------------------------------------------- phase M
class CmsTwin:
    """The count-min sketch in numpy: counts by np.add.at at the twin's
    cells, and the reference's host candidate logic over its own point
    queries."""

    def __init__(self):
        self.counts = np.zeros((M_DEPTH, M_WIDTH), dtype=np.float32)
        self.candidates = {}

    def query(self, cand):
        cells = np_cms_cells(cand, M_DEPTH, M_WIDTH)
        return self.counts[np.arange(M_DEPTH)[:, None], cells].min(axis=0)

    def update(self, arr):
        cells = np_cms_cells(arr, M_DEPTH, M_WIDTH)
        for d in range(M_DEPTH):
            np.add.at(self.counts[d], cells[d], np.float32(1.0))
        new = [float(x) for x in np.unique(arr)
               if float(x) not in self.candidates]
        if not new:
            return
        if len(self.candidates) + len(new) <= M_CAND:
            for x in new:
                self.candidates[x] = True
            return
        cand = np.concatenate([
            np.fromiter(self.candidates.keys(), dtype=np.float32,
                        count=len(self.candidates)),
            np.asarray(new, dtype=np.float32)])
        keep = np.argsort(-self.query(cand))[:M_CAND]
        self.candidates = {float(cand[i]): True for i in keep}

    def heavy_hitters(self, k):
        cand = np.fromiter(self.candidates.keys(), dtype=np.float32)
        ests = self.query(cand)
        order = np.argsort(-ests)[:k]
        return [(float(cand[i]), float(ests[i])) for i in order]


def run_phase_m(torch, seed, kernels, CountMinSketch):
    """Phase M: the count-min sketch on the card against its numpy twin:
    counts bit-equal, the candidate map (saturated) and every heavy-hitter
    list equal, top 3 {7, 13, 99}, no estimate under its true count."""
    rng = np.random.default_rng(seed + 140)
    sk = CountMinSketch(depth=M_DEPTH, width=M_WIDTH, max_candidates=M_CAND)
    check(sk.counts.device.type == "cuda", "m: sketch is not on the card")
    twin = CmsTwin()
    true = {}
    upd_s, query_ms, hitters = 0.0, [], []
    torch.cuda.synchronize()
    kernels.reset_launches()
    for u in range(M_UPDATES):
        v = m_values(rng, ROWS)
        t = time.perf_counter()
        sk.update(v)
        torch.cuda.synchronize()
        upd_s += time.perf_counter() - t
        twin.update(v)
        vals, cnt = np.unique(v, return_counts=True)
        for x, c in zip(vals.tolist(), cnt.tolist()):
            true[x] = true.get(x, 0) + c
        if (u + 1) % M_HH_EVERY == 0:
            t = time.perf_counter()
            hh = sk.heavy_hitters(3)
            query_ms.append((time.perf_counter() - t) * 1e3)
            check(np.array_equal(sk.counts.cpu().numpy(), twin.counts),
                  f"m update {u}: counts differ from the twin's")
            check(list(sk.candidates) == list(twin.candidates),
                  f"m update {u}: candidates differ from the twin's")
            check(hh == twin.heavy_hitters(3),
                  f"m update {u}: heavy hitters {hh}")
            check({x for x, _ in hh} == {7.0, 13.0, 99.0},
                  f"m update {u}: top 3 {hh}")
            # the twin's estimates (its counts are the sketch's, bit for
            # bit), so that the check launches no kernel
            cand = np.fromiter(sk.candidates.keys(), dtype=np.float32)
            ests = twin.query(cand)
            check(all(e >= true[float(x)] for x, e in zip(cand, ests)),
                  f"m update {u}: an estimate under its true count")
            hitters.append(hh)
    launches = dict(kernels.LAUNCHES)
    check(len(sk.candidates) == M_CAND and len(true) > M_CAND,
          f"m: the candidate map did not saturate ({len(sk.candidates)} of "
          f"{len(true)} values)")
    return dict(values_per_s=M_UPDATES * ROWS / upd_s, query_ms=query_ms,
                distinct=len(true), hitters=hitters[-1],
                true_top={x: true[x] for x, _ in hitters[-1]},
                launches=launches)


def phase_m_line(r):
    return (f"phase M count-min d={M_DEPTH} w={M_WIDTH} max_candidates="
            f"{M_CAND}: {M_UPDATES} updates x {ROWS} values, "
            f"{r['distinct']} distinct (saturated), update values/s="
            f"{r['values_per_s']:.0f} heavy_hitters_ms="
            + " ".join(f"{x:.3f}" for x in r["query_ms"])
            + f" top3={r['hitters']} true={r['true_top']} counts and "
            f"candidates equal to the twin at every check "
            f"launches={nz_dict(r['launches'])}")


# -------------------------------------------------------------------- main
# ------------------------------------------------------------ phase N
def on_mesh(plan_fused_rule, dev, strategy):
    """plan_fused_rule planning every rule with planOptimizeStrategy
    `strategy` over a device list naming `dev` N_DEVICES times (the mesh
    of one card)."""
    def plan(sql, options=None, **kw):
        return plan_fused_rule(
            sql, device=[dev] * N_DEVICES,
            options={**(options or {}), "planOptimizeStrategy": strategy},
            **kw)
    return plan


def library_merge(torch, state, parts, pane, R, kernels):
    """Yardstick, never called by the port: the merge over the rows axis
    as PyTorch's own calls: sum / amin / amax over the R partials, add_ /
    minimum / maximum into the pane (every pane for a pane-vector
    partial), fill_ back to the identity; the touch counts in int64."""
    for comp, part in parts.items():
        if comp == "touch":
            t = state["touch"].long() + part.long().sum(0)
            state["touch"].copy_((t & 0xFFFFFFFF).to(torch.uint32))
            part.zero_()
            continue
        blocks = part.view(R, -1, *part.shape[1:])
        op = kernels.SHARD_OPS.get(comp, 0)
        dst = (state[comp][pane:pane + 1] if blocks.shape[1] == 1
               else state[comp])
        if op == 0:
            dst.add_(blocks.sum(0))
        elif op == 1:
            torch.minimum(dst, blocks.amin(0), out=dst)
        else:
            torch.maximum(dst, blocks.amax(0), out=dst)
        part.fill_(kernels.INIT[comp])


def shard_fold_bytes(V, M, slots, pane_vec, parts, rows_shard, P, R):
    """Bytes the sharded scalar fold must move: V, M, the row mask, the
    slots (and the pane vector) read once, each touched partial line (act
    and the scalar columns; the touch count) read and written once."""
    N = slots.shape[0]
    r = np.arange(N) // rows_shard
    p = np.zeros(N, np.int64) if pane_vec is None else pane_vec.astype(
        np.int64)
    C = parts["act"].shape[1]
    touched = len(np.unique(((r * P + p) * C) + slots))
    width = sum(a.shape[2] for k, a in parts.items()
                if k in ("n", "s1", "s2", "mn", "mx")) + 1
    nbytes = V.numel() * 4 + M.numel() + N + N * 4 + touched * width * 8
    if pane_vec is not None:
        nbytes += N
    if "touch" in parts:
        nbytes += len(np.unique(r * C + slots)) * 8
    return nbytes


def shard_merge_bytes(state, parts, R, kernels):
    """Bytes the merge must move: the R partials read once, the merged
    panes of the state read and written once, and each partial element
    that left its identity written back to it."""
    nbytes = 0
    for comp, part in parts.items():
        ident = kernels.INIT.get(comp, 0.0)
        Pp = part.shape[0] // R if comp != "touch" else 1
        per_pane = state[comp][0].numel() if comp != "touch" else \
            state[comp].numel()
        nbytes += part.numel() * 4 + 2 * Pp * per_pane * 4
        nbytes += int((part.double() != ident).sum()) * 4
    return nbytes


def sharded_kernel_checks(torch, seed, kernels, sketches, plan_fused_rule,
                          TorchGroupBy, dev):
    """#23 / #24 on the card: sharded_fold (the flagship rule with a touch
    column; I3's event-time hopping rule on its 8-pane vector; phase B's
    percentile and hll rules, each branch also on its own) and
    shard_merge of each, on a 2x4 mesh of the card at the main path's
    shapes (65,536 rows, 16,384 slots): each against its plain version
    (counts, min / max, hll, hist and touch bit-equal, the fold's sums
    rtol 1e-5; the merge of the same partials bit-equal), and the fold +
    merge against #1's single-chip fold of the same batch."""
    from ekuiper_tpu_torch.parallel.mesh import make_mesh
    from ekuiper_tpu_torch.parallel.sharded import ShardedGroupBy

    rows = {}
    R, K = N_MESH["rows"], N_MESH["keys"]
    mesh = make_mesh(R, K, [dev] * N_DEVICES)
    cases = (("flagship", TUMBLING, None, True, False),
             ("pane_vec", I3_RULE, I_OPTS, False, True),
             ("pct", PCT_RULE, None, False, False),
             ("hll", HLL_RULE, None, False, False))
    for i, (tag, sql, opts, touch, vec) in enumerate(cases):
        node = plan_fused_rule(sql, key_slots=SLOTS, micro_batch=ROWS,
                               device=dev, options=opts)
        P = node.n_panes
        gb = ShardedGroupBy(node.plan, mesh, capacity=SLOTS, n_panes=P,
                            micro_batch=ROWS, track_touch=touch)
        single = TorchGroupBy(node.plan, capacity=SLOTS, n_panes=P,
                              micro_batch=ROWS, device=dev,
                              track_touch=touch)
        node.on_close()
        r = np.random.default_rng(seed + 130 + i)
        if tag in ("pct", "hll"):
            base, V, M, s_dev, s_host = sketch_inputs(torch, gb,
                                                      seed + 130 + i, dev)
        else:
            temp = r.normal(20, 5, ROWS).astype(np.float32)
            s_host = r.integers(0, N_KEYS, ROWS).astype(np.int32)
            base, V, M = gb.spec_inputs(
                {"temperature": torch.from_numpy(temp).to(dev)}, ROWS)
            s_dev = torch.from_numpy(s_host).to(dev)
        pv_host = r.integers(0, P, ROWS).astype(np.uint8) if vec else None
        pv = None if pv_host is None else torch.from_numpy(pv_host).to(dev)
        pane, m = P - 1, gb.rows_per_shard
        Pp = P if vec else 1
        wide = len(gb._widemap) > 0
        parts = gb._partials(Pp)
        ref = clone_state(parts)

        cmap, wmap = gb._colmap, gb._widemap

        def fold_k(dst, _pv=pv, cm=cmap, wm=wmap):
            kernels.sharded_fold(dst, base, V, M, s_dev, m, R, K, cm, wm,
                                 _pv)

        def fold_p(dst, _pv=pv):
            kernels.sharded_fold_plain(dst, base, V, M, s_dev, m, R, K, cmap,
                                       wmap, _pv)

        fold_k(parts)
        fold_p(ref)
        torch.cuda.synchronize()
        err = state_err(parts, ref, exact=EXACT + ("touch",))
        saved = clone_state(parts)
        # the fold's row, as the node calls it (every column in one
        # launch), timed into copies of the partials
        pidx = ((torch.arange(ROWS, device=dev) // m) * Pp
                + (0 if pv is None else pv.long()))
        upd = wide_updates(torch, gb, V, M, s_dev, pidx, sketches)
        lib_state = clone_state(saved)

        u_act, *u_sc = fold_updates(torch, lib_state, base, V, M, s_dev,
                                    pidx, cmap, kernels)
        lib_scalar = functools.partial(library_fold, torch, lib_state,
                                       [u_act] + u_sc)
        # act (every launch adds it) and the sketches
        lib_sketch = functools.partial(library_fold, torch, lib_state,
                                       [u_act] + upd)
        lib_all = functools.partial(library_fold, torch, lib_state,
                                    [u_act] + u_sc + upd)

        fn = functools.partial(fold_k, clone_state(saved))
        plain = functools.partial(fold_p, clone_state(saved))
        n_wide = sum(len(idx) for _, idx, _, _ in upd)
        nbytes = shard_fold_bytes(V, M, s_host, pv_host, saved, m, Pp, R)
        nbytes += sum(len(torch.unique(idx)) for _, idx, _, _ in upd) * 8
        ops = ROWS * (len(cmap) + 1) + n_wide
        t_k = time_ms(torch, fn, REPS)
        split = launch_split(torch, fn, SHARDED_FOLD_KERNEL, REPS)
        t_p = time_ms(torch, plain, REPS)
        t_l = time_ms(torch, lib_all, REPS)
        b_ms, b_by = bound(nbytes, ops)
        extra = f"cols={len(cmap)}+{len(wmap)} touch={touch}"
        branches = {}
        if wide:  # each branch on its own, beside its library call
            for branch, cm, wm, lib in (("scalar", cmap, NO_COLS, lib_scalar),
                                        ("sketch", NO_COLS, wmap, lib_sketch)):
                bfn = functools.partial(fold_k, clone_state(saved), cm=cm,
                                        wm=wm)
                branches[branch] = dict(
                    ms=time_ms(torch, bfn, REPS),
                    **launch_split(torch, bfn, SHARDED_FOLD_KERNEL, REPS),
                    library_ms=time_ms(torch, lib, REPS))
        name = "sharded_fold"
        key = name if tag == "flagship" else f"{name}/{tag}"
        print(f"kernel {key} mesh={R}x{K} P={P} pane_vec={vec} R={ROWS} "
              f"C={SLOTS} {extra}: max_abs_err={err[0]:.3g} "
              f"max_rel_err={err[1]:.3g} kernel_ms={t_k:.4f} "
              f"{split_text(split)} plain_ms={t_p:.4f} library_ms={t_l:.4f} "
              f"bound_ms={b_ms:.5f} ({b_by}) "
              + " ".join(f"{k}_only: kernel_ms={v['ms']:.4f} "
                         f"{split_text(v)} library_ms={v['library_ms']:.4f}"
                         for k, v in branches.items()))
        rows[key] = dict(max_abs_err=err[0], max_rel_err=err[1], ms=t_k,
                         **split, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                         library_ms=t_l, **({"branches": branches}
                                            if branches else {}))

        # the merge: the same partials through the kernel and the plain
        # version, bit-equal; then the fold + merge against #1's fold
        st_k, st_p = gb.init_state(), gb.init_state()
        plain_in = clone_state(saved)
        kernels.shard_merge(st_k, parts, pane, R)
        kernels.shard_merge_plain(st_p, plain_in, pane, R)
        torch.cuda.synchronize()
        merr = state_err(st_k, st_p, exact=tuple(st_k))
        state_err(parts, plain_in, exact=tuple(parts))  # back at identity
        st_1 = single.init_state()
        kernels.groupby_fold(st_1, base, V, M, s_dev, pane, single._colmap,
                             single._widemap, pv)
        torch.cuda.synchronize()
        err1 = state_err(st_k, st_1, exact=EXACT + ("touch",))
        nbytes = shard_merge_bytes(st_k, saved, R, kernels)

        def restore(dst):
            for k, t in dst.items():
                t.copy_(saved[k])

        lib_parts = clone_state(saved)
        lib_state = gb.init_state()
        fn = functools.partial(kernels.shard_merge, st_k, parts, pane, R)
        prep = functools.partial(restore, parts)
        t_k = time_ms(torch, fn, REPS, prep=prep)
        split = launch_split(torch, fn, "shard_merge_kernel", REPS,
                             prep=prep)
        t_p = time_ms(torch, functools.partial(
            kernels.shard_merge_plain, st_p, plain_in, pane, R), REPS,
            prep=functools.partial(restore, plain_in))
        t_l = time_ms(torch, functools.partial(
            library_merge, torch, lib_state, lib_parts, pane, R, kernels),
            REPS, prep=functools.partial(restore, lib_parts))
        b_ms, b_by = bound(nbytes, 0)
        mkey = "shard_merge" if tag == "flagship" else f"shard_merge/{tag}"
        print(f"kernel {mkey} mesh={R}x{K} P={P} merged_panes={Pp} "
              f"C={SLOTS}: max_abs_err={merr[0]:.3g} "
              f"vs_single_chip_fold max_abs_err={err1[0]:.3g} "
              f"max_rel_err={err1[1]:.3g} kernel_ms={t_k:.4f} "
              f"{split_text(split)} plain_ms={t_p:.4f} library_ms={t_l:.4f} "
              f"bound_ms={b_ms:.5f} ({b_by})")
        rows[mkey] = dict(max_abs_err=merr[0], vs_single_chip=err1[0],
                          ms=t_k, **split, plain_ms=t_p, bound_ms=b_ms,
                          bound_by=b_by, library_ms=t_l)
        del parts, ref, saved, st_k, st_p, st_1, plain_in, lib_parts
        del lib_state, gb, single
        torch.cuda.empty_cache()
    return rows


def run_n1(torch, seed, kernels, mods, dev):
    """N1: the flagship tumbling rule on a 2x4 mesh of the card and,
    beside it, single-chip, on the same batches: every window against the
    float64 twin, the two legs' windows against each other (keys, counts,
    min, max equal; avg within twice the float32 bound); rows/s and emit
    p50/p99 of each leg; the mesh leg's launches and shard_stats."""
    plan_fused_rule, ColumnBatch, Trigger = mods
    rng = np.random.default_rng(seed + 140)
    n_int, per = WINDOWS, BATCHES
    batches, idx, temp = make_batches(rng, ColumnBatch, n_int * per)
    refs = [reference_aggs(idx[w * per:(w + 1) * per],
                           temp[w * per:(w + 1) * per], N_KEYS)
            for w in range(n_int)]
    legs = {}
    for leg, plan in (("single", plan_fused_rule),
                      ("mesh", on_mesh(plan_fused_rule, dev,
                                       {"mesh": N_MESH}))):
        warm = plan(TUMBLING, key_slots=SLOTS, micro_batch=ROWS,
                    options=SYNC)
        warm.broadcast = lambda item: None
        warm.process(batches[0])
        warm.on_trigger(Trigger(ts=10_000))
        node = plan(TUMBLING, key_slots=SLOTS, micro_batch=ROWS,
                    options=SYNC)
        check(node.gb.device.type == "cuda", f"n1 {leg}: not on the card")
        emitted, emit_ms = [], []
        node.broadcast = emitted.append
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        for w in range(n_int):
            for b in batches[w * per:(w + 1) * per]:
                node.process(b)
            te = time.perf_counter()
            node.on_trigger(Trigger(ts=(w + 1) * 10_000))
            torch.cuda.synchronize()
            emit_ms.append((time.perf_counter() - te) * 1e3)
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        check(len(emitted) == n_int,
              f"n1 {leg}: {len(emitted)} windows, want {n_int}")
        worst = max(check_window(cb, refs[w], False, f"n1 {leg} window {w}")
                    for w, cb in enumerate(emitted))
        legs[leg] = dict(rows_per_s=n_int * per * ROWS / wall,
                         emit_ms=emit_ms, launches=launches,
                         max_abs_err=worst, windows=emitted, node=node)
    mesh = legs["mesh"]
    gb = mesh["node"].gb
    check(gb.mesh_tag == "2x4" and mesh["node"].shard_info["mode"]
          == "sharded", "n1: the rule is not on the 2x4 mesh")
    n_b = n_int * per
    c = mesh["launches"]
    check(c["sharded_fold"] == n_b and c["shard_merge"] == n_b
          and c["groupby_fold"] == 0,
          f"n1: launches {c['sharded_fold']} sharded folds, "
          f"{c['shard_merge']} merges, {c['groupby_fold']} #1 folds "
          f"(want {n_b}, {n_b}, 0)")
    check(legs["single"]["launches"]["sharded_fold"] == 0,
          "n1: the single-chip leg launched a sharded fold")
    vs = max(check_same_window(a, b, refs[w], f"n1 window {w}",
                               "the single-chip leg's")
             for w, (a, b) in enumerate(zip(mesh["windows"],
                                            legs["single"]["windows"])))
    stats = gb.shard_stats(mesh["node"].state)
    check(sum(x["rows"] for x in stats) == n_b * ROWS,
          "n1: shard_stats rows do not add up to the rows folded")
    for leg in legs.values():
        leg["node"].on_close()
        del leg["node"]
    return dict(legs=legs, vs_single=vs, stats=stats,
                batches=(batches, idx, temp, refs))


def run_n2(torch, kernels, mods, dev, n1):
    """N2: N1's rule and batches, windows 1-3 on 2x4, a snapshot restored
    on a single-chip node for window 4, its snapshot restored on a rule
    planned with shards 8 (1x8) for windows 5 and 6: every window against
    the twin and against N1's mesh window."""
    plan_fused_rule, ColumnBatch, Trigger = mods
    batches, _, _, refs = n1["batches"]
    per = BATCHES
    plans = (on_mesh(plan_fused_rule, dev, {"mesh": N_MESH}),
             plan_fused_rule, on_mesh(plan_fused_rule, dev, {"shards": 8}))
    spans = ((0, 3), (3, 4), (4, 6))
    got, node, tags = [], None, []
    kernels.reset_launches()
    for plan, (lo, hi) in zip(plans, spans):
        nxt = plan(TUMBLING, key_slots=SLOTS, micro_batch=ROWS, options=SYNC)
        if node is not None:
            nxt.restore_state(node.snapshot_state())
            check(nxt.kt.n_keys == node.kt.n_keys, "n2: keys lost")
            node.on_close()
        node = nxt
        tags.append(getattr(node.gb, "mesh_tag", "single"))
        node.broadcast = got.append
        for w in range(lo, hi):
            for b in batches[w * per:(w + 1) * per]:
                node.process(b)
            node.on_trigger(Trigger(ts=(w + 1) * 10_000))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    node.on_close()
    check(tags == ["2x4", "single", "1x8"], f"n2: legs {tags}")
    check(len(got) == 6, f"n2: {len(got)} windows, want 6")
    worst = vs = 0.0
    for w, cb in enumerate(got):
        worst = max(worst, check_window(cb, refs[w], False,
                                        f"n2 window {w}"))
        vs = max(vs, check_same_window(cb, n1["legs"]["mesh"]["windows"][w],
                                       refs[w], f"n2 window {w}",
                                       "N1's mesh window"))
    return dict(max_abs_err=worst, vs_n1=vs, legs=tags, launches=launches)


def run_phase_n(torch, seed, kernels, sketches, mods, TorchGroupBy, dev):
    """Phase N: the device mesh (#23, #24) on one card."""
    t0 = time.perf_counter()
    plan_fused_rule = mods[0]
    out = {"rows": sharded_kernel_checks(torch, seed, kernels, sketches,
                                         plan_fused_rule, TorchGroupBy, dev)}
    out["kernel_s"] = time.perf_counter() - t0
    mesh_mods = (on_mesh(plan_fused_rule, dev, {"mesh": N_MESH}),
                 *mods[1:])
    n1 = run_n1(torch, seed, kernels, mods, dev)
    out["n1"] = n1
    out["n2"] = run_n2(torch, kernels, mods, dev, n1)
    del n1["batches"]
    # N3: phase B's sketch rules on 2x4, 3 windows (hop boundaries) each
    out["n3"] = run_wide_rules(torch, seed, kernels, mesh_mods,
                               windows=N3_WINDOWS)
    for tag in ("pct", "hll"):
        c = out["n3"][tag]["launches"]
        check(c["sharded_fold"] > 0 and c["groupby_fold"] == 0,
              f"n3 {tag}: not folded through the sharded kernels ({c})")
    # N4: I3, the event-time hopping rule (2 s buckets), on 2x4
    s4 = EventStream(seed + 141, I_BATCHES["i3"])
    out["n4"] = run_i_flagship(torch, "N4", s4, I3_RULE, 10_000, 2_000,
                               kernels, mesh_mods)
    del s4
    check(out["n4"]["row_pane"]["sharded_fold"] > 0
          and out["n4"]["launches"]["groupby_fold"] == 0,
          "n4: no sharded pane-vector fold (#24)")
    # N5: D2's sliding rule on 2x4: the refold path, host-row edge refolds
    rng = np.random.default_rng(seed + 142)
    stream = SlidingStream(rng, N5_BATCHES)

    def fallback(node):
        check(node.sliding_fallback == "sharded_kernel",
              f"n5: fallback {node.sliding_fallback}")

    node, em, rps, launches, row_pane = run_sliding(
        torch, kernels, mesh_mods, D2_RULE, stream, "n5", impl="refold",
        sources=("device-async",), hook=fallback)
    t_check = time.perf_counter()
    twin = ScalarTwin(stream)
    worst = 0.0
    for i, (t, received, _, _, cb, _) in enumerate(em):
        a, b = stream.rows(t - node.length_ms, t, received)
        worst = max(worst, check_window(cb, twin.window(a, b), False,
                                        f"n5 trigger {i} (t={t})"))
    res = refold_result(node, em, rps, launches, row_pane, stream, t_check)
    check(res["triggers"] == res["want_triggers"],
          f"n5: {res['triggers']} triggers, {res['want_triggers']} rows")
    check(launches["groupby_fold_masked"] == 0
          and launches["groupby_fold"] == 0
          and launches["sharded_fold"] > 0
          and res["routes"]["cached"] == 0 and res["routes"]["host"] > 0,
          f"n5: refolds not from host rows through the sharded fold "
          f"({res['routes']}, {launches})")
    res.update(max_abs_err=worst)
    out["n5"] = res
    del node, em, twin, stream
    torch.cuda.empty_cache()
    # shards "auto" over the default device list (every visible card)
    auto = plan_fused_rule(TUMBLING, key_slots=SLOTS, micro_batch=ROWS,
                           options={"planOptimizeStrategy": {"shards":
                                                             "auto"}})
    out["auto"] = auto.shard_info
    check(auto.shard_info["mode"] == ("sharded" if torch.cuda.device_count()
                                      > 1 else "single-chip"),
          f"shards auto: {auto.shard_info}")
    auto.on_close()
    out["wall"] = time.perf_counter() - t0
    return out


def phase_n_lines(n):
    legs = n["n1"]["legs"]
    lines = [
        f"phase N kernel rows: {n['kernel_s']:.1f} s",
        *(f"phase N1 {leg}: {WINDOWS} windows x {BATCHES} batches x "
          f"{ROWS} rows, {N_KEYS} keys: rows/s={r['rows_per_s']:.0f} "
          f"emit_p50_ms={pct(r['emit_ms'], 50):.3f} "
          f"emit_p99_ms={pct(r['emit_ms'], 99):.3f} "
          f"max_abs_err={r['max_abs_err']:.3g} launches={r['launches']}"
          for leg, r in legs.items()),
        f"phase N1 mesh vs single-chip: max avg diff {n['n1']['vs_single']:.3g}"
        f"; shard_stats " + " ".join(
            f"k{x['shard']}:rows={x['rows']},keys={x['keys']}"
            for x in n["n1"]["stats"]),
        f"phase N2 2x4 -> single-chip -> 1x8 ({n['n2']['legs']}): 6 windows "
        f"max_abs_err={n['n2']['max_abs_err']:.3g} vs N1 max avg diff "
        f"{n['n2']['vs_n1']:.3g} launches={n['n2']['launches']}",
    ]
    for tag in ("pct", "hll"):
        r = n["n3"][tag]
        lines.append(f"phase N3 {tag} on 2x4: {r['rows']} rows against the "
                     f"twin ({r['edge_rows']} one bin over at an edge) "
                     f"emit_p50_ms={pct(r['emit_ms'], 50):.3f} "
                     f"launches={r['launches']}")
    r = n["n4"]
    lines.append(f"phase N4 I3 on 2x4: rows/s={r['rows_per_s']:.0f} "
                 f"windows={r['windows']} panes={r['n_panes']} "
                 f"vector_folds={r['vector_folds']} "
                 f"scalar_folds={r['scalar_folds']} "
                 f"emit_p50_ms={r['emit_p50']:.3f} "
                 f"emit_p99_ms={r['emit_p99']:.3f} "
                 f"max_abs_err={r['max_abs_err']:.3g} "
                 f"pane_vec_folds={r['row_pane']} launches={r['launches']}")
    r = n["n5"]
    lines.append(f"phase N5 D2 on 2x4: fallback={r['fallback']} "
                 f"rows/s={r['rows_per_s']:.0f} triggers={r['triggers']} "
                 f"stall_p50_ms={pct(r['stall'], 50):.3f} "
                 f"stall_p99_ms={pct(r['stall'], 99):.3f} "
                 f"delivery_p50_ms={pct(r['delivery'], 50):.3f} "
                 f"delivery_p99_ms={pct(r['delivery'], 99):.3f} "
                 f"routes={r['routes']} max_abs_err={r['max_abs_err']:.3g} "
                 f"pane_vec_folds={r['row_pane']} launches={r['launches']}")
    lines.append(f"phase N shards auto on the default device list: "
                 f"{json.dumps(n['auto'])}")
    lines.append(f"phase N: {n['wall']:.1f} s")
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the generated rows")
    args = ap.parse_args()
    t_run = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a card",
              file=sys.stderr)
        return 1
    from ekuiper_tpu_torch.data.batch import ColumnBatch
    from ekuiper_tpu_torch.ops import kernels, prefinalize, sketches
    from ekuiper_tpu_torch.ops.groupby import TorchGroupBy
    from ekuiper_tpu_torch.ops.sketches import CountMinSketch
    from ekuiper_tpu_torch.planner.fused import plan_fused_rule
    from ekuiper_tpu_torch.planner.planner import plan_host_rule
    from ekuiper_tpu_torch.planner.rulegroup import plan_rule_group
    from ekuiper_tpu_torch.runtime.events import Trigger
    from ekuiper_tpu_torch.runtime.node import Node

    # phase 1: the card and the build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)  # the card's name and power limit, as nvidia-smi gives them
    print(f"phase 1 card: {smi}")
    kernels.build_library()
    print(f"phase 1 build: {' '.join(sorted(set(SOURCE.values())))} nvcc "
          f"{' '.join(kernels.NVCC_FLAGS)} in {kernels.build_seconds:.2f} s "
          "(one nvcc per source, run together)")

    # phase 2: each kernel against its plain version
    dev = torch.device("cuda")
    rows = kernel_checks(torch, args.seed, kernels, plan_fused_rule, dev)
    fold_trace = fold_launch_trace(torch, args.seed, kernels,
                                   plan_fused_rule, dev)
    rows.update(sketch_kernel_checks(torch, args.seed, kernels, sketches,
                                     plan_fused_rule, TorchGroupBy, dev))
    rows.update(prefinalize_kernel_checks(torch, args.seed, kernels,
                                          plan_fused_rule, dev))
    rows.update(ring_kernel_checks(torch, args.seed, kernels,
                                   plan_fused_rule, dev))
    rows.update(group_kernel_checks(torch, args.seed, kernels,
                                    plan_rule_group, dev))
    rows.update(wide_group_kernel_checks(torch, args.seed, kernels, sketches,
                                         plan_rule_group, dev))
    rows.update(masked_kernel_checks(torch, args.seed, kernels, sketches,
                                     plan_fused_rule, TorchGroupBy, dev))
    rows.update(tier_kernel_checks(torch, args.seed, kernels,
                                   plan_fused_rule, dev))
    rows.update(event_group_kernel_checks(torch, args.seed, kernels,
                                          sketches, dev))
    rows.update(relational_kernel_checks(torch, args.seed, kernels, dev))
    rows.update(masked_touch_check(torch, args.seed, kernels,
                                   plan_fused_rule, TorchGroupBy, dev))
    rows.update(countmin_kernel_checks(torch, args.seed, kernels, dev))
    print(f"phase 2 kernels vs plain: ok (wall {time.perf_counter() - t_run:.0f} s)")

    mods = (plan_fused_rule, ColumnBatch, Trigger)
    # phase 3: end to end, tumbling (the main path)
    counts_t, rps, emit_ms, err, st = run_rule(torch, args.seed, TUMBLING,
                                               10_000, 1, kernels, mods)
    n_b = WINDOWS * BATCHES
    print(f"phase 3 tumbling: {WINDOWS} windows x {BATCHES} "
          f"batches x {ROWS} rows, {N_KEYS} keys: rows/s={rps:.0f} "
          f"emit_p50_ms={pct(emit_ms, 50):.3f} "
          f"emit_p99_ms={pct(emit_ms, 99):.3f} max_abs_err={err:.3g} "
          f"host_ms_per_batch encode={st['encode'] / n_b * 1e3:.3f} "
          f"fold={st['fold'] / n_b * 1e3:.3f} launches={counts_t}")
    # phase 4: end to end, hopping (2 panes)
    counts_h, rps, emit_ms, err, st = run_rule(torch, args.seed, HOPPING,
                                               5_000, 2, kernels, mods)
    print(f"phase 4 hopping: {WINDOWS} windows x {BATCHES} "
          f"batches per 5 s slide x {ROWS} rows, {N_KEYS} keys: "
          f"rows/s={rps:.0f} emit_p50_ms={pct(emit_ms, 50):.3f} "
          f"emit_p99_ms={pct(emit_ms, 99):.3f} max_abs_err={err:.3g} "
          f"host_ms_per_batch encode={st['encode'] / n_b * 1e3:.3f} "
          f"fold={st['fold'] / n_b * 1e3:.3f} launches={counts_h}")

    # phase A: heavy hitters (BASELINE config #2)
    counts_hh, a = run_hh_rule(torch, args.seed, kernels, mods)
    print(f"phase A heavy hitters: {SKETCH_WINDOWS} hop boundaries x "
          f"{SKETCH_BATCHES} batches x {ROWS} rows, {N_KEYS} keys, state "
          f"2048 -> {SLOTS} slots: {a['rows']} rows checked against the "
          f"numpy twin, 7 leads {a['led_by_7']} of {a['rows']} lists "
          f"({a['led_by_7'] / a['rows']:.4%}), rows/s={a['rows_per_s']:.0f} "
          f"emit_p50_ms={pct(a['emit_ms'], 50):.3f} "
          f"emit_p99_ms={pct(a['emit_ms'], 99):.3f} launches={counts_hh}")
    st = a["stages"]
    print(f"phase A host ms per batch: encode={st['encode']:.3f} "
          f"fold={st['fold']:.3f}; per boundary: finalize="
          f"{st['finalize']:.3f} (hh_assemble {st['assemble']:.3f}) "
          f"decode={st['decode']:.3f}; emit ms by boundary: "
          + " ".join(f"{x:.1f}" for x in a["emit_ms"])
          + f"; device busy share over the last interval "
          f"(profiled): {a['busy']:.4f}")
    # phase B: the wide finalize (percentile tumbling, hll hopping)
    b = run_wide_rules(torch, args.seed, kernels, mods)
    print(f"phase B percentile_approx: {b['pct']['rows']} rows, each in the "
          f"twin's bin ({b['pct']['edge_rows']} one bin over at a bin edge); "
          f"mean rel err vs np.quantile {b['pct']['sketch_err']:.4f}; "
          f"emit_p50_ms={pct(b['pct']['emit_ms'], 50):.3f} "
          f"launches={b['pct']['launches']}")
    print(f"phase B hll: {b['hll']['rows']} rows within ±1 of the twin; "
          f"mean rel err vs exact distinct {b['hll']['sketch_err']:.4f}; "
          f"emit_p50_ms={pct(b['hll']['emit_ms'], 50):.3f} "
          f"launches={b['hll']['launches']} "
          f"(wall {time.perf_counter() - t_run:.0f} s)")

    # phase C: the reference's default boundary on the mock clock
    c = run_phase_c(torch, args.seed, kernels, prefinalize, mods)
    print(f"phase C: {WINDOWS} windows x {BATCHES} batches x {ROWS} rows, "
          f"{N_KEYS} keys, {SLOTS} slots, prefinalizeLeadMs 250, every "
          "emitted row checked against its reference")
    for tag in c:
        print(phase_c_line(tag, c[tag]))
    print(f"phase C checks: C1/C2 max_abs_err "
          f"{max(c[t]['max_abs_err'] for t in ('c1', 'c1_nobackstop', 'c1_host', 'c2')):.3g}; "
          f"C1 host tail snapshot partials vs the lead-0 twin max abs diff "
          f"{c['c1_host']['absorb_partials_err']:.3g}; C3 pct "
          f"{c['c3_pct']['rows']} rows ({c['c3_pct']['edge_rows']} one bin "
          f"over at an edge), hll {c['c3_hll']['rows']} rows within ±1; C4 "
          f"{c['c4_hh']['rows']} top lists equal to the twin "
          f"(wall {time.perf_counter() - t_run:.0f} s)")

    # phase D: sliding rules on the DABA ring, mock clock, full size
    d = run_phase_d(torch, args.seed, kernels, mods)
    print(f"phase D: 65536-row batches of 62.5 ms, {N_KEYS} keys, {SLOTS} "
          f"slots, a trigger row in every {TRIGGER_EVERY}th batch; every "
          "emitted window checked against its numpy reference")
    for tag in d:
        print(phase_d_line(tag, d[tag]))
    print(f"phase D checks: D2 max_abs_err "
          f"{max(d[t]['max_abs_err'] for t in ('d2', 'd2_delay')):.3g}; D1 "
          f"{d['d1']['edge']} percentiles one bin over at an edge; D3 "
          f"{d['d3']['edge']} estimates off by one (wall "
          f"{time.perf_counter() - t_run:.0f} s)")

    # phase E: rule groups (BASELINE config #5), mock clock, full size
    e = run_phase_e(torch, args.seed, kernels, plan_rule_group, ColumnBatch)
    print(f"phase E: E1 {E1_RULES} rules x {E_WINDOWS['e1']} tumbling "
          f"windows, E3 the same rules x {E_WINDOWS['e3']} hop slides "
          f"({BATCHES} batches x {ROWS} rows, {N_KEYS} keys, {SLOTS} "
          f"slots); E2 four families x {E2_RULES} rules x "
          f"{E_WINDOWS['e2']} windows ({BATCHES} batches x {E2_ROWS} rows, "
          f"{E2_KEYS} keys); every rule's every window checked against a "
          "numpy float64 group-by of the rows passing its WHERE")
    for tag in e:
        print(group_line(tag, e[tag]))
    e2 = [e[f"e2_{fam}"] for fam, *_ in E2_FAMILIES]
    print(f"phase E checks: E1 {e['e1']['rows_checked']} rows, E2 "
          f"{sum(r['rows_checked'] for r in e2)} rows, E3 "
          f"{e['e3']['rows_checked']} rows; max abs err "
          f"{max(r['max_abs_err'] for r in e.values()):.3g}; E2 all four "
          f"families rule_rows/s={sum(r['rule_rows_per_s'] for r in e2):.0f} "
          f"(wall {time.perf_counter() - t_run:.0f} s)")

    # phase F: the sliding refold path, mock clock, full size
    f = run_phase_f(torch, args.seed, kernels, mods)
    print(f"phase F: {F_BATCHES} batches of 65536 rows, 62.5 ms each, "
          f"{N_KEYS} keys, {SLOTS} slots, a trigger row in every "
          f"{TRIGGER_EVERY}th batch; every emitted window checked against "
          "its numpy twin")
    for tag in ("f1", "f2", "f3", "f4"):
        print(phase_f_line(tag, f[tag]))
    print(f"phase F checks: F1 {f['f1']['checked_rows']} top lists equal "
          f"to the twin; F2 max_abs_err {f['f2']['max_abs_err']:.3g}, "
          f"against D2's DABA windows max avg diff {f['f2']['vs_daba']:.3g};"
          f" F3 {f['f3']['edge']} estimates off by one, refold routes "
          f"{f['f3']['routes']}; F4 max_abs_err {f['f4']['max_abs_err']:.3g}"
          f", refold routes {f['f4']['routes']} "
          f"(wall {time.perf_counter() - t_run:.0f} s)")

    # phase G: tiered key state (G1 the key-cardinality bench, G2 spills
    # and promotions), full size
    g = run_phase_g(torch, args.seed, kernels, mods)
    for line in phase_g_lines(g):
        print(line)
    print(f"phase G: wall {time.perf_counter() - t_run:.0f} s")

    # phase H: the count, session and state windows (H1 BASELINE config
    # #4) and the sketch rule groups, full size
    h = run_phase_h(torch, args.seed, kernels, mods, plan_rule_group)
    for line in phase_h_lines(h):
        print(line)
    print(f"phase H: wall {time.perf_counter() - t_run:.0f} s")

    # phase I: event time (watermarks, late drop, bucket-routed panes,
    # sessions, groups with the per-row pane vector, tiering), full size
    i = run_phase_i(torch, args.seed, kernels, mods)
    for line in phase_i_lines(i):
        print(line)
    print(f"phase I: wall {time.perf_counter() - t_run:.0f} s")

    # phase J: interval joins (J1 the match leg, J2 the full rule through
    # plan_host_rule, J3 16,384 rows a side)
    j = run_phase_j(torch, args.seed, kernels, plan_host_rule, ColumnBatch,
                    Node)
    for line in phase_j_lines(j):
        print(line)
    # phase K: lag (K1) and rank / dense_rank / lead (K2)
    k = run_phase_k(torch, args.seed, kernels, plan_host_rule, ColumnBatch,
                    Node)
    for line in phase_k_lines(k):
        print(line)
    print(f"phase J, K: wall {time.perf_counter() - t_run:.0f} s")

    # phase L: tiered sliding rules (L1 the DABA ring, L2 the refold path)
    # on a churning fleet, full size
    t_l = time.perf_counter()
    el = run_phase_l(torch, args.seed, kernels, mods)
    for tag in ("l1", "l2"):
        print(phase_l_line(tag, el[tag]))
    print(f"phase L checks: every window against the float64 twin, max "
          f"abs err {max(el[t]['max_abs_err'] for t in el):.3g}; the "
          f"twin's build {el['l1']['twin_s']:.1f} s; phase L "
          f"{time.perf_counter() - t_l:.1f} s "
          f"(wall {time.perf_counter() - t_run:.0f} s)")
    # phase M: the count-min sketch, full size
    t_m = time.perf_counter()
    m = run_phase_m(torch, args.seed, kernels, CountMinSketch)
    print(phase_m_line(m))
    print(f"phase M: {time.perf_counter() - t_m:.1f} s "
          f"(wall {time.perf_counter() - t_run:.0f} s)")
    # phase N: the device mesh (#23, #24) on a 2x4 mesh of the card: the
    # kernel rows, N1-N5, shards auto
    n = run_phase_n(torch, args.seed, kernels, sketches, mods, TorchGroupBy,
                    dev)
    rows.update(n["rows"])
    for line in phase_n_lines(n):
        print(line)
    print(f"phase N: wall {time.perf_counter() - t_run:.0f} s")

    # phase 5: every kernel launched on each path that uses it
    paths = {"tumbling": counts_t, "hopping": counts_h, "hh": counts_hh,
             "pct": b["pct"]["launches"], "hll": b["hll"]["launches"],
             **{tag: c[tag]["launches"] for tag in c},
             **{tag: d[tag]["launches"] for tag in d},
             # E2's four family nodes share one run and its counts
             "e1": e["e1"]["launches"], "e2": e["e2_fa"]["launches"],
             "e3": e["e3"]["launches"],
             **{tag: f[tag]["launches"] for tag in f},
             **{tag: g[tag]["launches"] for tag in ("g1", "g2a", "g2b")},
             **{tag: h[tag]["launches"] for tag in ("h1", "h2", "h3", "h4",
                                                    "h5_hll", "h5_pct",
                                                    "h6")},
             **{tag: i[tag]["launches"] for tag in ("i1", "i2", "i3", "i4",
                                                    "i5", "i6", "i7")},
             "j1": j["j1"]["launches"], "j3": j["j3"]["launches"],
             **{f"j2_{jt.lower()}": j["j2"][jt]["launches"]
                for jt in J2_TYPES},
             "k1": k["k1"]["launches"], "k2": k["k2"]["launches"],
             "l1": el["l1"]["launches"], "l2": el["l2"]["launches"],
             "m": m["launches"],
             "n1": n["n1"]["legs"]["mesh"]["launches"],
             "n2": n["n2"]["launches"],
             "n3_pct": n["n3"]["pct"]["launches"],
             "n3_hll": n["n3"]["hll"]["launches"],
             "n4": n["n4"]["launches"], "n5": n["n5"]["launches"]}
    for name, used_by in PATHS.items():
        for path in used_by:
            check(paths[path][name] > 0,
                  f"{name} was not launched on the {path} path")
    sliding = {**d, **f, **{tag: i[tag] for tag in ("i2", "i3", "i5",
                                                    "i6")}, **el,
               "n4": n["n4"]}
    for name, used_by in ROW_PANE_PATHS.items():
        for path in used_by:
            check(sliding[path]["row_pane"][name] > 0,
                  f"{name} took no per-row pane vector on the {path} path")
    touch = {tag: g[tag]["touch_launches"] for tag in ("g1", "g2a", "g2b")}
    touch["i7"] = i["i7"]["touch_launches"]
    touch.update({tag: el[tag]["touch_launches"] for tag in el})
    for name, used_by in TOUCH_PATHS.items():
        for path in used_by:
            check(touch[path][name] > 0,
                  f"{name} bumped no touch column on the {path} path")
    print("phase 5 kernels: " + " ".join(
        f"{n}=" + "+".join(f"{paths[p][n]}({p})" for p in PATHS[n])
        for n in PATHS))
    main_row = {"groupby_finalize_wide": "groupby_finalize_wide/pct/full",
                "groupby_hh_finalize": "groupby_hh_finalize/full",
                "groupby_components": "groupby_components/tumbling/full",
                "groupby_absorb": "groupby_absorb/tumbling",
                "ring_advance": "ring_advance/pct",
                "ring_flip": "ring_flip/pct",
                "ring_query": "ring_query/pct",
                "tier_demote": "tier_demote/g1",
                "tier_promote": "tier_promote/g2",
                "multirule_fold_wide": "multirule_fold_wide/hll",
                "multirule_finalize_wide": "multirule_finalize_wide/hll",
                "join_match": "join_match/2048",
                "segscan_shift": "segscan_shift/8192",
                "segscan_sort": "segscan_sort/65536",
                "cms_query": "cms_query/4096"}
    main_path = {"groupby_finalize_wide": "pct",
                 "groupby_hh_finalize": "hh", "groupby_components": "c1",
                 "groupby_absorb": "c1_host", "ring_advance": "d1",
                 "ring_flip": "d1", "ring_query": "d1",
                 "multirule_fold": "e1", "multirule_fold_order": "e1",
                 "multirule_finalize": "e1",
                 "multirule_reset_pane": "e1",
                 "groupby_fold_masked": "f2",
                 "tier_demote": "g1", "tier_promote": "g2a",
                 "multirule_fold_wide": "h5_hll",
                 "multirule_finalize_wide": "h5_hll",
                 "join_match": "j2_inner", "segscan_shift": "k1",
                 "segscan_sort": "k2", "cms_update": "m", "cms_query": "m",
                 "sharded_fold": "n1", "shard_merge": "n1"}
    table = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE[name],
         "replaces": REPLACES[name],
         "launches": paths[main_path.get(name, "tumbling")][name],
         "launches_by_path": {p: paths[p][name] for p in PATHS[name]},
         **rows[main_row.get(name, name)]}
        for name in PATHS]}
    entry = {k["name"]: k for k in table["kernels"]}
    # #1 as the node calls it on each rule, besides the tumbling one
    for tag in ("hopping", "hh", "pct", "hll", "mixed"):
        entry["groupby_fold"][f"{tag}_rule"] = rows[f"groupby_fold/{tag}"]
    entry["groupby_reset_pane"]["wide_state"] = rows["groupby_reset_pane/hh"]
    entry["groupby_finalize_wide"]["hll_hopping"] = rows[
        "groupby_finalize_wide/hll/full"]
    entry["groupby_components"]["hopping_subset"] = rows[
        "groupby_components/hopping/subset[1]"]
    entry["groupby_components"]["percentile"] = rows[
        "groupby_components/pct/full"]
    entry["groupby_components"]["hll_hopping"] = rows[
        "groupby_components/hll/full"]
    entry["groupby_absorb"]["percentile"] = rows["groupby_absorb/pct"]
    # the folds with a per-row pane vector (the sliding paths)
    # (and #15's per-row pane vector, the event-time groups)
    for name in ("groupby_fold", "multirule_fold", "multirule_fold_wide",
                 "multirule_fold_order"):
        entry[name]["pane_vec"] = dict(
            rows[f"{name}/pane_vec"], launches_by_path={
                p: sliding[p]["row_pane"][name]
                for p in ROW_PANE_PATHS[name]})
    entry["groupby_fold"]["pane_vec_pct"] = rows["groupby_fold/pane_vec_pct"]
    for name in ("ring_advance", "ring_flip", "ring_query"):
        entry[name]["scalar_rule"] = rows[f"{name}/scalar"]
        entry[name]["hll_rule"] = rows[f"{name}/hll"]
    # #15 on skewed slots: Zipf-skewed, one slot taking every row
    for tag in ("zipf", "one_slot"):
        entry["multirule_fold"][tag] = rows[f"multirule_fold/{tag}"]
    entry["multirule_finalize"]["hopping_subset"] = rows[
        "multirule_finalize/hopping_subset"]
    # #2 on F1's heavy_hitters and F3's hll rules, and a stale refold's
    # group of segments in one launch
    for tag in ("hh", "hll"):
        entry["groupby_fold_masked"][f"{tag}_rule"] = rows[
            f"groupby_fold_masked/{tag}"]
    entry["groupby_fold_masked"]["segments"] = rows[
        "groupby_fold_masked/segments"]
    # #1's touch branch (tiered key state), launched on the G paths
    entry["groupby_fold"]["touch"] = dict(
        rows["groupby_fold/touch"], launches_by_path={
            p: touch[p]["groupby_fold"] for p in TOUCH_PATHS["groupby_fold"]})
    for name in ("tier_demote", "tier_promote"):
        for tag in ("g1", "g2", "hll", "pct"):
            if f"{name}/{tag}" != main_row[name]:
                entry[name][f"{tag}_state"] = rows[f"{name}/{tag}"]
    # the sketch groups: the percentile family's runs, and the pane reset
    # over wide state
    for name in ("multirule_fold_wide", "multirule_finalize_wide"):
        entry[name]["pct_family"] = rows[f"{name}/pct"]
    entry["multirule_reset_pane"]["hll_family"] = rows[
        "multirule_reset_pane/hll"]
    entry["multirule_reset_pane"]["pct_family"] = rows[
        "multirule_reset_pane/pct"]
    # the relational tier: #20 at J3's shape, #21 at 131,072 rows (uniform
    # and Zipf-skewed slots) and both with one segment
    entry["join_match"]["at_16384"] = rows["join_match/16384"]
    entry["segscan_shift"]["at_131072"] = rows["segscan_shift/131072"]
    entry["segscan_shift"]["zipf"] = rows["segscan_shift/zipf"]
    entry["segscan_shift"]["one_segment"] = rows["segscan_shift/one_segment"]
    entry["segscan_sort"]["one_segment"] = rows["segscan_sort/one_segment"]
    # #2's touch branch (tiered sliding rules), launched on the refold path
    entry["groupby_fold_masked"]["touch"] = dict(
        rows["groupby_fold_masked/touch"], launches_by_path={
            p: touch[p]["groupby_fold_masked"]
            for p in TOUCH_PATHS["groupby_fold_masked"]})
    entry["cms_query"]["at_8192"] = rows["cms_query/8192"]
    # #10 on a uniform stream
    entry["cms_update"]["uniform"] = rows["cms_update/uniform"]
    # the mesh (#23, #24): the pane vector's fold and merge (N4), the
    # sketch rules' folds and merges
    entry["sharded_fold"]["pane_vec"] = dict(
        rows["sharded_fold/pane_vec"], launches_by_path={
            p: sliding[p]["row_pane"]["sharded_fold"]
            for p in ROW_PANE_PATHS["sharded_fold"]})
    for tag in ("pct", "hll"):
        entry["sharded_fold"][f"{tag}_rule"] = rows[f"sharded_fold/{tag}"]
    for tag in ("pane_vec", "pct", "hll"):
        entry["shard_merge"][f"{tag}_rule" if tag != "pane_vec"
                             else tag] = rows[f"shard_merge/{tag}"]
    # one kernel launch a fold chunk, for every mix of columns (the trace)
    entry["groupby_fold"]["launches_a_chunk"] = fold_trace["groupby_fold"]
    entry["sharded_fold"]["launches_a_chunk"] = fold_trace["sharded_fold"]
    check(len(table["kernels"]) == 26 and len(entry) == 26, "kernel table")
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except (SmokeFailure, ImportError, RuntimeError,
            subprocess.CalledProcessError, OSError) as exc:
        print(f"chip_smoke FAILED: {type(exc).__name__}: {exc}",
              file=sys.stderr)
        sys.exit(1)
