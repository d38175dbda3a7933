"""The port's CUDA kernels: their build, the wrappers that launch them, their
plain PyTorch versions and their launch counts.

Twenty-four kernels, written by hand in CUDA C++ for Hopper, each
replacing one device program of the reference (the fold's two: #1 and
the masked fold #2, one kernel behind two wrappers), and one helper kernel
that replaces none (the rule group's row order) (ekuiper_tpu/ops/groupby.py,
ekuiper_tpu/ops/slidingring.py, ekuiper_tpu/parallel/multirule.py,
ekuiper_tpu/ops/tierstore.py, ekuiper_tpu/ops/joinring.py,
ekuiper_tpu/ops/segscan.py, ekuiper_tpu/ops/sketches.py and
ekuiper_tpu/parallel/sharded.py). Three in
ekuiper_tpu_torch/csrc/groupby.cu (the fold's body in csrc/fold.cuh):

- `groupby_fold` replaces `DeviceGroupBy._fold_impl` → `_fold_core`
  (groupby.py:348-441) in ONE launch a chunk: scatter-add of act/n/s1/s2
  and scatter-min/max of mn/mx at [pane, slot, k], the uint32 touch[slot]
  += 1 of each row past the WHERE for a state with a touch column (tiered
  key state, groupby.py:379-385), and the hll / hist / hh branches
  (419-439): per valid row an atomic max of rho into register h1 & 255,
  an atomic add into the value's log bin, or, per depth, its code's cell
  counters as float4 atomics (the hh state 16-byte aligned; a code's low
  20 bits). Rows go to one pane, or each to its own (`pane_vec`, the
  reference's uint8 per-row pane vector, groupby.py:334-338, 432-434: a
  sliding batch that crosses a bucket edge). Slots come as int32 (the
  host fold's upload) or uint16 (a cached sliding batch). The expression
  closures are evaluated by torch into dense (S, R) value/mask tensors
  first, so the kernel does no expression work. Bound on an H100: a
  65,536-row batch moves ~2 MB (the spec values and masks, slots, the
  touched state lines), 0.7 µs at 3.35 TB/s; each row also issues one
  atomic per state column, so the atomics' throughput at L2 bounds it
  instead. Design (csrc/fold.cuh): the launch's blocks take roles by index
  range (scalar, hll / hist, hh), its parameters carry the column maps by
  value; the scalar role takes a thread a row and issues one native
  float atomic a column (a sign-split integer atomic for min/max, no
  compare-and-swap loop), the count columns of a slot as float4 / float2
  atomics over their run (8 atomics a row become 5 on the tumbling rule). Owner routes (CTAs or thread-block clusters
  owning slot ranges in shared memory, no global atomic) took 4-25
  times as long at the main path's shape and are not kept
  (fold_routes.py, PERF.md).
- `groupby_fold_masked` replaces `_fold_masked_impl` (groupby.py:353-354),
  which is `_fold_core` under the refold's row mask: groupby_fold's
  kernel, counted apart, over a refold's cached, padded segments
  concatenated (ops/groupby.py fold_masked_many), base their (mb,) row
  masks ∧ WHERE, into one pane: act, the scalar, touch and sketch columns
  of a segment group in ONE launch (the sliding refold's edge folds and a
  stale window's whole refold). Bound: each segment's mask of every row,
  and the slot, values and masks of the rows its mask keeps, summed over
  the segments, with the state the group touches counted once; a row
  with mask 0 (a hole, or the padding past a batch's real rows) writes
  nothing.
- `groupby_finalize_scalar` replaces `_finalize_impl`/`_finalize_dyn_impl`
  → `_finalize_body`/`_merged`/`_final_value` (groupby.py:444-520): pane
  merge under a (P,) mask tensor, the per-spec final value, and the
  stacked (S+1, C) result with act last. Bound: it reads the merged panes
  of state and writes (S+1)·C floats, well under a microsecond at the
  card's memory rate. Design: one thread per slot does the whole merge and every spec,
  so the result is one tensor and one device-to-host copy. The mask is a
  tensor argument, so one kernel serves the full and any subset mask.
- `groupby_reset_pane` replaces `_reset_pane_impl` (groupby.py:763):
  identity into one pane of every component and act, the wide sketch
  components included. Bound: it writes one pane (C·(ΣK·W+1) floats;
  176 MB for the heavy-hitters hopping state, 0.053 ms at 3.35 TB/s).
  Design: one launch covers every component; each pane of a component is
  one contiguous run, stored grid-stride and coalesced.

And two in ekuiper_tpu_torch/csrc/sketches.cu, for the sketch
aggregates (hll, percentile_approx, heavy_hitters), whose state
components are wide: (P, C, K, W) with W = 256 / 1,024 / 2,688:

- `groupby_finalize_wide` replaces the `hll` and `percentile_approx`
  kinds of `_final_value` (groupby.py:510-519) and their pane merge:
  multirule_finalize_wide's body as a group of one rule (a warp per slot);
  it writes those specs' rows of the same output that
  groupby_finalize_scalar fills. Bound: reading the live panes of the
  wide components once.
- `groupby_hh_finalize` replaces `_hh_finalize_impl` (groupby.py:628-656)
  with `sketches.hh_candidates`: one block per slot merges the panes,
  recovers each (depth, slot) cell's code by bit majority, validates and
  estimates it, and keeps the top 2k in lax.top_k's order. Bound:
  reading the live panes of hh once (352 MB at the main path's sizes,
  0.105 ms).

And two in ekuiper_tpu_torch/csrc/prefinalize.cu, for the latency-hiding
window emit (ops/prefinalize.py):

- `groupby_components` replaces `_components_impl` / `_components_dyn_impl`
  (groupby.py:541-566): the panes under a (P,) mask tensor merged into one
  fresh (C, W) array of raw components, which the boundary fetches to the
  host ahead of time. Bound: reading the live panes and writing the result
  once (67 MB each way for the percentile rule, 0.040 ms).
- `groupby_absorb` replaces `_absorb_impl` (groupby.py:729): host-shadow
  partials merged into one pane of the state in place (min / max / add).

And three in ekuiper_tpu_torch/csrc/slidingring.cu, for the sliding
window's DABA ring (ops/slidingring.py), each one launch over a table of
every component:

- `ring_advance` replaces `SlidingRing._advance_impl` (slidingring.py:283):
  the closed pane added to and the evicted pane subtracted from the
  additive running totals, the closed pane min/max-ed into the two-stack
  components' back partials, in place. Bound: reading two panes and
  reading and writing the partials (268 MB for the percentile rule,
  0.08 ms at 3.35 TB/s).
- `ring_flip` replaces `_flip_impl` (slidingring.py:303): every running
  partial rebuilt from the live panes in age order, the additive totals as
  a masked sum, the front stacks as reverse cumulative min/max, the back
  partials reset, in place. Bound: reading R panes once (3.49 GB for the
  percentile rule, 1.04 ms).
- `ring_query` replaces `_query_impl` (slidingring.py:332): the window body
  (running partials plus at most four weighted pane slices) into a fresh
  (C, W) array in the components layout, which the trigger fetches like a
  pre-issue. Bound: reading the partials and the slices and writing the
  result (0.12 ms for the percentile rule).

And five in ekuiper_tpu_torch/csrc/multirule.cu, for a rule group (N
homogeneous rules on a leading rule axis, parallel/multirule.py), each
ONE wrapper call for every rule of the group, with the per-row and
per-slot code of the single-rule kernels (csrc/groupby_common.cuh,
csrc/sketch_common.cuh), and the folds' row order:

- `multirule_fold_order` (a helper, replacing no program of the
  reference): a chunk's rows stably sorted by pane * C + slot (the
  relational tier's radix sort, csrc/radix_sort.cuh, over the key's
  bytes only) and each key's segment of the order; the rows outside the
  state last. Built once a chunk and read by both folds. Bound: the
  slots read and the order written once (~0.6 MB at 65,536 rows).
- `multirule_fold` replaces `BatchedGroupBy._batched_fold_impl`
  (multirule.py:196), the vmap of #1 with each rule's WHERE parameters
  bound: the shared spec values and masks, each rule's row mask, into
  (R, P, C, k), one pane or each row into its own (`pane_vec`, the uint8
  per-row pane vector the vmap shares across rules, groupby.py:334-338:
  an event-time batch across bucket edges). Bound: 17.7 MB of inputs at
  the 256-rule group and the touched (rule, pane, slot) state read and
  written once. Design: each rule's WHERE bits packed 32 to a word and,
  with the spec values and masks, gathered into the order, so a key's
  rows are contiguous; one thread per (key, block of 32 rules) sums a
  short segment in registers and writes each touched (rule, pane, slot)
  once; a warp per piece of a longer segment, the pieces of a key holding
  more than one piece added by atomics.
- `multirule_fold_wide` replaces the hll / hist branches of the same vmap
  (groupby.py:421-432): each row's register and rho, or its bin, computed
  once and applied to every rule whose WHERE bit keeps the row, rows in
  the order, into (R, P, C, k, W), with the same per-row panes.
  Bit-equal to its plain version (max is order-free, counts stay below
  2^24). Bound: its inputs once and the touched register / bin sectors
  read and written once; it issues one atomic per (rule, passing row,
  sketch column) into GBs of state.
- `multirule_finalize` replaces `_batched_finalize_impl` (multirule.py:210)
  and the key cut of `finalize_begin`: every rule's pane merge and final
  values into a fresh (R, S+1, K) result, K the columns the host takes.
- `multirule_finalize_wide` replaces that vmap's hll and percentile_approx
  final values (groupby.py:510-519): a warp per (rule, key) on a
  persistent grid (float4 loads of each live pane, the next key's loaded
  before the current key's arithmetic, warp-shuffle reductions) writes
  their rows of multirule_finalize's result. Bound: reading each live
  (rule, pane, key) register or bin run once.
- `multirule_reset_pane` replaces `_batched_reset_impl` (multirule.py:256):
  pane p of every rule and component to its identity, the wide ones too
  (64-bit lengths: a hopping percentile group of 63 rules holds 2.1e9
  floats). One grid sized to the card over every (component, rule) pane
  run, 16-byte stores with a scalar head and tail where a run is not
  16-byte aligned.

And two in ekuiper_tpu_torch/csrc/tierstore.cu, for the tiered key state
(ops/tierstore.py), over a packed row layout: each component's per-pane
block of one slot flattened in C order, the components sorted, act last:

- `tier_demote` replaces `TierStore._demote_impl` (tierstore.py:263): D
  slots' rows gathered into a fresh (D, Wp) block, then the n real slots
  (and their touch counters) reset to the identity; pad rows repeat
  slots[0]. One launch: each element read, packed and reset by one
  thread; row 0's pieces copied to the pads by the block that resets them,
  after its barrier.
- `tier_promote` replaces `_promote_impl` (tierstore.py:278): a block's
  rows merged into their slots by atomic add / min / max (identity pad
  rows on a repeated slot change nothing).

And three in ekuiper_tpu_torch/csrc/relational.cu, for the relational
tier (ops/joinring.py, ops/segscan.py):

- `join_match` replaces `JoinRing._match_impl` (joinring.py:186): the
  interval join's (PL, PR) pairing mask, slot equality ∧ the int32 band
  ∧ validity ∧ the ON residual (a bool tensor the expression IR computed,
  read through its broadcast strides), packed one bit a pair. A warp owns
  1,024 columns in registers and writes a row's 32 words, each a
  `__ballot_sync`, as one store; a persistent grid. Bound: writing PL·PR
  bits (0.010 ms at 16,384 a side; a (PL, PR) residual's read adds 0.080).
- `segscan_shift` replaces `SegScan._shift_impl` (segscan.py:124): a
  stable LSD radix sort by slot (csrc/radix_sort.cuh; 8-bit digits;
  one histogram launch counts every place, a place whose keys share one
  bin costs no pass, pad rows ride a bin of their own; each pass a
  stable scatter with decoupled look-back between tiles), then one
  segmented scan with look-back carries between blocks: row numbers
  from the carry's count, lag(1), running sums in float64 rounded once
  a row; a last launch writes the segment tails' carry back in place.
- `segscan_sort` replaces `SegScan._sort_impl` (segscan.py:165): the same
  sort by segment for row_number and lead(1), then by (segment, value)
  for rank and dense_rank, each followed by its segmented scan. Bound,
  both: the batch read once and the outputs written once (~1 µs); the
  chain of 8 (shift) or 16 (sort) launches sets the time.

And two in ekuiper_tpu_torch/csrc/countmin.cu, for `CountMinSketch`
(ops/sketches.py), over (d, w) float32 counts:

- `cms_update` replaces `CountMinSketch._update_impl` (sketches.py:282):
  each value adds one into cell hash_f32(v, d + 2) % w of each row d.
  Bound: the values read once and the counts read and written once (0.5
  MB at 65,536 values into (4, 8192)). Design: a thread a value, the
  lanes of a warp that hash to one cell adding their count with one
  global atomic (`__match_any_sync`), so a heavy hitter's cell takes one
  atomic a warp instead of one a value, at every width.
- `cms_query` replaces `_query_impl` (sketches.py:288): each value's min
  over its d cells. Bound: the values, the n·d cells, the (n,) result.

And two in ekuiper_tpu_torch/csrc/sharded.cu, for a rule on a (rows,
keys) device mesh whose devices are one card (parallel/sharded.py), over
partials of R row shards, (R·P', C, k[, W]), row shard r's block at r·P'
(key shard k's range is its slice [k·c, (k+1)·c) of the slot axis):

- `sharded_fold` replaces `ShardedGroupBy._build_fold` → `local_fold`
  (sharded.py:208, 221-331): every (row shard, key shard) folds its rows
  into its identity partial, act, n, s1, s2, mn, mx, the uint32 touch
  count and the hll / hist branches (299-314), in ONE launch (groupby_fold's
  kernel body, csrc/fold.cuh, over the partials); with a per-row pane vector
  (P' = P), `_build_fold_vec` (353, 371-474). Bound: the fold's bytes
  (~3 MB at the flagship shape with a touch column, 0.9 µs at 3.35 TB/s).
- `shard_merge` replaces their psum / pmin / pmax over "rows" and the add
  / min / max into the state (313-323, 403-407, 452-460): every
  component and the touch column in one flat index space of float4s (a
  block's component from the launch's table), a thread a float4 with the
  R partials' loads issued together and merged in r order, combined into
  the pane (or every pane), the partial float4s that left the identity
  written back to it. Bound: the R partials read once and one pane (P'
  panes) of state read and written.

Each wrapper takes its plain PyTorch version for tensors on the CPU, and
only there; for a CUDA tensor it launches the kernel or raises. A wrapper
adds one to `LAUNCHES[name]` where it launches its kernel and nowhere else:
`LAUNCHES` counts wrapper calls; a rule-group fold's one count covers its
pack and fold launches (and, called without an order, the order's call,
counted under `multirule_fold_order`). Each count of `groupby_fold`,
`groupby_fold_masked` and `sharded_fold` is one kernel, whatever their
columns.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import sketches

_PKG = Path(__file__).resolve().parents[1]
#: library name -> CUDA source; each builds into its own shared library
SOURCES = {"groupby": _PKG / "csrc" / "groupby.cu",
           "sketches": _PKG / "csrc" / "sketches.cu",
           "prefinalize": _PKG / "csrc" / "prefinalize.cu",
           "slidingring": _PKG / "csrc" / "slidingring.cu",
           "multirule": _PKG / "csrc" / "multirule.cu",
           "tierstore": _PKG / "csrc" / "tierstore.cu",
           "relational": _PKG / "csrc" / "relational.cu",
           "countmin": _PKG / "csrc" / "countmin.cu",
           "sharded": _PKG / "csrc" / "sharded.cu"}
#: headers the sources include (part of every library's build tag)
HEADERS = (_PKG / "csrc" / "fold.cuh",
           _PKG / "csrc" / "groupby_common.cuh",
           _PKG / "csrc" / "sketch_common.cuh",
           _PKG / "csrc" / "slot_type.cuh",
           _PKG / "csrc" / "radix_sort.cuh")
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: state component -> index in the kernels' component table
COMP_IDS = {"n": 0, "s1": 1, "s2": 2, "mn": 3, "mx": 4}
#: wide (register-axis) component -> index in csrc/sketches.cu's table
WIDE_IDS = {"hll": 0, "hist": 1, "hh": 2}
#: wide component -> its register width W
WIDE_W = {"hll": sketches.HLL_M, "hist": sketches.HIST_BINS,
          "hh": sketches.HH_SIZE}
#: aggregate kind -> final-value code of groupby_finalize_scalar; the
#: codes above "vars" are the sketch kinds, whose rows the sketch kernels
#: write (groupby_finalize_scalar skips them)
KIND_IDS = {"count": 0, "sum": 1, "avg": 2, "min": 3, "max": 4,
            "stddev": 5, "stddevs": 6, "var": 7, "vars": 8,
            "hll": 9, "percentile_approx": 10, "heavy_hitters": 11}
SCALAR_KINDS_MAX = KIND_IDS["vars"]
#: sketch kind -> final-value code of groupby_finalize_wide
WIDE_KIND_IDS = {"hll": 0, "percentile_approx": 1}
INIT = {"n": 0.0, "s1": 0.0, "s2": 0.0, "mn": float("inf"),
        "mx": float("-inf"), "act": 0.0, "hll": 0.0, "hist": 0.0, "hh": 0.0}
MAX_COLS = 64  # csrc/*.cu MAX_COLS / MAX_SPECS
MAX_SPECS = 64
MAX_RESET = 16  # csrc/groupby.cu MAX_RESET
MAX_PARTS = 16  # csrc/prefinalize.cu, csrc/slidingring.cu MAX_PARTS
MAX_RING = 256  # csrc/slidingring.cu MAX_RING
MAX_RULES = 65535  # csrc/multirule.cu MAX_RULES (the grid's y extent)
QUERY_ADJ = 4  # csrc/slidingring.cu QUERY_ADJ (ops/slidingring.py)
#: pane-merge op of a component in csrc/prefinalize.cu
MERGE_OPS = {"mn": 1, "mx": 2, "hll": 2}  # every other component: 0, a sum
#: csrc/slidingring.cu's combine codes are the same: 0 add, 1 min, 2 max
#: the log histogram's float32 constants, as csrc/sketches.cu HistConsts
#: takes them (lo, hi, 1/lo, 1/log_gamma, log_gamma, centre scale)
HIST_CONSTS = np.array([sketches._HIST_LO, sketches._HIST_HI * 0.999,
                        sketches._INV_LO, sketches._INV_LOG_GAMMA,
                        sketches._LOG_GAMMA, sketches._CENTER_SCALE],
                       dtype=np.float32)
#: float32(alpha·m·m) of the HLL raw estimate
HLL_NUM = float(np.float32(0.7213 / (1.0 + 1.079 / sketches.HLL_M)
                           * sketches.HLL_M * sketches.HLL_M))

#: launches of each kernel since the last reset_launches()
LAUNCHES: Dict[str, int] = {"groupby_fold": 0,
                            "groupby_fold_masked": 0,
                            "groupby_finalize_scalar": 0,
                            "groupby_reset_pane": 0,
                            "groupby_finalize_wide": 0,
                            "groupby_hh_finalize": 0,
                            "groupby_components": 0,
                            "groupby_absorb": 0,
                            "ring_advance": 0,
                            "ring_flip": 0,
                            "ring_query": 0,
                            "multirule_fold_order": 0,
                            "multirule_fold": 0,
                            "multirule_fold_wide": 0,
                            "multirule_finalize": 0,
                            "multirule_finalize_wide": 0,
                            "multirule_reset_pane": 0,
                            "tier_demote": 0,
                            "tier_promote": 0,
                            "join_match": 0,
                            "segscan_shift": 0,
                            "segscan_sort": 0,
                            "cms_update": 0,
                            "cms_query": 0,
                            "sharded_fold": 0,
                            "shard_merge": 0}
#: of LAUNCHES' folds, those that took a per-row pane vector
ROW_PANE_LAUNCHES: Dict[str, int] = {"groupby_fold": 0,
                                     "multirule_fold_order": 0,
                                     "multirule_fold": 0,
                                     "multirule_fold_wide": 0,
                                     "sharded_fold": 0}
#: of LAUNCHES' folds, those that bumped a touch column (tiered key state)
TOUCH_LAUNCHES: Dict[str, int] = {"groupby_fold": 0,
                                 "groupby_fold_masked": 0,
                                 "sharded_fold": 0}

#: the loaded libraries (SimpleNamespace(groupby=..., sketches=...,
#: prefinalize=..., slidingring=..., multirule=..., tierstore=...,
#: relational=..., countmin=..., sharded=...)), None until the first launch
_lib = None
_lib_lock = threading.Lock()
#: seconds the last build took (0.0 when cached libraries were loaded)
build_seconds = 0.0


def reset_launches() -> None:
    for counts in (LAUNCHES, ROW_PANE_LAUNCHES, TOUCH_LAUNCHES):
        for k in counts:
            counts[k] = 0


# ------------------------------------------------------------------ build
def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME): the group-by kernels are "
            "built from csrc/*.cu at first use on a CUDA machine")
    return str(path)


def build_library() -> Dict[str, Path]:
    """Compile each of SOURCES for sm_90a into _build/ (once per source
    content), one nvcc per source, all started together; return the
    shared libraries' paths by name."""
    global build_seconds
    outs: Dict[str, Path] = {}
    todo: Dict[str, Path] = {}
    headers = b"".join(h.read_bytes() for h in HEADERS)
    for name, src in SOURCES.items():
        tag = hashlib.sha1(src.read_bytes() + headers
                           + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
        outs[name] = BUILD_DIR / f"lib{name}_{tag}.so"
        if not outs[name].exists():
            todo[name] = src
    if not todo:
        build_seconds = 0.0
        return outs
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    try:
        for name, src in todo.items():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            procs[name] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        errors = []
        for name, (tmp, proc) in procs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc {SOURCES[name].name} failed "
                              f"({proc.returncode}):\n{err}")
            else:
                os.replace(tmp, outs[name])
        if errors:
            raise RuntimeError("\n".join(errors))
    finally:
        for tmp, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    build_seconds = time.perf_counter() - t0
    return outs


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            paths = build_library()
            P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            gb = ctypes.CDLL(str(paths["groupby"]))
            gb.groupby_fold.argtypes = [P, P, P, P, I, I, I, P, I, I, P, I,
                                        P, I, P, P, P, P, P, P, P, P]
            gb.groupby_finalize_scalar.argtypes = [P, P, P, P, I, I, P, I,
                                                   I, P, P]
            gb.groupby_reset_pane.argtypes = [P, P, P, I, I, P]
            sk = ctypes.CDLL(str(paths["sketches"]))
            sk.groupby_finalize_wide.argtypes = [P, P, P, I, I, P, P, I, P,
                                                 L, P, P]
            sk.groupby_hh_finalize.argtypes = [P, I, P, I, I, P, I, P, P]
            pf = ctypes.CDLL(str(paths["prefinalize"]))
            pf.groupby_components.argtypes = [P, P, P, I, P, I, I, P, P]
            pf.groupby_absorb.argtypes = [P, P, P, P, I, I, I, I, P]
            sr = ctypes.CDLL(str(paths["slidingring"]))
            sr.ring_advance.argtypes = [P, P, P, P, P, I, I, I, I, I, I, P]
            sr.ring_flip.argtypes = [P, P, P, P, P, P, I, I, P, P, I, P]
            sr.ring_query.argtypes = [P, P, P, P, P, P, I, I, I, I, I, P, P,
                                      P, P, P]
            mr = ctypes.CDLL(str(paths["multirule"]))
            mr.multirule_fold_order.argtypes = [P, I, I, P, I, I, P, I, P,
                                                P, P, P, P]
            mr.multirule_order_scratch_bytes.argtypes = [I]
            mr.multirule_order_scratch_bytes.restype = ctypes.c_longlong
            mr.multirule_fold.argtypes = [P, P, P, P, I, I, I, P, I, I, P,
                                          I, P, P, P, P, P, I, P, P, P, P,
                                          P]
            mr.multirule_finalize.argtypes = [P, P, P, P, I, I, I, I, P, I,
                                              I, P, P]
            mr.multirule_fold_wide.argtypes = [P, P, P, P, I, I, I, P, I, I,
                                               P, I, P, P, P, P, P, P, P]
            mr.multirule_finalize_wide.argtypes = [P, P, P, I, I, I, I, P, P,
                                                   I, P, L, I, P, P]
            mr.multirule_reset_pane.argtypes = [P, P, P, I, I, I, I, P]
            ts = ctypes.CDLL(str(paths["tierstore"]))
            ts.tier_demote.argtypes = [P, P, P, P, I, I, I, P, I, I, P, P, P]
            ts.tier_promote.argtypes = [P, P, P, P, I, I, I, P, I, P, P]
            LL = ctypes.c_longlong
            rl = ctypes.CDLL(str(paths["relational"]))
            rl.join_match.argtypes = [P, P, P, I, P, P, P, I, I, I, P, LL,
                                      LL, P, P]
            rl.segscan_shift.argtypes = [P, P, P, I, P, P, P, P, I, P, P, P,
                                         P, P, P, P]
            rl.segscan_sort.argtypes = [P, P, P, I, P, P, P, P, P, P, P, P]
            rl.segscan_scratch_bytes.argtypes = [I, I]
            rl.segscan_scratch_bytes.restype = LL
            cm = ctypes.CDLL(str(paths["countmin"]))
            cm.cms_update.argtypes = [P, I, I, P, I, P]
            cm.cms_query.argtypes = [P, I, I, P, I, P, P]
            sh = ctypes.CDLL(str(paths["sharded"]))
            sh.sharded_fold.argtypes = [P, P, P, P, I, I, I, I, P, I, I, I,
                                        P, I, P, I, P, P, P, P, P, P, P, P]
            sh.shard_merge.argtypes = [P, P, P, P, P, I, I, I, I, P, P, I, P]
            for lib, fns in ((gb, ("groupby_fold",
                                   "groupby_finalize_scalar",
                                   "groupby_reset_pane")),
                             (sk, ("groupby_finalize_wide",
                                   "groupby_hh_finalize")),
                             (pf, ("groupby_components", "groupby_absorb")),
                             (sr, ("ring_advance", "ring_flip",
                                   "ring_query")),
                             (mr, ("multirule_fold_order", "multirule_fold",
                                   "multirule_fold_wide",
                                   "multirule_finalize",
                                   "multirule_finalize_wide",
                                   "multirule_reset_pane")),
                             (ts, ("tier_demote", "tier_promote")),
                             (rl, ("join_match", "segscan_shift",
                                   "segscan_sort")),
                             (cm, ("cms_update", "cms_query")),
                             (sh, ("sharded_fold", "shard_merge"))):
                for fn in fns:
                    getattr(lib, fn).restype = I
            gb.groupby_error_string.argtypes = [I]
            gb.groupby_error_string.restype = ctypes.c_char_p
            _lib = SimpleNamespace(groupby=gb, sketches=sk, prefinalize=pf,
                                   slidingring=sr, multirule=mr, tierstore=ts,
                                   relational=rl, countmin=cm, sharded=sh)
        return _lib


def _raise_on(lib, name: str, rc: int) -> None:
    if rc != 0:
        msg = lib.groupby.groupby_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({rc})")


# ---------------------------------------------------------------- checks
def _on_cuda(name: str, state: Dict[str, torch.Tensor]) -> bool:
    """True to launch the kernel, False to take the plain version (CPU
    state); raises for any other device."""
    dev = state["act"].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    return True


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: tensor on {t.device}, state on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _comp_table(name: str, state: Dict[str, torch.Tensor]):
    """(pointer array, width array) of the five components, checked."""
    act = state["act"]
    P, C = act.shape
    _check(name, act, torch.float32, (P, C), act.device)
    ptrs = np.zeros(len(COMP_IDS), dtype=np.uint64)
    ks = np.zeros(len(COMP_IDS), dtype=np.int32)
    for comp, j in COMP_IDS.items():
        arr = state.get(comp)
        if arr is None:
            continue
        _check(name, arr, torch.float32, (P, C, arr.shape[2]), act.device)
        ptrs[j] = arr.data_ptr()
        ks[j] = arr.shape[2]
    return ptrs, ks


def _wide_table(name: str, state: Dict[str, torch.Tensor]):
    """(pointer array, K array) of the three wide components, checked."""
    act = state["act"]
    P, C = act.shape
    ptrs = np.zeros(len(WIDE_IDS), dtype=np.uint64)
    ks = np.zeros(len(WIDE_IDS), dtype=np.int32)
    for comp, j in WIDE_IDS.items():
        arr = state.get(comp)
        if arr is None:
            continue
        _check(name, arr, torch.float32,
               (P, C, arr.shape[2] if arr.dim() == 4 else -1, WIDE_W[comp]),
               act.device)
        ptrs[j] = arr.data_ptr()
        ks[j] = arr.shape[2]
    return ptrs, ks


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _ptr(a) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data if isinstance(a, np.ndarray)
                           else a.data_ptr())


# ------------------------------------------------------------------ fold
def groupby_fold(state: Dict[str, torch.Tensor], base: torch.Tensor,
                 V: torch.Tensor, M: torch.Tensor, slots: torch.Tensor,
                 pane: int, colmap: np.ndarray, widemap: np.ndarray,
                 pane_vec: Optional[torch.Tensor] = None) -> None:
    """Fold one micro-batch chunk into `state` in place, in ONE kernel
    launch: act, the scalar components, the touch column and the wide
    sketch components (#1).

    base: bool (R,) row mask after WHERE. V: float32 (S, R) spec values;
    M: bool (S, R) spec masks (each already ANDed with base). slots: int32
    or uint16 (R,). colmap: int32 (ncols, 3) of (COMP_IDS[comp], k, spec);
    widemap: int32 (ncols, 3) of (WIDE_IDS[comp], k, spec). pane_vec:
    optional uint8 (R,) per-row panes, which replace `pane`; the caller
    checks their range on the host (a pane outside [0, P) is dropped, as an
    out-of-range slot is). A state holding a `touch` column (uint32 (C,),
    tiered key state) also counts each row past `base` into touch[slot].
    """
    _fold("groupby_fold", state, base, V, M, slots, pane, colmap, widemap,
          pane_vec)


def groupby_fold_masked(state: Dict[str, torch.Tensor], base: torch.Tensor,
                        V: torch.Tensor, M: torch.Tensor, slots: torch.Tensor,
                        pane: int, colmap: np.ndarray,
                        widemap: np.ndarray) -> None:
    """The masked fold (#2): groupby_fold's kernel into the one pane
    `pane`, counted under its own name. base: bool (R,), a refold's row
    masks ∧ WHERE over its cached, padded segments concatenated (0 on
    their padding rows); V, M, slots, colmap, widemap as groupby_fold's
    over the same rows (each spec's mask ANDed with base)."""
    _fold("groupby_fold_masked", state, base, V, M, slots, pane, colmap,
          widemap, None)


def _fold(name, state, base, V, M, slots, pane, colmap, widemap,
          pane_vec) -> None:
    """groupby_fold's launch, counted under `name`."""
    if not _on_cuda(name, state):
        fold_plain(state, base, V, M, slots, pane, colmap, widemap, pane_vec)
        return
    act = state["act"]
    P, C = act.shape
    S, R = V.shape
    dev = act.device
    _check(name, base, torch.bool, (R,), dev)
    colmap = _check_batch(name, V, M, slots, pane, P, colmap, dev, pane_vec)
    widemap = _col_map(name, widemap, S)
    ptrs, ks = _comp_table(name, state)
    wptrs, wks = _wide_table(name, state)
    _check_wide_cols(name, widemap, wks)
    touch = state.get("touch")
    if touch is not None:
        _check(name, touch, torch.uint32, (C,), dev)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.groupby.groupby_fold(
            _ptr(base), _ptr(V), _ptr(M), _ptr(slots), _u16(slots), R,
            int(pane), _opt_ptr(pane_vec), P, C, _ptr(colmap), len(colmap),
            _ptr(widemap), len(widemap), _ptr(ptrs), _ptr(ks), _ptr(act),
            _opt_ptr(touch), _ptr(wptrs), _ptr(wks), _ptr(HIST_CONSTS),
            _stream(dev))
        LAUNCHES[name] += 1
        if pane_vec is not None:
            ROW_PANE_LAUNCHES[name] += 1
        if touch is not None:
            TOUCH_LAUNCHES[name] += 1
    _raise_on(lib, name, rc)


def _check_wide_cols(name: str, widemap: np.ndarray, ks: np.ndarray) -> None:
    for comp_id, k, _ in widemap.tolist():
        if comp_id not in _WIDE_NAMES or not 0 <= k < ks[comp_id]:
            raise ValueError(f"{name}: column {k} outside component "
                             f"{_WIDE_NAMES.get(comp_id, comp_id)}")


def fold_plain(state, base, V, M, slots, pane, colmap, widemap,
               pane_vec=None) -> None:
    """Plain PyTorch version of groupby_fold (same contract): the scalar
    fold, then the wide one."""
    fold_scalar_plain(state, base, V, M, slots, pane, colmap, pane_vec)
    if len(np.asarray(widemap).reshape(-1, 3)):
        fold_wide_plain(state, V, M, slots, pane, widemap, pane_vec)


def _opt_ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _u16(slots: torch.Tensor) -> int:
    return int(slots.dtype == torch.uint16)


def _check_batch(name, V, M, slots, pane, P, colmap, dev,
                 pane_vec=None, slot_dtypes=(torch.int32, torch.uint16)
                 ) -> np.ndarray:
    """Checks shared by the folds; returns the contiguous column map. The
    slots are int32, or uint16 where `slot_dtypes` takes it (the single
    rule's folds and masked folds: a cached sliding batch's slots)."""
    S, R = V.shape
    _check(name, V, torch.float32, (S, R), dev)
    _check(name, M, torch.bool, (S, R), dev)
    if slots.dtype not in slot_dtypes:
        raise TypeError(f"{name}: slots of {slots.dtype}, expected one of "
                        f"{list(slot_dtypes)}")
    _check(name, slots, slots.dtype, (R,), dev)
    if pane_vec is not None:
        _check(name, pane_vec, torch.uint8, (R,), dev)
    if not 0 <= pane < P:
        raise ValueError(f"{name}: pane {pane} outside [0, {P})")
    return _col_map(name, colmap, S)


def _col_map(name: str, colmap, S: int) -> np.ndarray:
    """A column map as a contiguous int32 (ncols, 3), checked: at most
    MAX_COLS columns, each naming a spec of V / M."""
    colmap = np.ascontiguousarray(colmap, dtype=np.int32).reshape(-1, 3)
    if len(colmap) > MAX_COLS:
        raise ValueError(f"{name}: {len(colmap)} state columns "
                         f"(max {MAX_COLS})")
    if len(colmap) and (colmap[:, 2].max() >= S or colmap[:, 2].min() < 0):
        raise ValueError(f"{name}: column map names a spec outside V/M")
    return colmap


_COMP_NAMES = {j: c for c, j in COMP_IDS.items()}
_WIDE_NAMES = {j: c for c, j in WIDE_IDS.items()}


def _pane_rows(pane, pane_vec, slots, P: int, C: int):
    """(flat pane * C + slot index, in-range mask) of each row: the scalar
    pane or the row's own; out-of-range slots and panes are dropped."""
    slots = slots.long()
    ok = (slots >= 0) & (slots < C)
    if pane_vec is None:
        return pane * C + slots.clamp(0, C - 1), ok
    p = pane_vec.long()
    ok = ok & (p < P)
    return p.clamp(0, P - 1) * C + slots.clamp(0, C - 1), ok


def fold_scalar_plain(state, base, V, M, slots, pane, colmap,
                      pane_vec=None) -> None:
    """The plain fold's act, scalar columns and touch column (groupby_fold's
    scalar part)."""
    P, C = state["act"].shape
    pc, ok = _pane_rows(pane, pane_vec, slots, P, C)
    _fold_columns_plain(state, pc, base & ok, V, M & ok, colmap)
    _touch_plain(state, base, slots)


def _touch_plain(state, rows, slots) -> None:
    """touch[slot] += 1 for each row set in `rows` whose slot is inside the
    state, where the state has a touch column. torch has no uint32
    scatter-add: count in int64, wrap back (the counters wrap modulo
    2**32, as the kernel's atomicAdd does)."""
    touch = state.get("touch")
    if touch is None:
        return
    s = slots.long()
    keep = rows & (s >= 0) & (s < touch.shape[0])
    t = touch.long()
    t.index_add_(0, s[keep], torch.ones_like(s[keep]))
    touch.copy_((t & 0xFFFFFFFF).to(torch.uint32))


def _fold_columns_plain(state, pc, rows, V, M, colmap) -> None:
    """The plain folds' scatters: act += rows at the flat (pane, slot)
    indices pc; each state column adds / mins / maxes its spec's V where
    its M (already inside rows) is set. pc, rows: (N,); V, M: (S, N)."""
    act = state["act"]
    act.view(-1).index_put_((pc,), rows.to(act.dtype), accumulate=True)
    for comp_id, k, s in np.asarray(colmap).reshape(-1, 3).tolist():
        comp = _COMP_NAMES[comp_id]
        arr = state[comp]
        K = arr.shape[-1]
        idx = pc * K + k
        m = M[s]
        v = V[s]
        flat = arr.view(-1)
        if comp == "n":
            flat.index_put_((idx,), m.to(arr.dtype), accumulate=True)
        elif comp == "s1":
            flat.index_put_((idx,), torch.where(m, v, 0.0), accumulate=True)
        elif comp == "s2":
            flat.index_put_((idx,), torch.where(m, v * v, 0.0),
                            accumulate=True)
        elif comp == "mn":
            flat.scatter_reduce_(0, idx, torch.where(m, v, INIT["mn"]),
                                 "amin", include_self=True)
        else:
            flat.scatter_reduce_(0, idx, torch.where(m, v, INIT["mx"]),
                                 "amax", include_self=True)


def fold_wide_plain(state, V, M, slots, pane, widemap,
                    pane_vec=None) -> None:
    """The plain fold's wide sketch columns (groupby_fold's hll / hist /
    hh part: the reference's scatter-max / scatter-add of
    sketches.hll_parts / hist_bin / hh_update_parts)."""
    P, C = state["act"].shape
    pc, ok = _pane_rows(pane, pane_vec, slots, P, C)
    for comp_id, k, s in np.asarray(widemap).reshape(-1, 3).tolist():
        comp = _WIDE_NAMES[comp_id]
        arr = state[comp]
        K, W = arr.shape[2], arr.shape[3]
        row = (pc * K + k) * W
        m = M[s] & ok
        v = V[s]
        flat = arr.view(-1)
        if comp == "hll":
            reg, rho = sketches.hll_parts(v)
            flat.scatter_reduce_(0, row + reg, torch.where(m, rho, 0.0),
                                 "amax", include_self=True)
        elif comp == "hist":
            flat.index_put_((row + sketches.hist_bin(v),), m.to(arr.dtype),
                            accumulate=True)
        else:
            idx, wts = sketches.hh_update_parts(v, m.to(arr.dtype))
            flat.index_put_(((row[:, None] + idx).reshape(-1),),
                            wts.reshape(-1), accumulate=True)


# -------------------------------------------------------------- finalize
def groupby_finalize_scalar(state: Dict[str, torch.Tensor],
                            pane_mask: torch.Tensor, spectab: np.ndarray,
                            rows: Optional[int] = None) -> torch.Tensor:
    """Merge the panes selected by `pane_mask` (bool (P,)) and compute
    every scalar spec's final value. spectab: int32 (S, 7) of
    (KIND_IDS[kind], k_n, k_s1, k_s2, k_mn, k_mx, output row), -1 for an
    absent component; sketch kinds are skipped (their rows are the sketch
    kernels'). Returns float32 (rows, C) on the state's device (rows
    defaults to S + 1), act in the last row."""
    name = "groupby_finalize_scalar"
    spectab = np.ascontiguousarray(spectab, dtype=np.int32).reshape(
        -1, 2 + len(COMP_IDS))
    S = len(spectab)
    rows = S + 1 if rows is None else int(rows)
    if not _on_cuda(name, state):
        return finalize_scalar_plain(state, pane_mask, spectab, rows)
    act = state["act"]
    P, C = act.shape
    dev = act.device
    _check(name, pane_mask, torch.bool, (P,), dev)
    if S > MAX_SPECS:
        raise ValueError(f"{name}: {S} specs (max {MAX_SPECS})")
    ptrs, ks = _comp_table(name, state)
    _check_spectab(name, spectab, rows, ks)
    out = torch.empty((rows, C), dtype=torch.float32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.groupby.groupby_finalize_scalar(
            _ptr(ptrs), _ptr(ks), _ptr(act), _ptr(pane_mask), P, C,
            _ptr(spectab), S, rows, _ptr(out), _stream(dev))
        LAUNCHES[name] += 1
    _raise_on(lib, name, rc)
    return out


def _check_spectab(name: str, spectab: np.ndarray, rows: int,
                   ks: np.ndarray) -> None:
    """Known kinds, scalar specs' rows inside the result (act's last row
    apart), and spec columns inside their components (widths ks)."""
    for kind, *kc, row in spectab.tolist():
        if kind not in KIND_IDS.values():
            raise ValueError(f"{name}: unknown kind code {kind}")
        if kind <= SCALAR_KINDS_MAX and not 0 <= row < rows - 1:
            raise ValueError(f"{name}: output row {row} outside "
                             f"[0, {rows - 1})")
        for j, k in enumerate(kc):
            if k >= ks[j]:
                raise ValueError(f"{name}: spec column {k} outside "
                                 f"component {_COMP_NAMES[j]}")


def _merged_plain(arr: torch.Tensor, comp: str, pm: torch.Tensor,
                  dim: int = 0):
    """The panes (axis `dim`) of `arr` selected by pm merged."""
    pm = pm.view(-1, *([1] * (arr.dim() - 1 - dim)))
    if comp == "mn":
        return torch.amin(torch.where(pm, arr, INIT["mn"]), dim=dim)
    if comp in ("mx", "hll"):  # hll registers merge by max
        return torch.amax(torch.where(pm, arr, INIT["mx"]), dim=dim)
    return torch.sum(torch.where(pm, arr, 0.0), dim=dim)


def final_value_plain(kind: str, c: Dict[str, torch.Tensor],
                      frac: float = 0.5) -> torch.Tensor:
    """The reference's _final_value (groupby.py:483-520)."""
    nan = float("nan")
    n = c.get("n")
    if kind == "count":
        return n
    if kind == "sum":
        return torch.where(n > 0, c["s1"], nan)
    if kind == "avg":
        return torch.where(n > 0, c["s1"] / torch.clamp(n, min=1.0), nan)
    if kind == "min":
        return torch.where(n > 0, c["mn"], nan)
    if kind == "max":
        return torch.where(n > 0, c["mx"], nan)
    if kind == "hll":
        # pane merge used -inf for masked panes; clamp back to 0
        regs = torch.clamp(c["hll"], min=0.0)
        return torch.round(sketches.hll_estimate(regs))
    if kind == "percentile_approx":
        return sketches.hist_quantile(c["hist"], frac)
    mean = c["s1"] / torch.clamp(n, min=1.0)
    if kind in ("stddev", "var"):
        v = torch.clamp(c["s2"] / torch.clamp(n, min=1.0) - mean * mean,
                        min=0.0)
        out = torch.sqrt(v) if kind == "stddev" else v
        return torch.where(n > 0, out, nan)
    if kind in ("stddevs", "vars"):
        v = torch.clamp((c["s2"] - c["s1"] * mean)
                        / torch.clamp(n - 1.0, min=1.0), min=0.0)
        out = torch.sqrt(v) if kind == "stddevs" else v
        return torch.where(n >= 2, out, nan)
    raise ValueError(f"unknown device agg kind {kind}")


def finalize_scalar_plain(state, pane_mask, spectab,
                          rows: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of groupby_finalize_scalar; the sketch kinds'
    rows are left NaN."""
    return _finalize_plain(state, pane_mask, spectab, rows, 0)


def _finalize_plain(state, pane_mask, spectab, rows, dim: int
                    ) -> torch.Tensor:
    """The plain finalizes: panes on axis `dim` of the state (0 for one
    rule, 1 behind the rule axis) merged under pane_mask, one row per spec
    (NaN for the sketch kinds) and act last, stacked on axis `dim`."""
    kinds = {v: k for k, v in KIND_IDS.items()}
    spectab = np.asarray(spectab).reshape(-1, 2 + len(COMP_IDS))
    rows = len(spectab) + 1 if rows is None else int(rows)
    act = _merged_plain(state["act"], "act", pane_mask, dim)
    out = [torch.full_like(act, float("nan")) for _ in range(rows - 1)]
    merged = {comp: _merged_plain(state[comp], comp, pane_mask, dim)
              for comp in COMP_IDS if comp in state}
    for kind, *kc, row in spectab.tolist():
        if kind > SCALAR_KINDS_MAX:
            continue
        c = {comp: merged[comp][..., kc[j]]
             for comp, j in COMP_IDS.items() if kc[j] >= 0}
        out[row] = final_value_plain(kinds[kind], c)
    return torch.stack(out + [act], dim=dim)


def groupby_finalize_wide(state: Dict[str, torch.Tensor],
                          pane_mask: torch.Tensor, widetab: np.ndarray,
                          fracs: np.ndarray, out: torch.Tensor) -> None:
    """Pane-merge the hll / hist components under `pane_mask` and write
    the hll and percentile_approx specs' final values into their rows of
    `out` (float32 (rows, C), from groupby_finalize_scalar). widetab:
    int32 (n, 3) of (WIDE_KIND_IDS[kind], k, output row); fracs: float32
    (n,) of the percentiles' fractions."""
    name = "groupby_finalize_wide"
    widetab = np.ascontiguousarray(widetab, dtype=np.int32).reshape(-1, 3)
    fracs = np.ascontiguousarray(fracs, dtype=np.float32).reshape(-1)
    if not _on_cuda(name, state):
        finalize_wide_plain(state, pane_mask, widetab, fracs, out)
        return
    act = state["act"]
    P, C = act.shape
    dev = act.device
    _check(name, pane_mask, torch.bool, (P,), dev)
    _check(name, out, torch.float32, (out.shape[0], C), dev)
    n = len(widetab)
    if n > MAX_SPECS or len(fracs) != n:
        raise ValueError(f"{name}: {n} specs, {len(fracs)} fractions "
                         f"(max {MAX_SPECS})")
    ptrs, ks = _wide_table(name, state)
    comp_of = {WIDE_KIND_IDS["hll"]: WIDE_IDS["hll"],
               WIDE_KIND_IDS["percentile_approx"]: WIDE_IDS["hist"]}
    for kind, k, row in widetab.tolist():
        if kind not in comp_of or not 0 <= k < ks[comp_of[kind]]:
            raise ValueError(f"{name}: spec ({kind}, {k}) has no column")
        if not 0 <= row < out.shape[0] - 1:
            raise ValueError(f"{name}: output row {row} outside the result")
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.sketches.groupby_finalize_wide(
            _ptr(ptrs), _ptr(ks), _ptr(pane_mask), P, C, _ptr(widetab),
            _ptr(fracs), n, _ptr(HIST_CONSTS), HLL_NUM, _ptr(out),
            _stream(dev))
        LAUNCHES[name] += 1
    _raise_on(lib, name, rc)


def finalize_wide_plain(state, pane_mask, widetab, fracs, out) -> None:
    """Plain PyTorch version of groupby_finalize_wide."""
    kinds = {v: k for k, v in WIDE_KIND_IDS.items()}
    for (kind, k, row), frac in zip(np.asarray(widetab).reshape(-1, 3)
                                    .tolist(), np.asarray(fracs).tolist()):
        kind = kinds[kind]
        comp = "hll" if kind == "hll" else "hist"
        merged = _merged_plain(state[comp][:, :, k], comp, pane_mask)
        out[row] = final_value_plain(kind, {comp: merged},
                                     float(np.float32(frac)))


def groupby_hh_finalize(state: Dict[str, torch.Tensor],
                        pane_mask: torch.Tensor, hhtab: np.ndarray,
                        out: torch.Tensor) -> None:
    """Heavy-hitter recovery for every heavy_hitters spec: sum-merge the
    hh panes under `pane_mask`, recover, validate and estimate each
    (depth, slot) cell's code, and write the top k2 codes and estimates in
    lax.top_k's order into rows [row, row + k2) and [row + k2, row + 2·k2)
    of `out` (float32 (rows, C)). hhtab: int32 (n, 3) of (k, k2, row)."""
    name = "groupby_hh_finalize"
    hhtab = np.ascontiguousarray(hhtab, dtype=np.int32).reshape(-1, 3)
    if not _on_cuda(name, state):
        hh_finalize_plain(state, pane_mask, hhtab, out)
        return
    act = state["act"]
    P, C = act.shape
    dev = act.device
    _check(name, pane_mask, torch.bool, (P,), dev)
    _check(name, out, torch.float32, (out.shape[0], C), dev)
    hh = state["hh"]
    _check(name, hh, torch.float32, (P, C, hh.shape[2], sketches.HH_SIZE),
           dev)
    n = len(hhtab)
    if n > MAX_SPECS:
        raise ValueError(f"{name}: {n} specs (max {MAX_SPECS})")
    for k, k2, row in hhtab.tolist():
        if not 0 <= k < hh.shape[2]:
            raise ValueError(f"{name}: hh column {k} outside the state")
        if not 0 < k2 <= sketches.HH_DEPTH * sketches.HH_WIDTH:
            raise ValueError(f"{name}: k2 {k2} outside the candidate pool")
        if not 0 <= row or row + 2 * k2 > out.shape[0] - 1:
            raise ValueError(f"{name}: rows {row}+{2 * k2} outside the "
                             "result")
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.sketches.groupby_hh_finalize(
            _ptr(hh), hh.shape[2], _ptr(pane_mask), P, C, _ptr(hhtab), n,
            _ptr(out), _stream(dev))
        LAUNCHES[name] += 1
    _raise_on(lib, name, rc)


def hh_finalize_plain(state, pane_mask, hhtab, out) -> None:
    """Plain PyTorch version of groupby_hh_finalize."""
    for k, k2, row in np.asarray(hhtab).reshape(-1, 3).tolist():
        merged = _merged_plain(state["hh"][:, :, k], "hh", pane_mask)
        codes, est = sketches.hh_candidates(merged, k2)
        out[row:row + k2] = codes.T
        out[row + k2:row + 2 * k2] = est.T


# ----------------------------------------------------------------- reset
def _paned(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The pane-scoped components (every one but the touch column, whose
    per-slot recency survives pane expiry, as in the reference)."""
    return {k: v for k, v in state.items() if k != "touch"}


def groupby_reset_pane(state: Dict[str, torch.Tensor], pane: int) -> None:
    """Write the identity into pane `pane` of every component and act
    (a touch column is left alone)."""
    name = "groupby_reset_pane"
    if not _on_cuda(name, state):
        reset_pane_plain(state, pane)
        return
    act = state["act"]
    P, C = act.shape
    if not 0 <= pane < P:
        raise ValueError(f"{name}: pane {pane} outside [0, {P})")
    comps = _paned(state)
    if len(comps) > MAX_RESET:
        raise ValueError(f"{name}: {len(comps)} components "
                         f"(max {MAX_RESET})")
    ptrs = np.zeros(len(comps), dtype=np.uint64)
    lens = np.zeros(len(comps), dtype=np.int64)
    inits = np.zeros(len(comps), dtype=np.float32)
    for j, (comp, arr) in enumerate(comps.items()):
        _check(name, arr, torch.float32, (P, C, *arr.shape[2:]), act.device)
        ptrs[j] = arr.data_ptr()
        lens[j] = arr[0].numel()
        inits[j] = INIT[comp]
    lib = _load()
    dev = act.device
    with torch.cuda.device(dev):
        rc = lib.groupby.groupby_reset_pane(_ptr(ptrs), _ptr(lens),
                                            _ptr(inits), len(comps),
                                            int(pane), _stream(dev))
        LAUNCHES[name] += 1
    _raise_on(lib, name, rc)


def reset_pane_plain(state, pane: int) -> None:
    """Plain PyTorch version of groupby_reset_pane."""
    for comp, arr in _paned(state).items():
        arr[pane].fill_(INIT[comp])


# -------------------------------------------------------- prefinalize
def _slot_width(arr: torch.Tensor) -> int:
    """Floats per slot of one pane of a state component (1 for act)."""
    return int(np.prod(arr.shape[2:], dtype=np.int64))


def groupby_components(state: Dict[str, torch.Tensor],
                       pane_mask: torch.Tensor,
                       comps: Sequence[str]) -> torch.Tensor:
    """Merge the panes selected by `pane_mask` (bool (P,)) of each of
    `comps` (state component names, act included, in output order) into
    one fresh float32 (C, W) tensor: each component's slot row flattened
    to its K (x register width) columns, side by side. mn merges by min
    from +inf, mx and hll by max from -inf, the others by sum from 0."""
    name = "groupby_components"
    if not _on_cuda(name, state):
        return components_plain(state, pane_mask, comps)
    act = state["act"]
    P, C = act.shape
    dev = act.device
    _check(name, pane_mask, torch.bool, (P,), dev)
    if not 0 < len(comps) <= MAX_PARTS or P > 255:
        raise ValueError(f"{name}: {len(comps)} components (max "
                         f"{MAX_PARTS}), {P} panes (max 255)")
    ptrs = np.zeros(len(comps), dtype=np.uint64)
    ws = np.zeros(len(comps), dtype=np.int32)
    ops = np.zeros(len(comps), dtype=np.int32)
    for t, comp in enumerate(comps):
        arr = state[comp]
        _check(name, arr, torch.float32, (P, C, *arr.shape[2:]), dev)
        ptrs[t], ws[t], ops[t] = arr.data_ptr(), _slot_width(arr), \
            MERGE_OPS.get(comp, 0)
    out = torch.empty((C, int(ws.sum())), dtype=torch.float32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.prefinalize.groupby_components(
            _ptr(ptrs), _ptr(ws), _ptr(ops), len(comps), _ptr(pane_mask), P,
            C, _ptr(out), _stream(dev))
        LAUNCHES[name] += 1
    _raise_on(lib, name, rc)
    return out


def components_plain(state, pane_mask, comps) -> torch.Tensor:
    """Plain PyTorch version of groupby_components."""
    C = state["act"].shape[1]
    return torch.cat([_merged_plain(state[c], c, pane_mask).reshape(C, -1)
                      for c in comps], dim=1)


def groupby_absorb(state: Dict[str, torch.Tensor],
                   shadow: Dict[str, torch.Tensor], pane: int) -> None:
    """Merge `shadow` (component -> float32 (Cs, K[, W]), or (Cs,) for
    act, on the state's device, Cs <= C) into pane `pane` of the state in
    place: min for mn, max for mx and hll, add otherwise; components the
    shadow lacks are left alone."""
    name = "groupby_absorb"
    if not _on_cuda(name, state):
        absorb_plain(state, shadow, pane)
        return
    act = state["act"]
    P, C = act.shape
    dev = act.device
    if not 0 <= pane < P:
        raise ValueError(f"{name}: pane {pane} outside [0, {P})")
    parts = [c for c in state if c in shadow]
    if len(parts) > MAX_PARTS:
        raise ValueError(f"{name}: {len(parts)} components (max {MAX_PARTS})")
    Cs = next((shadow[c].shape[0] for c in parts), 0)
    dst = np.zeros(len(parts), dtype=np.uint64)
    src = np.zeros(len(parts), dtype=np.uint64)
    ws = np.zeros(len(parts), dtype=np.int32)
    ops = np.zeros(len(parts), dtype=np.int32)
    for t, comp in enumerate(parts):
        arr, sh = state[comp], shadow[comp]
        _check(name, arr, torch.float32, (P, C, *arr.shape[2:]), dev)
        _check(name, sh, torch.float32, (Cs, *arr.shape[2:]), dev)
        dst[t], src[t] = arr.data_ptr(), sh.data_ptr()
        ws[t], ops[t] = _slot_width(arr), MERGE_OPS.get(comp, 0)
    if Cs > C:
        raise ValueError(f"{name}: shadow of {Cs} slots, state of {C}")
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.prefinalize.groupby_absorb(
            _ptr(dst), _ptr(src), _ptr(ws), _ptr(ops), len(parts), int(pane),
            C, Cs, _stream(dev))
        LAUNCHES[name] += 1
    _raise_on(lib, name, rc)


def absorb_plain(state, shadow, pane: int) -> None:
    """Plain PyTorch version of groupby_absorb."""
    for comp, arr in state.items():
        sh = shadow.get(comp)
        if sh is None:
            continue
        dst = arr[pane, :sh.shape[0]]
        if comp == "mn":
            torch.minimum(dst, sh, out=dst)
        elif comp in ("mx", "hll"):
            torch.maximum(dst, sh, out=dst)
        else:
            dst.add_(sh)


# ------------------------------------------------------------- sliding ring
def _ring_table(name: str, ring: Dict[str, torch.Tensor],
                state: Dict[str, torch.Tensor], comps: Sequence[str]):
    """The launch table of `comps`: pane, running partial (tot or back) and
    front pointers, floats per slot, combine codes, identities; checked
    against the pane state's (P, C) and the ring's capacity."""
    act = state["act"]
    P, C = act.shape
    dev = act.device
    if not 0 < len(comps) <= MAX_PARTS:
        raise ValueError(f"{name}: {len(comps)} components (max {MAX_PARTS})")
    n = len(comps)
    pane, run, front = (np.zeros(n, dtype=np.uint64) for _ in range(3))
    ws = np.zeros(n, dtype=np.int32)
    ops = np.zeros(n, dtype=np.int32)
    inits = np.zeros(n, dtype=np.float32)
    R = None
    for t, comp in enumerate(comps):
        arr = state[comp]
        _check(name, arr, torch.float32, (P, C, *arr.shape[2:]), dev)
        ops[t] = MERGE_OPS.get(comp, 0)
        key = ("back_" if ops[t] else "tot_") + comp
        _check(name, ring[key], torch.float32, (C, *arr.shape[2:]), dev)
        pane[t], run[t] = arr.data_ptr(), ring[key].data_ptr()
        if ops[t]:
            fr = ring["front_" + comp]
            R = fr.shape[0] if R is None else R
            _check(name, fr, torch.float32, (R, C, *arr.shape[2:]), dev)
            front[t] = fr.data_ptr()
        ws[t], inits[t] = _slot_width(arr), INIT[comp]
    return dict(pane=pane, run=run, front=front, w=ws, ops=ops, init=inits,
                n=n, P=P, C=C, R=R, dev=dev)


def ring_advance(ring: Dict[str, torch.Tensor],
                 state: Dict[str, torch.Tensor], comps: Sequence[str],
                 closed: int, closed_on: bool, evict: int,
                 evict_on: bool) -> None:
    """The DABA ring step, in place: for each additive component of
    `comps` tot = (tot + closed_on·pane[closed]) − evict_on·pane[evict];
    for each two-stack one (mn, mx, hll) back = min/max(back,
    pane[closed] if closed_on else the identity)."""
    name = "ring_advance"
    if not _on_cuda(name, state):
        ring_advance_plain(ring, state, comps, closed, closed_on, evict,
                           evict_on)
        return
    tab = _ring_table(name, ring, state, comps)
    for pane in (closed, evict):
        if not 0 <= pane < tab["P"]:
            raise ValueError(f"{name}: pane {pane} outside [0, {tab['P']})")
    lib = _load()
    dev = tab["dev"]
    with torch.cuda.device(dev):
        rc = lib.slidingring.ring_advance(
            _ptr(tab["pane"]), _ptr(tab["run"]), _ptr(tab["w"]), _ptr(tab["ops"]),
            _ptr(tab["init"]), tab["n"], tab["C"], int(closed),
            int(bool(closed_on)), int(evict), int(bool(evict_on)),
            _stream(dev))
        LAUNCHES[name] += 1
    _raise_on(lib, name, rc)


def _ring_combine(comp: str, a: torch.Tensor, b: torch.Tensor):
    return torch.minimum(a, b) if comp == "mn" else torch.maximum(a, b)


def ring_advance_plain(ring, state, comps, closed, closed_on, evict,
                       evict_on) -> None:
    """Plain PyTorch version of ring_advance (the reference's
    _advance_impl, in place)."""
    for comp in comps:
        arr = state[comp]
        if comp in MERGE_OPS:
            new = arr[closed] if closed_on else torch.full_like(
                arr[closed], INIT[comp])
            back = ring["back_" + comp]
            back.copy_(_ring_combine(comp, back, new))
            continue
        tot = ring["tot_" + comp]
        zero = torch.zeros_like(tot)
        tot.copy_((tot + (arr[closed] if closed_on else zero))
                  - (arr[evict] if evict_on else zero))


def _ring_order(name: str, order, valid, R: int):
    order = np.ascontiguousarray(order, dtype=np.int32).reshape(-1)
    valid = np.ascontiguousarray(valid, dtype=np.uint8).reshape(-1)
    if len(order) != R or len(valid) != R or R > MAX_RING:
        raise ValueError(f"{name}: order / valid of {len(order)} / "
                         f"{len(valid)} for a ring of {R} slots")
    if R and not np.array_equal(np.sort(order), np.arange(R)):
        raise ValueError(f"{name}: order is not a permutation of the slots")
    return order, valid


def ring_flip(ring: Dict[str, torch.Tensor], state: Dict[str, torch.Tensor],
              comps: Sequence[str], order: np.ndarray,
              valid: np.ndarray) -> None:
    """The DABA flip, in place: over the ring slots in the age order
    `order` (int32 (R,), a permutation), masked by `valid` (bool (R,)),
    each additive component's tot becomes the masked sum; each two-stack
    component's front[order[i]] becomes the combine of slots i..R-1 (the
    reverse cumulative min/max) and its back the identity."""
    name = "ring_flip"
    R = next((ring["front_" + c].shape[0] for c in comps if c in MERGE_OPS),
             len(np.asarray(order).reshape(-1)))
    order, valid = _ring_order(name, order, valid, R)
    if not _on_cuda(name, state):
        ring_flip_plain(ring, state, comps, order, valid)
        return
    tab = _ring_table(name, ring, state, comps)
    if R > tab["P"]:
        raise ValueError(f"{name}: {R} ring slots, {tab['P']} panes")
    lib = _load()
    dev = tab["dev"]
    with torch.cuda.device(dev):
        rc = lib.slidingring.ring_flip(
            _ptr(tab["pane"]), _ptr(tab["run"]), _ptr(tab["front"]), _ptr(tab["w"]),
            _ptr(tab["ops"]), _ptr(tab["init"]), tab["n"], tab["C"],
            _ptr(order), _ptr(valid), R, _stream(dev))
        LAUNCHES[name] += 1
    _raise_on(lib, name, rc)


def ring_flip_plain(ring, state, comps, order, valid) -> None:
    """Plain PyTorch version of ring_flip (the reference's _flip_impl, in
    place): gather in age order, masked sum, flip + cummin/cummax + flip,
    scatter back by `order`."""
    dev = state["act"].device
    order = torch.as_tensor(np.asarray(order, dtype=np.int64), device=dev)
    valid = torch.as_tensor(np.asarray(valid, dtype=np.bool_), device=dev)
    for comp in comps:
        g = state[comp][order]
        vm = valid.view(-1, *([1] * (g.dim() - 1)))
        if comp not in MERGE_OPS:
            ring["tot_" + comp].copy_(torch.where(vm, g, 0.0).sum(dim=0))
            continue
        g = torch.where(vm, g, INIT[comp])
        scan = torch.cummin if comp == "mn" else torch.cummax
        suffix = scan(g.flip(0), dim=0).values.flip(0)
        ring["front_" + comp].index_copy_(0, order, suffix)
        ring["back_" + comp].fill_(INIT[comp])


def ring_query(ring: Dict[str, torch.Tensor], state: Dict[str, torch.Tensor],
               comps: Sequence[str], body_on: bool, f_on: bool, f_idx: int,
               adj_slots: np.ndarray, adj_w: np.ndarray,
               adj_mm: np.ndarray) -> torch.Tensor:
    """The window body of one trigger into a fresh float32 (C, W) tensor,
    `comps` side by side in that order (the components layout): for each
    additive component (tot if body_on else 0) + Σ adj_w[i] ·
    pane[adj_slots[i]] over all QUERY_ADJ slots; for each two-stack one the
    combine of front[f_idx] (if body_on and f_on), back (if body_on) and
    the panes whose adj_mm is set."""
    name = "ring_query"
    adj_slots = np.ascontiguousarray(adj_slots, dtype=np.int32).reshape(-1)
    adj_w = np.ascontiguousarray(adj_w, dtype=np.float32).reshape(-1)
    adj_mm = np.ascontiguousarray(adj_mm, dtype=np.uint8).reshape(-1)
    if not len(adj_slots) == len(adj_w) == len(adj_mm) == QUERY_ADJ:
        raise ValueError(f"{name}: {QUERY_ADJ} adjustment slots expected")
    if not _on_cuda(name, state):
        return ring_query_plain(ring, state, comps, body_on, f_on, f_idx,
                                adj_slots, adj_w, adj_mm)
    tab = _ring_table(name, ring, state, comps)
    if ((adj_slots < 0) | (adj_slots >= tab["P"])).any():
        raise ValueError(f"{name}: adjustment slot outside the panes")
    if tab["R"] is not None and not 0 <= f_idx < tab["R"]:
        raise ValueError(f"{name}: front slot {f_idx} outside the ring")
    out = torch.empty((tab["C"], int(tab["w"].sum())), dtype=torch.float32,
                      device=tab["dev"])
    lib = _load()
    dev = tab["dev"]
    with torch.cuda.device(dev):
        rc = lib.slidingring.ring_query(
            _ptr(tab["pane"]), _ptr(tab["run"]), _ptr(tab["front"]), _ptr(tab["w"]),
            _ptr(tab["ops"]), _ptr(tab["init"]), tab["n"], tab["C"],
            int(bool(body_on)), int(bool(f_on)), int(f_idx), _ptr(adj_slots),
            _ptr(adj_w), _ptr(adj_mm), _ptr(out), _stream(dev))
        LAUNCHES[name] += 1
    _raise_on(lib, name, rc)
    return out


def ring_query_plain(ring, state, comps, body_on, f_on, f_idx, adj_slots,
                     adj_w, adj_mm) -> torch.Tensor:
    """Plain PyTorch version of ring_query (the reference's _query_impl)."""
    C = state["act"].shape[1]
    parts = []
    for comp in comps:
        arr = state[comp]
        if comp not in MERGE_OPS:
            tot = ring["tot_" + comp]
            v = tot if body_on else torch.zeros_like(tot)
            for i in range(QUERY_ADJ):
                v = v + float(adj_w[i]) * arr[int(adj_slots[i])]
        else:
            ident = torch.full_like(arr[0], INIT[comp])
            v = (ring["front_" + comp][int(f_idx)] if body_on and f_on
                 else ident)
            v = _ring_combine(comp, v, ring["back_" + comp] if body_on
                              else ident)
            for i in range(QUERY_ADJ):
                v = _ring_combine(comp, v, arr[int(adj_slots[i])]
                                  if adj_mm[i] else ident)
        parts.append(v.reshape(C, -1))
    return torch.cat(parts, dim=1)


# ------------------------------------------------------------- rule group
def _rule_table(name: str, state: Dict[str, torch.Tensor]):
    """(rules, panes, slots, pointer array, width array) of a rule group's
    scalar components (act (R, P, C), each scalar component (R, P, C, K)),
    the whole state checked (hll and hist (R, P, C, K, W) too; heavy
    hitters and touch have no batched kernel); the pointers are rule 0's,
    the kernels add each rule's offset."""
    act = state["act"]
    if act.dim() != 3:
        raise ValueError(f"{name}: act of shape {tuple(act.shape)}, want "
                         "(rules, panes, slots)")
    NR, P, C = act.shape
    _check(name, act, torch.float32, (NR, P, C), act.device)
    if NR > MAX_RULES:
        raise ValueError(f"{name}: {NR} rules (max {MAX_RULES})")
    other = sorted(set(state) - set(COMP_IDS) - set(RULE_WIDE) - {"act"})
    if other:
        raise ValueError(f"{name}: components {other} have no batched "
                         "kernel")
    for comp in RULE_WIDE:
        arr = state.get(comp)
        if arr is not None:
            _check(name, arr, torch.float32,
                   (NR, P, C, arr.shape[3] if arr.dim() == 5 else -1,
                    WIDE_W[comp]), act.device)
    ptrs = np.zeros(len(COMP_IDS), dtype=np.uint64)
    ks = np.zeros(len(COMP_IDS), dtype=np.int32)
    for comp, j in COMP_IDS.items():
        arr = state.get(comp)
        if arr is None:
            continue
        _check(name, arr, torch.float32,
               (NR, P, C, arr.shape[3] if arr.dim() == 4 else -1),
               act.device)
        ptrs[j] = arr.data_ptr()
        ks[j] = arr.shape[3]
    return NR, P, C, ptrs, ks


#: the wide components a rule group batches (the reference refuses
#: heavy_hitters groups, parallel/multirule.py:117)
RULE_WIDE = ("hll", "hist")


def _rule_wide_table(state: Dict[str, torch.Tensor]):
    """(pointer array, K array) of a rule group's wide components, rule
    0's blocks, already checked by _rule_table."""
    ptrs = np.zeros(len(WIDE_IDS), dtype=np.uint64)
    ks = np.zeros(len(WIDE_IDS), dtype=np.int32)
    for comp in RULE_WIDE:
        arr = state.get(comp)
        if arr is not None:
            ptrs[WIDE_IDS[comp]] = arr.data_ptr()
            ks[WIDE_IDS[comp]] = arr.shape[3]
    return ptrs, ks


def _check_rule_panes(name: str, state: Dict[str, torch.Tensor],
                      pane_vec: Optional[torch.Tensor], n: int,
                      pane_hi: Optional[int] = None) -> None:
    """A rule group's per-row pane vector: uint8 (n,) on the state's
    device, every pane below P: a pane at or above P is an error, not a
    row silently dropped. `pane_hi`, the vector's largest pane as the
    caller computed it on the host (it built the vector there), is checked
    against P with no wait; without it the check reads the vector's max
    back (a reduction and a wait on the card's stream)."""
    if pane_vec is None:
        return
    act = state["act"]
    _check(name, pane_vec, torch.uint8, (n,), act.device)
    if not n:
        return
    hi = int(pane_vec.max()) if pane_hi is None else int(pane_hi)
    if hi >= act.shape[1]:
        raise ValueError(f"{name}: pane {hi} outside [0, {act.shape[1]})")


class FoldOrder(NamedTuple):
    """A chunk's rows in the rule-group folds' order (multirule_fold_order):
    `rows` int32 (n,) the row indices stably ordered by their flat key
    pane * C + slot, the dropped rows (slot outside [0, C), pane outside
    [0, P)) last; `offsets` int32 (P * C + 1,), key k's rows at
    rows[offsets[k]:offsets[k + 1]], offsets[P * C] the rows kept; `bits`,
    where the order was built with the chunk's `base`, that mask's WHERE
    bits packed as int32 (n, ceil(R / 32)) words (bit q of word w: rule
    32 w + q keeps the row), which both folds then read instead of packing
    their own."""

    rows: torch.Tensor
    offsets: torch.Tensor
    bits: Optional[torch.Tensor] = None


def multirule_fold_order(slots: torch.Tensor, pane: int, P: int, C: int,
                         pane_vec: Optional[torch.Tensor] = None,
                         base: Optional[torch.Tensor] = None) -> FoldOrder:
    """The order both rule-group folds read a chunk's rows in, in one call:
    a stable sort of the rows by pane * C + slot (pane: `pane`, or each
    row's pane_vec entry), and each key's segment. A helper kernel of the
    port: it replaces no program of the reference (whose scatters need no
    order). slots: int32 (n,); pane_vec: optional uint8 (n,); base:
    optional bool (R, n), the chunk's WHERE masks, packed into the
    order's `bits` in the same call (one pack a chunk for both folds)."""
    name = "multirule_fold_order"
    dev = _device_of(name, slots)
    if dev is None:
        return multirule_fold_order_plain(slots, pane, P, C, pane_vec, base)
    n = slots.shape[0]
    _check(name, slots, torch.int32, (n,), dev)
    if pane_vec is not None:
        _check(name, pane_vec, torch.uint8, (n,), dev)
    NR, bits = 0, None
    if base is not None:
        NR = base.shape[0]
        _check(name, base, torch.bool, (NR, n), dev)
        bits = _rule_bits(NR, n, dev)
    if not 0 <= pane < P or P * C >= 2 ** 31 - 1:
        raise ValueError(f"{name}: pane {pane} of {P} panes x {C} slots")
    lib = _load()
    size = lib.multirule.multirule_order_scratch_bytes(n)
    if size < 0:
        raise ValueError(f"{name}: {n} rows refused (at most 2^29)")
    scratch = torch.empty(size, dtype=torch.uint8, device=dev)
    rows = torch.empty(n, dtype=torch.int32, device=dev)
    offsets = torch.empty(P * C + 1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.multirule.multirule_fold_order(
            _ptr(slots), n, int(pane), _opt_ptr(pane_vec), P, C,
            _opt_ptr(base), NR, _opt_ptr(bits), _ptr(scratch), _ptr(rows),
            _ptr(offsets), _stream(dev))
        LAUNCHES[name] += 1
        if pane_vec is not None:
            ROW_PANE_LAUNCHES[name] += 1
    _raise_on(lib, name, rc)
    return FoldOrder(rows, offsets, bits)


def multirule_fold_order_plain(slots, pane, P, C, pane_vec=None, base=None
                               ) -> FoldOrder:
    """Plain PyTorch version of multirule_fold_order: a stable argsort of
    the flat key (dropped rows keyed past every real one), the keys'
    counts summed into offsets, and base's bits shifted into words."""
    K = P * C
    pc, ok = _pane_rows(pane, pane_vec, slots, P, C)
    key = torch.where(ok, pc, K)
    rows = torch.argsort(key, stable=True).to(torch.int32)
    offsets = torch.zeros(K + 1, dtype=torch.int32, device=slots.device)
    offsets[1:] = torch.cumsum(torch.bincount(key, minlength=K + 1)[:K], 0)
    bits = None
    if base is not None:
        NR, n = base.shape
        nw = (NR + 31) // 32
        b = torch.zeros((nw * 32, n), dtype=torch.int64, device=base.device)
        b[:NR] = base
        shift = torch.arange(32, device=base.device)[None, :, None]
        words = (b.view(nw, 32, n) << shift).sum(1).T
        bits = torch.where(words >= 2 ** 31, words - 2 ** 32,
                           words).to(torch.int32).contiguous()
    return FoldOrder(rows, offsets, bits)


def _rule_bits(NR: int, n: int, dev) -> torch.Tensor:
    """The folds' packed WHERE bits, (n, ceil(NR / 32)) words."""
    return torch.empty((n, (NR + 31) // 32), dtype=torch.int32, device=dev)


def _rule_order(name: str, order: Optional[FoldOrder], base, slots, pane,
                pane_vec, P: int, C: int, dev
                ) -> Tuple[FoldOrder, Optional[torch.Tensor], torch.Tensor]:
    """The fold's row order (the caller's, checked, or one built here with
    base's packed bits), the base to pack in the fold (None where the
    order holds its words) and the words' tensor."""
    if order is None:
        order = multirule_fold_order(slots, pane, P, C, pane_vec, base)
    n = slots.shape[0]
    _check(name, order.rows, torch.int32, (n,), dev)
    _check(name, order.offsets, torch.int32, (P * C + 1,), dev)
    if order.bits is None:
        return order, base, _rule_bits(base.shape[0], n, dev)
    _check(name, order.bits, torch.int32, (n, (base.shape[0] + 31) // 32),
           dev)
    return order, None, order.bits


def multirule_fold(state: Dict[str, torch.Tensor], base: torch.Tensor,
                   V: torch.Tensor, M: torch.Tensor, slots: torch.Tensor,
                   pane: int, colmap: np.ndarray,
                   pane_vec: Optional[torch.Tensor] = None,
                   pane_hi: Optional[int] = None,
                   order: Optional[FoldOrder] = None) -> None:
    """Fold one micro-batch into every rule of a group's state, in place:
    act and the scalar components of rule r take the rows of base[r].

    base: bool (R, n), each rule's row mask after its WHERE. V: float32
    (S, n) spec values and M: bool (S, n) spec masks (validity, not-NaN,
    FILTER: the same for every rule, without the row mask). slots: int32
    (n,). colmap: int32 (ncols, 3) of (COMP_IDS[comp], k, spec). pane_vec:
    optional uint8 (n,) per-row panes, shared by every rule, which replace
    `pane` (an event-time batch across bucket edges); each must be below
    P. pane_hi: optional host bound of pane_vec's entries (its max, which
    the caller computed where it built the vector): checked against P
    with no read-back. order: optional multirule_fold_order of these
    slots and panes (shared with multirule_fold_wide); built here when
    absent (the plain version needs none). The wide components are
    multirule_fold_wide's.
    """
    name = "multirule_fold"
    _check_rule_panes(name, state, pane_vec, V.shape[1], pane_hi)
    if not _on_cuda(name, state):
        multirule_fold_plain(state, base, V, M, slots, pane, colmap,
                             pane_vec)
        return
    NR, P, C, ptrs, ks = _rule_table(name, state)
    act = state["act"]
    dev = act.device
    S, n = V.shape
    _check(name, base, torch.bool, (NR, n), dev)
    colmap = _check_batch(name, V, M, slots, pane, P, colmap, dev,
                          slot_dtypes=(torch.int32,))
    for comp_id, k, _ in colmap.tolist():
        if not 0 <= k < ks[comp_id]:
            raise ValueError(f"{name}: column {k} outside component "
                             f"{_COMP_NAMES[comp_id]}")
    order, pack, bits = _rule_order(name, order, base, slots, pane, pane_vec,
                                    P, C, dev)
    # the packed bits, values and masks in the order
    bits_s = torch.empty((bits.shape[1], n), dtype=bits.dtype, device=dev)
    Vs, Ms = torch.empty_like(V), torch.empty_like(M)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.multirule.multirule_fold(
            _opt_ptr(pack), _ptr(V), _ptr(M), _ptr(slots), n, NR, int(pane),
            _opt_ptr(pane_vec), P, C, _ptr(colmap), len(colmap), _ptr(ptrs),
            _ptr(ks), _ptr(act), _ptr(order.rows), _ptr(order.offsets), S,
            _ptr(bits), _ptr(bits_s), _ptr(Vs), _ptr(Ms), _stream(dev))
        LAUNCHES[name] += 1
        if pane_vec is not None:
            ROW_PANE_LAUNCHES[name] += 1
    _raise_on(lib, name, rc)


def _rule_rows_plain(NR: int, P: int, C: int, pane, pane_vec, slots):
    """(NR, n) flat (rule, pane, slot) index of each rule's rows and the
    (n,) in-range mask: _pane_rows' index, offset by each rule's state."""
    pc, ok = _pane_rows(pane, pane_vec, slots, P, C)
    rule = torch.arange(NR, device=pc.device)[:, None]
    return rule * (P * C) + pc[None, :], ok


def multirule_fold_plain(state, base, V, M, slots, pane, colmap,
                         pane_vec=None) -> None:
    """Plain PyTorch version of multirule_fold: the single-rule plain fold's
    scatters over a rule-offset flat index, (r, pane, slot)."""
    NR, P, C = state["act"].shape
    S, n = V.shape
    pc, ok = _rule_rows_plain(NR, P, C, pane, pane_vec, slots)
    pc = pc.reshape(-1)
    rows = base & ok
    _fold_columns_plain(state, pc, rows.reshape(-1), V.repeat(1, NR),
                        (M[:, None, :] & rows[None]).reshape(S, -1), colmap)


def multirule_fold_wide(state: Dict[str, torch.Tensor], base: torch.Tensor,
                        V: torch.Tensor, M: torch.Tensor, slots: torch.Tensor,
                        pane: int, widemap: np.ndarray,
                        pane_vec: Optional[torch.Tensor] = None,
                        pane_hi: Optional[int] = None,
                        order: Optional[FoldOrder] = None) -> None:
    """Fold one micro-batch into every rule's hll and hist components, in
    place: rule r takes the rows of base[r]. base, V, M, slots, pane,
    pane_vec, pane_hi, order: as multirule_fold. widemap: int32 (ncols, 3)
    of (WIDE_IDS[comp], k, spec), hll and hist columns only."""
    name = "multirule_fold_wide"
    widemap = np.ascontiguousarray(widemap, dtype=np.int32).reshape(-1, 3)
    if (widemap[:, 0] == WIDE_IDS["hh"]).any():
        raise ValueError(f"{name}: heavy_hitters does not batch")
    _check_rule_panes(name, state, pane_vec, V.shape[1], pane_hi)
    if not _on_cuda(name, state):
        multirule_fold_wide_plain(state, base, V, M, slots, pane, widemap,
                                  pane_vec)
        return
    NR, P, C, _, _ = _rule_table(name, state)
    ptrs, ks = _rule_wide_table(state)
    dev = state["act"].device
    S, n = V.shape
    _check(name, base, torch.bool, (NR, n), dev)
    widemap = _check_batch(name, V, M, slots, pane, P, widemap, dev,
                           slot_dtypes=(torch.int32,))
    for comp_id, k, _ in widemap.tolist():
        if not 0 <= k < ks[comp_id]:
            raise ValueError(f"{name}: column {k} outside component "
                             f"{_WIDE_NAMES[comp_id]}")
    order, pack, bits = _rule_order(name, order, base, slots, pane, pane_vec,
                                    P, C, dev)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.multirule.multirule_fold_wide(
            _opt_ptr(pack), _ptr(V), _ptr(M), _ptr(slots), n, NR, int(pane),
            _opt_ptr(pane_vec), P, C, _ptr(widemap), len(widemap),
            _ptr(ptrs), _ptr(ks), _ptr(HIST_CONSTS), _ptr(order.rows),
            _ptr(order.offsets), _ptr(bits), _stream(dev))
        LAUNCHES[name] += 1
        if pane_vec is not None:
            ROW_PANE_LAUNCHES[name] += 1
    _raise_on(lib, name, rc)


def multirule_fold_wide_plain(state, base, V, M, slots, pane, widemap,
                              pane_vec=None) -> None:
    """Plain PyTorch version of multirule_fold_wide: each row's register
    and rho (or bin) once, scattered over a rule-offset flat index
    (r, pane, slot, k, register) for the rules that keep the row."""
    NR, P, C = state["act"].shape
    rp, ok = _rule_rows_plain(NR, P, C, pane, pane_vec, slots)  # (NR, n)
    for comp_id, k, s in np.asarray(widemap).reshape(-1, 3).tolist():
        comp = _WIDE_NAMES[comp_id]
        arr = state[comp]
        K, W = arr.shape[3], arr.shape[4]
        keep = base & (M[s] & ok)[None, :]
        flat = arr.view(-1)
        if comp == "hll":
            reg, rho = sketches.hll_parts(V[s])
            idx = (rp * K + k) * W + reg[None, :]
            flat.scatter_reduce_(0, idx[keep], rho.expand(NR, -1)[keep],
                                 "amax", include_self=True)
        else:
            idx = (rp * K + k) * W + sketches.hist_bin(V[s])[None, :]
            flat.index_put_((idx[keep],),
                            torch.ones_like(idx[keep], dtype=arr.dtype),
                            accumulate=True)


def multirule_finalize(state: Dict[str, torch.Tensor],
                       pane_mask: torch.Tensor, spectab: np.ndarray,
                       n_cols: int, rows: Optional[int] = None
                       ) -> torch.Tensor:
    """Every rule's final values in one launch: merge the panes selected
    by `pane_mask` (bool (P,)) and compute each scalar spec's final value
    (spectab as groupby_finalize_scalar's) for slots [0, n_cols). Returns
    a fresh float32 (R, rows, n_cols) on the state's device (rows defaults
    to S + 1), each rule's act in its last row; the rows of the hll and
    percentile_approx specs are multirule_finalize_wide's to write."""
    name = "multirule_finalize"
    spectab = np.ascontiguousarray(spectab, dtype=np.int32).reshape(
        -1, 2 + len(COMP_IDS))
    S = len(spectab)
    rows = S + 1 if rows is None else int(rows)
    if not _on_cuda(name, state):
        return multirule_finalize_plain(state, pane_mask, spectab, n_cols,
                                        rows)
    NR, P, C, ptrs, ks = _rule_table(name, state)
    act = state["act"]
    dev = act.device
    _check(name, pane_mask, torch.bool, (P,), dev)
    if not 0 <= n_cols <= C:
        raise ValueError(f"{name}: {n_cols} columns of {C} slots")
    if S > MAX_SPECS:
        raise ValueError(f"{name}: {S} specs (max {MAX_SPECS})")
    if (spectab[:, 0] == KIND_IDS["heavy_hitters"]).any():
        raise ValueError(f"{name}: heavy_hitters has no batched final value")
    _check_spectab(name, spectab, rows, ks)
    out = torch.empty((NR, rows, n_cols), dtype=torch.float32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.multirule.multirule_finalize(
            _ptr(ptrs), _ptr(ks), _ptr(act), _ptr(pane_mask), NR, P, C,
            int(n_cols), _ptr(spectab), S, rows, _ptr(out), _stream(dev))
        LAUNCHES[name] += 1
    _raise_on(lib, name, rc)
    return out


def multirule_finalize_plain(state, pane_mask, spectab, n_cols,
                             rows: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of multirule_finalize: the single-rule plain
    finalize behind the rule axis, on slots [0, n_cols)."""
    cut = {comp: arr[:, :, :n_cols] for comp, arr in state.items()}
    return _finalize_plain(cut, pane_mask, spectab, rows, 1)


def multirule_finalize_wide(state: Dict[str, torch.Tensor],
                            pane_mask: torch.Tensor, widetab: np.ndarray,
                            fracs: np.ndarray, out: torch.Tensor) -> None:
    """Every rule's hll and percentile_approx final values in one launch:
    pane-merge the hll / hist components under `pane_mask` and write the
    specs' rows of `out` (float32 (R, rows, n_cols), from
    multirule_finalize) for slots [0, n_cols). widetab, fracs: as
    groupby_finalize_wide's."""
    name = "multirule_finalize_wide"
    widetab = np.ascontiguousarray(widetab, dtype=np.int32).reshape(-1, 3)
    fracs = np.ascontiguousarray(fracs, dtype=np.float32).reshape(-1)
    if not _on_cuda(name, state):
        multirule_finalize_wide_plain(state, pane_mask, widetab, fracs, out)
        return
    NR, P, C, _, _ = _rule_table(name, state)
    ptrs, ks = _rule_wide_table(state)
    dev = state["act"].device
    _check(name, pane_mask, torch.bool, (P,), dev)
    rows, n_cols = out.shape[1], out.shape[2]
    _check(name, out, torch.float32, (NR, rows, n_cols), dev)
    if not 0 <= n_cols <= C:
        raise ValueError(f"{name}: {n_cols} columns of {C} slots")
    n = len(widetab)
    if n > MAX_SPECS or len(fracs) != n:
        raise ValueError(f"{name}: {n} specs, {len(fracs)} fractions "
                         f"(max {MAX_SPECS})")
    comp_of = {WIDE_KIND_IDS["hll"]: WIDE_IDS["hll"],
               WIDE_KIND_IDS["percentile_approx"]: WIDE_IDS["hist"]}
    for kind, k, row in widetab.tolist():
        if kind not in comp_of or not 0 <= k < ks[comp_of[kind]]:
            raise ValueError(f"{name}: spec ({kind}, {k}) has no column")
        if not 0 <= row < rows - 1:
            raise ValueError(f"{name}: output row {row} outside the result")
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.multirule.multirule_finalize_wide(
            _ptr(ptrs), _ptr(ks), _ptr(pane_mask), NR, P, C, int(n_cols),
            _ptr(widetab), _ptr(fracs), n, _ptr(HIST_CONSTS), HLL_NUM, rows,
            _ptr(out), _stream(dev))
        LAUNCHES[name] += 1
    _raise_on(lib, name, rc)


def multirule_finalize_wide_plain(state, pane_mask, widetab, fracs,
                                  out) -> None:
    """Plain PyTorch version of multirule_finalize_wide: the single-rule
    plain final values behind the rule axis, on slots [0, n_cols)."""
    kinds = {v: k for k, v in WIDE_KIND_IDS.items()}
    n_cols = out.shape[2]
    for (kind, k, row), frac in zip(np.asarray(widetab).reshape(-1, 3)
                                    .tolist(), np.asarray(fracs).tolist()):
        kind = kinds[kind]
        comp = "hll" if kind == "hll" else "hist"
        merged = _merged_plain(state[comp][:, :, :n_cols, k], comp,
                               pane_mask, 1)
        out[:, row] = final_value_plain(kind, {comp: merged},
                                        float(np.float32(frac)))


def multirule_reset_pane(state: Dict[str, torch.Tensor], pane: int) -> None:
    """Write the identity into pane `pane` of every rule, every component
    and act, in one launch."""
    name = "multirule_reset_pane"
    if not _on_cuda(name, state):
        multirule_reset_pane_plain(state, pane)
        return
    NR, P, C, _, _ = _rule_table(name, state)
    if not 0 <= pane < P:
        raise ValueError(f"{name}: pane {pane} outside [0, {P})")
    ptrs = np.zeros(len(state), dtype=np.uint64)
    lens = np.zeros(len(state), dtype=np.int64)
    inits = np.zeros(len(state), dtype=np.float32)
    for j, (comp, arr) in enumerate(state.items()):
        ptrs[j] = arr.data_ptr()
        lens[j] = arr[0, 0].numel()
        inits[j] = INIT[comp]
    lib = _load()
    dev = state["act"].device
    with torch.cuda.device(dev):
        rc = lib.multirule.multirule_reset_pane(
            _ptr(ptrs), _ptr(lens), _ptr(inits), len(state), NR, P,
            int(pane), _stream(dev))
        LAUNCHES[name] += 1
    _raise_on(lib, name, rc)


def multirule_reset_pane_plain(state, pane: int) -> None:
    """Plain PyTorch version of multirule_reset_pane."""
    for comp, arr in state.items():
        arr[:, pane].fill_(INIT[comp])


# ------------------------------------------------------------ tier store
def _tier_table(name: str, state: Dict[str, torch.Tensor],
                comps: Sequence[str]):
    """(pointers, floats per slot and pane, identities, merge ops, P, C,
    Wp) of the packed row's blocks `comps` (in packed order), checked."""
    act = state["act"]
    P, C = act.shape
    if not 0 < len(comps) <= MAX_PARTS:
        raise ValueError(f"{name}: {len(comps)} blocks (max {MAX_PARTS})")
    ptrs = np.zeros(len(comps), dtype=np.uint64)
    ws = np.zeros(len(comps), dtype=np.int64)
    inits = np.zeros(len(comps), dtype=np.float32)
    ops = np.zeros(len(comps), dtype=np.int32)
    for t, comp in enumerate(comps):
        arr = state[comp]
        _check(name, arr, torch.float32, (P, C, *arr.shape[2:]), act.device)
        ptrs[t], ws[t] = arr.data_ptr(), _slot_width(arr)
        inits[t], ops[t] = INIT[comp], MERGE_OPS.get(comp, 0)
    return ptrs, ws, inits, ops, P, C, int(P * ws.sum())


def _check_tier_slots(name: str, slots: torch.Tensor, dev) -> int:
    if slots.dtype != torch.int32 or slots.dim() != 1:
        raise TypeError(f"{name}: slots must be int32 (D,), got "
                        f"{slots.dtype} {tuple(slots.shape)}")
    _check(name, slots, torch.int32, slots.shape, dev)
    return len(slots)


def tier_demote(state: Dict[str, torch.Tensor], slots: torch.Tensor, n: int,
                comps: Sequence[str]) -> torch.Tensor:
    """Gather the rows of `slots` (int32 (D,) on the state's device) into a
    fresh float32 (D, Wp) block, the blocks `comps` (sorted components,
    then "act") side by side, each slot's (P, w) run flattened in C order;
    then reset slots[:n] of those components, and of a `touch` column, to
    the identity, in place. Rows [n, D) must repeat slots[0] (the
    reference's pads, TierStore._slots): they are row 0's copies, never
    reset twice; n >= 1 where D > 0."""
    name = "tier_demote"
    if not _on_cuda(name, state):
        return tier_demote_plain(state, slots, n, comps)
    dev = state["act"].device
    D = _check_tier_slots(name, slots, dev)
    if not min(D, 1) <= n <= D:
        raise ValueError(f"{name}: {n} real rows of {D}")
    ptrs, ws, inits, ops, P, C, Wp = _tier_table(name, state, comps)
    touch = state.get("touch")
    if touch is not None:
        _check(name, touch, torch.uint32, (C,), dev)
    packed = torch.empty((D, Wp), dtype=torch.float32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.tierstore.tier_demote(
            _ptr(ptrs), _ptr(ws), _ptr(inits), _ptr(ops), len(comps), P, C,
            _ptr(slots), D, int(n), _ptr(packed), _opt_ptr(touch),
            _stream(dev))
        LAUNCHES[name] += 1
    _raise_on(lib, name, rc)
    return packed


def tier_demote_plain(state, slots, n: int, comps) -> torch.Tensor:
    """Plain PyTorch version of tier_demote (the reference's gather, then
    the identity set over every slot of `slots`)."""
    idx = slots.long()
    D = len(idx)
    parts = [state[c][:, idx].movedim(1, 0).reshape(D, -1) for c in comps]
    packed = torch.cat(parts, dim=1)
    for c in comps:
        state[c][:, idx] = INIT[c]
    touch = state.get("touch")
    if touch is not None:  # no uint32 index_put_ in torch: via int64
        t = touch.long()
        t[idx] = 0
        touch.copy_(t.to(torch.uint32))
    return packed


def tier_promote(state: Dict[str, torch.Tensor], packed: torch.Tensor,
                 slots: torch.Tensor, comps: Sequence[str]) -> None:
    """Merge the rows of `packed` (float32 (D, Wp), tier_demote's layout)
    into `slots` (int32 (D,)) in place: min for mn, max for mx and hll,
    add otherwise. Pad rows hold the identity (TierStore.init_row)."""
    name = "tier_promote"
    if not _on_cuda(name, state):
        tier_promote_plain(state, packed, slots, comps)
        return
    dev = state["act"].device
    D = _check_tier_slots(name, slots, dev)
    ptrs, ws, inits, ops, P, C, Wp = _tier_table(name, state, comps)
    _check(name, packed, torch.float32, (D, Wp), dev)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.tierstore.tier_promote(
            _ptr(ptrs), _ptr(ws), _ptr(inits), _ptr(ops), len(comps), P, C,
            _ptr(slots), D, _ptr(packed), _stream(dev))
        LAUNCHES[name] += 1
    _raise_on(lib, name, rc)


def tier_promote_plain(state, packed, slots, comps) -> None:
    """Plain PyTorch version of tier_promote (the reference's scatter-add /
    -min / -max along the slot axis)."""
    idx = slots.long()
    D = len(idx)
    col = 0
    for c in comps:
        arr = state[c]
        P, tail = arr.shape[0], tuple(arr.shape[2:])
        w = P * int(np.prod(tail, dtype=np.int64))
        seg = packed[:, col:col + w].reshape(D, P, *tail).movedim(0, 1)
        col += w
        if c in ("mn", "mx", "hll"):
            at = idx.view(1, D, *([1] * len(tail))).expand_as(seg)
            arr.scatter_reduce_(1, at, seg, "amin" if c == "mn" else "amax",
                                include_self=True)
        else:
            arr.index_add_(1, idx, seg)


# ------------------------------------------------------- relational tier
#: the plain versions' segment of pad rows, after every real slot
#: (ekuiper_tpu/ops/segscan.py _SEG_PAD; the kernels flag pad rows instead)
SEG_PAD = 1 << 30
_I32 = (-(1 << 31), (1 << 31) - 1)


def _device_of(name: str, t: torch.Tensor) -> Optional[torch.device]:
    """The CUDA device to launch on, None for the plain version (CPU
    tensors); raises for any other device."""
    if t.device.type == "cpu":
        return None
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device


def _pow2_len(name: str, t: torch.Tensor) -> int:
    if t.dim() != 1 or t.shape[0] < 1 or t.shape[0] & (t.shape[0] - 1):
        raise ValueError(f"{name}: expected a 1-d tensor of a power-of-two "
                         f"length, got shape {tuple(t.shape)}")
    return int(t.shape[0])


def _residual_view(name: str, residual: Optional[torch.Tensor], PL: int,
                   PR: int, dev) -> Tuple[Optional[torch.Tensor], int, int]:
    """The residual mask as (tensor, stride along i, stride along j): a bool
    tensor broadcastable to (PL, PR) ((PL, PR), (PL, 1), (1, PR) or
    (1, 1)), read in place through its broadcast strides."""
    if residual is None:
        return None, 0, 0
    if residual.dtype != torch.bool:
        raise TypeError(f"{name}: residual must be bool, got "
                        f"{residual.dtype}")
    if residual.device != dev:
        raise ValueError(f"{name}: residual on {residual.device}, "
                         f"sides on {dev}")
    if residual.dim() != 2 or residual.shape[0] not in (1, PL) \
            or residual.shape[1] not in (1, PR):
        raise ValueError(f"{name}: residual of shape "
                         f"{tuple(residual.shape)} does not broadcast to "
                         f"({PL}, {PR})")
    view = residual.expand(PL, PR)
    if view.stride(1) not in (0, 1):  # the kernel reads along j in order
        residual = residual.contiguous()
        view = residual.expand(PL, PR)
    return residual, view.stride(0), view.stride(1)


def join_match(slot_l: torch.Tensor, ts_l: torch.Tensor, vl: torch.Tensor,
               slot_r: torch.Tensor, ts_r: torch.Tensor, vr: torch.Tensor,
               lo: int, hi: int,
               residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The interval join's pairing mask over a padded candidate block,
    mask[i, j] = slot_l[i] == slot_r[j] ∧ lo ≤ ts_l[i] − ts_r[j] ≤ hi ∧
    vl[i] ∧ vr[j] ∧ residual[i, j], packed one bit a pair: a fresh uint8
    (PL, 4·ceil(PR / 32)), bit j % 8 of byte j // 8 of row i (numpy's
    `packbits(..., bitorder="little")`, rows padded to whole 32-bit words
    with 0 bits; ops/joinring.py `unpack_mask` turns it back).

    slot_*, ts_*: int32 (PL,) / (PR,), PL and PR powers of two (the event
    times rebased so that every difference fits int32, ops/joinring.py);
    v*: bool row validity; lo, hi: int32 bounds; residual: None or a bool
    tensor broadcastable to (PL, PR) (the ON residual's IR result)."""
    name = "join_match"
    dev = _device_of(name, slot_l)
    if dev is None:
        return join_match_plain(slot_l, ts_l, vl, slot_r, ts_r, vr, lo, hi,
                                residual)
    PL, PR = _pow2_len(name, slot_l), _pow2_len(name, slot_r)
    for t, dtype, n in ((slot_l, torch.int32, PL), (ts_l, torch.int32, PL),
                        (vl, torch.bool, PL), (slot_r, torch.int32, PR),
                        (ts_r, torch.int32, PR), (vr, torch.bool, PR)):
        _check(name, t, dtype, (n,), dev)
    for b in (lo, hi):
        if not _I32[0] <= int(b) <= _I32[1]:
            raise ValueError(f"{name}: band bound {b} outside int32")
    res, rs_i, rs_j = _residual_view(name, residual, PL, PR, dev)
    mask = torch.empty((PL, _mask_bytes(PR)), dtype=torch.uint8, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.relational.join_match(
            _ptr(slot_l), _ptr(ts_l), _ptr(vl), PL, _ptr(slot_r),
            _ptr(ts_r), _ptr(vr), PR, int(lo), int(hi), _opt_ptr(res),
            rs_i, rs_j, _ptr(mask), _stream(dev))
        LAUNCHES[name] += 1
    _raise_on(lib, name, rc)
    return mask


def _mask_bytes(PR: int) -> int:
    """Bytes of a packed mask row: whole 32-bit words."""
    return 4 * ((PR + 31) // 32)


def join_match_plain(slot_l, ts_l, vl, slot_r, ts_r, vr, lo: int, hi: int,
                     residual=None) -> torch.Tensor:
    """Plain PyTorch version of join_match (the reference's broadcast
    compares, int32 differences), packed by a weighted sum over groups of
    8 (the CPU's torch has no shifts on uint32)."""
    dt = ts_l[:, None] - ts_r[None, :]
    mask = ((slot_l[:, None] == slot_r[None, :]) & (dt >= lo) & (dt <= hi)
            & vl[:, None] & vr[None, :])
    if residual is not None:
        mask = mask & residual
    PL, PR = mask.shape
    nb = _mask_bytes(PR)
    if nb * 8 != PR:  # the last word's pad bits: 0
        mask = torch.cat([mask, mask.new_zeros((PL, nb * 8 - PR))], 1)
    weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8,
                           device=mask.device)
    return (mask.reshape(PL, nb, 8).to(torch.uint8) * weights).sum(
        -1, dtype=torch.uint8)


def _seg_keys_checked(name: str, seg, vals, valid, dev) -> int:
    B = _pow2_len(name, seg)
    _check(name, seg, torch.int32, (B,), dev)
    _check(name, vals, torch.float32, (B,), dev)
    _check(name, valid, torch.bool, (B,), dev)
    return B


def _seg_scratch(lib, B: int, sorts: int, dev) -> torch.Tensor:
    """The sort's key buffers and look-back counters, as one byte tensor of
    the size csrc/relational.cu lays out (sorts 1: the shift, 2: the
    window functions)."""
    n = lib.relational.segscan_scratch_bytes(B, sorts)
    if n < 0:
        raise ValueError(f"segscan: {B} rows refused (at most 2^29)")
    return torch.empty(n, dtype=torch.uint8, device=dev)


def segscan_shift(carry: Sequence[torch.Tensor], slots: torch.Tensor,
                  vals: torch.Tensor, valid: torch.Tensor
                  ) -> Tuple[torch.Tensor, ...]:
    """lag / row_number / running sum of one padded micro-batch, continuing
    the per-slot carry (cnt int32, last float32, has bool, acc float32, each
    (C,)), which it updates in place.

    slots: int32 (B,), B a power of two, each valid row's in [0, C) (a row
    outside counts no carry and writes none); vals: float32 (B,), NaN for
    NULL; valid: bool (B,). Returns fresh (row_number int32, lag float32,
    lag_has bool, run_sum float32) in arrival order (pad rows: 0, NaN,
    False, 0) and the continued partitions as an int32 (1,) tensor."""
    name = "segscan_shift"
    dev = _device_of(name, slots)
    if dev is None:
        return segscan_shift_plain(carry, slots, vals, valid)
    B = _seg_keys_checked(name, slots, vals, valid, dev)
    cnt, last, has, acc = carry
    C = cnt.shape[0]
    for t, dtype in ((cnt, torch.int32), (last, torch.float32),
                     (has, torch.bool), (acc, torch.float32)):
        _check(name, t, dtype, (C,), dev)
    lib = _load()
    scratch = _seg_scratch(lib, B, 1, dev)
    rn = torch.empty(B, dtype=torch.int32, device=dev)
    lag = torch.empty(B, dtype=torch.float32, device=dev)
    lhas = torch.empty(B, dtype=torch.bool, device=dev)
    run = torch.empty(B, dtype=torch.float32, device=dev)
    cont = torch.empty(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.relational.segscan_shift(
            _ptr(slots), _ptr(vals), _ptr(valid), B, _ptr(cnt), _ptr(last),
            _ptr(has), _ptr(acc), C, _ptr(scratch), _ptr(rn), _ptr(lag),
            _ptr(lhas), _ptr(run), _ptr(cont), _stream(dev))
        LAUNCHES[name] += 1
    _raise_on(lib, name, rc)
    return rn, lag, lhas, run, cont


def _seg_starts(ss: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(head flags, index of each position's segment head) of a sorted
    segment-id vector."""
    B = ss.shape[0]
    head = torch.ones(B, dtype=torch.bool, device=ss.device)
    head[1:] = ss[1:] != ss[:-1]
    idx = torch.arange(B, device=ss.device)
    start = torch.cummax(torch.where(head, idx, 0), 0).values
    return head, start


def _unsort(order: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(x)
    out[order] = x
    return out


def _seg_cumsum(head: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented sum, reset at every True of `head` (the
    reference's `_seg_cumsum`, a Hillis-Steele scan of (flag, value)
    pairs): no value, ±inf or NaN-making sum crosses a segment head."""
    f, v = head.clone(), x.clone()
    d = 1
    while d < x.shape[0]:
        v[d:] = torch.where(f[d:], v[d:], v[:-d] + v[d:])
        f[d:] = f[d:] | f[:-d]
        d <<= 1
    return v


def segscan_shift_plain(carry, slots, vals, valid):
    """Plain PyTorch version of segscan_shift (the reference's stable sort,
    segmented positions and sums; the sums a segmented scan in float64,
    rounded once)."""
    cnt, last, has, acc = carry
    B, C = slots.shape[0], cnt.shape[0]
    dev = slots.device
    s = torch.where(valid, slots, torch.full_like(slots, SEG_PAD))
    ss, order = torch.sort(s, stable=True)
    vv = vals[order]
    real = ss != SEG_PAD
    inr = real & (ss >= 0) & (ss < C)
    sc = torch.where(inr, ss, 0).long()
    head, start = _seg_starts(ss)
    tail = torch.ones(B, dtype=torch.bool, device=dev)
    tail[:-1] = ss[:-1] != ss[1:]
    idx = torch.arange(B, device=dev)
    pos = (idx - start + 1).to(torch.int32)
    c0 = torch.where(inr, cnt[sc], 0)
    h0 = inr & has[sc]
    l0 = last[sc]
    a0 = torch.where(inr, acc[sc], 0.0)
    nan = torch.tensor(float("nan"), device=dev)
    pv = torch.cat([vv[:1], vv[:-1]])
    lag = torch.where(head, torch.where(h0, l0, nan), pv)
    lhas = torch.where(head, h0, torch.ones_like(h0))
    vz = torch.where(torch.isnan(vv), 0.0, vv).double()
    run = a0 + _seg_cumsum(head, vz).float()
    rn = c0 + pos
    cont = (head & h0).sum().to(torch.int32).reshape(1)
    w = tail & inr
    ws = ss[w].long()
    cnt[ws] = rn[w]
    last[ws] = vv[w]
    has[ws] = True
    acc[ws] = run[w]
    rn = torch.where(real, rn, 0)
    lag = torch.where(real, lag, nan)
    lhas = lhas & real
    run = torch.where(real, run, 0.0)
    return (_unsort(order, rn), _unsort(order, lag), _unsort(order, lhas),
            _unsort(order, run), cont)


def segscan_sort(seg: torch.Tensor, vals: torch.Tensor, valid: torch.Tensor
                 ) -> Tuple[torch.Tensor, ...]:
    """Whole-collection window functions of one padded collection: fresh
    (row_number int32, lead float32, lead_has bool, rank int32,
    dense_rank int32, rank_has bool) in arrival order; row_number and
    lead(1) in arrival order within a segment, rank / dense_rank in value
    order within it (NaN = NULL sorts last and ranks as NULL).

    seg: int32 (B,), B a power of two, each valid row's in [0, 2^30);
    vals: float32 (B,); valid: bool (B,). Pad rows: 0, NaN, False, 0, 0,
    False."""
    name = "segscan_sort"
    dev = _device_of(name, seg)
    if dev is None:
        return segscan_sort_plain(seg, vals, valid)
    B = _seg_keys_checked(name, seg, vals, valid, dev)
    lib = _load()
    scratch = _seg_scratch(lib, B, 2, dev)
    rn = torch.empty(B, dtype=torch.int32, device=dev)
    lead = torch.empty(B, dtype=torch.float32, device=dev)
    lead_has = torch.empty(B, dtype=torch.bool, device=dev)
    rank = torch.empty(B, dtype=torch.int32, device=dev)
    dense = torch.empty(B, dtype=torch.int32, device=dev)
    rank_has = torch.empty(B, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        rc = lib.relational.segscan_sort(
            _ptr(seg), _ptr(vals), _ptr(valid), B, _ptr(scratch), _ptr(rn),
            _ptr(lead), _ptr(lead_has), _ptr(rank), _ptr(dense),
            _ptr(rank_has), _stream(dev))
        LAUNCHES[name] += 1
    _raise_on(lib, name, rc)
    return rn, lead, lead_has, rank, dense, rank_has


def segscan_sort_plain(seg, vals, valid):
    """Plain PyTorch version of segscan_sort (the reference's two stable
    orders, segmented positions, and propagated value-group heads)."""
    B = seg.shape[0]
    dev = seg.device
    s = torch.where(valid, seg, torch.full_like(seg, SEG_PAD))
    idx = torch.arange(B, device=dev)
    nan = torch.tensor(float("nan"), device=dev)
    # arrival order within a segment: row_number, lead(1)
    s1, o1 = torch.sort(s, stable=True)
    real1 = s1 != SEG_PAD
    _, start1 = _seg_starts(s1)
    rn = torch.where(real1, (idx - start1 + 1).to(torch.int32), 0)
    same = torch.zeros(B, dtype=torch.bool, device=dev)
    same[:-1] = s1[:-1] == s1[1:]
    same &= real1
    v1 = vals[o1]
    nxt = torch.where(same, torch.cat([v1[1:], v1[:1]]), nan)
    # value order within a segment (NaN keyed as +inf, arrival breaking
    # ties): two stable sorts, the value's first
    vkey = torch.where(torch.isnan(vals), float("inf"), vals)
    ov = torch.sort(vkey, stable=True).indices
    o2 = ov[torch.sort(s[ov], stable=True).indices]
    s2, k2 = s[o2], vkey[o2]
    head2, start2 = _seg_starts(s2)
    newv = head2.clone()
    newv[1:] |= k2[1:] != k2[:-1]
    pos2 = idx - start2 + 1
    last_new = torch.cummax(torch.where(newv, idx, 0), 0).values
    cs = torch.cumsum(newv.to(torch.int64), 0)
    dense = cs - cs[start2] + 1
    vval = ~torch.isnan(vals[o2]) & (s2 != SEG_PAD)
    rank = torch.where(vval, pos2[last_new], 0).to(torch.int32)
    dense = torch.where(vval, dense, 0).to(torch.int32)
    return (_unsort(o1, rn), _unsort(o1, nxt), _unsort(o1, same),
            _unsort(o2, rank), _unsort(o2, dense), _unsort(o2, vval))


# ------------------------------------------------------------- count-min
def _check_cms(name: str, counts: torch.Tensor, values: torch.Tensor,
               dev) -> Tuple[int, int, int]:
    """(depth, width, n), checked: float32 contiguous (d, w) counts and
    (n,) values on one device, sizes the kernels' int arguments take."""
    if counts.dim() != 2 or min(counts.shape) < 1:
        raise ValueError(f"{name}: counts must be (depth, width), got "
                         f"{tuple(counts.shape)}")
    d, w = (int(x) for x in counts.shape)
    _check(name, counts, torch.float32, (d, w), dev)
    if values.dim() != 1:
        raise ValueError(f"{name}: values must be 1-d, got "
                         f"{tuple(values.shape)}")
    n = int(values.shape[0])
    _check(name, values, torch.float32, (n,), dev)
    if d * w >= 1 << 31 or n >= 1 << 31:
        raise ValueError(f"{name}: sizes past int32")
    return d, w, n


def _cms_cells_plain(values: torch.Tensor, depth: int,
                     width: int) -> torch.Tensor:
    """(d, n) int64 flat cells d·w + hash_f32(v, d + 2) % w (the hash in
    int64 over the float's bits, so -0.0 and +0.0 hash apart)."""
    return torch.stack([d * width + sketches.hash_f32(values, salt=d + 2)
                        % width for d in range(depth)])


def cms_update(counts: torch.Tensor, values: torch.Tensor) -> None:
    """Count-min update (#10), in place: counts[d, h_d(v)] += 1 for each
    value and row. counts: float32 (d, w); values: float32 (n,)."""
    name = "cms_update"
    dev = _device_of(name, counts)
    if dev is None:
        cms_update_plain(counts, values)
        return
    d, w, n = _check_cms(name, counts, values, dev)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.countmin.cms_update(_ptr(counts), d, w, _ptr(values), n,
                                     _stream(dev))
        LAUNCHES[name] += 1
    _raise_on(lib, name, rc)


def cms_update_plain(counts, values) -> None:
    """Plain PyTorch version of cms_update (the reference's d scatter-adds;
    the counts stay integers below 2^24, so any order gives its bits)."""
    d, w = counts.shape
    cells = _cms_cells_plain(values, d, w).reshape(-1)
    counts.view(-1).index_add_(0, cells, torch.ones(
        cells.shape, dtype=counts.dtype, device=counts.device))


def cms_query(counts: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Count-min point query (#11): a fresh float32 (n,) of each value's min
    over its d cells. counts, values: as cms_update."""
    name = "cms_query"
    dev = _device_of(name, counts)
    if dev is None:
        return cms_query_plain(counts, values)
    d, w, n = _check_cms(name, counts, values, dev)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.countmin.cms_query(_ptr(counts), d, w, _ptr(values), n,
                                    _ptr(out), _stream(dev))
        LAUNCHES[name] += 1
    _raise_on(lib, name, rc)
    return out


def cms_query_plain(counts, values) -> torch.Tensor:
    """Plain PyTorch version of cms_query (the reference's d gathers and
    their min)."""
    d, w = counts.shape
    return counts.view(-1)[_cms_cells_plain(values, d, w)].amin(0)


# ------------------------------------------------------------ mesh shards
def _check_shards(name: str, parts: Dict[str, torch.Tensor], R: int,
                  m: int, N: int) -> Tuple[int, int]:
    """(P', C) of a partials dict of R row shards, checked: act (R·P', C),
    a touch partial uint32 (R, C); N rows cover at most R shards of m."""
    act = parts["act"]
    RP, C = act.shape
    if R < 1 or RP % R or m < 1 or N > R * m:
        raise ValueError(f"{name}: {N} rows in {R} row shards of {m}, "
                         f"partials of {RP} panes")
    touch = parts.get("touch")
    if touch is not None:
        _check(name, touch, torch.uint32, (R, C), act.device)
    return RP // R, C


def _shard_panes_plain(N: int, m: int, R: int, P: int, pane_vec, dev):
    """(N,) int64 partial pane of each row (row shard r's block r·P' plus
    its pane, csrc/sharded.cu part_pane), and the rows kept: a pane outside
    [0, P') in no block."""
    r = torch.arange(N, device=dev) // m
    p = (torch.zeros(N, dtype=torch.long, device=dev) if pane_vec is None
         else pane_vec.long())
    ok = (r < R) & (p < P)
    return torch.where(ok, r * P + p.clamp(max=P - 1), 0), ok


def sharded_fold(parts: Dict[str, torch.Tensor], base: torch.Tensor,
                 V: torch.Tensor, M: torch.Tensor, slots: torch.Tensor,
                 rows_per_shard: int, row_shards: int, key_shards: int,
                 colmap: np.ndarray, widemap: np.ndarray,
                 pane_vec: Optional[torch.Tensor] = None) -> None:
    """The sharded fold (#23; #24 with `pane_vec`): every (row shard, key
    shard) of a mesh on one device folds its rows into its identity
    partial, in place, act, the scalar and touch columns and the hll /
    hist columns, in ONE launch.

    parts: the partials, comp (R·P', C, k[, W]), act (R·P', C) and, for a
    state with a touch column, touch uint32 (R, C); row shard r's block of
    P' panes at r·P'. Row i of the chunk belongs to row shard i //
    rows_per_shard; its key shard is slot // (C / key_shards), and its
    partial slot is its global slot (a key shard's range is its slice of
    the block). base, V, M, slots, colmap, widemap: as groupby_fold's.
    pane_vec: optional uint8 (N,) per-row panes inside each block (P' the
    state's panes), else pane 0 of each block (P' = 1); a pane outside
    [0, P') is dropped. heavy_hitters never reaches a mesh (the planner
    refuses it).
    """
    name = "sharded_fold"
    R, K, m = int(row_shards), int(key_shards), int(rows_per_shard)
    S, N = V.shape
    P, C = _check_shards(name, parts, R, m, N)
    if K < 1 or C % K:
        raise ValueError(f"{name}: {C} slots in {K} key shards")
    if "hh" in parts:
        raise ValueError(f"{name}: heavy_hitters state on a mesh")
    if not _on_cuda(name, parts):
        sharded_fold_plain(parts, base, V, M, slots, m, R, K, colmap,
                           widemap, pane_vec)
        return
    act = parts["act"]
    dev = act.device
    _check(name, base, torch.bool, (N,), dev)
    colmap = _check_batch(name, V, M, slots, 0, R * P, colmap, dev, pane_vec)
    widemap = _col_map(name, widemap, S)
    ptrs, ks = _comp_table(name, parts)
    wptrs, wks = _wide_table(name, parts)
    _check_wide_cols(name, widemap, wks)
    touch = parts.get("touch")
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.sharded.sharded_fold(
            _ptr(base), _ptr(V), _ptr(M), _ptr(slots), _u16(slots), N, m, R,
            _opt_ptr(pane_vec), P, C // K, K, _ptr(colmap), len(colmap),
            _ptr(widemap), len(widemap), _ptr(ptrs), _ptr(ks), _ptr(act),
            _opt_ptr(touch), _ptr(wptrs), _ptr(wks), _ptr(HIST_CONSTS),
            _stream(dev))
        LAUNCHES[name] += 1
        if pane_vec is not None:
            ROW_PANE_LAUNCHES[name] += 1
        if touch is not None:
            TOUCH_LAUNCHES[name] += 1
    _raise_on(lib, name, rc)


def sharded_fold_plain(parts, base, V, M, slots, rows_per_shard, row_shards,
                       key_shards, colmap, widemap, pane_vec=None) -> None:
    """Plain PyTorch version of sharded_fold: the reference's local_fold
    scatters of every shard at once, over the row shards' partial panes
    (the key shards are slices of the slot axis)."""
    R, m = int(row_shards), int(rows_per_shard)
    RP, C = parts["act"].shape
    N = V.shape[1]
    pp, ok = _shard_panes_plain(N, m, R, RP // R, pane_vec, V.device)
    pc, in_slots = _pane_rows(0, pp, slots, RP, C)
    _fold_columns_plain(parts, pc, base & ok & in_slots,
                        V, M & ok & in_slots, colmap)
    touch = parts.get("touch")
    if touch is not None:  # per row shard, pane-independent (as _touch_plain)
        s = slots.long()
        r = torch.arange(N, device=V.device) // m
        keep = base & (s >= 0) & (s < C) & (r < R)
        flat = r * C + s
        t = touch.long().view(-1)
        t.index_add_(0, flat[keep], torch.ones_like(flat[keep]))
        touch.copy_((t.view(R, C) & 0xFFFFFFFF).to(torch.uint32))
    if len(np.asarray(widemap).reshape(-1, 3)):
        fold_wide_plain(parts, V, M & ok, slots, 0, widemap, pp)


#: the merge's op of a component (csrc/sharded.cu OP_ADD / OP_MIN / OP_MAX)
SHARD_OPS = {"mn": 1, "mx": 2, "hll": 2}  # every other component: 0, a sum
_SHARD_FNS = {0: torch.add, 1: torch.minimum, 2: torch.maximum}


def shard_merge(state: Dict[str, torch.Tensor],
                parts: Dict[str, torch.Tensor], pane: int,
                row_shards: int) -> None:
    """The merge over the rows axis (the reference's psum / pmin / pmax of
    #23 and #24): every component's R row-shard partials reduced in r
    order by its op (sum; min for mn; max for mx and hll), then added /
    min-ed / max-ed into the state, in place, in one launch; the partials
    written back to their identity. P' = 1 partials merge into pane
    `pane`; P' = P (a pane-vector fold's) into every pane. A touch
    partial's counts add into the state's touch column."""
    name = "shard_merge"
    R = int(row_shards)
    act = state["act"]
    P, C = act.shape
    Pp, Cp = _check_shards(name, parts, R, 1, 0)
    if Cp != C or Pp not in (1, P) or not 0 <= int(pane) < P:
        raise ValueError(f"{name}: partials of {Pp} panes x {Cp} slots "
                         f"for a state of {P} x {C}, pane {pane}")
    if set(parts) != set(state):
        raise ValueError(f"{name}: partials {sorted(parts)} for state "
                         f"{sorted(state)}")
    if not _on_cuda(name, state):
        shard_merge_plain(state, parts, pane, R)
        return
    dev = act.device
    comps = [c for c in state if c != "touch"]
    if len(comps) > MAX_RESET:
        raise ValueError(f"{name}: {len(comps)} components")
    sp = np.zeros(len(comps), dtype=np.uint64)
    pp = np.zeros(len(comps), dtype=np.uint64)
    lens = np.zeros(len(comps), dtype=np.int64)
    ops = np.zeros(len(comps), dtype=np.int32)
    idents = np.zeros(len(comps), dtype=np.float32)
    for j, comp in enumerate(comps):
        s, p = state[comp], parts[comp]
        _check(name, s, torch.float32, s.shape, dev)
        _check(name, p, torch.float32, (R * Pp, *s.shape[1:]), dev)
        sp[j], pp[j] = s.data_ptr(), p.data_ptr()
        lens[j] = s[0].numel()
        ops[j] = SHARD_OPS.get(comp, 0)
        idents[j] = INIT[comp]
    touch, t_part = state.get("touch"), parts.get("touch")
    if touch is not None:
        _check(name, touch, torch.uint32, (C,), dev)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.sharded.shard_merge(
            _ptr(sp), _ptr(pp), _ptr(lens), _ptr(ops), _ptr(idents),
            len(comps), R, Pp, int(pane), _opt_ptr(touch), _opt_ptr(t_part),
            C, _stream(dev))
        LAUNCHES[name] += 1
    _raise_on(lib, name, rc)


def shard_merge_plain(state, parts, pane: int, row_shards: int) -> None:
    """Plain PyTorch version of shard_merge: per component, the R partials
    reduced in r order, combined into the state, reset to the identity."""
    R = int(row_shards)
    Pp = parts["act"].shape[0] // R
    for comp, part in parts.items():
        if comp == "touch":
            add = part.long().sum(0)  # integers: any order
            t = (state["touch"].long() + add) & 0xFFFFFFFF
            state["touch"].copy_(t.to(torch.uint32))
            part.copy_(torch.zeros_like(part))
            continue
        fn = _SHARD_FNS[SHARD_OPS.get(comp, 0)]
        blocks = part.view(R, Pp, *part.shape[1:])
        acc = blocks[0]
        for r in range(1, R):
            acc = fn(acc, blocks[r])
        dst = state[comp][pane:pane + 1] if Pp == 1 else state[comp]
        dst.copy_(fn(dst, acc))
        part.fill_(INIT[comp])


# ------------------------------------------------------------ host tables
def column_map(comp_specs: Dict[str, Sequence[int]]) -> np.ndarray:
    """(ncols, 3) int32 of (COMP_IDS[comp], k, spec) for a plan's scalar
    component → spec-index lists."""
    rows: List[Tuple[int, int, int]] = [
        (COMP_IDS[comp], k, si)
        for comp, idxs in comp_specs.items() if comp in COMP_IDS
        for k, si in enumerate(idxs)]
    return np.asarray(rows, dtype=np.int32).reshape(-1, 3)


def wide_column_map(comp_specs: Dict[str, Sequence[int]]) -> np.ndarray:
    """(ncols, 3) int32 of (WIDE_IDS[comp], k, spec) for a plan's wide
    components."""
    rows: List[Tuple[int, int, int]] = [
        (WIDE_IDS[comp], k, si)
        for comp, idxs in comp_specs.items() if comp in WIDE_IDS
        for k, si in enumerate(idxs)]
    return np.asarray(rows, dtype=np.int32).reshape(-1, 3)


def spec_table(kinds: Sequence[str],
               comp_specs: Dict[str, Sequence[int]],
               rows: Optional[Sequence[int]] = None) -> np.ndarray:
    """(S, 7) int32 of (KIND_IDS[kind], k per scalar component or -1,
    output row); rows default to the spec order."""
    tab = np.full((len(kinds), 2 + len(COMP_IDS)), -1, dtype=np.int32)
    for i, kind in enumerate(kinds):
        tab[i, 0] = KIND_IDS[kind]
    for comp, idxs in comp_specs.items():
        if comp not in COMP_IDS:
            continue
        for k, si in enumerate(idxs):
            tab[si, 1 + COMP_IDS[comp]] = k
    tab[:, -1] = np.arange(len(kinds)) if rows is None else rows
    return tab
