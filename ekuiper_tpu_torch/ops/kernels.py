"""The group-by kernels of the fused window aggregate: their CUDA build, the
wrappers that launch them, their plain PyTorch versions and their launch
counts.

Twenty kernels, written by hand in CUDA C++ for Hopper, each replacing
one device program of the reference (ekuiper_tpu/ops/groupby.py,
ekuiper_tpu/ops/slidingring.py, ekuiper_tpu/parallel/multirule.py and
ekuiper_tpu/ops/tierstore.py). Four in
ekuiper_tpu_torch/csrc/groupby.cu:

- `groupby_fold_scalar` replaces `DeviceGroupBy._fold_impl` → `_fold_core`
  (groupby.py:348-441): scatter-add of act/n/s1/s2 and scatter-min/max of
  mn/mx at [pane, slot, k] for one micro-batch, and, for a state with a
  touch column (tiered key state), the uint32 touch[slot] += 1 of each
  row past the WHERE (groupby.py:379-385). Bound on an H100: a
  65,536-row batch moves ~2 MB (the spec values and masks, slots, the
  touched state lines), 0.7 µs at 3.35 TB/s; each row also issues one
  atomic per state column, so the atomics' throughput at L2 may bound it
  instead (which of the two does is not measured; chip_smoke.py reports
  the kernel body's device time beside the bound). Design: one thread
  per row, one launch per batch, native float atomicAdd and a sign-split
  integer atomic for min/max (no compare-and-swap loop), and the
  expression closures evaluated by torch into dense (S, R) value/mask
  tensors first, so the kernel itself does no expression work. Rows go
  to one pane, or each to its own pane (`pane_vec`, the reference's
  uint8 per-row pane vector, groupby.py:334-338: a sliding batch that
  crosses a bucket edge). Slots come as int32 (the host fold's upload) or
  uint16 (a cached sliding batch, the reference's slot_dtype).
- `groupby_fold_masked_scalar` replaces `_fold_masked_impl` (groupby.py:354):
  the same fold of a cached, padded batch under an explicit (mb,) row mask
  (mask ∧ WHERE), into one pane: the sliding refold's edge folds. Bound
  as the fold's; one thread per row, a row with mask 0 (a hole, or the
  padding past the batch's real rows) writes nothing.
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

And four in ekuiper_tpu_torch/csrc/sketches.cu, for the sketch
aggregates (hll, percentile_approx, heavy_hitters), whose state
components are wide: (P, C, K, W) with W = 256 / 1,024 / 2,688:

- `groupby_fold_wide` replaces the hll/hist/hh branches of `_fold_core`
  (groupby.py:419-439): per valid row an atomic max of rho into register
  h1 & 255, an atomic add into the value's log bin, or, per depth,
  atomic adds into the code's cell total and its set bits. One launch per
  batch beside groupby_fold_scalar (which adds act and the scalar
  columns), with the same per-row panes (the hh branch indexes
  (pane_vec[r], slot, k, idx), groupby.py:432-434). Likely bound: its
  atomics at L2 (at most 42 a row for hh).
- `groupby_fold_masked_wide` replaces the same branches of
  `_fold_masked_impl` (groupby.py:354): the wide fold under the refold's
  row mask into one pane, beside groupby_fold_masked_scalar, sharing the
  per-row code of groupby_fold_wide.
- `groupby_finalize_wide` replaces the `hll` and `percentile_approx`
  kinds of `_final_value` (groupby.py:510-519) and their pane merge: one
  block per slot; it writes those specs' rows of the same output that
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
ONE launch for every rule of the group, with the per-row and per-slot code
of the single-rule kernels (csrc/groupby_common.cuh,
csrc/sketch_common.cuh):

- `multirule_fold` replaces `BatchedGroupBy._batched_fold_impl`
  (multirule.py:196), the vmap of #1 with each rule's WHERE parameters
  bound: the shared spec values and masks, each rule's row mask, into
  (R, P, C, k). Bound: 17.6 MB of inputs at the 256-rule group (5.3 µs),
  but ~33M scattered atomics a batch into 67 MB of state, which set its
  time.
- `multirule_fold_wide` replaces the hll / hist branches of the same vmap
  (groupby.py:421-432): each row's register and rho, or its bin, computed
  once and applied to every rule whose row mask keeps the row, into
  (R, P, C, k, W). Bit-equal to its plain version (max is order-free,
  counts stay below 2^24). Bound: its inputs once, then one scattered
  atomic per (rule, passing row, sketch column) into GBs of state.
- `multirule_finalize` replaces `_batched_finalize_impl` (multirule.py:210)
  and the key cut of `finalize_begin`: every rule's pane merge and final
  values into a fresh (R, S+1, K) result, K the columns the host takes.
- `multirule_finalize_wide` replaces that vmap's hll and percentile_approx
  final values (groupby.py:510-519): one block per (rule, key) writes
  their rows of multirule_finalize's result. Bound: reading each live
  (rule, pane, key) register or bin run once.
- `multirule_reset_pane` replaces `_batched_reset_impl` (multirule.py:256):
  pane p of every rule and component to its identity, the wide ones too
  (64-bit lengths: a hopping percentile group of 63 rules holds 2.1e9
  floats).

And two in ekuiper_tpu_torch/csrc/tierstore.cu, for the tiered key state
(ops/tierstore.py), over a packed row layout: each component's per-pane
block of one slot flattened in C order, the components sorted, act last:

- `tier_demote` replaces `TierStore._demote_impl` (tierstore.py:263): D
  slots' rows gathered into a fresh (D, Wp) block, then the n real slots
  (and their touch counters) reset to the identity; pad rows repeat a
  real slot. Two launches in order, so no reset races a pad's gather.
- `tier_promote` replaces `_promote_impl` (tierstore.py:278): a block's
  rows merged into their slots by atomic add / min / max (identity pad
  rows on a repeated slot change nothing).

Each wrapper takes its plain PyTorch version for tensors on the CPU, and
only there; for a CUDA tensor it launches the kernel or raises. A wrapper
adds one to `LAUNCHES[name]` where it launches its kernel and nowhere else.
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
from typing import Dict, List, Optional, Sequence, Tuple

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
           "tierstore": _PKG / "csrc" / "tierstore.cu"}
#: headers the sources include (part of every library's build tag)
HEADERS = (_PKG / "csrc" / "groupby_common.cuh",
           _PKG / "csrc" / "sketch_common.cuh",
           _PKG / "csrc" / "slot_type.cuh")
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
LAUNCHES: Dict[str, int] = {"groupby_fold_scalar": 0,
                            "groupby_fold_masked_scalar": 0,
                            "groupby_fold_masked_wide": 0,
                            "groupby_finalize_scalar": 0,
                            "groupby_reset_pane": 0,
                            "groupby_fold_wide": 0,
                            "groupby_finalize_wide": 0,
                            "groupby_hh_finalize": 0,
                            "groupby_components": 0,
                            "groupby_absorb": 0,
                            "ring_advance": 0,
                            "ring_flip": 0,
                            "ring_query": 0,
                            "multirule_fold": 0,
                            "multirule_fold_wide": 0,
                            "multirule_finalize": 0,
                            "multirule_finalize_wide": 0,
                            "multirule_reset_pane": 0,
                            "tier_demote": 0,
                            "tier_promote": 0}
#: of LAUNCHES' folds, those that took a per-row pane vector
ROW_PANE_LAUNCHES: Dict[str, int] = {"groupby_fold_scalar": 0,
                                     "groupby_fold_wide": 0}
#: of LAUNCHES' folds, those that bumped a touch column (tiered key state)
TOUCH_LAUNCHES: Dict[str, int] = {"groupby_fold_scalar": 0}

#: the loaded libraries (SimpleNamespace(groupby=..., sketches=...,
#: prefinalize=..., slidingring=..., multirule=..., tierstore=...)), None
#: until the first launch
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
            gb.groupby_fold_scalar.argtypes = [P, P, P, P, I, I, I, P, I,
                                               I, P, I, P, P, P, P, P]
            gb.groupby_fold_masked_scalar.argtypes = [P, P, P, P, I, I, I,
                                                      I, I, P, I, P, P, P, P]
            gb.groupby_finalize_scalar.argtypes = [P, P, P, P, I, I, P, I,
                                                   I, P, P]
            gb.groupby_reset_pane.argtypes = [P, P, P, I, I, P]
            sk = ctypes.CDLL(str(paths["sketches"]))
            sk.groupby_fold_wide.argtypes = [P, P, P, I, I, I, P, I, I, P,
                                             I, P, P, P, P]
            sk.groupby_fold_masked_wide.argtypes = [P, P, P, P, I, I, I, I,
                                                    I, P, I, P, P, P, P]
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
            mr.multirule_fold.argtypes = [P, P, P, P, I, I, I, I, I, P, I,
                                          P, P, P, P]
            mr.multirule_finalize.argtypes = [P, P, P, P, I, I, I, I, P, I,
                                              I, P, P]
            mr.multirule_fold_wide.argtypes = [P, P, P, P, I, I, I, I, I, P,
                                               I, P, P, P, P]
            mr.multirule_finalize_wide.argtypes = [P, P, P, I, I, I, I, P, P,
                                                   I, P, L, I, P, P]
            mr.multirule_reset_pane.argtypes = [P, P, P, I, I, I, I, P]
            ts = ctypes.CDLL(str(paths["tierstore"]))
            ts.tier_demote.argtypes = [P, P, P, P, I, I, I, P, I, I, P, P, P]
            ts.tier_promote.argtypes = [P, P, P, P, I, I, I, P, I, P, P]
            for lib, fns in ((gb, ("groupby_fold_scalar",
                                   "groupby_fold_masked_scalar",
                                   "groupby_finalize_scalar",
                                   "groupby_reset_pane")),
                             (sk, ("groupby_fold_wide",
                                   "groupby_fold_masked_wide",
                                   "groupby_finalize_wide",
                                   "groupby_hh_finalize")),
                             (pf, ("groupby_components", "groupby_absorb")),
                             (sr, ("ring_advance", "ring_flip",
                                   "ring_query")),
                             (mr, ("multirule_fold", "multirule_fold_wide",
                                   "multirule_finalize",
                                   "multirule_finalize_wide",
                                   "multirule_reset_pane")),
                             (ts, ("tier_demote", "tier_promote"))):
                for fn in fns:
                    getattr(lib, fn).restype = I
            gb.groupby_error_string.argtypes = [I]
            gb.groupby_error_string.restype = ctypes.c_char_p
            _lib = SimpleNamespace(groupby=gb, sketches=sk, prefinalize=pf,
                                   slidingring=sr, multirule=mr, tierstore=ts)
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
def groupby_fold_scalar(state: Dict[str, torch.Tensor], base: torch.Tensor,
                        V: torch.Tensor, M: torch.Tensor,
                        slots: torch.Tensor, pane: int,
                        colmap: np.ndarray,
                        pane_vec: Optional[torch.Tensor] = None) -> None:
    """Fold one micro-batch into `state` in place: act and the scalar
    components.

    base: bool (R,) row mask after WHERE. V: float32 (S, R) spec values;
    M: bool (S, R) spec masks (each already ANDed with base). slots: int32
    or uint16 (R,). colmap: int32 (ncols, 3) of (COMP_IDS[comp], k, spec).
    pane_vec: optional uint8 (R,) per-row panes, which replace `pane`; the
    caller checks their range on the host (a pane outside [0, P) is
    dropped, as an out-of-range slot is). A state holding a `touch`
    column (uint32 (C,), tiered key state) also counts each row past
    `base` into touch[slot].
    """
    name = "groupby_fold_scalar"
    if not _on_cuda(name, state):
        fold_scalar_plain(state, base, V, M, slots, pane, colmap, pane_vec)
        return
    act = state["act"]
    P, C = act.shape
    S, R = V.shape
    dev = act.device
    _check(name, base, torch.bool, (R,), dev)
    colmap = _check_batch(name, V, M, slots, pane, P, colmap, dev, pane_vec)
    ptrs, ks = _comp_table(name, state)
    touch = state.get("touch")
    if touch is not None:
        _check(name, touch, torch.uint32, (C,), dev)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.groupby.groupby_fold_scalar(
            _ptr(base), _ptr(V), _ptr(M), _ptr(slots), _u16(slots), R,
            int(pane), _opt_ptr(pane_vec), P, C, _ptr(colmap), len(colmap),
            _ptr(ptrs), _ptr(ks), _ptr(act), _opt_ptr(touch), _stream(dev))
        LAUNCHES[name] += 1
        if pane_vec is not None:
            ROW_PANE_LAUNCHES[name] += 1
        if touch is not None:
            TOUCH_LAUNCHES[name] += 1
    _raise_on(lib, name, rc)


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
    colmap = np.ascontiguousarray(colmap, dtype=np.int32).reshape(-1, 3)
    if len(colmap) > MAX_COLS:
        raise ValueError(f"{name}: {len(colmap)} state columns "
                         f"(max {MAX_COLS})")
    if len(colmap) and (colmap[:, 2].max() >= S or colmap[:, 2].min() < 0):
        raise ValueError(f"{name}: column map names a spec outside V/M")
    if not 0 <= pane < P:
        raise ValueError(f"{name}: pane {pane} outside [0, {P})")
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
    """Plain PyTorch version of groupby_fold_scalar (same contract)."""
    P, C = state["act"].shape
    pc, ok = _pane_rows(pane, pane_vec, slots, P, C)
    _fold_columns_plain(state, pc, base & ok, V, M & ok, colmap)
    touch = state.get("touch")
    if touch is not None:
        # torch has no uint32 scatter-add: count in int64, wrap back (the
        # counters wrap modulo 2**32, as the kernel's atomicAdd does)
        s = slots.long()
        keep = base & (s >= 0) & (s < C)
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


def groupby_fold_wide(state: Dict[str, torch.Tensor], V: torch.Tensor,
                      M: torch.Tensor, slots: torch.Tensor, pane: int,
                      widemap: np.ndarray,
                      pane_vec: Optional[torch.Tensor] = None) -> None:
    """Fold one micro-batch into the wide sketch components, in place.

    V, M, slots, pane, pane_vec: as groupby_fold_scalar (M already holds
    the row mask). widemap: int32 (ncols, 3) of (WIDE_IDS[comp], k, spec).
    """
    name = "groupby_fold_wide"
    if not _on_cuda(name, state):
        fold_wide_plain(state, V, M, slots, pane, widemap, pane_vec)
        return
    act = state["act"]
    P, C = act.shape
    S, R = V.shape
    dev = act.device
    widemap = _check_batch(name, V, M, slots, pane, P, widemap, dev,
                           pane_vec)
    ptrs, ks = _wide_table(name, state)
    for comp_id, k, _ in widemap.tolist():
        if not 0 <= k < ks[comp_id]:
            raise ValueError(f"{name}: column {k} outside component "
                             f"{_WIDE_NAMES[comp_id]}")
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.sketches.groupby_fold_wide(
            _ptr(V), _ptr(M), _ptr(slots), _u16(slots), R, int(pane),
            _opt_ptr(pane_vec), P, C, _ptr(widemap), len(widemap), _ptr(ptrs),
            _ptr(ks), _ptr(HIST_CONSTS), _stream(dev))
        LAUNCHES[name] += 1
        if pane_vec is not None:
            ROW_PANE_LAUNCHES[name] += 1
    _raise_on(lib, name, rc)


def fold_wide_plain(state, V, M, slots, pane, widemap,
                    pane_vec=None) -> None:
    """Plain PyTorch version of groupby_fold_wide (the reference's
    scatter-max / scatter-add of sketches.hll_parts / hist_bin /
    hh_update_parts)."""
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


# ----------------------------------------------------------- masked fold
def groupby_fold_masked_scalar(state: Dict[str, torch.Tensor],
                               mask: torch.Tensor, V: torch.Tensor,
                               M: torch.Tensor, slots: torch.Tensor,
                               pane: int, colmap: np.ndarray) -> None:
    """The masked fold (#2): fold a cached, padded batch into pane `pane`
    of `state` in place, act and the scalar components, under the row mask
    `mask` (bool (R,): the refold's rows ∧ WHERE; 0 on padding rows).

    V: float32 (S, R); M: bool (S, R), each spec's mask already ANDed with
    `mask`. slots: uint16 or int32 (R,). colmap: as groupby_fold_scalar's.
    """
    name = "groupby_fold_masked_scalar"
    if not _on_cuda(name, state):
        fold_masked_scalar_plain(state, mask, V, M, slots, pane, colmap)
        return
    act = state["act"]
    P, C = act.shape
    S, R = V.shape
    dev = act.device
    _check(name, mask, torch.bool, (R,), dev)
    colmap = _check_batch(name, V, M, slots, pane, P, colmap, dev)
    ptrs, ks = _comp_table(name, state)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.groupby.groupby_fold_masked_scalar(
            _ptr(mask), _ptr(V), _ptr(M), _ptr(slots), _u16(slots), R,
            int(pane), P, C, _ptr(colmap), len(colmap), _ptr(ptrs), _ptr(ks),
            _ptr(act), _stream(dev))
        LAUNCHES[name] += 1
    _raise_on(lib, name, rc)


def fold_masked_scalar_plain(state, mask, V, M, slots, pane,
                             colmap) -> None:
    """Plain PyTorch version of groupby_fold_masked_scalar (the reference's
    _fold_core under base = mask): the fold's, into one pane, without the
    touch column (the kernel bumps none: only sliding refolds call it, and
    tiered sliding rules are refused)."""
    P, C = state["act"].shape
    pc, ok = _pane_rows(pane, None, slots, P, C)
    _fold_columns_plain(state, pc, mask & ok, V, M & ok, colmap)


def groupby_fold_masked_wide(state: Dict[str, torch.Tensor],
                             mask: torch.Tensor, V: torch.Tensor,
                             M: torch.Tensor, slots: torch.Tensor, pane: int,
                             widemap: np.ndarray) -> None:
    """The masked fold (#2) of the wide sketch components, in place: mask,
    V, M, slots and pane as groupby_fold_masked_scalar's; widemap as
    groupby_fold_wide's."""
    name = "groupby_fold_masked_wide"
    if not _on_cuda(name, state):
        fold_masked_wide_plain(state, mask, V, M, slots, pane, widemap)
        return
    act = state["act"]
    P, C = act.shape
    S, R = V.shape
    dev = act.device
    _check(name, mask, torch.bool, (R,), dev)
    widemap = _check_batch(name, V, M, slots, pane, P, widemap, dev)
    ptrs, ks = _wide_table(name, state)
    for comp_id, k, _ in widemap.tolist():
        if not 0 <= k < ks[comp_id]:
            raise ValueError(f"{name}: column {k} outside component "
                             f"{_WIDE_NAMES[comp_id]}")
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.sketches.groupby_fold_masked_wide(
            _ptr(mask), _ptr(V), _ptr(M), _ptr(slots), _u16(slots), R,
            int(pane), P, C, _ptr(widemap), len(widemap), _ptr(ptrs),
            _ptr(ks), _ptr(HIST_CONSTS), _stream(dev))
        LAUNCHES[name] += 1
    _raise_on(lib, name, rc)


def fold_masked_wide_plain(state, mask, V, M, slots, pane, widemap) -> None:
    """Plain PyTorch version of groupby_fold_masked_wide: fold_wide_plain
    with the row mask ANDed into every spec mask."""
    fold_wide_plain(state, V, M & mask, slots, pane, widemap)


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


def multirule_fold(state: Dict[str, torch.Tensor], base: torch.Tensor,
                   V: torch.Tensor, M: torch.Tensor, slots: torch.Tensor,
                   pane: int, colmap: np.ndarray) -> None:
    """Fold one micro-batch into every rule of a group's state, in place,
    in one launch: act and the scalar components of rule r take the rows
    of base[r].

    base: bool (R, n), each rule's row mask after its WHERE. V: float32
    (S, n) spec values and M: bool (S, n) spec masks (validity, not-NaN,
    FILTER: the same for every rule, without the row mask). slots: int32
    (n,). colmap: int32 (ncols, 3) of (COMP_IDS[comp], k, spec). The wide
    components are multirule_fold_wide's.
    """
    name = "multirule_fold"
    if not _on_cuda(name, state):
        multirule_fold_plain(state, base, V, M, slots, pane, colmap)
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
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.multirule.multirule_fold(
            _ptr(base), _ptr(V), _ptr(M), _ptr(slots), n, NR, int(pane), P,
            C, _ptr(colmap), len(colmap), _ptr(ptrs), _ptr(ks), _ptr(act),
            _stream(dev))
        LAUNCHES[name] += 1
    _raise_on(lib, name, rc)


def multirule_fold_plain(state, base, V, M, slots, pane, colmap) -> None:
    """Plain PyTorch version of multirule_fold: the single-rule plain fold's
    scatters over a rule-offset flat index, (r, pane, slot)."""
    NR, P, C = state["act"].shape
    S, n = V.shape
    slots = slots.long()
    ok = (slots >= 0) & (slots < C)
    rule = torch.arange(NR, device=slots.device)[:, None]
    pc = ((rule * P + pane) * C + slots.clamp(0, C - 1)[None, :]).reshape(-1)
    rows = base & ok
    _fold_columns_plain(state, pc, rows.reshape(-1), V.repeat(1, NR),
                        (M[:, None, :] & rows[None]).reshape(S, -1), colmap)


def multirule_fold_wide(state: Dict[str, torch.Tensor], base: torch.Tensor,
                        V: torch.Tensor, M: torch.Tensor, slots: torch.Tensor,
                        pane: int, widemap: np.ndarray) -> None:
    """Fold one micro-batch into every rule's hll and hist components, in
    place, in one launch: rule r takes the rows of base[r]. base, V, M,
    slots, pane: as multirule_fold. widemap: int32 (ncols, 3) of
    (WIDE_IDS[comp], k, spec), hll and hist columns only."""
    name = "multirule_fold_wide"
    widemap = np.ascontiguousarray(widemap, dtype=np.int32).reshape(-1, 3)
    if (widemap[:, 0] == WIDE_IDS["hh"]).any():
        raise ValueError(f"{name}: heavy_hitters does not batch")
    if not _on_cuda(name, state):
        multirule_fold_wide_plain(state, base, V, M, slots, pane, widemap)
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
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.multirule.multirule_fold_wide(
            _ptr(base), _ptr(V), _ptr(M), _ptr(slots), n, NR, int(pane), P,
            C, _ptr(widemap), len(widemap), _ptr(ptrs), _ptr(ks),
            _ptr(HIST_CONSTS), _stream(dev))
        LAUNCHES[name] += 1
    _raise_on(lib, name, rc)


def multirule_fold_wide_plain(state, base, V, M, slots, pane,
                              widemap) -> None:
    """Plain PyTorch version of multirule_fold_wide: each row's register
    and rho (or bin) once, scattered over a rule-offset flat index
    (r, pane, slot, k, register) for the rules that keep the row."""
    NR, P, C = state["act"].shape
    slots = slots.long()
    ok = (slots >= 0) & (slots < C)
    rule = torch.arange(NR, device=slots.device)[:, None]
    rp = (rule * P + pane) * C + slots.clamp(0, C - 1)[None, :]  # (NR, n)
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
    the identity, in place. Rows [n, D) must repeat a slot of the first n
    (the reference's pads): they are gathered, never reset twice."""
    name = "tier_demote"
    if not _on_cuda(name, state):
        return tier_demote_plain(state, slots, n, comps)
    dev = state["act"].device
    D = _check_tier_slots(name, slots, dev)
    if not 0 <= n <= D:
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
