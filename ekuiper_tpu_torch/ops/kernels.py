"""The group-by kernels of the fused window aggregate: their CUDA build, the
wrappers that launch them, their plain PyTorch versions and their launch
counts.

Six kernels, written by hand in CUDA C++ for Hopper, each replacing one
device program of the reference (ekuiper_tpu/ops/groupby.py). Three in
ekuiper_tpu_torch/csrc/groupby.cu:

- `groupby_fold_scalar` replaces `DeviceGroupBy._fold_impl` → `_fold_core`
  (groupby.py:348-441): scatter-add of act/n/s1/s2 and scatter-min/max of
  mn/mx at [pane, slot, k] for one micro-batch. Bound on an H100: a
  65,536-row batch moves ~2 MB (the spec values and masks, slots, the
  touched state lines), 0.7 µs at 3.35 TB/s; each row also issues one
  atomic per state column, so the atomics' throughput at L2 may bound it
  instead (which of the two does is not measured; chip_smoke.py reports
  the kernel body's device time beside the bound). Design: one thread
  per row, one launch per batch, native float atomicAdd and a sign-split
  integer atomic for min/max (no compare-and-swap loop), and the
  expression closures evaluated by torch into dense (S, R) value/mask
  tensors first, so the kernel itself does no expression work.
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

And three in ekuiper_tpu_torch/csrc/sketches.cu, for the sketch
aggregates (hll, percentile_approx, heavy_hitters), whose state
components are wide: (P, C, K, W) with W = 256 / 1,024 / 2,688:

- `groupby_fold_wide` replaces the hll/hist/hh branches of `_fold_core`
  (groupby.py:419-439): per valid row an atomic max of rho into register
  h1 & 255, an atomic add into the value's log bin, or, per depth,
  atomic adds into the code's cell total and its set bits. One launch per
  batch beside groupby_fold_scalar (which adds act and the scalar
  columns). Likely bound: its atomics at L2 (at most 42 a row for hh).
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
           "sketches": _PKG / "csrc" / "sketches.cu"}
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
                            "groupby_finalize_scalar": 0,
                            "groupby_reset_pane": 0,
                            "groupby_fold_wide": 0,
                            "groupby_finalize_wide": 0,
                            "groupby_hh_finalize": 0}

#: the loaded libraries (SimpleNamespace(groupby=..., sketches=...)),
#: None until the first launch
_lib = None
_lib_lock = threading.Lock()
#: seconds the last build took (0.0 when cached libraries were loaded)
build_seconds = 0.0


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    for name, src in SOURCES.items():
        tag = hashlib.sha1(src.read_bytes()
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
                                               P, P, P, P]
            gb.groupby_finalize_scalar.argtypes = [P, P, P, P, I, I, P, I,
                                                   I, P, P]
            gb.groupby_reset_pane.argtypes = [P, P, P, I, I, P]
            sk = ctypes.CDLL(str(paths["sketches"]))
            sk.groupby_fold_wide.argtypes = [P, P, P, I, I, I, P, I, P, P,
                                             P, P]
            sk.groupby_finalize_wide.argtypes = [P, P, P, I, I, P, P, I, P,
                                                 L, P, P]
            sk.groupby_hh_finalize.argtypes = [P, I, P, I, I, P, I, P, P]
            for lib, fns in ((gb, ("groupby_fold_scalar",
                                   "groupby_finalize_scalar",
                                   "groupby_reset_pane")),
                             (sk, ("groupby_fold_wide",
                                   "groupby_finalize_wide",
                                   "groupby_hh_finalize"))):
                for fn in fns:
                    getattr(lib, fn).restype = I
            gb.groupby_error_string.argtypes = [I]
            gb.groupby_error_string.restype = ctypes.c_char_p
            _lib = SimpleNamespace(groupby=gb, sketches=sk)
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
                        colmap: np.ndarray) -> None:
    """Fold one micro-batch into `state` in place: act and the scalar
    components.

    base: bool (R,) row mask after WHERE. V: float32 (S, R) spec values;
    M: bool (S, R) spec masks (each already ANDed with base). slots: int32
    (R,). colmap: int32 (ncols, 3) of (COMP_IDS[comp], k, spec).
    """
    name = "groupby_fold_scalar"
    if not _on_cuda(name, state):
        fold_scalar_plain(state, base, V, M, slots, pane, colmap)
        return
    act = state["act"]
    P, C = act.shape
    S, R = V.shape
    dev = act.device
    _check(name, base, torch.bool, (R,), dev)
    colmap = _check_batch(name, V, M, slots, pane, P, colmap, dev)
    ptrs, ks = _comp_table(name, state)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.groupby.groupby_fold_scalar(
            _ptr(base), _ptr(V), _ptr(M), _ptr(slots), R, int(pane), C,
            _ptr(colmap), len(colmap), _ptr(ptrs), _ptr(ks), _ptr(act),
            _stream(dev))
        LAUNCHES[name] += 1
    _raise_on(lib, name, rc)


def _check_batch(name, V, M, slots, pane, P, colmap, dev) -> np.ndarray:
    """Checks shared by the two folds; returns the contiguous column map."""
    S, R = V.shape
    _check(name, V, torch.float32, (S, R), dev)
    _check(name, M, torch.bool, (S, R), dev)
    _check(name, slots, torch.int32, (R,), dev)
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


def fold_scalar_plain(state, base, V, M, slots, pane, colmap) -> None:
    """Plain PyTorch version of groupby_fold_scalar (same contract)."""
    act = state["act"]
    P, C = act.shape
    slots = slots.long()
    ok = (slots >= 0) & (slots < C)  # out-of-range updates are dropped
    pc = pane * C + slots.clamp(0, C - 1)
    act.view(-1).index_put_((pc,), (base & ok).to(act.dtype),
                            accumulate=True)
    for comp_id, k, s in np.asarray(colmap).reshape(-1, 3).tolist():
        comp = _COMP_NAMES[comp_id]
        arr = state[comp]
        K = arr.shape[2]
        idx = pc * K + k
        m = M[s] & ok
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
                      widemap: np.ndarray) -> None:
    """Fold one micro-batch into the wide sketch components, in place.

    V, M, slots, pane: as groupby_fold_scalar (M already holds the row
    mask). widemap: int32 (ncols, 3) of (WIDE_IDS[comp], k, spec).
    """
    name = "groupby_fold_wide"
    if not _on_cuda(name, state):
        fold_wide_plain(state, V, M, slots, pane, widemap)
        return
    act = state["act"]
    P, C = act.shape
    S, R = V.shape
    dev = act.device
    widemap = _check_batch(name, V, M, slots, pane, P, widemap, dev)
    ptrs, ks = _wide_table(name, state)
    for comp_id, k, _ in widemap.tolist():
        if not 0 <= k < ks[comp_id]:
            raise ValueError(f"{name}: column {k} outside component "
                             f"{_WIDE_NAMES[comp_id]}")
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.sketches.groupby_fold_wide(
            _ptr(V), _ptr(M), _ptr(slots), R, int(pane), C, _ptr(widemap),
            len(widemap), _ptr(ptrs), _ptr(ks), _ptr(HIST_CONSTS),
            _stream(dev))
        LAUNCHES[name] += 1
    _raise_on(lib, name, rc)


def fold_wide_plain(state, V, M, slots, pane, widemap) -> None:
    """Plain PyTorch version of groupby_fold_wide (the reference's
    scatter-max / scatter-add of sketches.hll_parts / hist_bin /
    hh_update_parts)."""
    C = state["act"].shape[1]
    slots = slots.long()
    ok = (slots >= 0) & (slots < C)
    pc = pane * C + slots.clamp(0, C - 1)
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
    out = torch.empty((rows, C), dtype=torch.float32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.groupby.groupby_finalize_scalar(
            _ptr(ptrs), _ptr(ks), _ptr(act), _ptr(pane_mask), P, C,
            _ptr(spectab), S, rows, _ptr(out), _stream(dev))
        LAUNCHES[name] += 1
    _raise_on(lib, name, rc)
    return out


def _merged_plain(arr: torch.Tensor, comp: str, pm: torch.Tensor):
    pm = pm.view(-1, *([1] * (arr.dim() - 1)))
    if comp == "mn":
        return torch.amin(torch.where(pm, arr, INIT["mn"]), dim=0)
    if comp in ("mx", "hll"):  # hll registers merge by max
        return torch.amax(torch.where(pm, arr, INIT["mx"]), dim=0)
    return torch.sum(torch.where(pm, arr, 0.0), dim=0)


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
    kinds = {v: k for k, v in KIND_IDS.items()}
    spectab = np.asarray(spectab).reshape(-1, 2 + len(COMP_IDS))
    rows = len(spectab) + 1 if rows is None else int(rows)
    act = state["act"]
    out = torch.full((rows, act.shape[1]), float("nan"), dtype=act.dtype,
                     device=act.device)
    merged = {comp: _merged_plain(state[comp], comp, pane_mask)
              for comp in COMP_IDS if comp in state}
    for kind, *kc, row in spectab.tolist():
        if kind > SCALAR_KINDS_MAX:
            continue
        c = {comp: merged[comp][:, kc[j]]
             for comp, j in COMP_IDS.items() if kc[j] >= 0}
        out[row] = final_value_plain(kinds[kind], c)
    out[rows - 1] = _merged_plain(act, "act", pane_mask)
    return out


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
def groupby_reset_pane(state: Dict[str, torch.Tensor], pane: int) -> None:
    """Write the identity into pane `pane` of every component and act."""
    name = "groupby_reset_pane"
    if not _on_cuda(name, state):
        reset_pane_plain(state, pane)
        return
    act = state["act"]
    P, C = act.shape
    if not 0 <= pane < P:
        raise ValueError(f"{name}: pane {pane} outside [0, {P})")
    if len(state) > MAX_RESET:
        raise ValueError(f"{name}: {len(state)} components "
                         f"(max {MAX_RESET})")
    ptrs = np.zeros(len(state), dtype=np.uint64)
    lens = np.zeros(len(state), dtype=np.int64)
    inits = np.zeros(len(state), dtype=np.float32)
    for j, (comp, arr) in enumerate(state.items()):
        _check(name, arr, torch.float32, (P, C, *arr.shape[2:]), act.device)
        ptrs[j] = arr.data_ptr()
        lens[j] = arr[0].numel()
        inits[j] = INIT[comp]
    lib = _load()
    dev = act.device
    with torch.cuda.device(dev):
        rc = lib.groupby.groupby_reset_pane(_ptr(ptrs), _ptr(lens),
                                            _ptr(inits), len(state),
                                            int(pane), _stream(dev))
        LAUNCHES[name] += 1
    _raise_on(lib, name, rc)


def reset_pane_plain(state, pane: int) -> None:
    """Plain PyTorch version of groupby_reset_pane."""
    for comp, arr in state.items():
        arr[pane].fill_(INIT[comp])


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
