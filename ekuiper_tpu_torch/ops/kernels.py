"""The group-by kernels of the fused window aggregate: their CUDA build, the
wrappers that launch them, their plain PyTorch versions and their launch
counts.

Three kernels, written by hand in CUDA C++ for Hopper
(ekuiper_tpu_torch/csrc/groupby.cu), each replacing one device program of
the reference (ekuiper_tpu/ops/groupby.py):

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
  identity into one pane of every component and act. Bound: it writes one
  pane (C·(ΣK+1) floats), a fraction of a microsecond at the card's
  memory rate. Design: one launch covers every component.

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
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "groupby.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: state component -> index in the kernels' component table
COMP_IDS = {"n": 0, "s1": 1, "s2": 2, "mn": 3, "mx": 4}
#: aggregate kind -> final-value code of groupby_finalize_scalar
KIND_IDS = {"count": 0, "sum": 1, "avg": 2, "min": 3, "max": 4,
            "stddev": 5, "stddevs": 6, "var": 7, "vars": 8}
INIT = {"n": 0.0, "s1": 0.0, "s2": 0.0, "mn": float("inf"),
        "mx": float("-inf"), "act": 0.0}
MAX_COLS = 64  # csrc/groupby.cu MAX_COLS / MAX_SPECS
MAX_SPECS = 64

#: launches of each kernel since the last reset_launches()
LAUNCHES: Dict[str, int] = {"groupby_fold_scalar": 0,
                            "groupby_finalize_scalar": 0,
                            "groupby_reset_pane": 0}

_lib = None
_lib_lock = threading.Lock()
#: seconds the last build took (0.0 when a cached library was loaded)
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
            "built from csrc/groupby.cu at first use on a CUDA machine")
    return str(path)


def build_library() -> Path:
    """Compile csrc/groupby.cu for sm_90a into _build/ (once per source
    content) and return the shared library's path."""
    global build_seconds
    src = SOURCE.read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libgroupby_{tag}.so"
    if out.exists():
        build_seconds = 0.0
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_seconds = time.perf_counter() - t0
    return out


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.groupby_fold_scalar.argtypes = [P, P, P, P, I, I, I, P, I,
                                                P, P, P, P]
            lib.groupby_fold_scalar.restype = I
            lib.groupby_finalize_scalar.argtypes = [P, P, P, P, I, I, P, I,
                                                    P, P]
            lib.groupby_finalize_scalar.restype = I
            lib.groupby_reset_pane.argtypes = [P, P, P, I, I, P]
            lib.groupby_reset_pane.restype = I
            lib.groupby_error_string.argtypes = [I]
            lib.groupby_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _raise_on(lib, name: str, rc: int) -> None:
    if rc != 0:
        msg = lib.groupby_error_string(rc).decode()
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
    """Fold one micro-batch into `state` in place.

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
    ptrs, ks = _comp_table(name, state)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.groupby_fold_scalar(
            _ptr(base), _ptr(V), _ptr(M), _ptr(slots), R, int(pane), C,
            _ptr(colmap), len(colmap), _ptr(ptrs), _ptr(ks), _ptr(act),
            _stream(dev))
        LAUNCHES[name] += 1
    _raise_on(lib, name, rc)


_COMP_NAMES = {j: c for c, j in COMP_IDS.items()}


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


# -------------------------------------------------------------- finalize
def groupby_finalize_scalar(state: Dict[str, torch.Tensor],
                            pane_mask: torch.Tensor,
                            spectab: np.ndarray) -> torch.Tensor:
    """Merge the panes selected by `pane_mask` (bool (P,)) and compute
    every spec's final value. spectab: int32 (S, 6) of (KIND_IDS[kind],
    k_n, k_s1, k_s2, k_mn, k_mx), -1 for an absent component. Returns
    float32 (S+1, C) on the state's device, act in the last row."""
    name = "groupby_finalize_scalar"
    if not _on_cuda(name, state):
        return finalize_scalar_plain(state, pane_mask, spectab)
    act = state["act"]
    P, C = act.shape
    dev = act.device
    _check(name, pane_mask, torch.bool, (P,), dev)
    spectab = np.ascontiguousarray(spectab, dtype=np.int32).reshape(-1, 6)
    S = len(spectab)
    if S > MAX_SPECS:
        raise ValueError(f"{name}: {S} specs (max {MAX_SPECS})")
    ptrs, ks = _comp_table(name, state)
    for kind, *kc in spectab.tolist():
        if kind not in KIND_IDS.values():
            raise ValueError(f"{name}: unknown kind code {kind}")
        for j, k in enumerate(kc):
            if k >= ks[j]:
                raise ValueError(f"{name}: spec column {k} outside "
                                 f"component {_COMP_NAMES[j]}")
    out = torch.empty((S + 1, C), dtype=torch.float32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.groupby_finalize_scalar(
            _ptr(ptrs), _ptr(ks), _ptr(act), _ptr(pane_mask), P, C,
            _ptr(spectab), S, _ptr(out), _stream(dev))
        LAUNCHES[name] += 1
    _raise_on(lib, name, rc)
    return out


def _merged_plain(arr: torch.Tensor, comp: str, pm: torch.Tensor):
    pm = pm.view(-1, *([1] * (arr.dim() - 1)))
    if comp == "mn":
        return torch.amin(torch.where(pm, arr, INIT["mn"]), dim=0)
    if comp == "mx":
        return torch.amax(torch.where(pm, arr, INIT["mx"]), dim=0)
    return torch.sum(torch.where(pm, arr, 0.0), dim=0)


def final_value_plain(kind: str, c: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The reference's _final_value (groupby.py:483-520), scalar kinds."""
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


def finalize_scalar_plain(state, pane_mask, spectab) -> torch.Tensor:
    """Plain PyTorch version of groupby_finalize_scalar."""
    kinds = {v: k for k, v in KIND_IDS.items()}
    merged = {comp: _merged_plain(state[comp], comp, pane_mask)
              for comp in COMP_IDS if comp in state}
    rows: List[torch.Tensor] = []
    for kind, *kc in np.asarray(spectab).reshape(-1, 6).tolist():
        c = {comp: merged[comp][:, kc[j]]
             for comp, j in COMP_IDS.items() if kc[j] >= 0}
        rows.append(final_value_plain(kinds[kind], c))
    rows.append(_merged_plain(state["act"], "act", pane_mask))
    return torch.stack(rows, dim=0)


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
    ptrs, ks = _comp_table(name, state)
    lib = _load()
    dev = act.device
    with torch.cuda.device(dev):
        rc = lib.groupby_reset_pane(_ptr(ptrs), _ptr(ks), _ptr(act),
                                    int(pane), C, _stream(dev))
        LAUNCHES[name] += 1
    _raise_on(lib, name, rc)


def reset_pane_plain(state, pane: int) -> None:
    """Plain PyTorch version of groupby_reset_pane."""
    for comp, arr in state.items():
        arr[pane].fill_(INIT[comp])


# ------------------------------------------------------------ host tables
def column_map(comp_specs: Dict[str, Sequence[int]]) -> np.ndarray:
    """(ncols, 3) int32 of (COMP_IDS[comp], k, spec) for a plan's
    component → spec-index lists."""
    rows: List[Tuple[int, int, int]] = [
        (COMP_IDS[comp], k, si)
        for comp, idxs in comp_specs.items() for k, si in enumerate(idxs)]
    return np.asarray(rows, dtype=np.int32).reshape(-1, 3)


def spec_table(kinds: Sequence[str],
               comp_specs: Dict[str, Sequence[int]]) -> np.ndarray:
    """(S, 6) int32 of (KIND_IDS[kind], k per component or -1)."""
    tab = np.full((len(kinds), 1 + len(COMP_IDS)), -1, dtype=np.int32)
    for i, kind in enumerate(kinds):
        tab[i, 0] = KIND_IDS[kind]
    for comp, idxs in comp_specs.items():
        for k, si in enumerate(idxs):
            tab[si, 1 + COMP_IDS[comp]] = k
    return tab
