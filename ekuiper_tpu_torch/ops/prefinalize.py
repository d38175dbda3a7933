"""Latency-hiding window emit: a pre-issued components fetch plus a host
shadow of the window's tail (counterpart of ekuiper_tpu/ops/prefinalize.py).

Tumbling and hopping boundaries are known in advance
(timex.align_to_window), so the fused node (runtime/nodes_fused.py):

  1. A lead before the boundary, launches the pane-merged components
     kernel on the current state (groupby_components, which writes a
     fresh (C, W) tensor) and starts its copy into pinned host memory
     (PendingFinalize). The folds go on.
  2. Rows arriving in the tail fold into the device state AND into a
     HostShadow, the fold's twin over just those rows.
  3. At the boundary it merges the fetched components with the shadow and
     computes the final values with numpy: no device round trip waits at
     the boundary.

The reference leans on jax arrays being immutable: a dispatched program
sees a snapshot. The port folds and resets in place, so the snapshot is
the ordering of the card's streams instead: the components kernel runs on
the compute stream before any later fold or reset, and writes its own
output tensor; the copy runs on a side stream that waits for an event
recorded right after that launch, so it never queues behind later folds;
`record_stream` keeps the caching allocator from reusing the output under
the copy.

The shadow follows the port's fold, not the reference's shadow: its
sketch bins and registers come from the plain versions of ops/sketches.py
(the compiled-form hist_bin, the exponent-field rho), run on host tensors,
so they are bit-equal to the port's plain fold. Its closures are the numpy
twins of the fold's (sql/expr_ir.py mode="host") and see the same columns,
validity masks included. Counts, act, min/max, hist counters and hll
registers of a shadow equal the fold's exactly; its sums add float64
bincount weights into float32, as the reference's do (rtol 1e-5).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils import timex
from . import sketches
from .aggspec import WIDE_COMPONENTS, AggSpec, KernelPlan
# identities and register widths are the kernels' tables, so the shadow
# never drifts from the device state layout
from .kernels import INIT, WIDE_W
from .sketches import (HH_BITS, HH_DEPTH, HH_WIDTH, _GAMMA, _HIST_HALF,
                       _HIST_LO, _LOG_GAMMA)


def _comp_shape(comp: str, spec_idxs: List[int]) -> Tuple[int, ...]:
    shape: Tuple[int, ...] = (len(spec_idxs),)
    if comp in WIDE_COMPONENTS:
        shape = shape + (WIDE_W[comp],)
    return shape


# --------------------------------------------- sketch parts of the shadow
def _on_host(fn, *arrays):
    """One of ops/sketches.py's plain versions over host numpy arrays."""
    out = fn(*[torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])
    if isinstance(out, tuple):
        return tuple(t.numpy() for t in out)
    return out.numpy()


def hll_parts_np(values: np.ndarray):
    """(register, rho) per float32 value, as the port's fold takes them."""
    return _on_host(sketches.hll_parts, np.asarray(values, np.float32))


def hist_bin_np(values: np.ndarray) -> np.ndarray:
    """The signed log bin of each value, as the port's fold takes it."""
    return _on_host(sketches.hist_bin, np.asarray(values, np.float32))


def hh_update_parts_np(codes: np.ndarray, mf: np.ndarray):
    """Flat indices and weights of the heavy-hitters update (shadow fold)."""
    return _on_host(sketches.hh_update_parts, np.asarray(codes, np.float32),
                    np.asarray(mf, np.float32))


# ------------------------------------------------- numpy final values
def _splitmix32_np(x: np.ndarray, c1: int, c2: int) -> np.ndarray:
    x = x.astype(np.uint32)
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(c1)
        x = x ^ (x >> np.uint32(15))
        x = x * np.uint32(c2)
        x = x ^ (x >> np.uint32(16))
    return x


def _hh_slot_np(code: np.ndarray, d: int) -> np.ndarray:
    h = _splitmix32_np(code.astype(np.uint32) ^ np.uint32(
        sketches._hh_salt(d)), sketches._MIX1, sketches._MIX2)
    return (h % np.uint32(HH_WIDTH)).astype(np.int32)


def hh_dedupe_topk(codes_row, est_row, k: int):
    """Dedupe estimate-descending candidates (a code can appear once per
    depth) and trim to top-k (code, count) pairs. Shared by the device
    finalize route (TorchGroupBy.hh_assemble) and the numpy components
    route (hh_topk_np)."""
    seen = set()
    row = []
    for c, e in zip(codes_row, est_row):
        if e <= 0:
            break
        c = int(c)
        if c in seen:
            continue
        seen.add(c)
        row.append((c, int(round(e))))
        if len(row) >= k:
            break
    return row


def hh_topk_np(hh: np.ndarray, k: int) -> np.ndarray:
    """Per-key top-k (code, count) lists from the pane-merged
    heavy-hitters sketch hh (capacity, HH_SIZE): bit-majority code per
    (depth, slot), kept where it hashes back to its own slot, count-min
    estimate, estimate-descending, deduped."""
    cap = hh.shape[0]
    a = hh.reshape(cap, HH_DEPTH, HH_WIDTH, 1 + HH_BITS)
    tot = a[..., 0]  # (cap, D, W)
    bits = (a[..., 1:] * 2.0) > tot[..., None]
    codes = np.zeros((cap, HH_DEPTH, HH_WIDTH), dtype=np.uint32)
    for b in range(HH_BITS):
        codes |= bits[..., b].astype(np.uint32) << np.uint32(b)
    ok = tot > 0
    wslots = np.arange(HH_WIDTH, dtype=np.int32)[None, :]
    for d in range(HH_DEPTH):
        ok[:, d, :] &= _hh_slot_np(codes[:, d, :], d) == wslots
    est = np.full(codes.shape, np.inf, dtype=np.float32)
    rows = np.arange(cap)[:, None]
    flat_codes = codes.reshape(cap, -1)
    for d2 in range(HH_DEPTH):
        s = _hh_slot_np(flat_codes, d2)  # (cap, D*W)
        est = np.minimum(est, tot[rows, d2, s].reshape(codes.shape))
    est = np.where(ok, est, 0.0)
    out = np.empty(cap, dtype=np.object_)
    out[:] = [[] for _ in range(cap)]
    flat_est = est.reshape(cap, -1)
    live = np.nonzero(flat_est.max(axis=1) > 0)[0]
    if len(live):
        order = np.argsort(-flat_est[live], axis=1)
        for li, i in enumerate(live.tolist()):
            out[i] = hh_dedupe_topk(
                flat_codes[i, order[li]], flat_est[i, order[li]], k)
    return out


def hist_quantile_np(hist: np.ndarray, frac: float) -> np.ndarray:
    total = np.sum(hist, axis=-1)
    cum = np.cumsum(hist, axis=-1)
    target = frac * total[..., None]
    ge = cum >= np.maximum(target, 1e-9)
    idx = np.argmax(ge, axis=-1)
    mag_idx = np.where(
        idx > _HIST_HALF, idx - _HIST_HALF - 1, _HIST_HALF - 1 - idx
    ).astype(np.float32)
    center = _HIST_LO * np.exp(mag_idx * _LOG_GAMMA) * float(np.sqrt(_GAMMA))
    val = np.where(
        idx == _HIST_HALF, 0.0, np.where(idx > _HIST_HALF, center, -center)
    )
    return np.where(total > 0, val, np.nan)


def hll_estimate_np(registers: np.ndarray) -> np.ndarray:
    m = registers.shape[-1]
    alpha = 0.7213 / (1.0 + 1.079 / m)
    z = np.sum(2.0 ** (-registers), axis=-1)
    raw = alpha * m * m / z
    zeros = np.sum(registers == 0.0, axis=-1)
    small = m * np.log(m / np.maximum(zeros, 1).astype(np.float32))
    return np.where((raw < 2.5 * m) & (zeros > 0), small, raw)


def final_value_np(spec: AggSpec, c: Dict[str, np.ndarray]) -> np.ndarray:
    """Final values from pane-merged host components (the reference's
    numpy twin of _final_value)."""
    kind = spec.kind
    if kind == "count":
        return c["n"]
    n = c.get("n")
    with np.errstate(invalid="ignore", divide="ignore"):
        if kind == "sum":
            return np.where(n > 0, c["s1"], np.nan)
        if kind == "avg":
            return np.where(n > 0, c["s1"] / np.maximum(n, 1.0), np.nan)
        if kind == "min":
            return np.where(n > 0, c["mn"], np.nan)
        if kind == "max":
            return np.where(n > 0, c["mx"], np.nan)
        if kind in ("stddev", "var"):
            mean = c["s1"] / np.maximum(n, 1.0)
            v = np.maximum(c["s2"] / np.maximum(n, 1.0) - mean * mean, 0.0)
            out = np.sqrt(v) if kind == "stddev" else v
            return np.where(n > 0, out, np.nan)
        if kind in ("stddevs", "vars"):
            mean = c["s1"] / np.maximum(n, 1.0)
            v = np.maximum(
                (c["s2"] - c["s1"] * mean) / np.maximum(n - 1.0, 1.0), 0.0
            )
            out = np.sqrt(v) if kind == "stddevs" else v
            return np.where(n >= 2, out, np.nan)
        if kind == "hll":
            regs = np.maximum(c["hll"], 0.0)
            return np.round(hll_estimate_np(regs))
        if kind == "percentile_approx":
            return hist_quantile_np(c["hist"], spec.frac)
        if kind == "heavy_hitters":
            # (code, count) pairs, decoded by the node's ValueDict
            return hh_topk_np(c["hh"], spec.topk)
    raise ValueError(f"unknown device agg kind {kind}")


# ------------------------------------------------------------ host shadow
class HostShadow:
    """The fold's twin over the tail rows of a closing window: the same
    (n, s1, s2, mn, mx, hll, hist, hh, act) components, for one pane, on
    the host; merged into the fetched components at the boundary."""

    def __init__(self, plan: KernelPlan, comp_specs: Dict[str, List[int]],
                 capacity: int) -> None:
        self.plan = plan
        self.comp_specs = comp_specs
        self.capacity = capacity
        self.data: Dict[str, np.ndarray] = {}
        self.n_rows = 0
        for comp, spec_idxs in comp_specs.items():
            shape = (capacity,) + _comp_shape(comp, spec_idxs)
            self.data[comp] = np.full(shape, INIT[comp], dtype=np.float32)
        self.data["act"] = np.zeros(capacity, dtype=np.float32)

    def _ensure(self, max_slot: int) -> None:
        while max_slot >= self.capacity:
            for comp, arr in self.data.items():
                pad_shape = (self.capacity,) + arr.shape[1:]
                pad = np.full(pad_shape, INIT[comp], dtype=np.float32)
                self.data[comp] = np.concatenate([arr, pad], axis=0)
            self.capacity *= 2

    def fold(self, cols: Dict[str, np.ndarray], slots: np.ndarray,
             valid: Optional[Dict[str, np.ndarray]] = None) -> None:
        n = len(slots)
        if n == 0:
            return
        self.n_rows += n
        self._ensure(int(slots.max()))
        valid = valid or {}
        # the device closures see each validity mask as a column
        # (TorchGroupBy.fold); so do their twins
        hcols = dict(cols)
        for name, vm in valid.items():
            hcols["__valid_" + name] = np.asarray(vm, dtype=np.bool_)
        cap = self.capacity
        base = np.ones(n, dtype=np.bool_)
        if self.plan.filter_host is not None:
            base &= np.broadcast_to(
                np.asarray(self.plan.filter_host(hcols), dtype=np.bool_), (n,))
        self.data["act"] += np.bincount(
            slots, weights=base.astype(np.float32), minlength=cap
        )[:cap].astype(np.float32)
        for i, spec in enumerate(self.plan.specs):
            if spec.arg is None:
                v = np.ones(n, dtype=np.float32)
                m = base
            else:
                v = np.broadcast_to(
                    np.asarray(spec.arg_host(hcols), dtype=np.float32), (n,))
                m = base
                for col in spec.arg.columns:
                    vm = valid.get(col)
                    if vm is not None:
                        m = np.logical_and(m, vm)
                m = np.logical_and(m, ~np.isnan(v))
            if spec.filter_host is not None:
                m = np.logical_and(m, np.broadcast_to(
                    np.asarray(spec.filter_host(hcols), dtype=np.bool_),
                    (n,)))
            mf = m.astype(np.float32)
            for comp in spec.components:
                k = self.comp_specs[comp].index(i)
                arr = self.data[comp]
                if comp == "n":
                    arr[:, k] += np.bincount(slots, weights=mf,
                                             minlength=cap)[:cap]
                elif comp == "s1":
                    arr[:, k] += np.bincount(
                        slots, weights=np.where(m, v, 0.0), minlength=cap
                    )[:cap]
                elif comp == "s2":
                    arr[:, k] += np.bincount(
                        slots, weights=np.where(m, v * v, 0.0), minlength=cap
                    )[:cap]
                elif not m.any():
                    continue
                elif comp == "mn":
                    np.minimum.at(arr[:, k], slots[m], v[m])
                elif comp == "mx":
                    np.maximum.at(arr[:, k], slots[m], v[m])
                elif comp == "hll":
                    reg, rho = hll_parts_np(v[m])
                    np.maximum.at(arr, (slots[m], k, reg), rho)
                elif comp == "hist":
                    np.add.at(arr, (slots[m], k, hist_bin_np(v[m])), 1.0)
                elif comp == "hh":
                    idx, wts = hh_update_parts_np(v[m], mf[m])
                    np.add.at(arr, (slots[m][:, None], k, idx), wts)


def unpack_components(arr: np.ndarray, layout) -> Dict[str, np.ndarray]:
    """Split the stacked (capacity, W) components array back into the
    per-component dict, per TorchGroupBy._components_layout()."""
    cap = arr.shape[0]
    return {
        comp: arr[:, col] if shape == () else
        arr[:, col:col + w].reshape((cap,) + shape)
        for comp, col, w, shape in layout
    }


def merge_components(
    dev: Dict[str, np.ndarray], shadow: Optional[HostShadow], capacity: int,
) -> Dict[str, np.ndarray]:
    """Device components ⊕ shadow components. Pads the device result when
    the key table grew during the tail (new keys exist only in the shadow)."""
    out: Dict[str, np.ndarray] = {}
    if shadow is not None and shadow.n_rows:
        shadow._ensure(capacity - 1)
    for comp, d in dev.items():
        if d.shape[0] < capacity:
            pad_shape = (capacity - d.shape[0],) + d.shape[1:]
            d = np.concatenate(
                [d, np.full(pad_shape, INIT[comp], dtype=d.dtype)], axis=0)
        if shadow is not None and shadow.n_rows:
            s = shadow.data[comp][: d.shape[0]]
            if comp == "mn":
                d = np.minimum(d, s)
            elif comp in ("mx", "hll"):
                d = np.maximum(d, s)
            else:
                d = d + s
        out[comp] = d
    return out


class IdentityFinalize:
    """Always-ready stand-in for a components fetch of an EMPTY state
    (identity values): the backstop a tumbling window opens with, so its
    boundary never waits on the card (the window's rows all live in the
    backstop's window-spanning shadow)."""

    def __init__(self, comp_specs: Dict[str, List[int]], capacity: int) -> None:
        self.capacity = capacity
        self._comps: Dict[str, np.ndarray] = {}
        for comp, spec_idxs in comp_specs.items():
            shape = (capacity,) + _comp_shape(comp, spec_idxs)
            self._comps[comp] = np.full(shape, INIT[comp], dtype=np.float32)
        self._comps["act"] = np.zeros(capacity, dtype=np.float32)

    def ready(self) -> bool:
        return True

    def get(self) -> Dict[str, np.ndarray]:
        return self._comps

    def release(self) -> None:
        pass


# --------------------------------------------------------- the async fetch
class FetchPool:
    """One node's device-to-host fetches: a copy stream, and a few pinned
    host buffers per shape, reused (pinning tens of MB costs milliseconds;
    at most two real fetches are in flight per boundary)."""

    PER_SHAPE = 3

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self._free: Dict[tuple, List[torch.Tensor]] = {}
        self._lock = threading.Lock()

    def _take(self, shape: tuple, dtype) -> torch.Tensor:
        with self._lock:
            free = self._free.get((shape, dtype))
            if free:
                return free.pop()
        return torch.empty(shape, dtype=dtype, pin_memory=True)

    def give(self, buf: torch.Tensor) -> None:
        """Return a buffer: a later fetch may reuse it, ordered after any
        copy still writing it by the one copy stream."""
        with self._lock:
            free = self._free.setdefault((tuple(buf.shape), buf.dtype), [])
            if len(free) < self.PER_SHAPE:
                free.append(buf)

    def copy(self, src: torch.Tensor, after: Optional[torch.cuda.Event] = None):
        """Start the copy of `src` into a pinned buffer once the compute
        stream has passed `after` (its current point if None). Returns
        (buffer, start event, done event)."""
        if after is None:
            after = torch.cuda.Event()
            after.record(torch.cuda.current_stream(self.device))
        buf = self._take(tuple(src.shape), src.dtype)
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(after)
            start.record(self.stream)
            buf.copy_(src, non_blocking=True)
            done.record(self.stream)
        src.record_stream(self.stream)  # no reuse of src under the copy
        return buf, start, done


def begin_pending(stacked: torch.Tensor, layout,
                  pool: Optional[FetchPool]) -> "PendingFinalize":
    """Start the device-to-host copy of a just-launched components (or
    finalize) result and wrap it: the one async-fetch protocol of the
    boundary (pre-issue, deferred emit, heavy-hitters emit). `layout` None
    keeps the fetched array whole."""
    return PendingFinalize(stacked, layout, pool)


class PendingFinalize:
    """Handle for a components fetch in flight, created a lead before the
    window boundary.

    On CUDA the copy runs on the pool's copy stream into a pinned buffer
    (see the module docstring); `ready()` asks the copy's event and never
    blocks; `get()` waits for that event only, never for work queued on
    the compute stream after the launch. On the CPU the result is already
    on the host and the handle is ready at once. `t_created` / `t_done`
    are engine-clock ms, as the reference's are: the issue, and the first
    time the handle saw the copy landed.
    """

    def __init__(self, stacked: torch.Tensor, layout,
                 pool: Optional[FetchPool]) -> None:
        self.layout = layout  # [(comp, col, width, per-key shape)] or None
        self.nbytes = stacked.numel() * stacked.element_size()
        self._pool = pool
        self.t_created = timex.now_ms()
        self.t_done: Optional[int] = None
        if stacked.device.type == "cuda":
            self._buf, self._start, self._done = pool.copy(stacked)
        else:
            self._buf, self._start, self._done = stacked, None, None
            self.t_done = self.t_created

    def ready(self) -> bool:
        if self.t_done is None and self._done.query():
            self.t_done = timex.now_ms()
        return self.t_done is not None

    def fetch_ms(self) -> float:
        """Issue→landed latency in engine-clock ms; -1 while in flight."""
        if self.t_done is None:
            return -1.0
        return float(self.t_done - self.t_created)

    def copy_ms(self) -> Optional[float]:
        """The copy's own device time (CUDA events), once landed; None on
        the CPU or in flight."""
        if self._done is None or not self.ready():
            return None
        return self._start.elapsed_time(self._done)

    def get(self):
        if self._done is not None:
            self._done.synchronize()
            self.ready()
        arr = self._buf.numpy()
        if self.layout is None:
            return arr
        return unpack_components(arr, self.layout)

    def release(self) -> None:
        """Hand the pinned buffer back to the pool once the caller is done
        with what get() returned."""
        if self._pool is not None and self._buf is not None:
            self._pool.give(self._buf)
        self._buf = None


class DeferredFetch:
    """A launched result whose copy to the host starts only if `get()` is
    called: the deferred boundary's backup finalize, fetched only when the
    deferred merge fails. The copy waits for the compute stream's point at
    creation, not for work queued after it."""

    def __init__(self, stacked: torch.Tensor,
                 pool: Optional[FetchPool]) -> None:
        self._src = stacked
        self._pool = pool
        self._after = None
        if stacked.device.type == "cuda":
            self._after = torch.cuda.Event()
            self._after.record(torch.cuda.current_stream(stacked.device))

    def get(self) -> np.ndarray:
        if self._after is None:
            return self._src.numpy()
        buf, _, done = self._pool.copy(self._src, after=self._after)
        done.synchronize()
        return buf.numpy()
