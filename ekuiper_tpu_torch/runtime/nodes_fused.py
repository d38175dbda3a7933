"""Fused window→GROUP BY→aggregate node (counterpart of
ekuiper_tpu/runtime/nodes_fused.py `FusedWindowAggNode`, processing-time
TUMBLING and HOPPING windows).

Per micro-batch: encode GROUP BY keys to slots (host dictionary), upload
the kernel's columns and fold them into the device partials
(ops/groupby.py, the CUDA fold kernel). Per trigger: emit the window
through the vectorized direct-emit tail or as GroupedTuplesSet, then reset
the expired pane (one kernel).

The boundary emits as the reference's does (ops/prefinalize.py), once the
node is opened on the engine clock (`on_open` arms the timers):

- A lead before each boundary (`prefinalize_lead_ms`, twice: at 2x and at
  1x the lead) `on_pre_trigger` launches the pane-merged components kernel
  and starts its copy to pinned host memory; the window's tail rows also
  fold into a HostShadow.
- At the boundary, `_emit` merges the newest landed fetch with its shadow
  and computes the final values on the host. A tumbling window opens with
  an always-ready identity entry and a window-spanning shadow (the
  backstop), so its boundary never waits on the card.
- A boundary whose fetch has not landed is handed to the emit worker
  (`_deliver_pf`); heavy-hitters boundaries always go to the worker
  (`_emit_hh_async`), which runs the host dedupe off the fold thread.
- `tail_mode="host"` freezes the device state at the first pre-issue of a
  tumbling window: tail rows fold into the shadow only, and a checkpoint in
  that span flushes the shadow back to the card (`groupby_absorb`).

A boundary with no pre-issue (lead 0, or a node driven by hand without
pre-triggers) finalizes synchronously on the device, after any deferred
delivery before it: the reference hands that case to its worker as a
"count" delivery, a kind that waits for the count-window slice.
`last_emit_info["source"]` says which route served each boundary.

The sketch aggregates fold through derived columns built here per batch:
hll(col) reads `__hll__col` (the distinct-preserving float32 encoding of
the raw column) and heavy_hitters(col, k) reads `__hhc__col` (dense codes
from a per-column ValueDict, decoded back to the original values at
emit).

Not ported yet, and refused at construction: sliding, session, count and
state windows, event time, tiered key state and the mesh.
"""
from __future__ import annotations

import collections
import logging
import queue
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..data.batch import ColumnBatch
from ..data.rows import GroupedTuples, GroupedTuplesSet, Tuple, WindowRange
from ..ops.aggspec import (HH_COL_PREFIX, HLL_COL_PREFIX, KernelPlan,
                           ValueDict, _call_key, encode_hll_column)
from ..ops.groupby import TorchGroupBy
from ..ops.keytable import KeyTable
from ..ops.prefinalize import HostShadow, IdentityFinalize
from ..sql import ast
from ..utils import timex
from ..utils.device import Device
from .events import EOF, PreTrigger, Trigger
from .node import Node

logger = logging.getLogger(__name__)


class FusedWindowAggNode(Node):
    def __init__(
        self,
        name: str,
        window: ast.Window,
        plan: KernelPlan,
        dims: List[ast.FieldRef],
        capacity: int = 16384,
        micro_batch: int = 4096,
        direct_emit=None,  # ops.emit.DirectEmitPlan — vectorized tail
        emit_columnar: bool = False,  # window result stays a ColumnBatch
        device: Device = None,  # CUDA unless "cpu" is named (utils/device.py)
        prefinalize_lead_ms: int = 250,  # latency-hiding emit (prefinalize.py)
        prefinalize_backstop: bool = True,  # host backstop: boundaries never block
        tail_mode: str = "device",  # window-tail rows: "device" | "host"
    ) -> None:
        super().__init__(name)
        self.window = window
        self.plan = plan
        self.dims = dims
        self.direct_emit = direct_emit
        self.emit_columnar = emit_columnar
        self.wt = window.window_type
        self.length_ms = window.length_ms()
        self.interval_ms = window.interval_ms()
        if self.wt == ast.WindowType.HOPPING_WINDOW:
            iv = max(self.interval_ms, 1)
            self.n_panes = max((self.length_ms + iv - 1) // iv, 1)
        elif self.wt == ast.WindowType.TUMBLING_WINDOW:
            self.n_panes = 1
        else:
            raise NotImplementedError(
                f"{self.wt.name} windows are not ported yet")
        # heavy_hitters: per-column reversible dictionaries (codes -> values)
        # + the spec index -> raw column map for emit-time decoding. The hh
        # component is wide (sketches.HH_SIZE floats/key), so start small and
        # grow on demand instead of allocating the full default capacity.
        self._hh_cols: Dict[int, str] = {
            i: next(iter(s.arg.columns))[len(HH_COL_PREFIX):]
            for i, s in enumerate(plan.specs)
            if s.kind == "heavy_hitters"
        }
        self._hh_dicts: Dict[str, ValueDict] = {}
        self._hh_overflow_warned: set = set()
        if self._hh_cols and capacity > 2048:
            capacity = 2048
        self.gb = TorchGroupBy(plan, capacity=capacity,
                               n_panes=int(self.n_panes),
                               micro_batch=micro_batch, device=device)
        self.kt = KeyTable(self.gb.capacity)
        self.state: Optional[Dict[str, torch.Tensor]] = None
        self.cur_pane = 0
        self._rows_in_window = 0  # count windows: kept for the snapshot format
        self._spec_keys = [_call_key(s.call) for s in plan.specs]
        self._dtypes_seen = False
        # timers, armed by on_open: the boundary and its pre-triggers
        self._opened = False
        self._timer = None
        self._pre_timers: list = []
        # latency-hiding emit: up to 4 (pending fetch, shadow) pairs for the
        # coming boundary, the backstop identity first when there is one
        self._pipeline: list = []
        self.prefinalize_lead_ms = int(prefinalize_lead_ms)
        self._prefinalize_ok = (
            self.prefinalize_lead_ms > 0
            and self.gb.supports_prefinalize
            and plan.host_foldable
            # heavy-hitters boundaries use the compact recovery finalize:
            # a pre-issue would ship the raw HH_SIZE-wide sketch instead
            and not self._hh_cols
            and self.prefinalize_lead_ms < self._tick_interval()
        )
        # Window-tail rows after a pre-issue: "device" folds them into the
        # device state AND the shadow (snapshot + shadow count each row
        # once; the state stays complete, so checkpoints need no flush and
        # hopping panes keep tail rows for later windows). "host", for
        # tumbling windows, folds them into the shadow only (no upload
        # competing with the fetch); a checkpoint in that frozen span
        # flushes the shadow back to the card (absorb).
        if tail_mode not in ("device", "host"):
            raise ValueError(
                f"tail_mode must be 'device' or 'host', got {tail_mode!r}")
        self.tail_mode = tail_mode
        self._tail_host_only = (
            self._prefinalize_ok and tail_mode == "host"
            and self.wt == ast.WindowType.TUMBLING_WINDOW)
        self._device_frozen = False  # set at the first real pre-issue
        # backstop: tumbling windows only (a hopping window spans panes
        # older than the last boundary, which a boundary-started shadow
        # cannot represent)
        self._backstop_ok = (self._prefinalize_ok
                             and self.wt == ast.WindowType.TUMBLING_WINDOW)
        self._backstop = bool(prefinalize_backstop) and self._backstop_ok
        # heavy-hitters boundaries emit on the worker: the compact finalize
        # is launched on the pre-reset state, the dedupe runs off the fold
        # thread
        self._async_hh = (bool(self._hh_cols)
                          and self.gb.supports_prefinalize
                          and self.prefinalize_lead_ms > 0)
        # a boundary whose pre-issued fetch has not landed moves its wait
        # to the worker instead of stalling the folds
        self._emit_late_async = (self.gb.supports_prefinalize
                                 and not self._hh_cols)
        self._emit_q: Optional[queue.Queue] = None
        self._emit_worker: Optional[threading.Thread] = None
        # per-boundary record: {"source": "device" | "backstop" | "sync" |
        # "device-async" | "device-async-late", "fetch_ms": issue→landed
        # engine ms of the chosen fetch, "ages_ms": [age of each real
        # pre-issue at the boundary]}
        self.last_emit_info: Optional[dict] = None
        # recovery routes taken (each also logged): "sync" (a failed merge
        # finalized synchronously), "backup" (a failed deferred merge
        # emitted the backup finalize), "failed" (a worker delivery lost)
        self.recoveries: collections.Counter = collections.Counter()
        self._identity: Optional[IdentityFinalize] = None  # per capacity

    # ------------------------------------------------------------------- data
    def process(self, item: Any) -> None:
        if isinstance(item, Tuple):
            raise NotImplementedError(
                "row tuples into the fused node are not ported yet")
        if not isinstance(item, ColumnBatch):
            self.emit(item)
            return
        if item.n == 0:
            return
        with self._lock:
            self._fold(item)

    def _fold(self, batch: ColumnBatch) -> int:
        """Fold the batch into the current pane; returns rows folded."""
        return self._fold_rows(batch, self.cur_pane)

    def _build_kernel_inputs(self, sub: ColumnBatch, frozen: bool = False):
        """Encode group keys + materialize the kernel's numeric columns and
        validity masks for `sub`. Returns (cols, valid, slots). In a frozen
        span the device state does not grow (its rows go to the shadow)."""
        key_cols = []
        for d in self.dims:
            col = sub.columns.get(d.name)
            if col is None:
                col = np.full(sub.n, None, dtype=np.object_)
            key_cols.append(col)
        if key_cols:
            slots, grew = self.kt.encode_multi(key_cols)
            if grew and not frozen:
                self.state = self.gb.grow(self.state, self.kt.capacity)
        else:
            slots = np.zeros(sub.n, dtype=np.int32)
            if self.kt.n_keys == 0:
                self.kt.encode_column(np.array(["__all__"], dtype=np.object_))
        cols: Dict[str, np.ndarray] = {}
        valid: Dict[str, np.ndarray] = {}
        for name in self.plan.columns:
            if name.startswith(HLL_COL_PREFIX):
                # derived hashed copy for hll; raw column stays numeric for
                # any other spec / WHERE / FILTER that shares it
                raw = name[len(HLL_COL_PREFIX):]
                cols[name] = encode_hll_column(sub.columns.get(raw), sub.n)
                v = sub.valid.get(raw)
                if v is not None:
                    valid[name] = v
                continue
            if name.startswith(HH_COL_PREFIX):
                # heavy_hitters: dictionary-encode to dense codes the sketch
                # can bit-recover; the dict decodes them back at emit
                raw = name[len(HH_COL_PREFIX):]
                col = sub.columns.get(raw)
                vd = self._hh_dicts.setdefault(raw, ValueDict())
                if col is None:
                    cols[name] = np.full(sub.n, np.nan, dtype=np.float32)
                else:
                    cols[name] = vd.encode(col)
                    if vd.overflowed and raw not in self._hh_overflow_warned:
                        self._hh_overflow_warned.add(raw)
                        logger.warning(
                            "heavy_hitters(%s): value dictionary exceeded "
                            "%d distinct values; new values are invisible "
                            "to the sketch", raw, len(vd.snapshot()))
                v = sub.valid.get(raw)
                if v is not None:
                    valid[name] = v
                continue
            col = sub.columns.get(name)
            if col is None:
                cols[name] = np.full(sub.n, np.nan, dtype=np.float32)
                continue
            if col.dtype == np.object_:
                # mixed/object numeric column: coerce, NaN for bad rows
                coerced = np.full(sub.n, np.nan, dtype=np.float32)
                for i, v in enumerate(col):
                    if isinstance(v, (int, float)) and not isinstance(v, bool):
                        coerced[i] = v
                cols[name] = coerced
            else:
                cols[name] = col
            v = sub.valid.get(name)
            if v is not None:
                valid[name] = v
        if not self._dtypes_seen:
            self.gb.observe_dtypes(cols)
            self._dtypes_seen = True
        return cols, valid, slots

    def _fold_rows(self, sub: ColumnBatch, pane_arg) -> int:
        """Encode keys + build kernel columns + device fold for `sub` into
        pane `pane_arg`, and the same rows into every live shadow."""
        if self.state is None:
            self.state = self.gb.init_state()
        frozen = self._device_frozen and bool(self._pipeline)
        cols, valid, slots = self._build_kernel_inputs(sub, frozen)
        if not frozen:
            if self.gb.capacity < self.kt.capacity:
                # deferred grow: keys first seen in a frozen span, or a
                # restore that left the key table wider
                self.state = self.gb.grow(self.state, self.kt.capacity)
            self.state = self.gb.fold(self.state, cols, slots, valid,
                                      pane_arg)
        # every live shadow mirrors the fold (a frozen span's retries and
        # the backstop may share shadow objects)
        seen = set()
        for _, shadow in self._pipeline:
            if id(shadow) not in seen:
                seen.add(id(shadow))
                shadow.fold(cols, slots, valid)
        return sub.n

    # -------------------------------------------------------------- lifecycle
    def on_open(self) -> None:
        """Arm the boundary timers on the engine clock. Until a node is
        opened its caller drives on_trigger (and on_pre_trigger) itself."""
        with self._lock:
            if self.state is None:  # keep checkpoint-restored partials
                self.state = self.gb.init_state()
            self._opened = True
            self._schedule_next_tick()

    def on_close(self) -> None:
        with self._lock:
            self._opened = False
            for t in [self._timer, *self._pre_timers]:
                if t is not None:
                    t.stop()
        self._drain_async_emits()
        if self._emit_worker is not None and self._emit_worker.is_alive():
            self._emit_q.put(None)
            self._emit_worker.join(timeout=5)

    def _tick_interval(self) -> int:
        if self.wt == ast.WindowType.TUMBLING_WINDOW:
            return self.length_ms
        return self.interval_ms or self.length_ms

    def _schedule_next_tick(self) -> None:
        now = timex.now_ms()
        interval = self._tick_interval()
        next_end = timex.align_to_window(now + 1, interval)
        self._timer = timex.after(
            next_end - now, lambda ts: self.put_control(Trigger(ts=ts)))
        self._pre_timers = []
        if self._prefinalize_ok:
            # two chances per boundary: the 2x-lead pre-issue, and the
            # 1x-lead one that refreshes it if it has not landed yet
            lead = self.prefinalize_lead_ms
            for k in (2, 1):
                if next_end - now > k * lead:
                    self._pre_timers.append(timex.after(
                        next_end - now - k * lead,
                        lambda ts, end=next_end: self.put_control(
                            PreTrigger(ts=end))))

    # ---------------------------------------------------------------- control
    def on_pre_trigger(self, pre: PreTrigger) -> None:
        """Ahead of the boundary: launch the components kernel on the
        current state, start its copy, and shadow the tail rows. A landed
        real fetch needs no refresh; one still in flight gets a fresher
        one stacked beside it (at most two un-landed fetches)."""
        if not self._prefinalize_ok or self.kt.n_keys == 0:
            return
        real = self._real(self._pipeline)
        if real and real[-1][0].ready():
            return
        if len(self._pipeline) >= 4 or len(real) >= 2:
            return
        if real and self._device_frozen:
            # the state has not changed since the first real pre-issue
            # (frozen-span rows are host-only): retry the fetch on it,
            # sharing that span's shadow
            self._pipeline.append((self.gb.prefinalize_begin(self.state),
                                   real[0][1]))
            return
        self._pipeline.append((
            self.gb.prefinalize_begin(self.state),
            HostShadow(self.plan, self.gb.comp_specs, self.kt.capacity)))
        self._device_frozen = self._tail_host_only

    def on_trigger(self, trig: Trigger) -> None:
        end = trig.ts
        wr = WindowRange(end - self.length_ms, end)
        if self._async_hh:
            self._emit_hh_async(wr)
        else:
            self._boundary_emit(wr)
        if self.wt == ast.WindowType.TUMBLING_WINDOW:
            self.state = self.gb.reset_pane(self.state, 0)
        else:
            # advance to the next pane; expire it (it held the oldest slice)
            self.cur_pane = (self.cur_pane + 1) % self.n_panes
            self.state = self.gb.reset_pane(self.state, self.cur_pane)
        self.begin_window_backstop()
        if self._opened:
            self._schedule_next_tick()

    def begin_window_backstop(self) -> None:
        """Open the next window with an always-ready identity entry and a
        window-spanning shadow, so its boundary can never wait on the
        card; real pre-issues still run and are preferred once landed."""
        if not (self._backstop and self.kt.n_keys):
            return
        if self._identity is None or \
                self._identity.capacity != self.kt.capacity:
            # never written by a merge, so one per capacity serves every
            # window (the wide components make a fresh one real churn)
            self._identity = IdentityFinalize(self.gb.comp_specs,
                                              self.kt.capacity)
        self._release(self._pipeline)
        self._pipeline = [(
            self._identity,
            HostShadow(self.plan, self.gb.comp_specs, self.kt.capacity))]
        self._device_frozen = False

    def on_eof(self, eof: EOF) -> None:
        """Flush the open window (through its pre-issues, if any) and
        forward the EOF."""
        now = timex.now_ms()
        self._drain_async_emits()
        self._emit(WindowRange(now - self.length_ms, now))
        if self.wt == ast.WindowType.TUMBLING_WINDOW:
            self.state = self.gb.reset_pane(self.state, 0)
        self.broadcast(eof)

    # ------------------------------------------------------------------- emit
    @staticmethod
    def _release(pipeline) -> None:
        for pending, _ in pipeline:
            pending.release()

    @staticmethod
    def _real(pipeline) -> list:
        """The pipeline's real fetches (the backstop identity left out)."""
        return [e for e in pipeline if not isinstance(e[0], IdentityFinalize)]

    def _boundary_emit(self, wr: WindowRange) -> None:
        """Window-boundary emission that never waits on the card: with a
        landed fetch (or the backstop) emit now; with pre-issues none of
        which has landed, hand the wait to the emit worker and keep
        folding (the fetches are already ordered before the reset). A
        worker backlog also defers, so windows deliver in order."""
        if not (self._emit_late_async and self._pipeline):
            self._drain_async_emits()  # deliveries before this one first
            return self._emit(wr)
        q = self._emit_q
        backlog = q is not None and q.unfinished_tasks > 0
        ready_any = any(p.ready() for p, _ in self._pipeline)
        if not backlog and (ready_any or not self.kt.n_keys):
            return self._emit(wr)
        pipeline, self._pipeline = self._pipeline, []
        self._device_frozen = False
        # the backup finalize is launched NOW, before on_trigger's pane
        # reset: if the deferred merge fails, the worker recovers from it
        # (its copy happens only then)
        backup = self.gb.finalize_later(self.state)
        self._enqueue("pf", (pipeline, backup), wr)

    def _emit_hh_async(self, wr: WindowRange) -> None:
        """Heavy-hitters boundary: launch the compact recovery finalize on
        the pre-reset state, start its copy, hand delivery to the worker."""
        if self.kt.n_keys == 0:
            self.last_emit_info = None
            return
        self._enqueue("hh", self.gb.finalize_begin(self.state), wr)

    def _enqueue(self, kind: str, payload, wr: WindowRange) -> None:
        """Queue a delivery for the worker, stamped with the issue-time key
        count: the key table is append-only (no tiered slot recycling, for
        which the reference also stamps a slot→key copy), so the slots
        below that count decode to the same keys when the worker emits."""
        self._ensure_emit_worker()
        self._emit_q.put((kind, payload, self.kt.n_keys, wr,
                          time.perf_counter()))

    def _ensure_emit_worker(self) -> None:
        if self._emit_q is None:
            self._emit_q = queue.Queue()
        if self._emit_worker is None or not self._emit_worker.is_alive():
            # the worker runs on the card the node's state lives on (a
            # tensor's device names its index; the group-by's may not)
            self._emit_worker = threading.Thread(
                target=self._emit_worker_loop,
                args=(self.state["act"].device,),
                name=f"{self.name}-emit", daemon=True)
            self._emit_worker.start()

    def _emit_worker_loop(self, dev: torch.device) -> None:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        while True:
            item = self._emit_q.get()
            if item is None:
                self._emit_q.task_done()
                break
            kind, payload, n_keys, wr, t_issue = item
            try:
                if kind == "pf":
                    pipeline, backup = payload
                    try:
                        self._deliver_pf(pipeline, backup, n_keys, wr,
                                         t_issue)
                    finally:
                        self._release(pipeline)
                    continue
                try:  # "hh": the compact finalize, assembled here
                    outs, act = self.gb.host_tail(payload.get(), n_keys)
                    self.last_emit_info = {
                        "source": "device-async",
                        "fetch_ms": (time.perf_counter() - t_issue) * 1e3,
                        "ages_ms": []}
                    self._deliver(outs, act, wr)
                finally:  # outs / act may view the pinned buffer
                    payload.release()
            except Exception as exc:
                logger.error("async %s emit failed on %s: %s", kind,
                             self.name, exc)
                self.recoveries["failed"] += 1
            finally:
                self._emit_q.task_done()

    # bounded drain deadline (seconds)
    drain_deadline_s: float = 30.0

    def _drain_async_emits(self, must_complete: bool = False) -> None:
        """Block until the deferred deliveries have been emitted: before a
        synchronous boundary, a checkpoint, EOF and close. Bounded: on
        timeout a snapshot (must_complete) raises, so the checkpoint fails
        and a later one retries; the other callers log and go on."""
        q = self._emit_q
        if q is None:
            return
        deadline_s = self.drain_deadline_s
        deadline = time.perf_counter() + deadline_s
        with q.all_tasks_done:
            while q.unfinished_tasks:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    if must_complete:
                        raise RuntimeError(
                            f"{self.name}: async emit drain timed out after "
                            f"{deadline_s:.0f}s with {q.unfinished_tasks} "
                            "emission(s) in flight")
                    logger.error(
                        "%s: async emit drain timed out after %.0fs with %d "
                        "emission(s) in flight; going on", self.name,
                        deadline_s, q.unfinished_tasks)
                    return
                q.all_tasks_done.wait(remaining)

    def _deliver_pf(self, pipeline, backup, n_keys: int, wr: WindowRange,
                    t_issue: float) -> None:
        """Worker delivery of a deferred boundary: wait for the best
        pre-issue to land, merge, emit. Touches only the fetches and the
        closed window's shadow, never self.state; a failed merge emits the
        backup finalize instead."""
        real = self._real(pipeline)
        # the newest landed real fetch; else wait on the oldest real one
        # (its copy was queued first); the backstop only without any
        pending, shadow = next(
            ((p, s) for p, s in reversed(real) if p.ready()), None,
        ) or (real[0] if real else pipeline[0])
        try:
            outs, act = self.gb.prefinalize_merge(pending, shadow, n_keys)
        except Exception as exc:
            logger.warning("%s: deferred boundary merge failed (%s); "
                           "emitting the backup finalize", self.name, exc)
            self.recoveries["backup"] += 1
            outs, act = self.gb.host_tail(backup.get(), n_keys)
        self.last_emit_info = {
            "source": "device-async-late",
            "fetch_ms": (pending.fetch_ms() if hasattr(pending, "fetch_ms")
                         else (time.perf_counter() - t_issue) * 1000.0),
            "ages_ms": []}
        self._deliver(outs, act, wr)

    def _emit(self, wr: WindowRange) -> None:
        pipeline, self._pipeline = self._pipeline, []
        frozen, self._device_frozen = self._device_frozen, False
        try:
            self._emit_from(pipeline, frozen, wr)
        finally:
            self._release(pipeline)

    def _emit_from(self, pipeline, frozen: bool, wr: WindowRange) -> None:
        n_keys = self.kt.n_keys
        if n_keys == 0 or self.state is None:
            self.last_emit_info = None  # no stale record for empty windows
            return
        if not pipeline:
            outs, act = self.gb.finalize(self.state, n_keys)
            self.last_emit_info = {"source": "sync", "fetch_ms": 0.0,
                                   "ages_ms": []}
            self._deliver(outs, act, wr)
            return
        real = self._real(pipeline)
        # the newest landed real fetch; else the newest ready entry (the
        # backstop); else wait on the oldest (its copy was queued first)
        pending, shadow = next(
            ((p, s) for p, s in reversed(real) if p.ready()), None,
        ) or next(((p, s) for p, s in reversed(pipeline) if p.ready()),
                  pipeline[0])
        now = timex.now_ms()
        self.last_emit_info = {
            "source": ("backstop" if isinstance(pending, IdentityFinalize)
                       else "device"),
            "fetch_ms": (pending.fetch_ms() if hasattr(pending, "fetch_ms")
                         else 0.0),
            "ages_ms": [float(now - p.t_created) for p, _ in real]}
        try:
            outs, act = self.gb.prefinalize_merge(pending, shadow, n_keys)
            if hasattr(pending, "fetch_ms"):
                # the merge may have waited for the copy: record when it
                # landed, not the in-flight sentinel
                self.last_emit_info["fetch_ms"] = pending.fetch_ms()
        except Exception as exc:
            logger.warning("%s: prefinalize merge failed (%s); finalizing "
                           "synchronously", self.name, exc)
            self.recoveries["sync"] += 1
            if frozen and real:
                self._flush_shadow(real[0][1])
            outs, act = self.gb.finalize(self.state, n_keys)
            self.last_emit_info["source"] = "sync"
        self._deliver(outs, act, wr)

    def _deliver(self, outs, act: np.ndarray, wr: WindowRange) -> None:
        active = np.nonzero(act > 0)[0]
        if len(active) == 0:
            return
        if self.direct_emit is not None:
            self._emit_direct(outs, active, wr)
            return
        self._emit_grouped(outs, active, wr)

    def _decode_hh(self, outs):
        """Map heavy_hitters (code, count) pairs back to original values."""
        if not self._hh_cols:
            return outs
        outs = list(outs)
        for i, raw in self._hh_cols.items():
            vd = self._hh_dicts.get(raw)
            col = outs[i]
            dec = np.empty(len(col), dtype=np.object_)
            dec[:] = [
                [{"value": vd.decode(c) if vd else None, "count": n}
                 for c, n in row]
                for row in col
            ]
            outs[i] = dec
        return outs

    def _emit_grouped(self, outs, active: np.ndarray, wr: WindowRange) -> None:
        """Row-path emit tail: build GroupedTuplesSet for downstream
        HAVING/ORDER/PROJECT nodes."""
        outs = self._decode_hh(outs)
        active_list = active.tolist()
        out_lists = []
        for col in outs:
            sel = col[active]
            if np.issubdtype(sel.dtype, np.floating):
                sel = np.where(np.isnan(sel), None, sel.astype(object))
            out_lists.append(sel.tolist())
        groups: List[GroupedTuples] = []
        dim_names = [d.name for d in self.dims]
        single_dim = dim_names[0] if len(dim_names) == 1 else None
        spec_keys = self._spec_keys
        ts = wr.window_end
        for j, slot in enumerate(active_list):
            key = self.kt.decode(slot)
            if single_dim is not None:
                msg = {single_dim: key}
            elif dim_names:
                msg = dict(zip(dim_names, key))
            else:
                msg = {}
            agg_values = {
                spec_keys[i]: out_lists[i][j] for i in range(len(spec_keys))
            }
            groups.append(
                GroupedTuples(
                    content=[Tuple(emitter="", message=msg, timestamp=ts)],
                    group_key=str(key), window_range=wr, agg_values=agg_values,
                )
            )
        self.emit(GroupedTuplesSet(groups=groups, window_range=wr))

    def _emit_direct(self, outs, active: np.ndarray, wr: WindowRange) -> None:
        """Vectorized tail: HAVING/ORDER/LIMIT/projection computed over the
        finalize arrays; emits the final output messages directly."""
        outs = self._decode_hh(outs)
        dim_names = [d.name for d in self.dims]
        dim_cols: Dict[str, np.ndarray] = {}
        if dim_names:
            keys = self.kt.decode_all()
            if len(dim_names) == 1:
                col = np.empty(len(active), dtype=np.object_)
                col[:] = [keys[s] for s in active.tolist()]
                dim_cols[dim_names[0]] = col
            else:
                sel = [keys[s] for s in active.tolist()]
                for i, dn in enumerate(dim_names):
                    col = np.empty(len(active), dtype=np.object_)
                    col[:] = [k[i] for k in sel]
                    dim_cols[dn] = col
        agg_cols = [col[active] for col in outs]
        if self.emit_columnar:
            cb = self.direct_emit.run_columnar(
                dim_cols, agg_cols, wr.window_start, wr.window_end)
            if cb is not None and cb.n:
                self.emit(cb, count=cb.n)
            return
        msgs = self.direct_emit.run(
            dim_cols, agg_cols, wr.window_start, wr.window_end)
        if msgs:
            # always a list of message dicts, never a bare dict
            self.emit(msgs, count=len(msgs))

    def _flush_shadow(self, shadow) -> None:
        """Fold a frozen span's (host-only) rows back into the device state
        (tumbling only: hopping shadows duplicate device content)."""
        if not self._tail_host_only or shadow is None or not shadow.n_rows:
            return
        if self.gb.capacity < shadow.capacity:
            self.state = self.gb.grow(self.state, shadow.capacity)
        self.state = self.gb.absorb(self.state, shadow.data, 0)

    def _flush_tail(self) -> None:
        """Make the device state complete before a snapshot; drops the
        pre-issue pipeline. Only a frozen span's shadow holds rows the
        device lacks (the backstop's shadow duplicates folded rows)."""
        pipeline, self._pipeline = self._pipeline, []
        frozen, self._device_frozen = self._device_frozen, False
        try:
            real = self._real(pipeline)
            if frozen and real:
                self._flush_shadow(real[0][1])
        finally:
            self._release(pipeline)

    # ------------------------------------------------------------------ state
    def snapshot_state(self) -> Optional[dict]:
        """The reference's snapshot format (keys, partials, cur_pane,
        rows_in_window), so a checkpoint crosses between the packages.
        Deferred deliveries drain first, and a frozen span's shadow is
        flushed into the state."""
        with self._lock:
            return self._snapshot()

    def _snapshot(self) -> dict:
        self._drain_async_emits(must_complete=True)
        if self.state is None:
            self.state = self.gb.init_state()
        self._flush_tail()
        host = self.gb.state_to_host(self.state)
        snap = {
            "keys": self.kt.decode_all(),
            "partials": {k: v.tolist() for k, v in host.items()},
            "cur_pane": self.cur_pane,
            "rows_in_window": self._rows_in_window,
        }
        if self._hh_dicts:
            # code order indexes the saved sketch counters — must persist
            snap["hh_dicts"] = {
                c: vd.snapshot() for c, vd in self._hh_dicts.items()
            }
        return snap

    def restore_state(self, state: dict) -> None:
        with self._lock:
            self._restore(state)

    def _restore(self, state: dict) -> None:
        keys = state.get("keys", [])
        self.kt.restore([tuple(k) if isinstance(k, list) else k for k in keys])
        partials = state.get("partials")
        if partials:
            host, cap = self.gb.host_from_partials(partials)
            self.gb.capacity = cap
            self.state = self.gb.state_from_host(host)
            self.kt.capacity = max(self.kt.capacity, self.gb.capacity)
        self.cur_pane = state.get("cur_pane", 0)
        self._rows_in_window = state.get("rows_in_window", 0)
        for c, values in state.get("hh_dicts", {}).items():
            vd = ValueDict()
            vd.restore(values)
            self._hh_dicts[c] = vd
