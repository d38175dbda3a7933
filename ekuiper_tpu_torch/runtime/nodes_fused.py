"""Fused window→GROUP BY→aggregate node (counterpart of
ekuiper_tpu/runtime/nodes_fused.py `FusedWindowAggNode`: TUMBLING,
HOPPING, SLIDING, COUNT, SESSION and STATE windows on processing time,
and all but SLIDING on event time).

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
  (`_emit_hh_async`), which runs the host dedupe off the fold thread, and
  so do a rule group's tumbling boundaries (`"mr"`,
  runtime/nodes_multirule.py), one stacked finalize for every rule.
- `tail_mode="host"` freezes the device state at the first pre-issue of a
  tumbling window: tail rows fold into the shadow only, and a checkpoint in
  that span flushes the shadow back to the card (`groupby_absorb`).

A boundary with no pre-issue (lead 0, or a node driven by hand without
pre-triggers) finalizes synchronously on the device, after any deferred
delivery before it (the reference hands that case to its worker as a
"count" delivery; the port's "count" deliveries are the count window's).
`last_emit_info["source"]` says which route served each boundary.

The sketch aggregates fold through derived columns built here per batch:
hll(col) reads `__hll__col` (the distinct-preserving float32 encoding of
the raw column) and heavy_hitters(col, k) reads `__hhc__col` (dense codes
from a per-column ValueDict, decoded back to the original values at
emit).

SLIDING windows (`SLIDINGWINDOW(unit, L[, delay]) OVER (WHEN cond)`) fold
rows into time panes of `bucket_ms` by row timestamp (a batch that crosses
a bucket edge folds with a per-row pane vector) and keep the rows in a
host row ring. A trigger row t emits the window (t - L, t + delay] by one
of the reference's two implementations:

- the DABA ring (ops/slidingring.py), the default: each closed bucket
  advances the ring's running partials, and a trigger is one ring query
  (the body) plus the two partial edge buckets folded on the host into a
  HostShadow; the emit worker merges the two (`"ring"` deliveries, source
  `"device-ring"`). Off the in-order discipline (a gap, late rows, a
  recycled pane, a delayed emission) a trigger rebuilds the ring with one
  flip or merges the window's live panes with the components kernel.
- the refold path (`slidingImpl: "refold"`, and where the ring cannot
  serve: a heavy_hitters plan, a ring over its `slidingDevRingMb` budget,
  a plan the ring rejects; `sliding_fallback` names the reason): each
  batch is uploaded once, padded to the micro-batch, and kept on the card
  (`_dev_ring`, capped by the same budget, oldest entries evicted first).
  A trigger refolds its two edge buckets into the scratch pane, from the
  cached batches under a row mask (all of a trigger's cached segments in
  one `fold_masked_many` call: one masked-fold launch a segment group)
  or from the host rows of evicted ones, then finalizes the full
  panes and the scratch pane under one pane mask: heavy_hitters
  synchronously (source `"sync"`), the others on the emit worker
  (`"refold"` deliveries, source `"device-async"`), and resets the scratch
  pane. A window whose pane was recycled refolds whole from the rows.

Tiered key state (ops/tierstore.py; `tier_budget_mb`, the planner's
tierStore / tierHotMb options) on tumbling and hopping rules: the state is
built at the layout's hot capacity, each batch's new keys are admitted
(returning demoted keys promoted into their fresh slots) before it folds,
and each boundary emits the device groups, then the spilled keys' share
of the window, resets the expired pane (bumping its epoch), and applies the
policy's demote plan and starts the next touch scan; the harvests and
scans run on the emit worker (`"tier"` tasks). Slots recycle between a
deferred delivery's dispatch and its emit, so each delivery carries the
slot→key list of its dispatch.

COUNT, STATE and SESSION windows fold into one pane and emit on their
own edges, not on the clock's boundaries, as the reference's do:

- `COUNTWINDOW(n)`: a batch is folded up to the window's n-th row, the
  window emits and its pane resets, and the rest of the batch folds into
  the next window. Under the default boundary (`prefinalize_lead_ms` >
  0) the finalize is launched on the state as it stands and the emit
  worker delivers it (`"count"` deliveries, source `"device-async"`)
  while the fold thread resets the pane and goes on; with lead 0 the
  window emits synchronously.
- `STATEWINDOW(begin, emit)`: both conditions are evaluated on the host
  over the batch's columns (a batch without a column they read gives
  all-false); a begin row opens the window, the rows up to and including
  the next emit row fold into it (the opening row cannot close it), and
  the window emits synchronously and resets.
- `SESSIONWINDOW(unit, length, gap)`: every batch extends the session
  (one per stream, as the reference's); one gap timer re-arms itself
  against the last batch's time and the length timer caps the session.
  Each trigger carries its session's id (and the gap check its arm
  generation), so a trigger of a closed session or a superseded gap
  check does nothing.

Event time (`is_event_time`, behind a runtime/nodes_window.py
WatermarkNode that drops late rows and orders the batch): no boundary
timers; the watermarks, delivered to `on_watermark`, close the windows.

- TUMBLING / HOPPING: each row folds into the pane of its time bucket
  (bucket = ts // the hop or the length, pane = bucket % n_panes; n_panes
  covers the window's span, the late tolerance and two of slack). A batch
  of one bucket folds with a scalar pane, one across buckets with a uint8
  per-row pane vector (a rule group too: the batched folds take it). A
  watermark emits each window whose buckets lie wholly below it,
  synchronously (a group: every rule's window to its own node), and
  resets the pane that expires. A row of a bucket already emitted is
  dropped, counted (`event_counts["dropped"]`); a batch spanning more
  buckets than the panes hold emits its oldest windows early.
- SESSION: batches are buffered as they come; a watermark sorts the
  buffered rows, splits them at gaps and folds, emits and resets each
  session whose last row + gap it has passed. EOF emits the rest as one
  window.
- COUNT and STATE fold as on processing time.

Tiered sliding rules demote only quiescent keys (the DABA ring and the
refold path alike). On a mesh (`mesh`, a parallel/mesh.py Mesh of one
device) the state is a parallel/sharded.py ShardedGroupBy: each batch
folds per (row shard, key shard) into partials merged into the state;
boundaries stay synchronous, the state untiered, and a sliding rule
takes the refold path with host-row edge refolds (`sliding_fallback`
"sharded_kernel"), as the reference's. Not ported yet, and refused at
construction: event-time sliding windows.
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
from ..ops.groupby import TorchGroupBy, col_np_dtype, slot_dtype
from ..ops.keytable import KeyTable
from ..ops.prefinalize import HostShadow, IdentityFinalize
from ..ops.slidingring import QUERY_ADJ, SlidingRing, ring_layout_for
from ..ops.tierstore import TierManager, plan_tier_layout
from ..parallel.sharded import ShardedGroupBy
from ..sql import ast
from ..sql.compiler import try_compile
from ..utils import timex
from ..utils.device import Device
from .events import EOF, PreTrigger, Trigger, Watermark
from .node import Node

logger = logging.getLogger(__name__)

#: the most panes an event-time window may need: pane ids ship as uint8
MAX_EVENT_PANES = 255


def event_time_panes(window: ast.Window, late_tolerance_ms: int):
    """(bucket ms, window span in buckets, panes) of an event-time
    tumbling or hopping window (the reference's nodes_fused.py 121-137 and
    planner.py 336-347): the bucket is the hop, or the length; the panes
    hold every bucket that can be live at once, the window's span, the
    late tolerance's buckets and two of slack, at least four."""
    length = window.length_ms()
    bucket = (window.interval_ms()
              if window.window_type == ast.WindowType.HOPPING_WINDOW
              and window.interval_ms() else length)
    span = max(length // max(bucket, 1), 1)
    slack = -(-max(late_tolerance_ms, 0) // max(bucket, 1))
    return bucket, span, max(span + slack + 2, 4)


def _host_mask(ce, columns: Dict[str, np.ndarray], n: int) -> np.ndarray:
    """Vectorized host condition -> per-row bool mask. A batch missing the
    referenced column (or with uncoercible types) evaluates to all-false:
    null semantics, as the host row evaluator's."""
    try:
        return np.broadcast_to(np.asarray(ce(columns), dtype=np.bool_), (n,))
    except Exception:
        return np.zeros(n, dtype=np.bool_)


def _enc_arr(a: np.ndarray) -> dict:
    """Checkpoint encoding of a numpy array (the reference's): raw bytes
    in base64 and the dtype."""
    import base64

    a = np.ascontiguousarray(a)
    return {"d": str(a.dtype),
            "b": base64.b64encode(a.tobytes()).decode("ascii")}


def _dec_arr(v) -> np.ndarray:
    import base64

    if isinstance(v, dict) and "b" in v:
        return np.frombuffer(base64.b64decode(v["b"]),
                             dtype=np.dtype(v["d"])).copy()
    return np.asarray(v)  # list-encoded checkpoints


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
        dev_ring_budget_mb: int = 256,  # sliding ring state cap (MB)
        sliding_impl: str = "daba",  # "daba" rings | "refold"
        ring_layout=None,  # ops.slidingring.RingLayout chosen at plan time
        tier_budget_mb: float = 0.0,  # tiered key state's budget (0 = off)
        tier_scan_ms: int = 0,  # tier policy cadence (0 = from the window)
        is_event_time: bool = False,  # watermark-driven windows (see above)
        late_tolerance_ms: int = 0,  # the watermark's lag behind max ts
        mesh=None,  # parallel.mesh.Mesh: the state sharded (parallel/)
    ) -> None:
        super().__init__(name)
        self.mesh = mesh
        self.window = window
        self.plan = plan
        self.dims = dims
        self.direct_emit = direct_emit
        self.emit_columnar = emit_columnar
        self.wt = window.window_type
        self.length_ms = window.length_ms()
        self.interval_ms = window.interval_ms()
        self.is_event_time = bool(is_event_time)
        #: the WatermarkNode the planner connects ahead of an event-time
        #: node (its entry; planner/fused.py), else None
        self.watermark = None
        if self.is_event_time:
            self._init_event_time(window, int(late_tolerance_ms))
        elif self.wt == ast.WindowType.HOPPING_WINDOW:
            iv = max(self.interval_ms, 1)
            self.n_panes = max((self.length_ms + iv - 1) // iv, 1)
        elif self.wt == ast.WindowType.TUMBLING_WINDOW:
            self.n_panes = 1
        elif self.wt == ast.WindowType.SLIDING_WINDOW:
            self._init_sliding(window, plan, capacity, dev_ring_budget_mb,
                               sliding_impl, ring_layout)
        else:
            # count, state and session windows: one pane, reset at each
            # emission (their edges are rows and timers, not buckets)
            self.n_panes = 1
            self._init_row_windows(window)
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
        # tiered key state (ops/tierstore.py): the geometry from the budget
        # and the pane count, as the reference chooses it; heavy_hitters
        # plans stay untiered. The state (and a sliding rule's ring, so a
        # wide rule can keep DABA inside slidingDevRingMb) is built at the
        # hot capacity: growth past it stays possible, the recycler works
        # to avoid it.
        self.tier: Optional[TierManager] = None
        self._tier_layout = None
        # a sharded kernel keeps the untiered path (the reference's gate)
        if tier_budget_mb and mesh is None and not self._hh_cols and \
                self.wt in (ast.WindowType.TUMBLING_WINDOW,
                            ast.WindowType.HOPPING_WINDOW,
                            ast.WindowType.SLIDING_WINDOW):
            self._tier_layout = plan_tier_layout(
                plan, int(self.n_panes), capacity, float(tier_budget_mb),
                scan_interval_ms=int(tier_scan_ms),
                window_ms=self.interval_ms or self.length_ms)
            if self._tier_layout is not None:
                capacity = min(capacity, self._tier_layout.hot_capacity())
        self.gb = self._make_gb(plan, capacity, micro_batch, device)
        self.ring: Optional[SlidingRing] = None
        self._ring_dev: Optional[Dict[str, torch.Tensor]] = None
        if self.wt == ast.WindowType.SLIDING_WINDOW:
            self.sliding_impl = self._choose_sliding_impl(sliding_impl)
        self.kt = KeyTable(self.gb.capacity)
        if self._tier_layout is not None and \
                getattr(self.gb, "track_touch", False):
            sliding = self.wt == ast.WindowType.SLIDING_WINDOW
            self.tier = TierManager(
                self.gb, self.kt, self._tier_layout, submit=self._tier_submit,
                # a sliding rule demotes only keys idle past the whole pane
                # and row retention, so no pane, ring partial or retained
                # row still names the recycled slot
                quiescent_only=sliding,
                min_idle_ms=((self.n_ring_panes + 10) * self.bucket_ms
                             if sliding else 0),
                on_tier_event=self._on_tier_event)
        else:
            self._tier_layout = None  # a group-by without a touch column
        self.state: Optional[Dict[str, torch.Tensor]] = None
        self.cur_pane = 0
        # count window: its length in rows, and the rows of the open window
        self.count_len = window.length or 0
        self._rows_in_window = 0
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
            self.wt in (ast.WindowType.TUMBLING_WINDOW,  # boundary timers
                        ast.WindowType.HOPPING_WINDOW)
            # watermark boundaries are not known ahead: they emit
            # synchronously
            and not self.is_event_time
            and self.prefinalize_lead_ms > 0
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
                          and not self.is_event_time
                          and self.gb.supports_prefinalize
                          and self.prefinalize_lead_ms > 0)
        # a boundary whose pre-issued fetch has not landed moves its wait
        # to the worker instead of stalling the folds
        self._emit_late_async = (self.gb.supports_prefinalize
                                 and not self.is_event_time
                                 and not self._hh_cols)
        # a count window's emission: the finalize is launched on the state
        # as it stands and the worker delivers it (`"count"`), while the
        # fold thread resets the pane and folds the rest of the batch
        self._async_count = (self.wt == ast.WindowType.COUNT_WINDOW
                             and self.gb.supports_prefinalize
                             and not self._hh_cols
                             and self.prefinalize_lead_ms > 0)
        # a rule group's tumbling boundaries emit on the worker (set by
        # runtime/nodes_multirule.py MultiRuleFusedNode)
        self._async_mr = False
        self._emit_q: Optional[queue.Queue] = None
        self._emit_worker: Optional[threading.Thread] = None
        # deliveries queued (fold thread) and done (emit worker): each is
        # written by one thread, the difference is the deliveries a
        # boundary must wait for (the tier's tasks on the same worker are
        # not deliveries)
        self._deliveries_queued = 0
        self._deliveries_done = 0
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

    def _make_gb(self, plan: KernelPlan, capacity: int, micro_batch: int,
                 device: Device) -> TorchGroupBy:
        """Build the group-by state and kernels: a ShardedGroupBy on the
        node's mesh (capacity and micro_batch rounded up to its shards);
        MultiRuleFusedNode builds a BatchedGroupBy (with the
        already-computed self.n_panes)."""
        if self.mesh is not None:
            return ShardedGroupBy(plan, self.mesh, capacity=capacity,
                                  n_panes=int(self.n_panes),
                                  micro_batch=micro_batch)
        return TorchGroupBy(plan, capacity=capacity,
                            n_panes=int(self.n_panes),
                            micro_batch=micro_batch, device=device,
                            track_touch=self._tier_layout is not None)

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
            if self.wt == ast.WindowType.COUNT_WINDOW:
                self._fold_count_window(item)
            elif self.wt == ast.WindowType.STATE_WINDOW:
                self._fold_state_window(item)
            elif self.is_event_time and \
                    self.wt == ast.WindowType.SESSION_WINDOW:
                # the sessions resolve at each watermark: buffer the batch
                # as it came (no device work until a session is complete)
                self._evs_batches.append(item)
            else:
                self._fold(item)
                if self.wt == ast.WindowType.SESSION_WINDOW:
                    self._touch_session()

    def _fold(self, batch: ColumnBatch, start: int = 0,
              end: Optional[int] = None) -> int:
        """Fold rows [start, end) of the batch into the current pane (a
        sliding window: into its rows' time panes); returns rows folded."""
        end = batch.n if end is None else end
        if end <= start:
            return 0
        sub = (batch if start == 0 and end == batch.n
               else batch.take(np.arange(start, end)))
        if self.is_event_time and self.wt in (
                ast.WindowType.TUMBLING_WINDOW, ast.WindowType.HOPPING_WINDOW):
            # event-time count and state windows fold as processing time
            # does (the watermark node has dropped and ordered the rows)
            return self._fold_event(sub)
        if self.wt == ast.WindowType.SLIDING_WINDOW:
            return self._fold_sliding(sub)
        return self._fold_rows(sub, self.cur_pane)

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
            if self.tier is not None:
                # the admission point: returning demoted keys (this
                # batch's new-key log) get their spilled partials merged
                # into their fresh slots before the fold
                self.state = self.tier.admit(self.state)
            self.state = self.gb.fold(self.state, cols, slots, valid,
                                      pane_arg)
            if self.mesh is not None:  # shard_stats' key occupancy
                self.gb.n_keys_hint = self.kt.n_keys
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
            if self.wt in (ast.WindowType.TUMBLING_WINDOW,
                           ast.WindowType.HOPPING_WINDOW) and \
                    not self.is_event_time:
                self._schedule_next_tick()

    def on_close(self) -> None:
        with self._lock:
            self._opened = False
            for t in [self._timer, *self._pre_timers,
                      *getattr(self, "_slide_timers", {}).values(),
                      getattr(self, "_gap_timer", None),
                      getattr(self, "_cap_timer", None)]:
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
        if self.wt == ast.WindowType.SLIDING_WINDOW:
            # a delayed sliding emission, armed at its trigger row
            if isinstance(trig.tag, tuple) and trig.tag[0] == "sliding":
                self._pending_slides.pop(trig.tag[1], None)
                self._slide_timers.pop(trig.tag[1], None)
                self._emit_sliding(trig.tag[1])
            return
        if self.wt == ast.WindowType.SESSION_WINDOW:
            if isinstance(trig.tag, tuple) and trig.tag[0] in (
                    "session_gap", "session_cap"):
                self._on_session_trigger(trig)
            return
        if self.is_event_time:
            return  # its windows close on watermarks only
        end = trig.ts
        wr = WindowRange(end - self.length_ms, end)
        if self._async_hh:
            self._emit_hh_async(wr)
        elif self._async_mr:
            self._emit_mr_async(wr)
        else:
            self._boundary_emit(wr)
        # spilled keys with live panes add their share of this window on
        # the host, before the pane expiry marks their slices stale
        self._emit_tier_extras(wr)
        if self.wt == ast.WindowType.TUMBLING_WINDOW:
            self._reset_pane_tiered(0)
        else:
            # advance to the next pane; expire it (it held the oldest slice)
            self.cur_pane = (self.cur_pane + 1) % self.n_panes
            self._reset_pane_tiered(self.cur_pane)
        self._tier_boundary()
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
        forward the EOF, after the deliveries in flight. A sliding window
        emits only on trigger rows; an open session closes now."""
        now = timex.now_ms()
        self._drain_async_emits()
        if self.is_event_time and self.wt == ast.WindowType.SESSION_WINDOW:
            self._evs_flush()
            self.broadcast(eof)
            return
        if self.is_event_time and self.wt in (
                ast.WindowType.TUMBLING_WINDOW, ast.WindowType.HOPPING_WINDOW):
            # every window that can still hold data, walking the dirty
            # buckets, never bucket by bucket across a gap
            while self._dirty:
                first = min(self._dirty)
                nxt = self._next_emit_bucket
                self._next_emit_bucket = (first if nxt is None
                                          else max(nxt, first))
                self._emit_event_bucket(self._next_emit_bucket)
            self.broadcast(eof)
            return
        if self.wt == ast.WindowType.SLIDING_WINDOW:
            self.broadcast(eof)
            return
        if self.wt == ast.WindowType.SESSION_WINDOW:
            if self._session_open:
                self._close_session(now)
            self.broadcast(eof)
            return
        wr = WindowRange(now - self.length_ms, now)
        self._emit(wr)
        self._emit_tier_extras(wr)
        if self.wt == ast.WindowType.TUMBLING_WINDOW:
            self._reset_pane_tiered(0)
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
        backlog = self._deliveries_queued > self._deliveries_done
        if not (self._emit_late_async and self._pipeline):
            if backlog:
                self._drain_async_emits()  # deliveries before this one first
            return self._emit(wr)
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
        count and slot→key list (_keys_snapshot)."""
        self._ensure_emit_worker()
        self._deliveries_queued += 1
        self._emit_q.put((kind, payload, self.kt.n_keys, wr,
                          time.perf_counter(), self._keys_snapshot()))

    def _keys_snapshot(self) -> Optional[list]:
        """The slot→key list of a deferred delivery's dispatch: a tiered
        boundary retires and recycles slots before the worker emits, so
        decoding the live table could give a window to a slot's next key.
        An untiered table is append-only: the live one decodes the same
        (None). So does a tiered sliding rule's: it demotes only quiescent
        keys, never in a delivery's active set."""
        if self.tier is None or self.wt == ast.WindowType.SLIDING_WINDOW:
            return None
        return self.kt.decode_all()

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
            kind, payload, n_keys, wr, t_issue, keys = item
            try:
                if kind == "tier":
                    # tiered-state upkeep (ops/tierstore.py): harvest a
                    # landed demote block, or run the placement scan
                    self.tier.worker_task(payload)
                    continue
                if kind == "ring":
                    # a sliding trigger: the ring query (or components)
                    # fetch merged with the host edge shadow
                    pending, shadow = payload
                    try:
                        outs, act = self.gb.prefinalize_merge(
                            pending, shadow, n_keys)
                        self.last_emit_info = {
                            "source": "device-ring",
                            "fetch_ms": (pending.fetch_ms()
                                         if hasattr(pending, "fetch_ms")
                                         else 0.0),
                            "ages_ms": []}
                        self._deliver(outs, act, wr, keys)
                    finally:
                        pending.release()
                    continue
                if kind == "pf":
                    pipeline, backup = payload
                    try:
                        self._deliver_pf(pipeline, backup, n_keys, wr,
                                         t_issue, keys)
                    finally:
                        self._release(pipeline)
                    continue
                if kind == "mr":
                    # a rule group's boundary: the stacked (R, S+1, K)
                    # finalize, sliced per rule (nodes_multirule.py)
                    try:
                        arr = payload.get()
                        self.last_emit_info = {
                            "source": "device-async",
                            "fetch_ms": (time.perf_counter() - t_issue) * 1e3,
                            "ages_ms": []}
                        self._deliver_mr(arr, n_keys, wr)
                    finally:  # the rules' columns may view the pinned buffer
                        payload.release()
                    continue
                # "hh" (the compact finalize), "refold" (a sliding
                # trigger's pane-mask finalize) and "count" (a count
                # window's finalize): assembled here
                try:
                    outs, act = self.gb.host_tail(payload.get(), n_keys)
                    self.last_emit_info = {
                        "source": "device-async",
                        "fetch_ms": (time.perf_counter() - t_issue) * 1e3,
                        "ages_ms": []}
                    self._deliver(outs, act, wr, keys)
                finally:  # outs / act may view the pinned buffer
                    payload.release()
            except Exception as exc:
                logger.error("async %s emit failed on %s: %s", kind,
                             self.name, exc)
                self.recoveries["failed"] += 1
            finally:
                if kind != "tier":
                    self._deliveries_done += 1
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
                    t_issue: float, keys: Optional[list] = None) -> None:
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
        self._deliver(outs, act, wr, keys)

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

    def _deliver(self, outs, act: np.ndarray, wr: WindowRange,
                 keys: Optional[list] = None) -> None:
        """Emit the groups with act > 0; slot i's key is keys[i] (the
        live key table's when None)."""
        active = np.nonzero(act > 0)[0]
        if len(active) == 0:
            return
        if self.direct_emit is not None:
            self._emit_direct(outs, active, wr, keys)
            return
        self._emit_grouped(outs, active, wr, keys)

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

    def _emit_grouped(self, outs, active: np.ndarray, wr: WindowRange,
                      keys: Optional[list] = None) -> None:
        """Row-path emit tail: build GroupedTuplesSet for downstream
        HAVING/ORDER/PROJECT nodes."""
        decode = self.kt.decode if keys is None else keys.__getitem__
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
            key = decode(slot)
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

    def _emit_direct(self, outs, active: np.ndarray, wr: WindowRange,
                     keys: Optional[list] = None) -> None:
        """Vectorized tail: HAVING/ORDER/LIMIT/projection computed over the
        finalize arrays; emits the final output messages directly."""
        outs = self._decode_hh(outs)
        dim_names = [d.name for d in self.dims]
        dim_cols: Dict[str, np.ndarray] = {}
        if dim_names:
            if keys is None:
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

    # ------------------------------------------------- count, state, session
    def _init_row_windows(self, window: ast.Window) -> None:
        """The state window's host conditions and the session's timers and
        bookkeeping (the reference's constructor, nodes_fused.py:221-259)."""
        if self.wt == ast.WindowType.STATE_WINDOW:
            self._begin_host = try_compile(window.begin_condition)
            self._emitc_host = try_compile(window.emit_condition)
            if self._begin_host is None or self._emitc_host is None:
                raise ValueError(
                    "state device path needs vectorizable begin/emit "
                    "conditions (the host path handles the rest)")
            self._state_open = False
        if self.wt == ast.WindowType.SESSION_WINDOW:
            self.gap_ms = self.interval_ms or self.length_ms
            self._session_open = False
            self._session_start = 0
            self._last_row_ms = 0
            # gap and cap triggers carry the session id they were armed
            # for; a trigger of a session that has closed does nothing
            self._session_id = 0
            self._gap_timer = None
            self._gap_gen = 0  # arm generation: one live gap check at a time
            self._cap_timer = None
            # event time: the batches of the sessions not yet complete
            self._evs_batches: List[ColumnBatch] = []

    def _fold_count_window(self, batch: ColumnBatch) -> None:
        """Fold the batch up to the window's last row, emit and reset at
        the edge, go on with the rest in the next window."""
        pos = 0
        while pos < batch.n:
            take = min(self.count_len - self._rows_in_window, batch.n - pos)
            self._fold(batch, pos, pos + take)
            self._rows_in_window += take
            pos += take
            if self._rows_in_window >= self.count_len:
                wr = WindowRange(0, timex.now_ms())
                if self._async_count:
                    self._emit_count_async(wr)
                else:
                    self._emit(wr)
                self.state = self.gb.reset_pane(self.state, 0)
                self._rows_in_window = 0

    def _emit_count_async(self, wr: WindowRange) -> None:
        """Launch the finalize on the state as it stands, start its copy,
        and hand the delivery to the worker; the caller resets the pane
        right after (the result is a fresh tensor, copied after an event,
        so the reset cannot reach it)."""
        if self.kt.n_keys == 0:
            self.last_emit_info = None
            return
        self._enqueue("count", self.gb.finalize_begin(self.state), wr)

    def _fold_state_window(self, batch: ColumnBatch) -> None:
        """Walk the batch's begin and emit rows (both masks in one
        vectorized pass over the host columns); fold only the open spans,
        emit and reset at each emit row. The emit row is inclusive, and
        the row that opens the window cannot close it (the reference's
        host row path)."""
        begin_m = _host_mask(self._begin_host, batch.columns, batch.n)
        emit_m = _host_mask(self._emitc_host, batch.columns, batch.n)
        pos = 0
        while pos < batch.n:
            scan_from = pos
            if not self._state_open:
                opens = np.nonzero(begin_m[pos:])[0]
                if not len(opens):
                    return  # closed, and no begin row in the rest
                pos += int(opens[0])
                self._state_open = True
                scan_from = pos + 1
            closes = np.nonzero(emit_m[scan_from:])[0]
            if not len(closes):
                self._fold(batch, pos, batch.n)
                return  # the window stays open across batches
            end = scan_from + int(closes[0]) + 1
            self._fold(batch, pos, end)
            self._emit(WindowRange(0, timex.now_ms()))
            self.state = self.gb.reset_pane(self.state, 0)
            self._state_open = False
            pos = end

    def _touch_session(self) -> None:
        """A batch arrived: open the session if closed (arming the length
        cap) and note the last row's time. ONE gap check per session,
        re-armed against that time, not a timer per batch."""
        now = timex.now_ms()
        if not self._session_open:
            self._session_open = True
            self._session_start = now
            self._session_id += 1
            if self.length_ms > 0:
                sid = self._session_id
                self._cap_timer = timex.after(
                    self.length_ms,
                    lambda ts, _s=sid: self.put_control(
                        Trigger(ts=ts, tag=("session_cap", _s))))
        self._last_row_ms = now
        if (self._gap_timer is None or self._gap_timer.fired
                or self._gap_timer.stopped):
            self._arm_gap_check(self.gap_ms)

    def _arm_gap_check(self, delay_ms: int) -> None:
        """Arm the session's gap check; the generation tag turns a check
        armed before this one into a no-op."""
        if self._gap_timer is not None:
            self._gap_timer.stop()
        self._gap_gen += 1
        sid, gen = self._session_id, self._gap_gen
        self._gap_timer = timex.after(
            max(delay_ms, 1),
            lambda ts, _s=sid, _g=gen: self.put_control(
                Trigger(ts=ts, tag=("session_gap", _s, _g))))

    def _on_session_trigger(self, trig: Trigger) -> None:
        kind, sid = trig.tag[0], trig.tag[1]
        if not self._session_open or sid != self._session_id:
            return  # a trigger of a session that has closed
        if kind == "session_cap":
            self._close_session(trig.ts)
            return
        if trig.tag[2] != self._gap_gen:
            return  # a superseded gap check: a newer one is armed
        # close only after a full gap of quiet; else re-arm for the rest
        idle = timex.now_ms() - self._last_row_ms
        if idle >= self.gap_ms:
            self._close_session(self._last_row_ms + self.gap_ms)
        else:
            self._arm_gap_check(self.gap_ms - idle)

    def _touch_session_timers_only(self) -> None:
        """Arm the gap and the rest of the cap for a session open at a
        checkpoint (restore): a new session id, so triggers armed before
        the checkpoint do nothing."""
        now = timex.now_ms()
        self._last_row_ms = now
        self._session_id += 1
        if self.length_ms > 0:
            remaining = max(self._session_start + self.length_ms - now, 1)
            sid = self._session_id
            self._cap_timer = timex.after(
                remaining,
                lambda ts, _s=sid: self.put_control(
                    Trigger(ts=ts, tag=("session_cap", _s))))
        self._arm_gap_check(self.gap_ms)

    def _close_session(self, end_ts: int) -> None:
        self._emit(WindowRange(self._session_start, end_ts))
        self.state = self.gb.reset_pane(self.state, 0)
        self._session_open = False
        for t in (self._gap_timer, self._cap_timer):
            if t is not None:
                t.stop()
        self._gap_timer = self._cap_timer = None

    # ------------------------------------------------------------ event time
    def _init_event_time(self, window: ast.Window,
                         late_tolerance_ms: int) -> None:
        """Event-time geometry (the reference's constructor, nodes_fused.py
        103-149). Tumbling and hopping windows route each row to the pane
        of its time bucket (bucket = ts // bucket_ms, pane = bucket %
        n_panes; event_time_panes). Count, state and session windows keep
        one pane."""
        self._next_emit_bucket: Optional[int] = None
        self._max_bucket: Optional[int] = None
        # buckets holding data not yet expired: a window without any skips
        # its finalize, and a gap in time is jumped in O(1)
        self._dirty: set = set()
        #: rows the fold dropped (their bucket had been emitted), folds by
        #: pane argument, and windows emitted early to free a pane
        self.event_counts: collections.Counter = collections.Counter()
        if self.wt == ast.WindowType.SLIDING_WINDOW:
            raise NotImplementedError(
                "event-time sliding windows run on the reference's host "
                "window path, which is not ported yet")
        if self.wt not in (ast.WindowType.TUMBLING_WINDOW,
                           ast.WindowType.HOPPING_WINDOW):
            self.n_panes = 1
            self._init_row_windows(window)
            return
        self.bucket_ms, span, self.n_panes = event_time_panes(
            window, late_tolerance_ms)
        if self.length_ms % max(self.bucket_ms, 1) != 0:
            # flooring the span would aggregate less than the declared
            # window: the reference's planner sends such shapes to its host
            # path, its node raises
            raise ValueError(
                f"event-time window length {self.length_ms}ms is not a "
                f"multiple of the pane bucket {self.bucket_ms}ms")
        if self.n_panes > MAX_EVENT_PANES:
            # pane ids ship as uint8
            raise ValueError(
                f"event-time window needs {self.n_panes} panes (max "
                f"{MAX_EVENT_PANES}): widen the hop interval or reduce "
                "lateTolerance")
        self.window_span = span

    def _fold_event(self, sub: ColumnBatch) -> int:
        """Fold an event-time batch into its rows' bucket panes (the
        reference's _fold_event). Rows of a bucket already emitted are
        dropped and counted: its pane may have been recycled. A batch of one
        bucket folds with a scalar pane, one across buckets with the uint8
        per-row pane vector. A batch spanning more buckets than the panes
        hold folds in order: what fits, then the oldest pending window is
        emitted to free its pane, and so on, so a recycled pane is always
        emitted and reset before new rows land in it."""
        ts = sub.timestamps
        if ts is None:
            ts = np.zeros(sub.n, dtype=np.int64)
        buckets = ts // self.bucket_ms
        if self._next_emit_bucket is None:
            self._next_emit_bucket = int(buckets.min())
        late = buckets < self._next_emit_bucket
        if late.any():
            self.event_counts["dropped"] += int(late.sum())
            keep = np.nonzero(~late)[0]
            if len(keep) == 0:
                return 0
            sub = sub.take(keep)
            buckets = buckets[keep]
        self._max_bucket = max(int(buckets.max()),
                               -1 if self._max_bucket is None
                               else self._max_bucket)
        total = 0
        while sub.n:
            # pane reuse: bucket b may fold once bucket b - P has expired,
            # i.e. b <= next_emit + P - W
            limit = self._next_emit_bucket + self.n_panes - self.window_span
            mask = buckets <= limit
            idx = np.nonzero(mask)[0]
            if len(idx):
                seg = buckets[idx]
                ub = np.unique(seg)
                if len(ub) == 1:
                    pane_arg = int(ub[0]) % self.n_panes
                    self.event_counts["scalar_folds"] += 1
                else:
                    pane_arg = (seg % self.n_panes).astype(np.uint8)
                    self.event_counts["vector_folds"] += 1
                total += self._fold_rows(
                    sub if mask.all() else sub.take(idx), pane_arg)
                self._dirty.update(int(b) for b in ub)
            if mask.all():
                break
            # make room for the rest: emit the next window, or jump an
            # empty stretch without a finalize. Rows within the tolerance
            # that arrive after such a forced emission drop, counted: the
            # panes are bounded where the host path buffers without bound
            rest = np.nonzero(~mask)[0]
            sub = sub.take(rest)
            buckets = buckets[rest]
            self._advance_one(int(buckets.min()))
        return total

    def _advance_one(self, needed_bucket: int) -> None:
        """Move the emission cursor toward making `needed_bucket` foldable:
        emit the next window if it can hold data, else jump the empty
        stretch in one step."""
        nxt = self._next_emit_bucket
        if not self._dirty:
            self._next_emit_bucket = max(
                nxt + 1, needed_bucket - (self.n_panes - self.window_span))
            return
        first = min(self._dirty)
        if nxt < first:
            self._next_emit_bucket = first  # no window before it has data
            return
        self.event_counts["forced"] += 1
        self._emit_event_bucket(nxt)

    def _emit_event_bucket(self, b: int) -> None:
        """Emit the window ending at bucket b's end (tumbling: bucket b;
        hopping: buckets b - W + 1 .. b) over those buckets' panes, then
        expire the window's oldest pane. A window without a dirty bucket
        skips the finalize."""
        W = self.window_span
        window_buckets = range(b - W + 1, b + 1)
        end_ms = (b + 1) * self.bucket_ms
        wr = WindowRange(end_ms - self.length_ms, end_ms)
        panes = sorted({x % self.n_panes for x in window_buckets})
        if self.kt.n_keys and any(x in self._dirty for x in window_buckets):
            self._emit_panes(wr, panes)
        # spilled keys with data in this window's panes (their pane epochs
        # tell which partials are still valid)
        self._emit_tier_extras(wr, panes=panes)
        expiring = b - W + 1
        if expiring in self._dirty:
            self._dirty.discard(expiring)
            self._reset_pane_tiered(expiring % self.n_panes)
        self._tier_boundary()
        self._next_emit_bucket = b + 1

    def _emit_panes(self, wr: WindowRange, panes: List[int]) -> None:
        """Finalize the panes of one window synchronously and emit it
        (a rule group: every rule's window to its own node)."""
        outs, act = self.gb.finalize(self.state, self.kt.n_keys, panes=panes)
        self.last_emit_info = {"source": "sync", "fetch_ms": 0.0,
                               "ages_ms": []}
        self._deliver(outs, act, wr)

    def on_watermark(self, wm: Watermark) -> None:
        """Emit every window the watermark has passed (buckets wholly below
        it), or each complete session; then forward the watermark."""
        if self.is_event_time and self.wt == ast.WindowType.SESSION_WINDOW:
            self._evs_watermark(wm.ts)
        elif self.is_event_time and self._next_emit_bucket is not None:
            floor_b = wm.ts // self.bucket_ms - 1
            while self._next_emit_bucket <= floor_b:
                if not self._dirty:
                    self._next_emit_bucket = floor_b + 1
                    break
                first = min(self._dirty)
                if self._next_emit_bucket < first:
                    # no window before the first dirty bucket has data
                    self._next_emit_bucket = min(first, floor_b + 1)
                    continue
                self._emit_event_bucket(self._next_emit_bucket)
        self.broadcast(wm)

    def _evs_watermark(self, wm_ts: int) -> None:
        """Emit every complete leading session below the watermark (the
        reference's _evs_watermark): the buffered rows sorted by time,
        split where the gap between neighbours exceeds the session gap,
        and a session emitted once its last row + gap <= the watermark,
        folded into pane 0, finalized and the pane reset."""
        if not self._evs_batches:
            return
        gap = self.gap_ms
        big = ColumnBatch.concat(self._evs_batches)
        ts = big.timestamps
        if ts is None:
            ts = np.zeros(big.n, dtype=np.int64)
        order = np.argsort(ts, kind="stable")
        ts_sorted = ts[order]
        ends = (np.nonzero(np.diff(ts_sorted) > gap)[0] + 1).tolist()
        start = 0
        for end in [*ends, len(ts_sorted)]:
            last = int(ts_sorted[end - 1])
            if last + gap > wm_ts:
                break  # the first incomplete session, and all after it
            self._fold_rows(big.take(order[start:end]), 0)
            self._emit(WindowRange(int(ts_sorted[start]), last + gap))
            self.state = self.gb.reset_pane(self.state, 0)
            self.event_counts["sessions"] += 1
            start = end
        if start == 0:
            self._evs_batches = [big]  # compacted, nothing emitted
        elif start >= len(ts_sorted):
            self._evs_batches = []
        else:
            self._evs_batches = [big.take(np.sort(order[start:]))]

    def _evs_flush(self) -> None:
        """EOF: every buffered row as ONE window [now - L, now), as the
        reference's host path and fused node flush."""
        if not self._evs_batches:
            return
        big = ColumnBatch.concat(self._evs_batches)
        self._evs_batches = []
        now = timex.now_ms()
        self._fold_rows(big, 0)
        self._emit(WindowRange(now - self.length_ms, now))
        self.state = self.gb.reset_pane(self.state, 0)

    # ----------------------------------------------------------- tiered state
    def _tier_submit(self, payload: tuple) -> None:
        """Hand a tier task (a demote harvest, a policy scan) to the emit
        worker: neither runs on the fold thread."""
        self._ensure_emit_worker()
        self._emit_q.put(("tier", payload, 0, None, time.perf_counter(),
                          None))

    def _on_tier_event(self, kind: str, n: int = 0) -> None:
        """A demotion or promotion changed slots under the DABA ring's
        running partials: the panes stay the truth, the next trigger
        rebuilds the partials with one flip."""
        if self.wt == ast.WindowType.SLIDING_WINDOW and \
                self.sliding_impl == "daba":
            self._rg_dirty = True

    def _reset_pane_tiered(self, pane: int) -> None:
        """reset_pane and the tier's epoch bump: spilled rows remember the
        pane epochs they were packed under, so the reset marks their slice
        of that pane stale."""
        self.state = self.gb.reset_pane(self.state, pane)
        if self.tier is not None:
            self.tier.note_pane_reset(pane)

    def _tier_boundary(self) -> None:
        """Pane-boundary tier hook (fold thread): apply the demote plan and
        start the next touch scan."""
        if self.tier is not None:
            self.state = self.tier.on_boundary(self.state)

    def _emit_tier_extras(self, wr: WindowRange,
                          panes: Optional[List[int]] = None) -> None:
        """Emit the spilled keys' share of a closing window: their still
        valid per-pane partials (of `panes`, default all), final values on
        the host, through the same emit tail as the device groups, as a
        second message of the window."""
        if self.tier is None:
            return
        res = self.tier.window_groups(self.plan, panes)
        if res is not None:
            keys, outs, act = res
            self._deliver(outs, act, wr, keys)

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

    # ---------------------------------------------------------------- sliding
    def _init_sliding(self, window, plan, capacity, dev_ring_budget_mb,
                      sliding_impl, ring_layout) -> None:
        """Sliding-window geometry and bookkeeping (the reference's
        constructor branch): the ring layout (chosen at plan time, or
        derived here the same way), the delay, the trigger condition."""
        self.delay_ms = window.delay_ms()
        if ring_layout is None:
            ring_layout = ring_layout_for(window, plan, capacity=capacity,
                                          budget_mb=dev_ring_budget_mb)
        self._ring_layout = ring_layout
        self.bucket_ms = ring_layout.bucket_ms
        self.n_ring_panes = ring_layout.n_ring_panes
        self.n_panes = ring_layout.n_panes
        self._scratch_pane = ring_layout.scratch_pane
        if sliding_impl not in ("daba", "refold"):
            raise ValueError(f"slidingImpl must be 'daba' or 'refold', "
                             f"got {sliding_impl!r}")
        # the budget of the DABA ring's partials, or of the refold path's
        # device batch cache
        self.dev_ring_budget_bytes = int(dev_ring_budget_mb) << 20
        # refold path: bucket -> [(dev_all, slots, bucket row mask, ts) or
        # None], aligned 1:1 with the _ring lists (None: no device copy, an
        # evicted entry or one from before a restore), its bytes and its
        # entries in age order (bucket, index, bytes)
        self._dev_ring: Dict[int, list] = {}
        self._dev_ring_bytes = 0
        self._dev_ring_fifo: collections.deque = collections.deque()
        # refold path: edge refolds by route ("cached" from the device
        # cache, "host" from the row ring), whole-window "stale" refolds,
        # "evicted" cache entries
        self.refold_counts: collections.Counter = collections.Counter()
        # why a sliding rule that asked for the ring runs the refold path
        # ("heavy_hitters", "ring_rejected", "ring_budget"), else None
        self.sliding_fallback: Optional[str] = None
        self._pane_bucket: Dict[int, int] = {}  # pane -> bucket it holds
        self._ring: Dict[int, list] = {}  # bucket -> [(cols, valid, slots, ts)]
        self._bucket_max_ts: Dict[int, int] = {}
        self._ring_max_bucket = -1
        self._pending_slides: Dict[int, int] = {}  # trigger t -> fire_at ms
        self._slide_timers: Dict[int, Any] = {}
        # per-node counts: ring triggers by route ("fast", "dyn", "head",
        # "edge"), "flip"s (of which "reanchor"s), "advance"s,
        # "late_dropped" rows, "recycled_refold" buckets
        self.ring_counts: collections.Counter = collections.Counter()
        if window.trigger_condition is None:
            raise ValueError(
                "sliding device path requires a trigger condition: per-row "
                "emission at device batch rates must be gated")
        self._trigger_host = try_compile(window.trigger_condition)
        if self._trigger_host is None:
            raise ValueError("sliding device path needs a vectorizable "
                             "OVER (WHEN ...) trigger condition")

    def _choose_sliding_impl(self, requested: str) -> str:
        """The DABA ring, or the refold path where the reference takes it:
        a requested refold, a heavy_hitters plan (its finalize is
        assembled on the host), a plan the ring rejects, a ring over the
        slidingDevRingMb budget. A fallback is logged and named in
        `sliding_fallback` (the reference records a flight event)."""
        if requested != "daba":
            return "refold"
        if self.mesh is not None:
            return self._sliding_fallback(
                "sharded_kernel", "the ring reads a single-chip state")
        if self.gb._host_finalize_only:
            return self._sliding_fallback(
                "heavy_hitters", "the ring has no heavy_hitters finalize")
        try:
            ring = SlidingRing(self.gb, self._ring_layout)
        except ValueError as exc:
            return self._sliding_fallback("ring_rejected", str(exc))
        est = ring.estimate_bytes(self.gb.capacity)
        if est > self.dev_ring_budget_bytes:
            return self._sliding_fallback(
                "ring_budget",
                f"the ring needs {est / 2**20:.1f} MB > slidingDevRingMb "
                f"{self.dev_ring_budget_bytes / 2**20:.0f} MB")
        self.ring = ring
        self._ring_reset_tracking()
        # the running total keeps one spare bucket beyond the window span:
        # an evicted pane is subtracted before bucket b + R can recycle it
        self._span_tot = self._ring_layout.span_buckets + 1
        return "daba"

    def _sliding_fallback(self, reason: str, why: str) -> str:
        self.sliding_fallback = reason
        logger.warning("%s: sliding ring unavailable (%s: %s); using the "
                       "refold path", self.name, reason, why)
        return "refold"

    def _ring_reset_tracking(self) -> None:
        """Host-side ring bookkeeping to a cold (dirty) state: the next
        trigger rebuilds the partials from the panes in one flip."""
        self._rg_head = -1       # newest bucket any row has folded into
        self._rg_closed = -1     # last bucket absorbed into the partials
        self._rg_dirty = True    # the partials need a flip before serving
        self._rg_flip_lo = -1    # front-stack span [flip_lo, flip_hi]
        self._rg_flip_hi = -1
        self._rg_closes = 0      # advance count (re-anchor cadence)
        self._rg_anchor = 0
        self._rg_tot: collections.deque = collections.deque()  # (b, slot, on)

    def _ring_state_now(self) -> Dict[str, torch.Tensor]:
        """The ring tensors, allocated at first use and kept at the group
        by's (possibly grown) key capacity."""
        if self._ring_dev is None:
            self.ring.capacity = int(self.gb.capacity)
            self._ring_dev = self.ring.init_state()
        elif self.ring.capacity < self.gb.capacity:
            self._ring_dev = self.ring.grow(self._ring_dev, self.gb.capacity)
        return self._ring_dev

    def ring_dev_bytes(self) -> int:
        """Bytes of the ring partials on the card (0 until allocated)."""
        if self._ring_dev is None:
            return 0
        return SlidingRing.state_nbytes(self._ring_dev)

    def _ring_advance_buckets(self, buckets: np.ndarray) -> None:
        """Bucket-close maintenance after a fold: absorb newly closed panes
        into the running partials (one ring_advance per bucket). Late rows
        into absorbed buckets and time gaps mark the partials dirty; the
        next trigger heals them with one flip."""
        ubs = np.unique(buckets).tolist()
        nh = int(ubs[-1])
        if self._rg_closed >= 0 and int(ubs[0]) <= self._rg_closed:
            self._rg_dirty = True
        if nh <= self._rg_head:
            return
        if self._rg_head < 0 or nh - self._rg_head > 8:
            # cold start or a time gap: no per-bucket advances, one flip
            # at the next trigger rebuilds everything
            self._rg_dirty = True
            self._rg_tot.clear()
            self._rg_head = nh
            self._rg_closed = nh - 1
            return
        for b in range(self._rg_head, nh):
            self._ring_close_bucket(b)
        self._rg_head = nh

    def _ring_close_bucket(self, b: int) -> None:
        slot = b % self.n_ring_panes
        on = self._pane_bucket.get(slot) == b
        ev_slot, ev_on = 0, False
        self._rg_tot.append((b, slot, on))
        if len(self._rg_tot) > self._span_tot:
            ob, oslot, oon = self._rg_tot.popleft()
            if oon and self._pane_bucket.get(oslot) != ob:
                # the evicted bucket's pane was already recycled (a burst
                # batch): rebuild from the panes at the next trigger
                self._rg_dirty = True
            else:
                ev_slot, ev_on = oslot, bool(oon)
        if not self._rg_dirty:
            self._ring_dev = self.ring.advance(
                self._ring_state_now(), self.state, slot, bool(on), ev_slot,
                ev_on)
            self.ring_counts["advance"] += 1
        self._rg_closes += 1
        self._rg_closed = b

    def _fold_sliding(self, sub: ColumnBatch) -> int:
        """Fold rows into the time panes of their timestamps, keep them in
        the host row ring (for the trigger's edge folds), advance the ring,
        and fire the trigger rows."""
        if self.state is None:
            self.state = self.gb.init_state()
        ts = sub.timestamps
        if ts is None:
            ts = np.full(sub.n, timex.now_ms(), dtype=np.int64)
        buckets = ts // self.bucket_ms
        R = self.n_ring_panes
        # a batch spanning >= R buckets would alias two buckets onto one
        # pane within one fold: split it into alias-free chunks folded in
        # bucket order, so each recycle lands before its pane's new rows
        if int(buckets.max() - buckets.min()) >= R:
            order = np.argsort(buckets, kind="stable")
            sorted_b = buckets[order]
            start = 0
            base = int(sorted_b[0])
            for i in range(1, len(order) + 1):
                if i == len(order) or int(sorted_b[i]) - base >= R:
                    self._fold_sliding(sub.take(order[start:i]))
                    if i < len(order):
                        base = int(sorted_b[i])
                        start = i
            return sub.n
        # late guard: drop a row only when its pane was recycled past its
        # bucket (folding it would corrupt newer data)
        if self._ring_max_bucket >= 0:
            drop = []
            for b in np.unique(buckets).tolist():
                held = self._pane_bucket.get(int(b) % R)
                if held is not None and held > int(b):
                    drop.append(int(b))
            if drop:
                late = np.isin(buckets, drop)
                n_late = int(late.sum())
                self.ring_counts["late_dropped"] += n_late
                logger.warning("%s: %d sliding rows older than the pane "
                               "retention dropped", self.name, n_late)
                keep = np.nonzero(~late)[0]
                if len(keep) == 0:
                    return 0
                sub = sub.take(keep)
                ts = ts[keep]
                buckets = buckets[keep]
        # recycle panes: reset any pane about to receive a newer bucket
        ubs = np.unique(buckets).tolist()
        for b in ubs:
            pane = int(b) % R
            held = self._pane_bucket.get(pane)
            if held is not None and held != int(b):
                self._reset_pane_tiered(pane)
            self._pane_bucket[pane] = int(b)
        self._ring_max_bucket = max(self._ring_max_bucket, int(ubs[-1]))
        # the row ring outlives the panes by a margin, so a trigger whose
        # pane was recycled can still fold the bucket's rows on the host
        floor_b = self._ring_max_bucket - R - 8
        expired = [b for b in self._ring if b < floor_b]
        for b in expired:
            del self._ring[b]
            self._bucket_max_ts.pop(b, None)
            dropped = self._dev_ring.pop(b, None)
            if dropped:
                self._dev_ring_bytes -= sum(self._dev_entry_nbytes(e)
                                            for e in dropped)
        if expired:
            # the evict loop drains the FIFO only over budget: purge the
            # expired buckets' entries, or it grows for the stream's life
            self._dev_ring_fifo = collections.deque(
                e for e in self._dev_ring_fifo if e[0] >= floor_b)
        daba = self.sliding_impl == "daba"
        cols, valid, slots = self._build_kernel_inputs(sub)
        if self.tier is not None:
            self.state = self.tier.admit(self.state)
        # the refold path uploads the batch once, padded, and keeps it on
        # the card for its trigger-time edge refolds; the fold reads it
        dev = None if daba else self._upload_sliding_inputs(cols, valid,
                                                            slots)
        if dev is None:
            f_cols, f_valid, f_slots, n_rows = cols, valid, slots, None
        else:
            (f_cols, f_valid, f_slots, _), n_rows = dev, sub.n
        pane_vec = (buckets % R).astype(np.uint8)
        # a single-bucket batch (the common case) folds into a scalar pane
        self.state = self.gb.fold(
            self.state, f_cols, f_slots, f_valid,
            int(pane_vec[0]) if len(ubs) == 1 else pane_vec, n_rows=n_rows)
        for b in ubs:
            m = buckets == b
            sel = np.nonzero(m)[0]
            seg = ((cols, valid, slots, ts) if len(ubs) == 1 else (
                {k: v[sel] for k, v in cols.items()},
                {k: v[sel] for k, v in valid.items()}, slots[sel], ts[sel]))
            self._ring.setdefault(int(b), []).append(seg)
            if not daba:
                # the aligned device entry: the whole batch's tensors and
                # this bucket's rows (a refold ANDs the time cut into them)
                self._cache_entry(int(b), None if dev is None
                                  else (dev[3], dev[2], m, ts))
            bmax = int(ts[sel].max())
            if bmax > self._bucket_max_ts.get(int(b), -1):
                self._bucket_max_ts[int(b)] = bmax
        if daba:
            self._ring_advance_buckets(buckets)
        # the tier's upkeep at bucket granularity (sliding's pane boundary),
        # throttled by the scan cadence inside
        self._tier_boundary()
        # trigger rows: OVER (WHEN ...) on the raw batch columns
        trig = _host_mask(self._trigger_host, sub.columns, sub.n)
        for i in np.nonzero(trig)[0].tolist():
            t = int(ts[i])
            if self.delay_ms > 0:
                self._schedule_sliding(t, timex.now_ms() + self.delay_ms)
            else:
                self._emit_sliding(t)
        return sub.n

    def _upload_sliding_inputs(self, cols, valid, slots):
        """The refold path's upload of one batch (the reference's): each
        plan column, its validity mask and the slots, padded to the
        micro-batch, on the card, so the fold reads them and the device
        cache keeps them for the edge refolds. Returns (dev_cols,
        dev_valid, slots, dev_all), dev_all every column and its
        `__valid_<col>` (None where absent), or None for a batch over one
        micro-batch or under a quarter of one (a padded copy of a small
        batch would pin bytes out of proportion; its refolds take the host
        rows). Slots go up as slot_dtype(capacity): after the capacity
        doubles past 65,535, new entries are int32 while older uint16
        ones stay valid."""
        mb = self.gb.micro_batch
        n = len(slots)
        if n > mb or n < mb // 4 or self.mesh is not None:
            # a sharded rule's edge refolds take the host rows (the
            # reference's): the masked fold reads a single-chip state
            return None
        pad = mb - n
        dev_cols, dev_valid, dev_all = {}, {}, {}
        for name in self.plan.columns:
            arr = np.asarray(cols[name], dtype=col_np_dtype(self.plan, name))
            d = self.gb.upload(np.pad(arr, (0, pad)) if pad else arr,
                               arr.dtype)
            dev_cols[name] = dev_all[name] = d
            vm = valid.get(name)
            if vm is not None:
                vm = dev_valid[name] = self.gb.upload(
                    np.pad(vm, (0, pad)) if pad else vm, np.bool_)
            dev_all["__valid_" + name] = vm
        s = np.pad(slots, (0, pad)) if pad else slots
        s_dev = self.gb.upload(s, slot_dtype(self.gb.capacity))
        return dev_cols, dev_valid, s_dev, dev_all

    @staticmethod
    def _dev_entry_nbytes(entry) -> int:
        """Device bytes of one cache entry: its columns, validity masks
        and slots (the reference's count). A batch that crosses bucket
        edges has one entry per bucket over the same tensors, so this
        counts it once per entry: the budget errs toward evicting early."""
        if entry is None:
            return 0
        dev_all, s_dev = entry[0], entry[1]
        return sum(t.numel() * t.element_size()
                   for t in [*dev_all.values(), s_dev] if t is not None)

    def _cache_entry(self, b: int, entry) -> None:
        """Append bucket b's device entry (None: no device copy) beside its
        row segment, then evict down to the budget."""
        lst = self._dev_ring.setdefault(b, [])
        lst.append(entry)
        if entry is not None:
            nb = self._dev_entry_nbytes(entry)
            self._dev_ring_bytes += nb
            self._dev_ring_fifo.append((b, len(lst) - 1, nb))
            self._dev_ring_evict()

    def _dev_ring_evict(self) -> None:
        """Drop the oldest cached entries until the cache fits the budget;
        their refolds take the exact host rows (the aligned row ring keeps
        every segment)."""
        freed = evicted = 0
        while (self._dev_ring_bytes > self.dev_ring_budget_bytes
               and self._dev_ring_fifo):
            b, idx, nbytes = self._dev_ring_fifo.popleft()
            lst = self._dev_ring.get(b)
            if lst is None or idx >= len(lst) or lst[idx] is None:
                continue  # already gone (its bucket expired)
            lst[idx] = None
            self._dev_ring_bytes -= nbytes
            freed += nbytes
            evicted += 1
        if evicted:
            self.refold_counts["evicted"] += evicted
            logger.debug("%s: %d sliding cache entries (%d bytes) evicted; "
                         "%d bytes cached", self.name, evicted, freed,
                         self._dev_ring_bytes)

    def _schedule_sliding(self, t: int, fire_at: int) -> None:
        """Arm a delayed sliding emission; tracked in _pending_slides so a
        checkpoint re-arms it."""
        self._pending_slides[t] = fire_at
        delay = max(fire_at - timex.now_ms(), 0)
        self._slide_timers[t] = timex.after(
            delay, lambda _ts, t0=t: self.put_control(
                Trigger(ts=t0, tag=("sliding", t0))))

    def _emit_sliding(self, t: int) -> None:
        """Emit the window (t - L, t + delay] for trigger time t."""
        if self.sliding_impl == "daba":
            self._emit_sliding_ring(t)
        else:
            self._emit_sliding_refold(t)

    def _emit_sliding_refold(self, t: int) -> None:
        """The refold path's trigger: the panes fully inside the window,
        plus the partial edge buckets refolded into the scratch pane (from
        the device cache under a row mask, or from the host rows), merged
        by one finalize over their pane mask. When a pane inside the
        window was recycled while its rows are retained, the whole window
        refolds from the rows (exact, slower)."""
        n_keys = self.kt.n_keys
        if n_keys == 0:
            return
        lo = t - self.length_ms  # exclusive
        hi = t + self.delay_ms  # inclusive
        B, R = self.bucket_ms, self.n_ring_panes
        b_lo, b_hi = lo // B, hi // B
        full, stale = [], False
        for b in range(b_lo + 1, b_hi):
            if self._pane_bucket.get(b % R) == b:
                full.append(b)
            elif b in self._ring:
                stale = True  # pane recycled, rows still retained
        if stale:
            # the window's time cuts apply to its end buckets only: every
            # row of a bucket between them lies inside (lo, hi]
            full = []
            edges = [(b, lo if b == b_lo else None, hi if b == b_hi else None)
                     for b in range(b_lo, b_hi + 1)]
            self.refold_counts["stale"] += 1
        elif b_lo == b_hi:
            edges = [(b_lo, lo, hi)]
        else:
            edges = [(b_lo, lo, None)]
            # the high edge straight from its pane when it holds exactly
            # (b_hi * B, hi]: no received row of it exceeds hi, and its
            # span clears the window's low cut
            if (self._pane_bucket.get(b_hi % R) == b_hi and b_hi * B > lo
                    and self._bucket_max_ts.get(b_hi, hi + 1) <= hi):
                full.append(b_hi)
            else:
                edges.append((b_hi, None, hi))
        used_scratch, cached = False, {}
        for b, lo_excl, hi_incl in edges:
            used_scratch |= self._refold_bucket(b, lo_excl, hi_incl, cached)
        if cached:
            self.state = self.gb.fold_masked_many(
                self.state, list(cached.values()), self._scratch_pane)
        panes = sorted({b % R for b in full})
        if used_scratch:
            panes.append(self._scratch_pane)
        wr = WindowRange(lo, hi)
        if panes and self.gb._host_finalize_only:
            # heavy_hitters: the synchronous finalize (recovery kernel and
            # the host dedupe), as the reference keeps it
            outs, act = self.gb.finalize(self.state, n_keys, panes=panes)
            self.last_emit_info = {"source": "sync", "fetch_ms": 0.0,
                                   "ages_ms": []}
            self._deliver(outs, act, wr)
        elif panes:
            # launched here, in order after the scratch folds and before
            # the scratch reset below, into a fresh result whose copy waits
            # for an event after the launch; the emit worker delivers it
            pane_mask = np.zeros(self.gb.n_panes, dtype=np.bool_)
            pane_mask[panes] = True
            self._enqueue("refold",
                          self.gb.finalize_begin(self.state, pane_mask), wr)
        if used_scratch:
            self._reset_pane_tiered(self._scratch_pane)

    def _refold_bucket(self, b: int, lo_excl: Optional[int],
                       hi_incl: Optional[int], cached: dict) -> bool:
        """Refold bucket b's rows inside (lo_excl, hi_incl] into the
        scratch pane: an evicted or uncached segment from its host rows
        here, a cached one into `cached` (its batch's tensors and row
        mask, by the batch's slot tensor: the entries of one batch in
        several buckets share one mask), which the trigger folds in one
        fold_masked_many call. True if any row folded."""
        used = False
        devs = self._dev_ring.get(b, [])
        for i, (cols, valid, slots, ts) in enumerate(self._ring.get(b, [])):
            dev = devs[i] if i < len(devs) else None
            if dev is not None:
                # the whole batch's tensors, this bucket's rows, and the
                # whole batch's timestamps
                dev_all, s_dev, m, ts = dev
            else:
                m = np.ones(len(ts), dtype=np.bool_)
            if lo_excl is not None:
                m = m & (ts > lo_excl)
            if hi_incl is not None:
                m = m & (ts <= hi_incl)
            if not m.any():
                continue
            used = True
            if dev is not None:
                seg = cached.get(id(s_dev))
                if seg is None:
                    cached[id(s_dev)] = [dev_all, s_dev, m]
                else:
                    seg[2] = seg[2] | m
                self.refold_counts["cached"] += 1
            else:
                sel = np.nonzero(m)[0]
                self.state = self.gb.fold(
                    self.state, {k: v[sel] for k, v in cols.items()},
                    slots[sel], {k: v[sel] for k, v in valid.items()},
                    self._scratch_pane)
                self.refold_counts["host"] += 1
        return used

    def _emit_sliding_ring(self, t: int) -> None:
        """The DABA trigger: the body as one ring query, the partial edge
        buckets folded on the host into the trigger's shadow; the emit
        worker merges and delivers."""
        n_keys = self.kt.n_keys
        if n_keys == 0:
            return
        lo = t - self.length_ms  # exclusive
        hi = t + self.delay_ms  # inclusive
        b_lo, b_hi = lo // self.bucket_ms, hi // self.bucket_ms
        shadow = HostShadow(self.plan, self.gb.comp_specs, self.kt.capacity)
        include_head = False
        if b_lo == b_hi:
            # the window inside one bucket: the host edge fold is all of it
            self._shadow_ring_rows(shadow, b_lo, lo_excl=lo, hi_incl=hi)
            body = None
        else:
            self._shadow_ring_rows(shadow, b_lo, lo_excl=lo)
            body = (b_lo + 1, b_hi - 1)
            # the high edge straight from the live pane when it holds
            # exactly (b_hi * B, hi]: no received row of it exceeds hi
            if (self._pane_bucket.get(b_hi % self.n_ring_panes) == b_hi
                    and self._bucket_max_ts.get(b_hi, hi + 1) <= hi):
                include_head = True
            else:
                self._shadow_ring_rows(shadow, b_hi, hi_incl=hi)
        pending = self._ring_body_query(body, include_head, b_hi, shadow)
        if pending is None:
            self.ring_counts["edge"] += 1
            pending = IdentityFinalize(self.gb.comp_specs, self.kt.capacity)
        self._enqueue("ring", (pending, shadow), WindowRange(lo, hi))

    def _shadow_ring_rows(self, shadow, b: int, lo_excl: Optional[int] = None,
                          hi_incl: Optional[int] = None) -> None:
        """Fold bucket b's retained rows (optionally time-cut) into the
        trigger's HostShadow: at most one bucket of rows."""
        for cols, valid, slots, ts in self._ring.get(b, []):
            m = np.ones(len(ts), dtype=np.bool_)
            if lo_excl is not None:
                m &= ts > lo_excl
            if hi_incl is not None:
                m &= ts <= hi_incl
            if not m.any():
                continue
            if m.all():
                shadow.fold(cols, slots, valid)
            else:
                sel = np.nonzero(m)[0]
                shadow.fold({k: v[sel] for k, v in cols.items()},
                            slots[sel], {k: v[sel] for k, v in valid.items()})

    def _ring_body_query(self, body, include_head: bool, b_hi: int, shadow):
        """Launch the body of one trigger: the ring query when the running
        partials cover it, after a flip when they do not, and the masked
        components merge for shapes off the in-order discipline (delayed
        emissions, recycled panes). None for an empty body."""
        head_slot = b_hi % self.n_ring_panes
        if body is None:
            return None
        j, e = body
        if j > e:
            if not include_head:
                return None
            adj_slots = np.zeros(QUERY_ADJ, dtype=np.int32)
            adj_w = np.zeros(QUERY_ADJ, dtype=np.float32)
            adj_mm = np.zeros(QUERY_ADJ, dtype=np.bool_)
            adj_slots[0], adj_w[0], adj_mm[0] = head_slot, 1.0, True
            self.ring_counts["head"] += 1
            return self.ring.query_begin(
                self._ring_state_now(), self.state, body_on=False,
                f_on=False, f_slot=0, adj_slots=adj_slots,
                adj_weights=adj_w, adj_mm=adj_mm)
        if self._rg_closed == e and self._rg_head == b_hi:
            ok = not self._rg_dirty and self._ring_fast_ok(j)
            if not ok:
                self._ring_flip(j, e)
                ok = not self._rg_dirty and self._ring_fast_ok(j)
            if ok:
                self.ring_counts["fast"] += 1
                return self._ring_query_fast(j, include_head, head_slot)
        self.ring_counts["dyn"] += 1
        return self._ring_query_dyn(j, e, include_head, head_slot, shadow)

    def _ring_fast_ok(self, j: int) -> bool:
        """Can the running partials serve a body starting at bucket j?"""
        if self._rg_closes - self._rg_anchor > 4 * self._span_tot:
            # periodic re-anchor: rebuild the float totals from the panes
            # before subtract-on-evict drift can build up
            self.ring_counts["reanchor"] += 1
            return False
        if self.ring.mm_comps:
            if self._rg_flip_lo < 0 or j < self._rg_flip_lo \
                    or j > self._rg_flip_hi + 1:
                return False
        if not self._rg_tot or self._rg_tot[0][0] > j:
            return False  # the total no longer covers the window start
        n_sub = sum(1 for (b, _s, on) in self._rg_tot if b < j and on)
        return n_sub <= QUERY_ADJ - 1

    def _ring_flip(self, j: int, e: int) -> None:
        """Rebuild every running partial from the live panes over [j, e]
        (one ring_flip). A bucket whose pane was recycled while its rows
        are retained cannot flip: the caller then merges the panes."""
        valid = np.zeros(self.n_ring_panes, dtype=np.bool_)
        tot_entries = []
        for b in range(j, e + 1):
            s = b % self.n_ring_panes
            live = self._pane_bucket.get(s) == b
            if not live and b in self._ring:
                return
            valid[b - j] = live
            tot_entries.append((b, s, live))
        self._ring_dev = self.ring.flip(
            self._ring_state_now(), self.state, j % self.n_ring_panes, valid)
        self.ring_counts["flip"] += 1
        self._rg_tot = collections.deque(tot_entries)
        self._rg_flip_lo, self._rg_flip_hi = j, e
        self._rg_anchor = self._rg_closes
        self._rg_dirty = False

    def _ring_query_fast(self, j: int, include_head: bool, head_slot: int):
        """The constant-time trigger: combine(front[j], back) for the
        two-stack components, the running total minus at most two trailing
        pane slices for the additive ones, plus the live head pane."""
        adj_slots = np.zeros(QUERY_ADJ, dtype=np.int32)
        adj_w = np.zeros(QUERY_ADJ, dtype=np.float32)
        adj_mm = np.zeros(QUERY_ADJ, dtype=np.bool_)
        k = 0
        for b, s, on in self._rg_tot:
            if b < j and on:
                adj_slots[k], adj_w[k] = s, -1.0
                k += 1
        if include_head:
            adj_slots[k], adj_w[k], adj_mm[k] = head_slot, 1.0, True
        f_on = bool(self.ring.mm_comps) and j <= self._rg_flip_hi
        return self.ring.query_begin(
            self._ring_state_now(), self.state, body_on=True, f_on=f_on,
            f_slot=j % self.n_ring_panes, adj_slots=adj_slots,
            adj_weights=adj_w, adj_mm=adj_mm)

    def _ring_query_dyn(self, j: int, e: int, include_head: bool,
                        head_slot: int, shadow):
        """Exact fallback body: the window's live panes merged under a mask
        (groupby_components); buckets whose pane was recycled fold their
        retained rows on the host into the trigger's shadow."""
        pane_mask = np.zeros(self.gb.n_panes, dtype=np.bool_)
        for b in range(j, e + 1):
            s = b % self.n_ring_panes
            if self._pane_bucket.get(s) == b:
                pane_mask[s] = True
            elif b in self._ring:
                self._shadow_ring_rows(shadow, b)
                self.ring_counts["recycled_refold"] += 1
        if include_head:
            pane_mask[head_slot] = True
        if not pane_mask.any():
            return None
        return self.gb.components_begin_dyn(self.state, pane_mask)

    # ------------------------------------------------------------------ state
    def snapshot_state(self) -> Optional[dict]:
        """The reference's snapshot format (keys, partials, cur_pane,
        rows_in_window; an open state window or session), so a checkpoint
        crosses between the packages.
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
        if self.tier is not None:
            # the cold tier (the hot one is the partials above, retired
            # slots as None holes in the key list)
            snap["tier"] = self.tier.snapshot()
        if self.wt == ast.WindowType.SESSION_WINDOW:
            snap["session_open"] = self._session_open
            snap["session_start"] = self._session_start
        if self.wt == ast.WindowType.STATE_WINDOW:
            snap["state_open"] = self._state_open
        if self.is_event_time:
            snap["next_emit_bucket"] = self._next_emit_bucket
            snap["max_bucket"] = self._max_bucket
            snap["dirty_buckets"] = sorted(self._dirty)
            if self.wt == ast.WindowType.SESSION_WINDOW and \
                    self._evs_batches:
                # the buffered sessions' rows, as lists (the reference's
                # encoding)
                snap["evs"] = [
                    {"cols": {k: v.tolist() for k, v in b.columns.items()},
                     "valid": {k: v.tolist() for k, v in b.valid.items()},
                     "ts": (b.timestamps.tolist()
                            if b.timestamps is not None else None),
                     "emitter": b.emitter, "n": b.n}
                    for b in self._evs_batches]
        if self.wt == ast.WindowType.SLIDING_WINDOW:
            snap["pane_bucket"] = dict(self._pane_bucket)
            snap["ring_max_bucket"] = self._ring_max_bucket
            snap["pending_slides"] = dict(self._pending_slides)
            # the retained rows as raw bytes (the reference's encoding)
            snap["ring"] = {
                str(b): [
                    {"cols": {k: _enc_arr(v) for k, v in cols.items()},
                     "valid": {k: _enc_arr(v) for k, v in valid.items()},
                     "slots": _enc_arr(slots), "ts": _enc_arr(ts)}
                    for cols, valid, slots, ts in segs]
                for b, segs in self._ring.items()}
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
            # a sharded kernel rounds the restored capacity up to its key
            # shards (a snapshot of another mesh size, or single-chip):
            # state_from_host decides, the key table follows
            self.state = self.gb.state_from_host(host)
            self.kt.capacity = max(self.kt.capacity, self.gb.capacity)
        if self.tier is not None and state.get("tier"):
            self.tier.restore(state["tier"])
        self.cur_pane = state.get("cur_pane", 0)
        self._rows_in_window = state.get("rows_in_window", 0)
        for c, values in state.get("hh_dicts", {}).items():
            vd = ValueDict()
            vd.restore(values)
            self._hh_dicts[c] = vd
        if self.wt == ast.WindowType.STATE_WINDOW:
            self._state_open = bool(state.get("state_open", False))
        if self.wt == ast.WindowType.SESSION_WINDOW and \
                state.get("session_open"):
            # re-open with fresh timers: the restored rows count, and the
            # gap restarts from the restore
            self._session_open = True
            self._session_start = int(state.get("session_start", 0))
            self._touch_session_timers_only()
        if self.is_event_time:
            self._restore_event_time(state)
        if self.wt == ast.WindowType.SLIDING_WINDOW:
            self._restore_sliding(state)

    def _restore_event_time(self, state: dict) -> None:
        self._next_emit_bucket = state.get("next_emit_bucket")
        self._max_bucket = state.get("max_bucket")
        self._dirty = set(state.get("dirty_buckets", []))
        if self.wt != ast.WindowType.SESSION_WINDOW:
            return
        self._evs_batches = []
        for d in state.get("evs", []):
            cols = {}
            for k, v in d["cols"].items():
                arr = np.asarray(v)
                if arr.dtype.kind in ("U", "O"):  # strings stay objects
                    arr = np.array(v, dtype=np.object_)
                cols[k] = arr
            self._evs_batches.append(ColumnBatch(
                n=int(d["n"]), columns=cols,
                valid={k: np.asarray(v, dtype=np.bool_)
                       for k, v in d.get("valid", {}).items()},
                timestamps=(np.asarray(d["ts"], dtype=np.int64)
                            if d.get("ts") is not None else None),
                emitter=d.get("emitter", "")))

    def _restore_sliding(self, state: dict) -> None:
        self._pane_bucket = {int(k): v for k, v in
                             state.get("pane_bucket", {}).items()}
        self._ring_max_bucket = state.get("ring_max_bucket", -1)
        self._bucket_max_ts = {}
        self._ring = {
            int(b): [({k: _dec_arr(v) for k, v in seg["cols"].items()},
                      {k: _dec_arr(v) for k, v in seg["valid"].items()},
                      _dec_arr(seg["slots"]), _dec_arr(seg["ts"]))
                     for seg in segs]
            for b, segs in state.get("ring", {}).items()}
        # the device batch cache is not checkpointed: refolds take the host
        # rows until new batches are cached (None placeholders keep later
        # entries aligned with their row segments)
        self._dev_ring = {b: [None] * len(segs)
                          for b, segs in self._ring.items()}
        self._dev_ring_bytes = 0
        self._dev_ring_fifo.clear()
        if self.sliding_impl == "daba":
            # the ring partials are caches of the panes, never
            # checkpointed: the first trigger after a restore rebuilds
            # them with one flip
            self._ring_dev = None
            self._ring_reset_tracking()
            self._rg_head = self._ring_max_bucket
            self._rg_closed = (self._rg_head - 1 if self._rg_head >= 0
                               else -1)
        # re-arm the delayed emissions pending at the checkpoint (past-due
        # ones fire at the next clock move)
        self._pending_slides = {}
        for t, fire_at in state.get("pending_slides", {}).items():
            self._schedule_sliding(int(t), int(fire_at))
