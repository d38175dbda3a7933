"""The event-time watermark operator and the host window operator
(counterparts of the `WatermarkNode` and `WindowNode` of
ekuiper_tpu/runtime/nodes_window.py).

An event-time rule runs source → WatermarkNode → fused node. Per batch the
node drops the late rows, those with a timestamp below `max_ts -
lateTolerance` (the largest timestamp seen so far, less the tolerance),
sorts the rest by timestamp (stable, and only when the batch is out of
order), forwards the batch as one ColumnBatch and then broadcasts the
watermark `max_ts - lateTolerance` once it is positive. Downstream the
watermark reaches the fused node's `on_watermark` (runtime/node.py
`send_to`), which emits the windows it closes; an EOF given to this
node's `put_control` reaches the fused node's `on_eof`, which flushes
the windows still open.

Row tuples raise, as they do on the fused node: the port's path is
columnar.

The host `WindowNode` buffers a processing-time TUMBLING or HOPPING window
for the host operator chain (planner/planner.py `plan_host_rule`: joins,
analytic and window functions): whole ColumnBatches at ingest (rows from
several streams, each batch keeping its emitter), single rows in a row
buffer, a window FILTER as a vectorized mask where it compiles; on each
epoch-aligned tick of the engine clock (utils/timex.py) it emits one
WindowTuples of the rows of [end - length, end). Its snapshot and restore
keep the reference's format, so a checkpoint crosses both packages. Event
time and the other window kinds (count, session, state, sliding) raise
NotImplementedError: they are the rest of the host operator path (ROADMAP
Queue 1 item 5).
"""
from __future__ import annotations

from typing import Any, List, Optional

import numpy as np

from ..data.batch import ColumnBatch, from_tuples
from ..data.rows import Row, Tuple, WindowRange, WindowTuples
from ..sql import ast
from ..sql.compiler import try_compile
from ..sql.eval import Evaluator
from ..utils import timex
from .events import EOF, Trigger, Watermark
from .node import Node


class WatermarkNode(Node):
    """Late drop and ordering of an event-time stream, and its watermarks.

    `dropped` counts the rows dropped as late; `watermark_ts()` is the
    watermark last broadcast (None before the first)."""

    def __init__(self, name: str, late_tolerance_ms: int = 0) -> None:
        super().__init__(name)
        self.late_tolerance = int(late_tolerance_ms)
        self.max_ts = 0
        self.dropped = 0

    def process(self, item: Any) -> None:
        if isinstance(item, Tuple):
            raise NotImplementedError(
                "row tuples into the watermark node are not ported yet")
        if not isinstance(item, ColumnBatch):
            self.emit(item)
            return
        with self._lock:
            ts = item.timestamps
            if ts is None:
                ts = np.zeros(item.n, dtype=np.int64)
            keep = ts >= self.max_ts - self.late_tolerance
            n_late = int(item.n - keep.sum())
            if n_late:
                self.dropped += n_late
                idx = np.nonzero(keep)[0]
                item = item.take(idx)
                ts = ts[idx]
            if item.n:
                self.max_ts = max(self.max_ts, int(ts.max()))
                if item.n > 1 and (np.diff(ts) < 0).any():
                    item = item.take(np.argsort(ts, kind="stable"))
                self.emit(item, count=item.n)
            wm = self.max_ts - self.late_tolerance
            if wm > 0:
                self.broadcast(Watermark(ts=wm))

    def on_eof(self, eof: EOF) -> None:
        """The stream ended: each downstream node takes the EOF as the
        control event it is (the fused node flushes its open windows in
        `on_eof`), not as data."""
        for out in self.outputs:
            out.put_control(eof)

    def watermark_ts(self) -> Optional[int]:
        """The current watermark, None until it is positive (none has been
        broadcast before that)."""
        wm = self.max_ts - self.late_tolerance
        return wm if wm > 0 else None

    def snapshot_state(self) -> Optional[dict]:
        with self._lock:
            return {"max_ts": self.max_ts}

    def restore_state(self, state: dict) -> None:
        with self._lock:
            self.max_ts = state.get("max_ts", 0)


class WindowNode(Node):
    """Buffering window operator: processing-time tumbling and hopping
    windows (the reference's WindowNode, ekuiper_tpu/runtime/nodes_window.py
    91-500, cut to those two kinds)."""

    KINDS = (ast.WindowType.TUMBLING_WINDOW, ast.WindowType.HOPPING_WINDOW)

    def __init__(self, name: str, window: ast.Window,
                 is_event_time: bool = False) -> None:
        super().__init__(name)
        if is_event_time or window.window_type not in self.KINDS:
            raise NotImplementedError(
                f"the host {'event-time ' if is_event_time else ''}"
                f"{window.window_type.value} window is not ported yet "
                "(ROADMAP Queue 1 item 5)")
        self.window = window
        self.ev = Evaluator()
        self.buffer: List[Row] = []
        self.length_ms = window.length_ms()
        self.interval_ms = window.interval_ms()
        self.wt = window.window_type
        self._timer = None
        # columnar spine: batches buffer whole and explode to rows only at
        # emit, only for the selected rows; a window FILTER rides along when
        # it compiles to a vectorized host closure, else every batch takes
        # the row path
        self._vfilter = None
        self._use_bbuf = True
        if window.filter is not None:
            self._vfilter = try_compile(window.filter)
            if self._vfilter is None:
                self._use_bbuf = False
        self.bbuf: List[ColumnBatch] = []

    # ----------------------------------------------------------------- open
    def on_open(self) -> None:
        self._schedule_next_tick()

    def on_close(self) -> None:
        if self._timer is not None:
            self._timer.stop()

    def _tick_interval(self) -> int:
        if self.wt == ast.WindowType.TUMBLING_WINDOW:
            return self.length_ms
        return self.interval_ms or self.length_ms

    def _schedule_next_tick(self) -> None:
        now = timex.now_ms()
        # epoch-aligned boundaries like the reference's getAlignedWindowEndTime
        next_end = timex.align_to_window(now + 1, self._tick_interval())
        self._timer = timex.after(
            next_end - now, lambda ts: self.put_control(Trigger(ts=ts)))

    # --------------------------------------------------------------- ingest
    def process(self, item: Any) -> None:
        with self._lock:
            if isinstance(item, ColumnBatch):
                if self._use_bbuf:
                    self._ingest_batch(item)
                    return
                rows: List[Row] = item.to_tuples()
            elif isinstance(item, Row):
                rows = [item]
            elif isinstance(item, EOF):  # an EOF passed on as data
                self.on_eof(item)
                return
            else:
                self.emit(item)
                return
            if self.window.filter is not None:
                rows = [r for r in rows
                        if self.ev.eval_condition(self.window.filter, r)]
            self.buffer.extend(rows)

    def _ingest_batch(self, batch: ColumnBatch) -> None:
        if self._vfilter is not None and batch.n:
            try:
                mask = np.broadcast_to(np.asarray(
                    self._vfilter(batch.columns), dtype=np.bool_),
                    (batch.n,)).copy()
                for c in self._vfilter.columns:
                    # null filter columns exclude the row, matching the
                    # row evaluator and FilterNode (nodes_ops.py)
                    mask &= batch.is_valid(c)
            except Exception:
                mask = np.array([
                    self.ev.eval_condition(self.window.filter, r)
                    for r in batch.to_tuples()], dtype=np.bool_)
            if not mask.all():
                batch = batch.take(np.nonzero(mask)[0])
        if batch.n:
            self.bbuf.append(batch)

    @staticmethod
    def _bts(batch: ColumnBatch) -> np.ndarray:
        if batch.timestamps is None:
            return np.zeros(batch.n, dtype=np.int64)
        return batch.timestamps

    def _bbuf_select(self, start: int, end: int) -> List[Row]:
        """Materialize rows with start <= ts < end."""
        out: List[Row] = []
        for batch in self.bbuf:
            ts = self._bts(batch)
            mask = (ts >= start) & (ts < end)
            if mask.all():
                out.extend(batch.to_tuples())
            elif mask.any():
                out.extend(batch.take(np.nonzero(mask)[0]).to_tuples())
        return out

    def _bbuf_evict_before(self, cutoff: int) -> None:
        kept: List[ColumnBatch] = []
        for batch in self.bbuf:
            mask = self._bts(batch) >= cutoff
            if mask.all():
                kept.append(batch)
            elif mask.any():
                kept.append(batch.take(np.nonzero(mask)[0]))
        self.bbuf = kept

    def _bbuf_all_rows(self) -> List[Row]:
        out: List[Row] = []
        for batch in self.bbuf:
            out.extend(batch.to_tuples())
        return out

    # -------------------------------------------------------------- triggers
    def on_trigger(self, trig: Trigger) -> None:
        end = trig.ts
        start = end - self.length_ms
        if self.wt == ast.WindowType.TUMBLING_WINDOW:
            rows = self._bbuf_all_rows() + self.buffer
            self.bbuf = []
            self.buffer = []
        else:
            # windows are [start, end); a row landing in the same ms as the
            # tick counts once (in the next window), not in both
            rows = self._bbuf_select(start, end) + [
                r for r in self.buffer if start <= r.timestamp < end]
            cutoff = end - self.length_ms + (self.interval_ms or 0)
            self._bbuf_evict_before(cutoff)
            self._evict_before(cutoff)
        self._emit_window(rows, WindowRange(start, end))
        self._schedule_next_tick()

    def on_eof(self, eof: EOF) -> None:
        # flush whatever is buffered (trial/bounded runs)
        rows = list(self.buffer) + self._bbuf_all_rows()
        if rows:
            now = timex.now_ms()
            self._emit_window(rows, WindowRange(now - self.length_ms, now))
            self.buffer = []
            self.bbuf = []
        self.broadcast(eof)

    # ----------------------------------------------------------------- emit
    def _emit_window(self, rows: List[Row], wr: WindowRange) -> None:
        self.emit(WindowTuples(content=list(rows), window_range=wr))

    def _evict_before(self, ts: int) -> None:
        """Drop rows strictly before ts (rows at ts can still belong to a
        [ts, ...) window)."""
        if ts <= 0:
            return
        self.buffer = [r for r in self.buffer if r.timestamp >= ts]

    # ----------------------------------------------------------------- state
    def snapshot_state(self) -> Optional[dict]:
        with self._lock:
            rows = [r for r in self.buffer if isinstance(r, Tuple)]
            rows += [r for r in self._bbuf_all_rows()
                     if isinstance(r, Tuple)]
            return {
                "buffer": [
                    {"message": r.message, "timestamp": r.timestamp,
                     "emitter": r.emitter,
                     # __analytic_* overlays are computed upstream of the
                     # window; losing them on restore would re-run the
                     # analytic (double-advancing its state)
                     "cal_cols": dict(r.cal_cols), "slid": False}
                    for r in rows],
                "rows_since_emit": 0, "state_open": False,
                "next_emit_end": None,
            }

    def restore_state(self, state: dict) -> None:
        with self._lock:
            restored = [
                Tuple(emitter=d.get("emitter", ""), message=d["message"],
                      timestamp=d["timestamp"],
                      cal_cols=dict(d.get("cal_cols", {})))
                for d in state.get("buffer", [])]
            # columnarizing drops cal-col overlays; rows carrying
            # __analytic_* state stay in the row buffer after a restore
            if (self._use_bbuf and restored
                    and not any(r.cal_cols for r in restored)):
                # one batch per emitter: joins match rows by emitter, and a
                # batch stamps one
                by_emitter: dict = {}
                for r in restored:
                    by_emitter.setdefault(r.emitter, []).append(r)
                self.bbuf = [from_tuples(rows, emitter=em)
                             for em, rows in by_emitter.items()]
                self.buffer = []
            else:
                self.buffer = restored
