"""The event-time watermark operator (counterpart of the `WatermarkNode` of
ekuiper_tpu/runtime/nodes_window.py; the reference's host `WindowNode` is
not ported).

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
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np

from ..data.batch import ColumnBatch
from ..data.rows import Tuple
from .events import EOF, Watermark
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
