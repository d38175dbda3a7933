"""Runtime node (slim counterpart of ekuiper_tpu/runtime/node.py).

Its caller calls `process` with each data item and `on_trigger` at each
window boundary, in order, on one thread; output goes to the connected
downstream nodes through `emit` / `broadcast`. The reference's input
queue, worker thread, clock timers, checkpoint barriers, tracing and
metrics come with the topology and are not ported yet. An exception in
`process` or `on_trigger` (a failed kernel launch among them) propagates
to the caller; nothing is caught and skipped. `snapshot_state` /
`restore_state` are the checkpoint hooks.
"""
from __future__ import annotations

from typing import Any, List, Optional

from .events import Trigger


class Node:
    def __init__(self, name: str) -> None:
        self.name = name
        self.outputs: List["Node"] = []

    def connect(self, downstream: "Node") -> "Node":
        self.outputs.append(downstream)
        return downstream

    # ------------------------------------------------------------- overridables
    def process(self, item: Any) -> None:
        self.emit(item)

    def on_trigger(self, trig: Trigger) -> None:
        pass

    # ------------------------------------------------------------------ output
    def emit(self, item: Any, count: int = 1) -> None:
        self.broadcast(item)

    def broadcast(self, item: Any) -> None:
        for out in self.outputs:
            out.process(item)

    # ------------------------------------------------------------------- state
    def snapshot_state(self) -> Optional[dict]:
        return None

    def restore_state(self, state: dict) -> None:
        pass
