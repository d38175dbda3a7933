"""Runtime node (slim counterpart of ekuiper_tpu/runtime/node.py).

Its caller calls `process` with each data item, in order, on one thread;
output goes to the connected downstream nodes through `emit` /
`broadcast`, or to one of them through `send_to`. Control events (window triggers, pre-triggers, EOF) arrive
through `put_control`, which the clock's timers call once the node is
opened (`on_open`); a caller that never opens the node calls `on_trigger`
itself. The port has no input queue or worker thread yet: `put_control`
runs the handler inline, under the node's lock, which `process` holds
too, so a timer thread of the real clock cannot interleave with a fold.

An exception in a handler (a failed kernel launch among them) propagates
to the caller; nothing is caught and skipped. `snapshot_state` /
`restore_state` are the checkpoint hooks.
"""
from __future__ import annotations

import threading
from typing import Any, List, Optional

from .events import EOF, PreTrigger, Trigger


class Node:
    def __init__(self, name: str) -> None:
        self.name = name
        self.outputs: List["Node"] = []
        # serialises data (process) with control events (put_control)
        self._lock = threading.RLock()

    def connect(self, downstream: "Node") -> "Node":
        self.outputs.append(downstream)
        return downstream

    def put_control(self, item: Any) -> None:
        """Deliver a control event (called by the clock's timers)."""
        with self._lock:
            if isinstance(item, Trigger):
                self.on_trigger(item)
            elif isinstance(item, PreTrigger):
                self.on_pre_trigger(item)
            elif isinstance(item, EOF):
                self.on_eof(item)
            else:
                raise TypeError(f"not a control event: {item!r}")

    # ------------------------------------------------------------- overridables
    def on_open(self) -> None:
        """Set-up before data: arm the node's timers."""

    def on_close(self) -> None:
        """Stop timers and drain work in flight."""

    def process(self, item: Any) -> None:
        self.emit(item)

    def on_trigger(self, trig: Trigger) -> None:
        pass

    def on_pre_trigger(self, pre: PreTrigger) -> None:
        pass

    def on_eof(self, eof: EOF) -> None:
        self.broadcast(eof)

    # ------------------------------------------------------------------ output
    def emit(self, item: Any, count: int = 1) -> None:
        self.broadcast(item)

    def broadcast(self, item: Any) -> None:
        for out in self.outputs:
            self.send_to(out, item)

    def send_to(self, out: "Node", item: Any) -> None:
        """Hand `item` to one downstream node (a rule group routes each
        rule's window to that rule's own node through it)."""
        out.process(item)

    # ------------------------------------------------------------------- state
    def snapshot_state(self) -> Optional[dict]:
        return None

    def restore_state(self, state: dict) -> None:
        pass
