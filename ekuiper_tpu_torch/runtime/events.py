"""Events flowing between runtime nodes (subset of
ekuiper_tpu/runtime/events.py)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional


@dataclass
class EOF:
    """Stream end (bounded sources): the window node flushes its open
    window and forwards the event."""

    source_id: str = ""


@dataclass
class Watermark:
    """Event-time watermark: no further rows with a timestamp below `ts`
    are expected (the WatermarkNode's broadcast, runtime/nodes_window.py).
    A node receives it in `on_watermark`, under its lock."""

    ts: int


@dataclass
class Trigger:
    """Window trigger tick (processing time): `ts` is the window end. A
    delayed sliding emission carries tag ("sliding", t), t its trigger
    row's time."""

    ts: int
    tag: Optional[Any] = None


@dataclass
class PreTrigger:
    """Advance notice of an upcoming window boundary, delivered a lead
    before it so the fused node can pre-issue its components fetch
    (ops/prefinalize.py). `ts` is the boundary the notice is for."""

    ts: int
