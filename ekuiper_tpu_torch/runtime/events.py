"""Events flowing between runtime nodes (subset of
ekuiper_tpu/runtime/events.py)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Trigger:
    """Window trigger tick (processing time): `ts` is the window end."""

    ts: int
