"""Time units of window specs (subset of ekuiper_tpu/utils/timex.py).

The reference's engine clock (real and mock clocks, timers) drives window
triggers from the topology. The port's slice has no topology yet: its
caller hands the fused node each `Trigger` with the window end, so no
module of the port reads a clock.
"""
from __future__ import annotations

MS = 1
SECOND = 1000
MINUTE = 60 * SECOND
HOUR = 60 * MINUTE
DAY = 24 * HOUR

_UNIT_MS = {"ms": MS, "ss": SECOND, "mi": MINUTE, "hh": HOUR, "dd": DAY}


def unit_to_ms(unit: str) -> int:
    """Window-size unit (as in TUMBLINGWINDOW(ss, 10)) to milliseconds."""
    try:
        return _UNIT_MS[unit.lower()]
    except KeyError:
        raise ValueError(f"unknown time unit {unit!r} (want dd/hh/mi/ss/ms)")
