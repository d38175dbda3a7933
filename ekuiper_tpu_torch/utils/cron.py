"""Durations of rule options (subset of ekuiper_tpu/utils/cron.py: the
port's slice needs `parse_duration_ms` only)."""
from __future__ import annotations

import re

from .infra import EngineError

_DUR_RE = re.compile(r"(\d+(?:\.\d+)?)(ms|s|m|h|d)")
_DUR_MS = {"ms": 1, "s": 1000, "m": 60_000, "h": 3_600_000, "d": 86_400_000}


def parse_duration_ms(spec) -> int:
    """Go-style duration ('1h30m', '10s', '500ms') or a bare number of
    milliseconds."""
    if isinstance(spec, (int, float)):
        return int(spec)
    s = str(spec).strip().lower()
    if not s:
        return 0
    if s.isdigit():
        return int(s)
    total = 0.0
    pos = 0
    for m in _DUR_RE.finditer(s):
        if m.start() != pos:
            raise EngineError(f"bad duration {spec!r}")
        total += float(m.group(1)) * _DUR_MS[m.group(2)]
        pos = m.end()
    if pos != len(s):
        raise EngineError(f"bad duration {spec!r}")
    return int(total)
