"""Type coercion (subset of ekuiper_tpu/data/cast.py — analogue of eKuiper's
pkg/cast/cast.go): what the host row evaluator (sql/eval.py) and the
relational nodes need of it — the float and boolean casts its operators
apply, `to_string` for partition keys, and the three-way `compare` with
cross-type numeric comparison.
"""
from __future__ import annotations

from typing import Any, Optional

STRICT = "strict"
CONVERT_ALL = "convert_all"


class CastError(ValueError):
    pass


def to_float(v: Any, strict: str = CONVERT_ALL) -> float:
    if isinstance(v, bool):
        if strict == STRICT:
            raise CastError(f"cannot cast bool {v} to float strictly")
        return 1.0 if v else 0.0
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, str) and strict != STRICT:
        try:
            return float(v)
        except ValueError as e:
            raise CastError(f"cannot cast string {v!r} to float") from e
    raise CastError(f"cannot cast {type(v).__name__} {v!r} to float")


def to_bool(v: Any, strict: str = CONVERT_ALL) -> bool:
    if isinstance(v, bool):
        return v
    if strict != STRICT:
        if isinstance(v, (int, float)) and v in (0, 1):
            return bool(v)
        if isinstance(v, str):
            low = v.lower()
            if low in ("true", "1"):
                return True
            if low in ("false", "0"):
                return False
    raise CastError(f"cannot cast {type(v).__name__} {v!r} to boolean")


def to_string(v: Any, strict: str = CONVERT_ALL) -> str:
    if isinstance(v, str):
        return v
    if strict == STRICT:
        raise CastError(f"cannot cast {type(v).__name__} {v!r} to string strictly")
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, bytes):
        return v.decode("utf-8", errors="replace")
    if isinstance(v, float) and float(v).is_integer():
        return str(int(v))
    return str(v)


def compare(a: Any, b: Any) -> Optional[int]:
    """Three-way compare with eKuiper-style cross-type numeric comparison.
    Returns None for incomparable (NULL-ish) pairs."""
    if a is None or b is None:
        return None
    if isinstance(a, bool) or isinstance(b, bool):
        if isinstance(a, bool) and isinstance(b, bool):
            return (a > b) - (a < b)
        return None
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return (a > b) - (a < b)
    if isinstance(a, str) and isinstance(b, str):
        return (a > b) - (a < b)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        for x, y in zip(a, b):
            c = compare(x, y)
            if c is None or c != 0:
                return c
        return (len(a) > len(b)) - (len(a) < len(b))
    return None
