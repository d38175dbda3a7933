"""Engine logger and error types (subset of ekuiper_tpu/utils/infra.py:
the port's slice needs the logger and the plan/parse errors only)."""
from __future__ import annotations

import logging

logger = logging.getLogger("ekuiper_tpu_torch")


class EngineError(Exception):
    """Base class for engine errors."""


class ParseError(EngineError):
    pass


class PlanError(EngineError):
    pass
