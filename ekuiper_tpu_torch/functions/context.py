"""Function execution context (cut down from
ekuiper_tpu/functions/context.py — analogue of api.FunctionContext,
contract/api/ctx.go:41-66): the per-call-instance state a stateful function
keeps (lag's history, row_number's count).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict


@dataclass
class FunctionContext:
    state: Dict[str, Any] = field(default_factory=dict)

    def get_state(self, key: str, default: Any = None) -> Any:
        return self.state.get(key, default)

    def put_state(self, key: str, value: Any) -> None:
        self.state[key] = value
