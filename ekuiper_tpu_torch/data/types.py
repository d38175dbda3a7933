"""Stream data types & schema — analogue of eKuiper's column types in stream
DDL (reference: pkg/ast/sourceStmt.go) and the planner's field index assignment
for SliceTuple (reference: internal/topo/planner/planner.go:88,94-165).

The schema decides which columns are device-eligible (numeric → torch
tensors on the card) and which stay host-side (strings/arrays/structs →
dictionary-encoded or object columns).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional

import numpy as np


class DataType(str, Enum):
    BIGINT = "bigint"
    FLOAT = "float"
    STRING = "string"
    BOOLEAN = "boolean"
    DATETIME = "datetime"
    BYTEA = "bytea"
    ARRAY = "array"
    STRUCT = "struct"
    UNKNOWN = "unknown"  # schemaless column


NUMERIC_TYPES = {DataType.BIGINT, DataType.FLOAT, DataType.BOOLEAN, DataType.DATETIME}

_NP_DTYPES = {
    DataType.BIGINT: np.int64,
    DataType.FLOAT: np.float32,
    DataType.BOOLEAN: np.bool_,
    DataType.DATETIME: np.int64,  # epoch ms
}


def np_dtype(dt: DataType):
    """numpy dtype for device-eligible columns; object for host columns."""
    return _NP_DTYPES.get(dt, np.object_)


@dataclass
class Field:
    name: str
    type: DataType = DataType.UNKNOWN
    # nested element/field types for ARRAY/STRUCT columns
    elem_type: Optional["DataType"] = None
    fields: Optional[List["Field"]] = None

    @property
    def device_eligible(self) -> bool:
        return self.type in NUMERIC_TYPES

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"name": self.name, "type": self.type.value}
        if self.elem_type is not None:
            d["elem_type"] = self.elem_type.value
        if self.fields is not None:
            d["fields"] = [f.to_dict() for f in self.fields]
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Field":
        return Field(
            name=d["name"],
            type=DataType(d.get("type", "unknown")),
            elem_type=DataType(d["elem_type"]) if d.get("elem_type") else None,
            fields=[Field.from_dict(f) for f in d["fields"]] if d.get("fields") else None,
        )


@dataclass
class Schema:
    """Ordered field list. Empty fields = schemaless stream."""

    fields: List[Field] = field(default_factory=list)

    @property
    def schemaless(self) -> bool:
        return len(self.fields) == 0

    def field_names(self) -> List[str]:
        return [f.name for f in self.fields]

    def get(self, name: str) -> Optional[Field]:
        for f in self.fields:
            if f.name == name:
                return f
        return None

    def index_of(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        return -1

    def to_dict(self) -> Dict[str, Any]:
        return {"fields": [f.to_dict() for f in self.fields]}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Schema":
        return Schema(fields=[Field.from_dict(f) for f in d.get("fields", [])])
