"""Row & collection data model (subset of ekuiper_tpu/data/rows.py) —
analogue of eKuiper's internal/xsql row model: Tuple (map row + metadata +
alias overlay, internal/xsql/row.go:319) and the GroupedTuples collections
(internal/xsql/collection.go:40-109) the fused node's row-path emit builds.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple as PyTuple


class Row:
    """Interface: anything the expression evaluator can read values from."""

    def value(self, key: str, table: str = "") -> PyTuple[Any, bool]:
        raise NotImplementedError

    def all_values(self) -> Dict[str, Any]:
        raise NotImplementedError

    def set_cal_col(self, key: str, value: Any) -> None:
        raise NotImplementedError


@dataclass
class Tuple(Row):
    """One event. `message` is the decoded payload; `cal_cols` is the
    alias/computed-column overlay (analogue of AffiliateRow, row.go:105)."""

    emitter: str = ""
    message: Dict[str, Any] = field(default_factory=dict)
    timestamp: int = 0  # ms; ingest time, replaced by event time when configured
    metadata: Dict[str, Any] = field(default_factory=dict)
    cal_cols: Dict[str, Any] = field(default_factory=dict)

    def value(self, key: str, table: str = "") -> PyTuple[Any, bool]:
        if table and table != self.emitter:
            return None, False
        if key in self.cal_cols:
            return self.cal_cols[key], True
        if key in self.message:
            return self.message[key], True
        return None, False

    def all_values(self) -> Dict[str, Any]:
        out = dict(self.message)
        out.update(self.cal_cols)
        return out

    def meta(self, key: str) -> PyTuple[Any, bool]:
        if key in self.metadata:
            return self.metadata[key], True
        return None, False

    def set_cal_col(self, key: str, value: Any) -> None:
        self.cal_cols[key] = value

    def clone(self) -> "Tuple":
        return Tuple(
            emitter=self.emitter,
            message=copy.copy(self.message),
            timestamp=self.timestamp,
            metadata=copy.copy(self.metadata),
            cal_cols=copy.copy(self.cal_cols),
        )


@dataclass
class WindowRange:
    """Window bounds attached to emitted collections; feeds window_start()/
    window_end() SQL functions (reference: internal/xsql window range)."""

    window_start: int = 0
    window_end: int = 0


class Collection:
    """Interface for multi-row results flowing between operators."""

    def rows(self) -> List[Row]:
        raise NotImplementedError

    def __len__(self) -> int:
        return len(self.rows())

    def __iter__(self) -> Iterator[Row]:
        return iter(self.rows())


@dataclass
class GroupedTuples(Collection):
    """One GROUP BY group: rows + shared group key
    (analogue internal/xsql/row.go:374)."""

    content: List[Row] = field(default_factory=list)
    group_key: str = ""
    window_range: Optional[WindowRange] = None
    cal_cols: Dict[str, Any] = field(default_factory=dict)
    # precomputed aggregate results by call key — filled by the device kernel
    # path so the evaluator skips per-group recomputation
    agg_values: Dict[str, Any] = field(default_factory=dict)

    def rows(self) -> List[Row]:
        return self.content

    # GroupedTuples acts as a Row for post-agg operators (HAVING/project read
    # both agg results and the first row's columns).
    def value(self, key: str, table: str = "") -> PyTuple[Any, bool]:
        if key in self.cal_cols:
            return self.cal_cols[key], True
        if self.content:
            return self.content[0].value(key, table)
        return None, False

    def all_values(self) -> Dict[str, Any]:
        out = self.content[0].all_values() if self.content else {}
        out.update(self.cal_cols)
        return out

    def set_cal_col(self, key: str, value: Any) -> None:
        self.cal_cols[key] = value


@dataclass
class GroupedTuplesSet(Collection):
    """All groups of one window/batch (analogue collection.go:109)."""

    groups: List[GroupedTuples] = field(default_factory=list)
    window_range: Optional[WindowRange] = None

    def rows(self) -> List[Row]:
        return list(self.groups)
