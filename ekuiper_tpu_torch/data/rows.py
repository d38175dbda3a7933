"""Row & collection data model (subset of ekuiper_tpu/data/rows.py) —
analogue of eKuiper's internal/xsql row model: Tuple (map row + metadata +
alias overlay, internal/xsql/row.go:319), JoinTuple (row.go:355), and the
WindowTuples / GroupedTuples collections (internal/xsql/collection.go:40-109)
that the host operator chain (runtime/nodes_window.py, nodes_ops.py,
nodes_join.py) and the fused node's row-path emit build.
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
class JoinTuple(Row):
    """Merged row from a join: ordered (emitter, Tuple) pairs
    (analogue of internal/xsql/row.go:355)."""

    tuples: List[Tuple] = field(default_factory=list)
    cal_cols: Dict[str, Any] = field(default_factory=dict)

    @property
    def timestamp(self) -> int:
        return max((t.timestamp for t in self.tuples), default=0)

    def add(self, t: Tuple) -> None:
        self.tuples.append(t)

    def value(self, key: str, table: str = "") -> PyTuple[Any, bool]:
        if key in self.cal_cols:
            return self.cal_cols[key], True
        if table:
            for t in self.tuples:
                if t.emitter == table:
                    return t.value(key)
            return None, False
        for t in self.tuples:
            v, ok = t.value(key)
            if ok:
                return v, True
        return None, False

    def all_values(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for t in reversed(self.tuples):
            out.update(t.all_values())
        out.update(self.cal_cols)
        return out

    def set_cal_col(self, key: str, value: Any) -> None:
        self.cal_cols[key] = value

    def clone(self) -> "JoinTuple":
        return JoinTuple(
            tuples=[t.clone() for t in self.tuples], cal_cols=copy.copy(self.cal_cols)
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
class WindowTuples(Collection):
    """All rows of one triggered window (analogue collection.go:70)."""

    content: List[Row] = field(default_factory=list)
    window_range: Optional[WindowRange] = None

    def rows(self) -> List[Row]:
        return self.content

    # acts as the aggregate context for ungrouped agg queries: non-agg
    # columns read from the first row (reference semantics)
    def value(self, key: str, table: str = "") -> PyTuple[Any, bool]:
        if self.content:
            return self.content[0].value(key, table)
        return None, False

    def all_values(self) -> Dict[str, Any]:
        return self.content[0].all_values() if self.content else {}


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
