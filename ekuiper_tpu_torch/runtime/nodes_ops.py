"""Relational operator nodes of the host chain (subset of
ekuiper_tpu/runtime/nodes_ops.py — analogues of internal/topo/operator/*):
FilterNode (WHERE), AnalyticNode (analytic functions before the filter),
WindowFuncNode (window functions over a collection) and ProjectNode
(SELECT). The aggregate, HAVING and ORDER BY nodes are not ported yet
(ROADMAP Queue 1 item 5).
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

import numpy as np

from ..data.batch import ColumnBatch
from ..data.rows import Row, Tuple, WindowTuples
from ..sql import ast
from ..sql.compiler import try_compile
from ..sql.eval import Evaluator
from .node import Node


class FilterNode(Node):
    """WHERE — vectorized over a ColumnBatch when it compiles, per row
    otherwise (reference: internal/topo/operator/filter_operator.go)."""

    def __init__(self, name: str, condition: ast.Expr) -> None:
        super().__init__(name)
        self.condition = condition
        self.compiled = try_compile(condition)
        self.ev = Evaluator()

    def process(self, item: Any) -> None:
        if isinstance(item, ColumnBatch):
            out = self._filter_batch(item)
            if out.n > 0:
                self.emit(out, count=out.n)
            return
        if isinstance(item, WindowTuples):
            kept = [r for r in item.rows()
                    if self.ev.eval_condition(self.condition, r)]
            if kept:
                self.emit(WindowTuples(content=kept,
                                       window_range=item.window_range))
            return
        if isinstance(item, Row):
            if self.ev.eval_condition(self.condition, item):
                self.emit(item)
            return
        self.emit(item)

    def _filter_batch(self, batch: ColumnBatch) -> ColumnBatch:
        if self.compiled is not None and all(
                c in batch.columns for c in self.compiled.columns):
            try:
                mask = np.broadcast_to(np.asarray(
                    self.compiled(batch.columns), dtype=bool),
                    (batch.n,)).copy()
                for c in self.compiled.columns:
                    mask &= batch.is_valid(c)
                return batch.select(mask)
            except Exception:
                pass  # fall back to rows
        # the rows the row evaluator keeps (the reference rebuilds them into
        # a batch; the same rows in the same order)
        mask = np.array([self.ev.eval_condition(self.condition, r)
                         for r in batch.to_tuples()], dtype=bool)
        return batch.select(mask)


class AnalyticNode(Node):
    """Pre-computes analytic function values per row before filtering
    (reference: analyticfuncs_operator.go). Results cache on the row as
    __analytic_{func_id} cal-cols which the evaluator reads back."""

    def __init__(self, name: str, calls: List[ast.Call]) -> None:
        super().__init__(name)
        self.calls = calls
        self.ev = Evaluator()

    def process(self, item: Any) -> None:
        if isinstance(item, ColumnBatch):
            rows = item.to_tuples()
        elif isinstance(item, Row):
            rows = [item]
        else:
            self.emit(item)
            return
        with self._lock:
            for r in rows:
                for call in self.calls:
                    r.set_cal_col(f"__analytic_{call.func_id}",
                                  self.ev.eval(call, r))
        if isinstance(item, ColumnBatch):
            for r in rows:
                self.emit(r)
        else:
            self.emit(item)

    def snapshot_state(self) -> Optional[dict]:
        # a frozen copy: handing out the live dict would let later rows
        # mutate the checkpoint
        with self._lock:
            try:
                return {"func_states": json.loads(
                    json.dumps(self.ev.func_states))}
            except (TypeError, ValueError):
                return None

    def restore_state(self, state: dict) -> None:
        with self._lock:
            fs = state.get("func_states", {})
            self.ev.func_states = {int(k): v for k, v in fs.items()}


class ProjectNode(Node):
    """SELECT projection (reference: project_operator.go:54-136). Emits
    result Tuples with the output message per row (a list of them for a
    collection of several rows)."""

    def __init__(self, name: str, fields: List[ast.Field],
                 limit: Optional[int] = None) -> None:
        super().__init__(name)
        self.fields = fields
        self.limit = limit
        self.ev = Evaluator()

    def process(self, item: Any) -> None:
        if isinstance(item, WindowTuples):
            rows: List[Row] = item.rows()
        elif isinstance(item, ColumnBatch):
            rows = item.to_tuples()
        elif isinstance(item, Row):
            rows = [item]
        else:
            self.emit(item)
            return
        if self.limit is not None:
            rows = rows[: self.limit]
        out: List[Tuple] = []
        for r in rows:
            msg: Dict[str, Any] = {}
            for idx, f in enumerate(self.fields):
                if f.invisible:
                    continue
                msg[f.output_name or f"kuiper_field_{idx}"] = \
                    self.ev.eval(f.expr, r)
            meta = getattr(r, "metadata", None)
            out.append(Tuple(emitter="", message=msg,
                             timestamp=getattr(r, "timestamp", 0),
                             metadata=dict(meta) if meta else {}))
        if out:
            self.emit(out if len(out) > 1 else out[0], count=len(out))


class WindowFuncNode(Node):
    """SQL window functions (row_number) applied over a collection
    (reference: windowfunc_operator.go)."""

    def __init__(self, name: str, calls: List[ast.Call]) -> None:
        super().__init__(name)
        self.calls = calls
        self.ev = Evaluator()

    @staticmethod
    def _rows(item: Any) -> Optional[List[Row]]:
        if isinstance(item, WindowTuples):
            return item.rows()
        if isinstance(item, Row):
            return [item]
        if isinstance(item, ColumnBatch):
            return item.to_tuples()
        return None

    def process(self, item: Any) -> None:
        rows = self._rows(item)
        if rows is None:
            self.emit(item)
            return
        # row_number restarts per collection
        self.ev.func_states = {}
        for r in rows:
            for call in self.calls:
                r.set_cal_col(f"__analytic_{call.func_id}",
                              self.ev.eval(call, r))
        self._emit_rows(item, rows)

    def _emit_rows(self, item: Any, rows: List[Row]) -> None:
        if isinstance(item, ColumnBatch):
            # emit the mutated rows, not the unmodified batch
            for r in rows:
                self.emit(r)
        else:
            self.emit(item)
