"""Join node (subset of ekuiper_tpu/runtime/nodes_join.py) — analogue of
eKuiper's JoinOp nested-loop join over window collections
(internal/topo/operator/join_operator.go). The stream-to-lookup-table join
(LookupNode) is not ported yet (ROADMAP Queue 1 item 5).
"""
from __future__ import annotations

from typing import Any, Dict, List

from ..data.rows import JoinTuple, Tuple, WindowTuples
from ..sql import ast
from ..sql.eval import Evaluator
from .node import Node


class JoinNode(Node):
    """Nested-loop join over a window's mixed-emitter rows: the ON clause
    through the row evaluator for every (left, right) pair. Emission order:
    per left row its matches in right order, an unmatched left row (LEFT /
    FULL) at its place, then the unmatched right rows (RIGHT / FULL) in
    their order."""

    def __init__(self, name: str, joins: List[ast.Join],
                 left_name: str) -> None:
        super().__init__(name)
        self.joins = joins
        self.left_name = left_name
        self.ev = Evaluator()

    def process(self, item: Any) -> None:
        if not isinstance(item, WindowTuples):
            self.emit(item)
            return
        by_emitter: Dict[str, List[Any]] = {}
        for r in item.rows():
            if isinstance(r, Tuple):
                by_emitter.setdefault(r.emitter, []).append(r)
            elif isinstance(r, JoinTuple) and r.tuples:
                by_emitter.setdefault(r.tuples[0].emitter, []).append(r)
        current: List[JoinTuple] = [
            JoinTuple(tuples=list(t.tuples)) if isinstance(t, JoinTuple)
            else JoinTuple(tuples=[t])
            for t in by_emitter.get(self.left_name, [])]
        for join in self.joins:
            right_rows = by_emitter.get(join.table.ref_name, [])
            current = self._join_step(current, right_rows, join)
        if current:
            self.emit(WindowTuples(content=list(current),
                                   window_range=item.window_range))

    def _join_step(self, left: List[JoinTuple], right: List[Tuple],
                   join: ast.Join) -> List[JoinTuple]:
        out: List[JoinTuple] = []
        jt = join.join_type
        matched_right: set = set()

        for lt in left:
            matched = False
            for ri, rt in enumerate(right):
                if jt == ast.JoinType.CROSS:
                    ok = True
                else:
                    probe = JoinTuple(tuples=list(lt.tuples) + widen(rt))
                    ok = self.ev.eval_condition(join.on, probe)
                if ok:
                    matched = True
                    matched_right.add(ri)
                    out.append(JoinTuple(tuples=list(lt.tuples) + widen(rt)))
            if not matched and jt in (ast.JoinType.LEFT, ast.JoinType.FULL):
                out.append(JoinTuple(tuples=list(lt.tuples)))
        if jt in (ast.JoinType.RIGHT, ast.JoinType.FULL):
            for ri, rt in enumerate(right):
                if ri not in matched_right:
                    out.append(JoinTuple(tuples=widen(rt)))
        return out


def widen(rt) -> List[Tuple]:
    """A right-side row as the tuples it adds to a joined row."""
    return list(rt.tuples) if isinstance(rt, JoinTuple) else [rt]
