"""Device relational nodes: the runtime half of planner/relational.py
(counterpart of ekuiper_tpu/runtime/nodes_relational.py).

DeviceJoinNode replaces the nested-loop probe of JoinNode with one
banded-gather mask per window (ops/joinring.py, the `join_match` kernel).
The mask only decides PAIRING — emitted tuples are the original host rows
reassembled in the reference emission order (per left row: matches in right
order; unmatched-left at the left row's position; unmatched rights appended
in right order) — so device emissions are byte-identical to the nested
loop. A window whose data steps outside the device contract
(JoinWindowFallback) runs the host loop for that window only; the plan
stays lifted and the window is counted (`ring.fallback_windows_total`),
never silent.

DeviceAnalyticNode lifts lag() onto the segscan shift kernel: partition
keys dictionary-encode once (the group-by's KeyTable discipline) and the
per-partition carry lives in tensors on the card. Values are float32 — the
numeric contract of every fused kernel. A non-numeric value migrates the
node to the host path permanently, transplanting the device carry into the
evaluator's lag history first, so no row ever sees a reset state; the
migration is counted (`migrations`, and the `analytic_runtime_type` host
fallback).

VectorWindowFuncNode computes rank/dense_rank/lead collection-wide (they
are whole-collection functions — a per-row exec cannot know the value
order). Ranks come from the segscan sort kernel when every value is
numeric and round-trips float32 exactly and the node was planned for the
device, else from the exact host path; lead's value assignment is an exact
index shift either way.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np

from ..data import cast
from ..data.batch import ColumnBatch
from ..data.rows import JoinTuple, Row, Tuple
from ..ops.joinring import JoinWindowFallback, SideBatch
from ..ops.keytable import KeyTable
from ..sql import ast
from ..sql.compiler import record_host_fallback
from ..utils.device import Device
from .nodes_join import JoinNode, widen
from .nodes_ops import AnalyticNode, WindowFuncNode


def _is_null(v: Any) -> bool:
    return v is None or (isinstance(v, float) and v != v)


def _numeric(v: Any) -> bool:
    return v is None or (isinstance(v, (int, float))
                         and not isinstance(v, bool))


class DeviceJoinNode(JoinNode):
    """JoinNode with the device mask path for the (single) stream-stream
    join step the planner lowered."""

    def __init__(self, name: str, joins: List[ast.Join], left_name: str,
                 lowering, device: Device = None) -> None:
        super().__init__(name, joins, left_name)
        self.lowering = lowering
        self.ring = lowering.build_ring(device=device)

    def _side_rows(self, rows: List[Row], side: str) -> SideBatch:
        lw = self.lowering
        stream = lw.left if side == "l" else lw.right
        names = lw.key_l if side == "l" else lw.key_r
        raws = lw.raw_l if side == "l" else lw.raw_r
        batch = SideBatch(n=len(rows))
        for col in names:
            batch.key_cols.append(
                [r.value(col, stream)[0] for r in rows])
        band_col = lw.band_l if side == "l" else lw.band_r
        if band_col is not None:
            batch.band = [r.value(band_col, stream)[0] for r in rows]
        for raw in raws:
            col = raw[len("__jl_"):]
            batch.cols[raw] = [r.value(col, stream)[0] for r in rows]
        return batch

    def _join_step(self, left: List[JoinTuple], right: List[Tuple],
                   join: ast.Join) -> List[JoinTuple]:
        try:
            mask = self.ring.match(self._side_rows(left, "l"),
                                   self._side_rows(right, "r"))
        except JoinWindowFallback as exc:
            self.ring.fallback_windows_total += 1
            record_host_fallback(exc.reason)
            return super()._join_step(left, right, join)
        jt = join.join_type
        out: List[JoinTuple] = []
        matched_right = mask.any(axis=0) if len(left) else \
            np.zeros(len(right), dtype=bool)
        for i, lt in enumerate(left):
            hits = np.nonzero(mask[i])[0]
            for j in hits:
                out.append(JoinTuple(
                    tuples=list(lt.tuples) + widen(right[j])))
            if not len(hits) and jt in (ast.JoinType.LEFT,
                                        ast.JoinType.FULL):
                out.append(JoinTuple(tuples=list(lt.tuples)))
        if jt in (ast.JoinType.RIGHT, ast.JoinType.FULL):
            for j, rt in enumerate(right):
                if not matched_right[j]:
                    out.append(JoinTuple(tuples=widen(rt)))
        return out


class DeviceAnalyticNode(AnalyticNode):
    """AnalyticNode with lag() on the segscan shift kernel."""

    def __init__(self, name: str, calls: List[ast.Call], lowering,
                 device: Device = None) -> None:
        super().__init__(name, calls)
        self.lowering = lowering
        self.device = device
        self._migrated = False
        self.migrations = 0
        self._seg = None
        self._keys = KeyTable(initial_capacity=4096)

    def _ensure_seg(self):
        if self._seg is None:
            from ..ops.segscan import SegScan

            self._seg = SegScan(capacity=4096, device=self.device)
        return self._seg

    def process(self, item: Any) -> None:
        if self._migrated:
            super().process(item)
            return
        if isinstance(item, ColumnBatch):
            rows = item.to_tuples()
        elif isinstance(item, Row):
            rows = [item]
        else:
            self.emit(item)
            return
        with self._lock:
            staged = self._stage_calls(rows)
            if staged is None:
                # non-numeric value: move the carry to host state, then
                # let the host path compute this batch (no state was
                # updated)
                self._migrate_lag_state()
                for r in rows:
                    for call in self.calls:
                        r.set_cal_col(f"__analytic_{call.func_id}",
                                      self.ev.eval(call, r))
            else:
                self._apply_device(rows, staged)
        if isinstance(item, ColumnBatch):
            for r in rows:
                self.emit(r)
        else:
            self.emit(item)

    def _stage_calls(self, rows: List[Row]
                     ) -> Optional[List[Dict[str, Any]]]:
        """Validate + encode every call over the whole batch BEFORE any
        state update (migration must see a pristine carry). Returns None
        when any value falls outside the numeric device contract."""
        staged = []
        for plan in self.lowering.calls:
            vals = np.full(len(rows), np.nan, dtype=np.float32)
            pstrs: List[str] = []
            for i, r in enumerate(rows):
                v = r.value(plan.col)[0]
                if not _numeric(v):
                    return None
                if v is not None:
                    vals[i] = v
                pstrs.append("#".join(
                    cast.to_string(self.ev.eval(p, r))
                    for p in plan.partition))
            staged.append({"plan": plan, "vals": vals, "pstrs": pstrs})
        return staged

    def _apply_device(self, rows: List[Row], staged) -> None:
        seg = self._ensure_seg()
        for st in staged:
            plan, vals, pstrs = st["plan"], st["vals"], st["pstrs"]
            keys = np.empty(len(rows), dtype=object)
            for i, p in enumerate(pstrs):
                keys[i] = (plan.call.func_id, p)
            slots, _ = self._keys.encode_column(keys)
            out = seg.shift(slots.astype(np.int32), vals, len(rows))
            for i, r in enumerate(rows):
                if not out["lag_has"][i]:
                    v: Any = plan.default
                elif math.isnan(float(out["lag"][i])):
                    v = None
                else:
                    v = float(out["lag"][i])
                r.set_cal_col(f"__analytic_{plan.call.func_id}", v)

    def _migrate_lag_state(self) -> None:
        """One-way device -> host state transplant: per-partition last
        values leave the carry and become the evaluator's lag history,
        so the host path continues every partition where the device left
        it. Runs off the hot path, at most once per node."""
        self._migrated = True
        self.migrations += 1
        record_host_fallback("analytic_runtime_type")
        if self._seg is None:
            return
        carry = self._seg.peek_carry()
        for slot, key in enumerate(self._keys.decode_all()):
            if key is None or not bool(carry["has"][slot]):
                continue
            func_id, pstr = key
            last = float(carry["last"][slot])
            st = self.ev.func_states.setdefault(int(func_id), {})
            st["p:" + pstr] = {
                "hist": [None if math.isnan(last) else last]}
        self._seg = None

    # ------------------------------------------------------------- state
    def snapshot_state(self) -> Optional[dict]:
        with self._lock:
            base = super().snapshot_state()
            if base is None:
                return None
            base["migrated"] = self._migrated
            if self._seg is not None:
                base["segscan"] = self._seg.snapshot()
                base["part_keys"] = [list(k) if isinstance(k, tuple) else k
                                     for k in self._keys.decode_all()]
            return base

    def restore_state(self, state: dict) -> None:
        with self._lock:
            super().restore_state(state)
            self._migrated = bool(state.get("migrated", False))
            snap = state.get("segscan")
            if snap is not None and not self._migrated:
                self._ensure_seg().restore(snap)
                self._keys.restore([tuple(k) if isinstance(k, list) else k
                                    for k in state.get("part_keys", [])])
            else:
                self._seg = None


class VectorWindowFuncNode(WindowFuncNode):
    """WindowFuncNode computing rank/dense_rank/lead collection-wide;
    row_number (and any future per-row window func) keeps the exec
    path. `use_device` routes exact-float32 rank batches through the
    segscan sort kernel."""

    VECTOR = ("rank", "dense_rank", "lead")

    def __init__(self, name: str, calls: List[ast.Call],
                 use_device: bool = False, device: Device = None) -> None:
        super().__init__(name, calls)
        self.use_device = use_device
        self.device = device
        self._seg = None
        #: collections whose ranks took the sort kernel / the host path
        self.rank_paths = {"device": 0, "host": 0}

    def process(self, item: Any) -> None:
        rows = self._rows(item)
        if rows is None:
            self.emit(item)
            return
        self.ev.func_states = {}
        vector = [c for c in self.calls if c.name in self.VECTOR]
        per_row = [c for c in self.calls if c.name not in self.VECTOR]
        if vector and rows:
            self._apply_vector(vector, rows)
        for r in rows:
            for call in per_row:
                r.set_cal_col(f"__analytic_{call.func_id}",
                              self.ev.eval(call, r))
        self._emit_rows(item, rows)

    # ---------------------------------------------------------- vector
    def _apply_vector(self, calls: List[ast.Call],
                      rows: List[Row]) -> None:
        n = len(rows)
        for call in calls:
            vals = [self.ev.eval(call.args[0], r) if call.args else None
                    for r in rows]
            if call.partition:
                pkeys = ["#".join(cast.to_string(self.ev.eval(p, r))
                                  for p in call.partition)
                         for r in rows]
            else:
                pkeys = [""] * n
            seg_of: Dict[str, int] = {}
            seg = np.zeros(n, dtype=np.int32)
            for i, p in enumerate(pkeys):
                seg[i] = seg_of.setdefault(p, len(seg_of))
            if call.name == "lead":
                out = self._lead(call, rows, vals, seg)
            else:
                out = self._ranks(call, vals, seg)
            for i, r in enumerate(rows):
                r.set_cal_col(f"__analytic_{call.func_id}", out[i])

    def _lead(self, call: ast.Call, rows: List[Row], vals: List[Any],
              seg: np.ndarray) -> List[Any]:
        offset = 1
        if len(call.args) > 1:
            offset = int(self.ev.eval(call.args[1], rows[0]))
        members: Dict[int, List[int]] = {}
        for i, s in enumerate(seg):
            members.setdefault(int(s), []).append(i)
        out: List[Any] = [None] * len(rows)
        for idxs in members.values():
            for pos, i in enumerate(idxs):
                if pos + offset < len(idxs) and offset >= 0:
                    out[i] = vals[idxs[pos + offset]]
                elif len(call.args) > 2:
                    out[i] = self.ev.eval(call.args[2], rows[i])
        return out

    def _ranks(self, call: ast.Call, vals: List[Any],
               seg: np.ndarray) -> List[Any]:
        numeric = all(_numeric(v) for v in vals)
        if numeric and self.use_device:
            fv = np.full(len(vals), np.nan, dtype=np.float32)
            exact = True
            for i, v in enumerate(vals):
                if v is None or (isinstance(v, float) and math.isnan(v)):
                    continue
                fv[i] = v
                if float(fv[i]) != float(v):
                    exact = False  # float32 would reorder ties
                    break
            if exact:
                if self._seg is None:
                    from ..ops.segscan import SegScan

                    self._seg = SegScan(capacity=256, device=self.device)
                self.rank_paths["device"] += 1
                out = self._seg.ranks(seg, fv, len(vals))
                key = "rank" if call.name == "rank" else "dense_rank"
                has = out["rank_has"]
                return [int(out[key][i]) if has[i] else None
                        for i in range(len(vals))]
        self.rank_paths["host"] += 1
        return self._ranks_py(call, vals, seg)

    @staticmethod
    def _ranks_py(call: ast.Call, vals: List[Any],
                  seg: np.ndarray) -> List[Any]:
        """Exact host ranks over arbitrary comparable values: rank =
        1 + count(valid smaller); dense_rank = 1 + count(distinct valid
        smaller). NULL (and float NaN) ranks as NULL."""
        import bisect

        members: Dict[int, List[int]] = {}
        for i, s in enumerate(seg):
            members.setdefault(int(s), []).append(i)
        out: List[Any] = [None] * len(vals)
        for idxs in members.values():
            valid = sorted(vals[i] for i in idxs
                           if not _is_null(vals[i]))
            distinct: List[Any] = []
            for v in valid:
                if not distinct or distinct[-1] != v:
                    distinct.append(v)
            pool = valid if call.name == "rank" else distinct
            for i in idxs:
                if _is_null(vals[i]):
                    continue
                out[i] = 1 + bisect.bisect_left(pool, vals[i])
        return out
