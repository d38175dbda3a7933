"""Fused window→GROUP BY→aggregate node (counterpart of
ekuiper_tpu/runtime/nodes_fused.py `FusedWindowAggNode`, processing-time
TUMBLING and HOPPING windows).

Per micro-batch: encode GROUP BY keys to slots (host dictionary), upload
the kernel's columns and fold them into the device partials
(ops/groupby.py, the CUDA fold kernel). Per trigger: finalize on the
device (pane merge + final values, one kernel), one device-to-host copy,
emit through the vectorized direct-emit tail or as GroupedTuplesSet, then
reset the expired pane (one kernel).

Not ported yet, and refused at construction: sliding, session, count and
state windows, event time, the latency-hiding prefinalize pipeline (every
boundary finalizes synchronously), sketch aggregates, tiered key state and
the mesh.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..data.batch import ColumnBatch
from ..data.rows import GroupedTuples, GroupedTuplesSet, Tuple, WindowRange
from ..ops.aggspec import KernelPlan, _call_key
from ..ops.groupby import TorchGroupBy
from ..ops.keytable import KeyTable
from ..sql import ast
from ..utils.device import Device
from .events import Trigger
from .node import Node


class FusedWindowAggNode(Node):
    def __init__(
        self,
        name: str,
        window: ast.Window,
        plan: KernelPlan,
        dims: List[ast.FieldRef],
        capacity: int = 16384,
        micro_batch: int = 4096,
        direct_emit=None,  # ops.emit.DirectEmitPlan — vectorized tail
        emit_columnar: bool = False,  # window result stays a ColumnBatch
        device: Device = None,  # CUDA unless "cpu" is named (utils/device.py)
    ) -> None:
        super().__init__(name)
        self.window = window
        self.plan = plan
        self.dims = dims
        self.direct_emit = direct_emit
        self.emit_columnar = emit_columnar
        self.wt = window.window_type
        self.length_ms = window.length_ms()
        self.interval_ms = window.interval_ms()
        if self.wt == ast.WindowType.HOPPING_WINDOW:
            iv = max(self.interval_ms, 1)
            self.n_panes = max((self.length_ms + iv - 1) // iv, 1)
        elif self.wt == ast.WindowType.TUMBLING_WINDOW:
            self.n_panes = 1
        else:
            raise NotImplementedError(
                f"{self.wt.name} windows are not ported yet")
        self.gb = TorchGroupBy(plan, capacity=capacity,
                               n_panes=int(self.n_panes),
                               micro_batch=micro_batch, device=device)
        self.kt = KeyTable(self.gb.capacity)
        self.state: Optional[Dict[str, torch.Tensor]] = None
        self.cur_pane = 0
        self._rows_in_window = 0  # count windows: kept for the snapshot format
        self._spec_keys = [_call_key(s.call) for s in plan.specs]
        self._dtypes_seen = False

    # ------------------------------------------------------------------- data
    def process(self, item: Any) -> None:
        if isinstance(item, Tuple):
            raise NotImplementedError(
                "row tuples into the fused node are not ported yet")
        if not isinstance(item, ColumnBatch):
            self.emit(item)
            return
        if item.n == 0:
            return
        self._fold(item)

    def _fold(self, batch: ColumnBatch) -> int:
        """Fold the batch into the current pane; returns rows folded."""
        return self._fold_rows(batch, self.cur_pane)

    def _build_kernel_inputs(self, sub: ColumnBatch):
        """Encode group keys + materialize the kernel's numeric columns and
        validity masks for `sub`. Returns (cols, valid, slots)."""
        key_cols = []
        for d in self.dims:
            col = sub.columns.get(d.name)
            if col is None:
                col = np.full(sub.n, None, dtype=np.object_)
            key_cols.append(col)
        if key_cols:
            slots, grew = self.kt.encode_multi(key_cols)
            if grew:
                self.state = self.gb.grow(self.state, self.kt.capacity)
        else:
            slots = np.zeros(sub.n, dtype=np.int32)
            if self.kt.n_keys == 0:
                self.kt.encode_column(np.array(["__all__"], dtype=np.object_))
        cols: Dict[str, np.ndarray] = {}
        valid: Dict[str, np.ndarray] = {}
        for name in self.plan.columns:
            col = sub.columns.get(name)
            if col is None:
                cols[name] = np.full(sub.n, np.nan, dtype=np.float32)
                continue
            if col.dtype == np.object_:
                # mixed/object numeric column: coerce, NaN for bad rows
                coerced = np.full(sub.n, np.nan, dtype=np.float32)
                for i, v in enumerate(col):
                    if isinstance(v, (int, float)) and not isinstance(v, bool):
                        coerced[i] = v
                cols[name] = coerced
            else:
                cols[name] = col
            v = sub.valid.get(name)
            if v is not None:
                valid[name] = v
        if not self._dtypes_seen:
            self.gb.observe_dtypes(cols)
            self._dtypes_seen = True
        return cols, valid, slots

    def _fold_rows(self, sub: ColumnBatch, pane_arg) -> int:
        """Encode keys + build kernel columns + device fold for `sub` into
        pane `pane_arg`."""
        if self.state is None:
            self.state = self.gb.init_state()
        cols, valid, slots = self._build_kernel_inputs(sub)
        if self.gb.capacity < self.kt.capacity:
            # deferred grow: a restore can leave the key table wider
            self.state = self.gb.grow(self.state, self.kt.capacity)
        self.state = self.gb.fold(self.state, cols, slots, valid, pane_arg)
        return sub.n

    # ---------------------------------------------------------------- control
    def on_trigger(self, trig: Trigger) -> None:
        end = trig.ts
        wr = WindowRange(end - self.length_ms, end)
        self._boundary_emit(wr)
        if self.wt == ast.WindowType.TUMBLING_WINDOW:
            self.state = self.gb.reset_pane(self.state, 0)
        else:
            # advance to the next pane; expire it (it held the oldest slice)
            self.cur_pane = (self.cur_pane + 1) % self.n_panes
            self.state = self.gb.reset_pane(self.state, self.cur_pane)

    # ------------------------------------------------------------------- emit
    def _boundary_emit(self, wr: WindowRange) -> None:
        """Window-boundary emission. Synchronous: the latency-hiding
        pre-issue pipeline of the reference is not ported yet."""
        self._emit(wr)

    def _emit(self, wr: WindowRange) -> None:
        n_keys = self.kt.n_keys
        if n_keys == 0 or self.state is None:
            return
        outs, act = self.gb.finalize(self.state, n_keys)
        active = np.nonzero(act > 0)[0]
        if len(active) == 0:
            return
        if self.direct_emit is not None:
            self._emit_direct(outs, active, wr)
            return
        self._emit_grouped(outs, active, wr)

    def _emit_grouped(self, outs, active: np.ndarray, wr: WindowRange) -> None:
        """Row-path emit tail: build GroupedTuplesSet for downstream
        HAVING/ORDER/PROJECT nodes."""
        active_list = active.tolist()
        out_lists = []
        for col in outs:
            sel = col[active]
            if np.issubdtype(sel.dtype, np.floating):
                sel = np.where(np.isnan(sel), None, sel.astype(object))
            out_lists.append(sel.tolist())
        groups: List[GroupedTuples] = []
        dim_names = [d.name for d in self.dims]
        single_dim = dim_names[0] if len(dim_names) == 1 else None
        spec_keys = self._spec_keys
        ts = wr.window_end
        for j, slot in enumerate(active_list):
            key = self.kt.decode(slot)
            if single_dim is not None:
                msg = {single_dim: key}
            elif dim_names:
                msg = dict(zip(dim_names, key))
            else:
                msg = {}
            agg_values = {
                spec_keys[i]: out_lists[i][j] for i in range(len(spec_keys))
            }
            groups.append(
                GroupedTuples(
                    content=[Tuple(emitter="", message=msg, timestamp=ts)],
                    group_key=str(key), window_range=wr, agg_values=agg_values,
                )
            )
        self.emit(GroupedTuplesSet(groups=groups, window_range=wr))

    def _emit_direct(self, outs, active: np.ndarray, wr: WindowRange) -> None:
        """Vectorized tail: HAVING/ORDER/LIMIT/projection computed over the
        finalize arrays; emits the final output messages directly."""
        dim_names = [d.name for d in self.dims]
        dim_cols: Dict[str, np.ndarray] = {}
        if dim_names:
            keys = self.kt.decode_all()
            if len(dim_names) == 1:
                col = np.empty(len(active), dtype=np.object_)
                col[:] = [keys[s] for s in active.tolist()]
                dim_cols[dim_names[0]] = col
            else:
                sel = [keys[s] for s in active.tolist()]
                for i, dn in enumerate(dim_names):
                    col = np.empty(len(active), dtype=np.object_)
                    col[:] = [k[i] for k in sel]
                    dim_cols[dn] = col
        agg_cols = [col[active] for col in outs]
        if self.emit_columnar:
            cb = self.direct_emit.run_columnar(
                dim_cols, agg_cols, wr.window_start, wr.window_end)
            if cb is not None and cb.n:
                self.emit(cb, count=cb.n)
            return
        msgs = self.direct_emit.run(
            dim_cols, agg_cols, wr.window_start, wr.window_end)
        if msgs:
            # always a list of message dicts, never a bare dict
            self.emit(msgs, count=len(msgs))

    # ------------------------------------------------------------------ state
    def snapshot_state(self) -> Optional[dict]:
        """The reference's snapshot format (keys, partials, cur_pane,
        rows_in_window), so a checkpoint crosses between the packages."""
        if self.state is None:
            self.state = self.gb.init_state()
        host = self.gb.state_to_host(self.state)
        return {
            "keys": self.kt.decode_all(),
            "partials": {k: v.tolist() for k, v in host.items()},
            "cur_pane": self.cur_pane,
            "rows_in_window": self._rows_in_window,
        }

    def restore_state(self, state: dict) -> None:
        keys = state.get("keys", [])
        self.kt.restore([tuple(k) if isinstance(k, list) else k for k in keys])
        partials = state.get("partials")
        if partials:
            host, cap = self.gb.host_from_partials(partials)
            self.gb.capacity = cap
            self.state = self.gb.state_from_host(host)
            self.kt.capacity = max(self.kt.capacity, self.gb.capacity)
        self.cur_pane = state.get("cur_pane", 0)
        self._rows_in_window = state.get("rows_in_window", 0)
