"""Multi-rule fused window node: N homogeneous rules, one set of kernel
launches (counterpart of ekuiper_tpu/runtime/nodes_multirule.py).

Extends FusedWindowAggNode with a BatchedGroupBy (a leading rule axis,
parallel/multirule.py) and per-rule output routing: each attached rule
gets its own downstream node (`add_rule_output`), while ingest, key
encode, upload, fold and finalize happen ONCE for the group. This is the
answer to the upstream 300-rules-on-one-stream fan-out deployment.

Boundaries: a processing-time tumbling group launches the stacked
(R, S+1, K) finalize on the state as it stands and hands its copy to the
emit worker (`"mr"` deliveries), so the fold thread resets the pane and
goes on at once; the finalize writes a fresh tensor and its copy follows
the side-stream protocol of ops/prefinalize.py, so the reset launched
next cannot reach it. A hopping group emits synchronously through
`_emit` (the reference's split: BatchedGroupBy has no pre-issue), and so
do count, state and session groups, whose windows the fused node's paths
cut (a count group counts the stream's rows, before any rule's WHERE, as
the reference's group does). A checkpoint keeps the reference's format,
partials (R, panes, cap, k[, W]), so it crosses between the packages;
the fused node's restore reads the capacity through
BatchedGroupBy.host_from_partials, and also restores an open state
window or session (the reference's group restore drops both).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..data.rows import WindowRange
from ..parallel.multirule import BatchedGroupBy, RuleBatchSpec
from ..sql import ast
from .node import Node
from .nodes_fused import FusedWindowAggNode


class MultiRuleFusedNode(FusedWindowAggNode):
    def __init__(
        self,
        name: str,
        window: ast.Window,
        spec: RuleBatchSpec,
        dims: List[ast.FieldRef],
        capacity: int = 16384,
        micro_batch: int = 4096,
        **kw,
    ) -> None:
        if window.window_type == ast.WindowType.SLIDING_WINDOW:
            raise NotImplementedError(
                "a rule group on a SLIDING_WINDOW is not ported")
        self.spec = spec  # before super().__init__: _make_gb reads it
        super().__init__(name, window, spec.plan, dims, capacity=capacity,
                         micro_batch=micro_batch, **kw)
        # boundary emits go through the async worker: one stacked
        # (R, S+1, K) copy per group is tens of MB and must not stall the
        # folds
        self._async_mr = self.wt == ast.WindowType.TUMBLING_WINDOW
        #: rule_id -> downstream entry node (per-rule sink chain); also
        #: connect()-ed so control events (EOF) broadcast to all
        self.rule_outputs: Dict[str, Node] = {}

    def _make_gb(self, plan, capacity: int, micro_batch: int, device):
        return BatchedGroupBy(self.spec, capacity=capacity,
                              n_panes=int(self.n_panes),
                              micro_batch=micro_batch, device=device)

    def add_rule_output(self, rule_id: str, entry: Node) -> None:
        self.rule_outputs[rule_id] = entry
        self.connect(entry)  # control events (EOF) reach every rule chain

    # ------------------------------------------------------------------- emit
    def _emit(self, wr: WindowRange) -> None:
        """Synchronous group emit (hopping boundaries, EOF flush): one
        launch, one copy, every rule."""
        n_keys = self.kt.n_keys
        if n_keys == 0 or self.state is None:
            self.last_emit_info = None
            return
        outs, act = self.gb.finalize(self.state, n_keys)  # (R, K) each
        self.last_emit_info = {"source": "sync", "fetch_ms": 0.0,
                               "ages_ms": []}
        self._emit_rules(outs, act, n_keys, wr)

    def _emit_mr_async(self, wr: WindowRange) -> None:
        """Window-boundary group emit: launch the stacked finalize on the
        state as it stands, start its copy, and hand the delivery to the
        emit worker; the caller resets the pane right after."""
        n_keys = self.kt.n_keys
        if n_keys == 0:
            self.last_emit_info = None
            return
        self._enqueue("mr", self.gb.finalize_begin(self.state, n_keys), wr)

    def _deliver_mr(self, arr: np.ndarray, n_keys: int,
                    wr: WindowRange) -> None:
        """Emit-worker delivery: slice the landed stacked array per rule.
        n_keys was captured at dispatch; keys are append-only, so the first
        n_keys table entries still match the snapshot's slot ids."""
        outs, act = self.gb.host_tail(arr, n_keys)
        self._emit_rules(outs, act, n_keys, wr)

    def _emit_rules(self, outs, act, n_keys: int, wr: WindowRange) -> None:
        """Each attached rule's window (its active keys) to its own node."""
        dim_names = [d.name for d in self.dims]
        keys_arr = np.empty(n_keys, dtype=np.object_)
        keys_arr[:] = self.kt.decode_all()[:n_keys]
        for r, rid in enumerate(self.gb.rule_ids):
            out_node = self.rule_outputs.get(rid)
            if out_node is None:
                continue
            active = np.nonzero(act[r] > 0)[0]
            if len(active) == 0:
                continue
            dim_cols: Dict[str, np.ndarray] = {}
            if dim_names:
                sel = keys_arr[active]
                if len(dim_names) == 1:
                    dim_cols[dim_names[0]] = sel
                else:
                    for i, dn in enumerate(dim_names):
                        col = np.empty(len(active), dtype=np.object_)
                        col[:] = [k[i] for k in sel.tolist()]
                        dim_cols[dn] = col
            agg_cols = [o[r][active] for o in outs]
            if self.emit_columnar:
                cb = self.direct_emit.run_columnar(
                    dim_cols, agg_cols, wr.window_start, wr.window_end)
                if cb is not None and cb.n:
                    self.send_to(out_node, cb)
            else:
                msgs = self.direct_emit.run(
                    dim_cols, agg_cols, wr.window_start, wr.window_end)
                if msgs:
                    # always a list (the fused node's emission contract)
                    self.send_to(out_node, msgs)
