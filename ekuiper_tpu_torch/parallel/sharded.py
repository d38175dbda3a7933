"""Sharded GROUP BY aggregation on a (rows, keys) device mesh (counterpart
of ekuiper_tpu/parallel/sharded.py `ShardedGroupBy`).

Layout, as the reference's:

- a batch's rows are split over "rows": row shard r owns rows [r·m, (r+1)·m)
  of each micro-batch chunk, m = micro_batch / R (micro_batch rounded up to
  a multiple of R);
- the key capacity is split over "keys": key shard k owns the slot range
  [k·c, (k+1)·c), c = capacity / K (capacity rounded up to a multiple of
  K);
- the fold: every (row shard, key shard) folds its rows whose slot lies in
  its range into a fresh identity partial, then one psum / pmin / pmax per
  component merges the row shards into the state;
- finalize, pane reset, components, checkpoints: the single-chip code
  (the reference inherits them from DeviceGroupBy as well).

The port's mesh is one device (parallel/mesh.py): the state is ONE tensor
per component in the single-chip layout {comp: (P, capacity, k[, W])},
key shard k its contiguous slice, not replicated R times (replication
over "rows" is a placement that changes no result). The partials hold one
block per row shard, and every shard and column of a chunk folds in one
launch (`sharded_fold`), merged by one more (`shard_merge`),
csrc/sharded.cu. A snapshot is byte-compatible with both
packages and with any mesh size. Not ported: the shard registry and its
metrics (`render_prometheus`, `diagnostics`), which wait for the port's
observability (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..ops import kernels
from ..ops.aggspec import WIDE_COMPONENTS, KernelPlan
from ..ops.groupby import TorchGroupBy
from .mesh import Mesh

_INIT = kernels.INIT


class ShardedGroupBy(TorchGroupBy):
    """Group-by aggregation over a ("rows", "keys") mesh of one device.

    State layout matches TorchGroupBy: {comp: (n_panes, capacity, k[, W])},
    act (n_panes, capacity), touch (capacity,) uint32 with track_touch;
    capacity is a multiple of the key shards, micro_batch of the row
    shards.
    """

    watch_prefix = "sharded"
    #: boundaries stay synchronous, as the reference keeps them (its
    #: finalize gathers across the mesh)
    supports_prefinalize = False

    def __init__(self, plan: KernelPlan, mesh: Mesh, capacity: int = 16384,
                 n_panes: int = 1, micro_batch: int = 4096,
                 track_touch: bool = False) -> None:
        if any(s.kind == "heavy_hitters" for s in plan.specs):
            raise ValueError("heavy_hitters state is node-local (its value "
                             "dictionary): it never runs on a mesh")
        self.mesh = mesh
        self.n_keys_shards = K = int(mesh.shape["keys"])
        self.n_row_shards = R = int(mesh.shape["rows"])
        # capacity / micro_batch rounded up to even division across shards
        super().__init__(plan, capacity=self._round(capacity),
                         n_panes=n_panes,
                         micro_batch=-(-int(micro_batch) // R) * R,
                         device=mesh.device, track_touch=track_touch)
        self.mesh_tag = f"{R}x{K}"
        self.rows_per_shard = self.micro_batch // R
        # the row shards' identity partials, per panes a block holds (1:
        # the scalar pane; n_panes: the pane vector), at self.capacity
        self._parts: Dict[int, Dict[str, torch.Tensor]] = {}
        # rows folded into each key shard's range, counted on the host off
        # the slot vector, and a key-occupancy hint the node refreshes
        self.shard_rows = np.zeros(K, dtype=np.int64)
        self.n_keys_hint = 0

    def _round(self, capacity: int) -> int:
        K = self.n_keys_shards
        return -(-int(capacity) // K) * K

    # ------------------------------------------------------------------ state
    def grow(self, state: Dict[str, torch.Tensor],
             new_capacity: int) -> Dict[str, torch.Tensor]:
        """Raise the key capacity (rounded up to the key shards); slot s
        then lies in key shard s // (capacity / K), so the ranges shift."""
        return super().grow(state, self._round(new_capacity))

    def state_from_host(self, host: Dict[str, np.ndarray]
                        ) -> Dict[str, torch.Tensor]:
        """State from a snapshot of either package and any mesh size: a
        capacity that does not divide this mesh's K is padded up with each
        component's identity (the extra slots are unassigned; the key
        table's dense slot ids do not depend on the placement). The touch
        column keeps key axis 0 and its uint32 dtype."""
        out: Dict[str, np.ndarray] = {}
        cap = None
        for comp, v in host.items():
            arr = np.asarray(v)
            axis = 0 if comp == "touch" else 1
            c = arr.shape[axis]
            rounded = self._round(c)
            if rounded != c:
                pad_shape = list(arr.shape)
                pad_shape[axis] = rounded - c
                arr = np.concatenate(
                    [arr, np.full(pad_shape, _INIT.get(comp, 0.0),
                                  dtype=arr.dtype)], axis=axis)
            cap = rounded if cap is None else max(cap, rounded)
            out[comp] = arr
        state = super().state_from_host(out)
        if cap is not None:
            self.capacity = int(cap)
        return state

    # ------------------------------------------------------------------- fold
    def fold(self, state: Dict[str, torch.Tensor], cols, slots, valid=None,
             pane_idx=0, n_rows: Optional[int] = None
             ) -> Dict[str, torch.Tensor]:
        """TorchGroupBy.fold (host arrays in chunks of micro_batch, or one
        pre-padded device chunk), each chunk through the sharded kernels;
        a host slot vector also counts the rows of each key shard."""
        if isinstance(slots, np.ndarray):
            self.note_rows(slots, n_rows)
        return super().fold(state, cols, slots, valid, pane_idx, n_rows)

    def fold_masked_many(self, state, segments, pane_idx):
        """The masked fold (#2) reads a single-chip state: a sharded
        rule's refolds take host rows through fold (the reference's)."""
        raise NotImplementedError(
            "the masked fold does not run on a sharded state; the sharded "
            "refold path folds host rows")

    def _partials(self, n_panes: int) -> Dict[str, torch.Tensor]:
        """The row shards' identity partials of blocks of `n_panes` panes,
        made at first use and again after a grow, and kept (each merge
        leaves them at the identity): R / P times the state's bytes for the
        scalar pane, R times for the pane vector's blocks."""
        parts = self._parts.get(n_panes)
        if parts is not None and parts["act"].shape[1] == self.capacity:
            return parts
        R, C = self.n_row_shards, self.capacity
        lead = (R * n_panes, C)
        parts = {}
        for comp, idxs in self.comp_specs.items():
            shape = lead + (len(idxs),)
            if comp in WIDE_COMPONENTS:
                shape = shape + (kernels.WIDE_W[comp],)
            parts[comp] = torch.full(shape, _INIT[comp], dtype=torch.float32,
                                     device=self.device)
        parts["act"] = torch.zeros(lead, dtype=torch.float32,
                                   device=self.device)
        if self.track_touch:
            parts["touch"] = torch.zeros((R, C), dtype=torch.uint32,
                                         device=self.device)
        self._parts[n_panes] = parts
        return parts

    def _fold_chunk(self, state: Dict[str, torch.Tensor],
                    cols: Dict[str, torch.Tensor], n: int,
                    slots: torch.Tensor, pane: int,
                    pane_vec: Optional[torch.Tensor],
                    pane_hi: Optional[int] = None) -> None:
        """One chunk: the closures, the sharded fold of every (row shard,
        key shard) into the partials (one launch), then the merge into the
        state (pane `pane`, or every pane under a pane vector)."""
        base, V, M = self.spec_inputs(cols, n)
        parts = self._partials(1 if pane_vec is None else self.n_panes)
        R, m = self.n_row_shards, self.rows_per_shard
        kernels.sharded_fold(parts, base, V, M, slots, m, R,
                             self.n_keys_shards, self._colmap, self._widemap,
                             pane_vec)
        kernels.shard_merge(state, parts, pane, R)

    # ---------------------------------------------------------- observability
    def note_rows(self, slots: np.ndarray, n: Optional[int] = None,
                  n_keys: Optional[int] = None) -> None:
        """Accrue the rows of each key shard off a host slot vector (the
        shard of slot s is s // (capacity / K)); `n_keys` refreshes the
        occupancy hint."""
        if n is not None:
            slots = slots[:n]
        if n_keys is not None:
            self.n_keys_hint = int(n_keys)
        if len(slots) == 0:
            return
        K = self.n_keys_shards
        c = max(self.capacity // K, 1)
        shard = np.minimum(np.asarray(slots, dtype=np.int64) // c, K - 1)
        self.shard_rows += np.bincount(shard, minlength=K)[:K]

    def shard_stats(self, state: Optional[Dict[str, Any]] = None
                    ) -> List[Dict[str, Any]]:
        """Per key shard: rows folded into its range, key slots it holds
        (from the occupancy hint), its slots and its share of the state's
        bytes. Host arithmetic only."""
        K = self.n_keys_shards
        c = max(self.capacity // K, 1)
        state_bytes = 0
        if state is not None:
            state_bytes = sum(t.numel() * t.element_size()
                              for t in state.values())
        return [{"shard": i, "rows": int(self.shard_rows[i]),
                 "keys": int(min(max(self.n_keys_hint - i * c, 0), c)),
                 "slots": c, "state_bytes": state_bytes // K}
                for i in range(K)]

    def collective_bytes_per_fold(self) -> int:
        """Bytes ONE fold's merge over "rows" would move per device as a
        ring all-reduce of the (n_panes, capacity/K, k) partials, ~2(R-1)/R
        of their bytes; 0 for R = 1 (the reference's estimate; on one
        device the merge moves them through its memory instead)."""
        R = self.n_row_shards
        if R <= 1:
            return 0
        c = max(self.capacity // max(self.n_keys_shards, 1), 1)
        elems = self.n_panes * c
        for comp, idxs in self.comp_specs.items():
            w = kernels.WIDE_W[comp] if comp in WIDE_COMPONENTS else 1
            elems += self.n_panes * c * len(idxs) * w
        return int(2 * (R - 1) / R * elems * 4)
