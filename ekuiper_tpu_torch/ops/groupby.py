"""Fused GROUP BY aggregation state and its fold / finalize / reset
(counterpart of ekuiper_tpu/ops/groupby.py `DeviceGroupBy`).

Per-key partial state lives in dense tensors of shape (n_panes, capacity,
k) — one column per aggregate spec, one pane per window sub-interval:

- TUMBLING windows: 1 pane, reset after emit.
- HOPPING windows: P = length/interval panes; emit merges the live panes,
  expiry resets one pane.

State components per spec: n (count), s1 (sum), s2 (sum of squares), mn
(min), mx (max), plus `act` (rows per key per pane after WHERE). Keys,
shapes, dtypes and identities are the reference's, so a `state_to_host`
snapshot of either package restores in the other.

Unlike the reference (pure functions over immutable jax arrays, state
buffers donated to each call), the fold and the pane reset update the
state tensors IN PLACE — no second copy of the state exists. The methods
still return the state dict, so callers read exactly as they read the
reference.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.device import Device, resolve_device
from . import kernels
from .aggspec import KernelPlan

_INIT = kernels.INIT


def apply_int_semantics(specs, host: List[np.ndarray]) -> List[np.ndarray]:
    """Reference-exact integer semantics on finalize output: counts are
    int64; integer-typed inputs get truncating avg / integral sum/min/max.
    Shared by the single-chip and sharded paths so results are identical
    regardless of placement."""
    for i, spec in enumerate(specs):
        if spec.kind in ("count", "hll"):
            host[i] = host[i].astype(np.int64)
        elif spec.int_input and spec.kind in ("sum", "avg", "min", "max"):
            with np.errstate(invalid="ignore"):
                trunc = np.trunc(host[i])
            host[i] = np.where(np.isnan(host[i]), np.nan, trunc)
    return host


def observe_int_inputs(specs, columns: Dict[str, np.ndarray]) -> None:
    """Record integer-typed agg inputs (drives apply_int_semantics)."""
    for spec in specs:
        if spec.arg is not None and len(spec.arg.columns) == 1:
            (col_name,) = spec.arg.columns
            col = columns.get(col_name)
            if col is not None and np.issubdtype(col.dtype, np.integer):
                spec.int_input = True


def _as_mask(x, n: int, device: torch.device) -> torch.Tensor:
    """A closure's boolean result (tensor or Python/numpy bool) as a
    bool (n,) tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.bool).expand(n)
    return torch.full((n,), bool(x), dtype=torch.bool, device=device)


def _as_values(x, n: int, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).expand(n)
    return torch.full((n,), float(x), dtype=torch.float32, device=device)


class TorchGroupBy:
    """Group-by aggregation state on one device + its kernels. `device`
    defaults to CUDA and raises without a card unless it is "cpu"."""

    def __init__(self, plan: KernelPlan, capacity: int = 16384,
                 n_panes: int = 1, micro_batch: int = 4096,
                 device: Device = None) -> None:
        self.plan = plan
        self.capacity = int(capacity)
        self.n_panes = int(n_panes)
        self.micro_batch = int(micro_batch)
        self.device = resolve_device(device)
        # component -> ordered spec indices holding a column in that array
        self.comp_specs: Dict[str, List[int]] = {}
        for i, spec in enumerate(plan.specs):
            for comp in sorted(spec.components):
                self.comp_specs.setdefault(comp, []).append(i)
        self._colmap = kernels.column_map(self.comp_specs)
        self._spectab = kernels.spec_table([s.kind for s in plan.specs],
                                           self.comp_specs)
        self._masks: Dict[Tuple[bool, ...], torch.Tensor] = {}

    # ------------------------------------------------------------------ state
    def init_state(self) -> Dict[str, torch.Tensor]:
        state: Dict[str, torch.Tensor] = {}
        for comp, spec_idxs in self.comp_specs.items():
            shape = (self.n_panes, self.capacity, len(spec_idxs))
            state[comp] = torch.full(shape, _INIT[comp], dtype=torch.float32,
                                     device=self.device)
        # activity: rows per key per pane (post-WHERE), for group existence
        state["act"] = torch.zeros((self.n_panes, self.capacity),
                                   dtype=torch.float32, device=self.device)
        return state

    def grow(self, state: Dict[str, torch.Tensor],
             new_capacity: int) -> Dict[str, torch.Tensor]:
        """Raise the key capacity, preserving partials, on the device."""
        out: Dict[str, torch.Tensor] = {}
        for comp, arr in state.items():
            pad_shape = list(arr.shape)
            pad_shape[1] = new_capacity - arr.shape[1]
            pad = torch.full(pad_shape, _INIT[comp], dtype=arr.dtype,
                             device=arr.device)
            out[comp] = torch.cat([arr, pad], dim=1)
        self.capacity = int(new_capacity)
        return out

    # ------------------------------------------------------------------- fold
    def _upload(self, arr: np.ndarray, dtype) -> torch.Tensor:
        """Host column → tensor on the device: through a pinned staging
        buffer and a non-blocking copy on a CUDA device (the caching host
        allocator keeps the buffer alive until the copy has run)."""
        host = torch.from_numpy(np.ascontiguousarray(arr, dtype=dtype))
        if self.device.type != "cuda":
            return host
        pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        pinned.copy_(host)
        return pinned.to(self.device, non_blocking=True)

    def spec_inputs(self, cols: Dict[str, torch.Tensor], n: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(base (n,), V (S, n), M (S, n)) for one chunk of device columns:
        the row mask after WHERE, and each spec's float32 argument and its
        mask (base ∧ column validity ∧ not NaN ∧ FILTER) — the closure work
        of the reference's _fold_core, done by torch before the launch."""
        dev = self.device
        base = torch.ones(n, dtype=torch.bool, device=dev)
        if self.plan.filter is not None:
            base = base & _as_mask(self.plan.filter(cols), n, dev)
        vs, ms = [], []
        for spec in self.plan.specs:
            if spec.arg is None:
                v = torch.ones(n, dtype=torch.float32, device=dev)
                m = base
            else:
                v = _as_values(spec.arg(cols), n, dev)
                m = base
                for col in spec.arg.columns:
                    vm = cols.get("__valid_" + col)
                    if vm is not None:
                        m = m & vm
                m = m & ~torch.isnan(v)
            if spec.filter is not None:
                m = m & _as_mask(spec.filter(cols), n, dev)
            vs.append(v)
            ms.append(m)
        return base.contiguous(), torch.stack(vs), torch.stack(ms)

    def fold(self, state: Dict[str, torch.Tensor], cols: Dict[str, np.ndarray],
             slots: np.ndarray, valid: Optional[Dict[str, np.ndarray]] = None,
             pane_idx=0, n_rows: Optional[int] = None
             ) -> Dict[str, torch.Tensor]:
        """Fold a host micro-batch into the partials, in place.

        cols: numeric columns referenced by the kernel plan (numpy).
        slots: int32 key slot per row. valid: optional per-column masks.
        pane_idx: the destination pane (a scalar: processing-time windows).
        Rows are folded in chunks of at most `micro_batch`.
        """
        if isinstance(pane_idx, np.ndarray):
            raise NotImplementedError(
                "per-row panes (event-time windows) are not ported yet")
        pane = int(pane_idx)
        if not 0 <= pane < self.n_panes:
            raise ValueError(f"pane {pane} outside [0, {self.n_panes})")
        n = n_rows if n_rows is not None else len(slots)
        slots = np.asarray(slots)
        if n and (slots[:n].min() < 0 or slots[:n].max() >= self.capacity):
            raise ValueError(
                f"slot outside [0, {self.capacity}): grow the state first")
        valid = valid or {}
        mb = self.micro_batch
        for start in range(0, n, mb):
            end = min(start + mb, n)
            cnt = end - start
            dev_cols: Dict[str, torch.Tensor] = {}
            for name in self.plan.columns:
                dev_cols[name] = self._upload(
                    cols[name][start:end], np.float32)
                vm = valid.get(name)
                if vm is not None:
                    dev_cols["__valid_" + name] = self._upload(
                        vm[start:end], np.bool_)
            s_dev = self._upload(slots[start:end], np.int32)
            base, V, M = self.spec_inputs(dev_cols, cnt)
            kernels.groupby_fold_scalar(state, base, V, M, s_dev, pane,
                                        self._colmap)
        return state

    # --------------------------------------------------------------- finalize
    def _pane_mask(self, panes: Optional[List[int]]) -> torch.Tensor:
        pm = np.zeros(self.n_panes, dtype=np.bool_)
        if panes is None:
            pm[:] = True
        else:
            pm[panes] = True
        key = tuple(pm.tolist())
        t = self._masks.get(key)
        if t is None:  # one small upload per distinct mask, then cached
            t = self._masks[key] = torch.from_numpy(pm).to(self.device)
        return t

    def finalize(self, state: Dict[str, torch.Tensor], n_keys: int,
                 panes: Optional[List[int]] = None
                 ) -> Tuple[List[np.ndarray], np.ndarray]:
        """Emit final aggregate values for slots [0, n_keys).

        Returns (per-spec value arrays, active-row-count array); keys with
        active == 0 did not appear in this window and must not emit a group.
        NaN encodes NULL for empty-group sum/avg/min/max. The stacked
        result crosses to the host in ONE copy.
        """
        stacked = kernels.groupby_finalize_scalar(
            state, self._pane_mask(panes), self._spectab).cpu().numpy()
        host = [stacked[i][:n_keys] for i in range(len(self.plan.specs))]
        host = apply_int_semantics(self.plan.specs, host)
        return host, stacked[-1][:n_keys]

    # ------------------------------------------------------------------ reset
    def reset_pane(self, state: Dict[str, torch.Tensor],
                   pane_idx: int) -> Dict[str, torch.Tensor]:
        kernels.groupby_reset_pane(state, int(pane_idx))
        return state

    def reset_all(self, state: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        return self.init_state()

    # ------------------------------------------------------------- dtype note
    def observe_dtypes(self, columns: Dict[str, np.ndarray]) -> None:
        """Record integer-typed agg inputs for reference-exact finalize."""
        observe_int_inputs(self.plan.specs, columns)

    # ---------------------------------------------------------- checkpointing
    def state_to_host(self, state: Dict[str, torch.Tensor]
                      ) -> Dict[str, np.ndarray]:
        """Numpy copies of the state (the reference's snapshot format)."""
        return {k: v.to("cpu", copy=True).numpy() for k, v in state.items()}

    def state_from_host(self, host: Dict[str, np.ndarray]
                        ) -> Dict[str, torch.Tensor]:
        """State tensors from a snapshot of either package. A reference
        snapshot's `touch` column (tiered key state) is dropped: the port
        keeps no tiered state."""
        want = set(self.comp_specs) | {"act"}
        got = set(host) - {"touch"}
        if got != want:
            raise ValueError(f"snapshot components {sorted(got)} do not "
                             f"match this plan's {sorted(want)}")
        return {k: torch.tensor(np.asarray(v), dtype=torch.float32,
                                device=self.device)
                for k, v in host.items() if k != "touch"}

    def host_from_partials(self, partials: Dict[str, object]
                           ) -> Tuple[Dict[str, np.ndarray], int]:
        """Checkpoint partials -> (float32 host arrays, capacity)."""
        host = {k: np.asarray(v, dtype=np.float32)
                for k, v in partials.items() if k != "touch"}
        return host, host["act"].shape[1]
