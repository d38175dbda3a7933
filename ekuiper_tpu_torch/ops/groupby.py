"""Fused GROUP BY aggregation state and its fold / finalize / reset
(counterpart of ekuiper_tpu/ops/groupby.py `DeviceGroupBy`).

Per-key partial state lives in dense tensors of shape (n_panes, capacity,
k) — one column per aggregate spec, one pane per window sub-interval —
and (n_panes, capacity, k, W) for the sketch components:

- TUMBLING windows: 1 pane, reset after emit.
- HOPPING windows: P = length/interval panes; emit merges the live panes,
  expiry resets one pane.
- SLIDING windows: one pane per time bucket plus a scratch pane, into
  which the refold path refolds a trigger's edge buckets (`fold_masked`,
  over batches kept on the device) before finalizing an arbitrary pane
  mask (`finalize_begin`).

State components per spec: n (count), s1 (sum), s2 (sum of squares), mn
(min), mx (max), the wide hll (HyperLogLog registers, W 256), hist
(log-histogram, W 1,024) and hh (heavy-hitters counters, W 2,688), plus
`act` (rows per key per pane after WHERE) and, for tiered key state
(`track_touch`, ops/tierstore.py), `touch`: a uint32 (capacity,) count of
each slot's rows after WHERE, bumped by the fold, kept across pane resets,
the placement policy's recency signal. Keys,
shapes, dtypes and identities are the reference's, so a `state_to_host`
snapshot of either package restores in the other.

Unlike the reference (pure functions over immutable jax arrays, state
buffers donated to each call), the fold, the pane reset and the absorb
update the state tensors IN PLACE — no second copy of the state exists.
The methods still return the state dict, so callers read exactly as they
read the reference. What the reference gets from immutability, a
snapshot that later folds cannot disturb, the port gets from its kernels
writing fresh output tensors on the compute stream, in order with the
folds (see ops/prefinalize.py).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import Device, resolve_device
from . import kernels
from .aggspec import WIDE_COMPONENTS, KernelPlan, materialize_hll_columns
from .prefinalize import (DeferredFetch, FetchPool, PendingFinalize,
                          begin_pending, final_value_np, hh_dedupe_topk,
                          merge_components)

_INIT = kernels.INIT


def col_np_dtype(plan: KernelPlan, name: str):
    """Upload dtype of one kernel column (the reference's): float32 unless
    the plan declares otherwise; every column the port plans is float32."""
    return np.dtype(getattr(plan, "col_dtypes", {}).get(name, "float32"))


def slot_dtype(capacity: int):
    """Slot-vector dtype for a key capacity (the reference's): uint16 while
    every slot id (0..capacity-1) fits, int32 past 65,535. A cached sliding
    batch keeps the dtype it was uploaded with: after a doubling past the
    boundary its uint16 slots still index the same dense slots."""
    return np.uint16 if capacity <= 65535 else np.int32


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


def _as_mask(x, shape, device: torch.device) -> torch.Tensor:
    """A closure's boolean result (tensor or Python/numpy bool) as a bool
    tensor of `shape` ((n,) rows, or (R, n) under a rule group's (R, 1)
    parameters), broadcast and contiguous."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.bool).expand(shape).contiguous()
    return torch.full(shape, bool(x), dtype=torch.bool, device=device)


def _as_values(x, n: int, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).expand(n)
    return torch.full((n,), float(x), dtype=torch.float32, device=device)


class TorchGroupBy:
    """Group-by aggregation state on one device + its kernels. `device`
    defaults to CUDA and raises without a card unless it is "cpu"."""

    #: the latency-hiding emit pipeline (ops/prefinalize.py) works here
    supports_prefinalize = True
    #: fold() takes pre-padded device tensors (the sliding refold's cached
    #: uploads)
    accepts_device_inputs = True

    def __init__(self, plan: KernelPlan, capacity: int = 16384,
                 n_panes: int = 1, micro_batch: int = 4096,
                 device: Device = None, track_touch: bool = False) -> None:
        self.plan = plan
        self.capacity = int(capacity)
        self.n_panes = int(n_panes)
        self.micro_batch = int(micro_batch)
        self.device = resolve_device(device)
        # tiered key state: a per-slot uint32 touch column rides the state
        # and is bumped by the fold kernel (no host sync)
        self.track_touch = bool(track_touch)
        # component -> ordered spec indices holding a column in that array
        self.comp_specs: Dict[str, List[int]] = {}
        for i, spec in enumerate(plan.specs):
            for comp in sorted(spec.components):
                self.comp_specs.setdefault(comp, []).append(i)
        self._colmap = kernels.column_map(self.comp_specs)
        self._widemap = kernels.wide_column_map(self.comp_specs)
        # heavy_hitters plans finalize to the reference's compact layout
        # (groupby.py _hh_finalize_impl): 2·k2 rows of recovered (codes,
        # estimates) per hh spec, one final-value row per other spec, act
        # last; the top-k lists are assembled on the host (hh_assemble)
        self._host_finalize_only = any(
            s.kind == "heavy_hitters" for s in plan.specs)
        rows, row = [], 0
        widetab, fracs, hhtab = [], [], []
        for i, spec in enumerate(plan.specs):
            rows.append(row)
            if spec.kind == "heavy_hitters":
                hhtab.append((self.comp_specs["hh"].index(i),
                              2 * spec.topk, row))
                row += 4 * spec.topk
                continue
            if spec.kind == "hll":
                widetab.append((kernels.WIDE_KIND_IDS["hll"],
                                self.comp_specs["hll"].index(i), row))
                fracs.append(0.0)
            elif spec.kind == "percentile_approx":
                widetab.append((kernels.WIDE_KIND_IDS["percentile_approx"],
                                self.comp_specs["hist"].index(i), row))
                fracs.append(spec.frac)
            row += 1
        self._rows = row + 1  # act last
        self._spectab = kernels.spec_table([s.kind for s in plan.specs],
                                           self.comp_specs, rows)
        self._widetab = np.asarray(widetab, dtype=np.int32).reshape(-1, 3)
        self._fracs = np.asarray(fracs, dtype=np.float32)
        self._hhtab = np.asarray(hhtab, dtype=np.int32).reshape(-1, 3)
        self._masks: Dict[Tuple[bool, ...], torch.Tensor] = {}
        self._comp_order = [comp for comp, *_ in self._components_layout()]
        self._fetch: Optional[FetchPool] = None  # built at the first fetch

    # ------------------------------------------------------------------ state
    def _lead(self) -> Tuple[int, ...]:
        """Axes of every state tensor before (panes, capacity): none for one
        rule (a rule group's BatchedGroupBy has its rule axis here)."""
        return ()

    def init_state(self) -> Dict[str, torch.Tensor]:
        lead = (*self._lead(), self.n_panes, self.capacity)
        state: Dict[str, torch.Tensor] = {}
        for comp, spec_idxs in self.comp_specs.items():
            shape = lead + (len(spec_idxs),)
            if comp in WIDE_COMPONENTS:
                shape = shape + (kernels.WIDE_W[comp],)
            state[comp] = torch.full(shape, _INIT[comp], dtype=torch.float32,
                                     device=self.device)
        # activity: rows per key per pane (post-WHERE), for group existence
        state["act"] = torch.zeros(lead, dtype=torch.float32,
                                   device=self.device)
        if self.track_touch:
            state["touch"] = torch.zeros((self.capacity,),
                                         dtype=torch.uint32,
                                         device=self.device)
        return state

    def grow(self, state: Dict[str, torch.Tensor],
             new_capacity: int) -> Dict[str, torch.Tensor]:
        """Raise the key capacity, preserving partials, on the device (a
        heavy-hitters state is hundreds of MB: no host round trip)."""
        axis = len(self._lead()) + 1
        out: Dict[str, torch.Tensor] = {}
        for comp, arr in state.items():
            pad_shape = list(arr.shape)
            if comp == "touch":  # (capacity,): the key axis is axis 0
                # (a slice copy: torch has few uint32 kernels on CUDA)
                out[comp] = torch.zeros(new_capacity, dtype=arr.dtype,
                                        device=arr.device)
                out[comp][:len(arr)].copy_(arr)
                continue
            pad_shape[axis] = new_capacity - arr.shape[axis]
            pad = torch.full(pad_shape, _INIT[comp], dtype=arr.dtype,
                             device=arr.device)
            out[comp] = torch.cat([arr, pad], dim=axis)
        self.capacity = int(new_capacity)
        return out

    # ------------------------------------------------------------------- fold
    def upload(self, arr: np.ndarray, dtype) -> torch.Tensor:
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
        base = self._where(cols, (n,))
        V, M = self._spec_values(cols, n)
        return base, V, M & base

    def _where(self, cols: Dict[str, torch.Tensor], shape) -> torch.Tensor:
        """The row mask after WHERE, of `shape`."""
        if self.plan.filter is None:
            return torch.ones(shape, dtype=torch.bool, device=self.device)
        return _as_mask(self.plan.filter(cols), shape, self.device)

    def _spec_values(self, cols: Dict[str, torch.Tensor], n: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(V (S, n), M (S, n)): each spec's float32 argument and its mask
        without the row mask (column validity ∧ not NaN ∧ FILTER)."""
        dev = self.device
        vs, ms = [], []
        for spec in self.plan.specs:
            m = torch.ones(n, dtype=torch.bool, device=dev)
            if spec.arg is None:
                v = torch.ones(n, dtype=torch.float32, device=dev)
            else:
                v = _as_values(spec.arg(cols), n, dev)
                for col in spec.arg.columns:
                    vm = cols.get("__valid_" + col)
                    if vm is not None:
                        m = m & vm
                m = m & ~torch.isnan(v)
            if spec.filter is not None:
                m = m & _as_mask(spec.filter(cols), (n,), dev)
            vs.append(v)
            ms.append(m)
        return torch.stack(vs), torch.stack(ms)

    def fold(self, state: Dict[str, torch.Tensor], cols: Dict[str, np.ndarray],
             slots: np.ndarray, valid: Optional[Dict[str, np.ndarray]] = None,
             pane_idx=0, n_rows: Optional[int] = None
             ) -> Dict[str, torch.Tensor]:
        """Fold a host micro-batch into the partials, in place.

        cols: numeric columns referenced by the kernel plan (numpy).
        slots: int32 key slot per row. valid: optional per-column masks.
        pane_idx: the destination pane, a scalar, or a per-row array (a
        sliding batch that crosses a bucket edge routes each row to its
        bucket's pane; shipped as uint8, as the reference ships it).
        Rows are folded in chunks of at most `micro_batch`.

        Pre-uploaded device inputs (the reference's shared-upload branch):
        cols, valid and slots as tensors on the state's device, padded to
        `micro_batch`, slots uint16 or int32, with `n_rows` real rows. They
        fold as one chunk, with no second upload.
        """
        if isinstance(slots, torch.Tensor):
            return self._fold_device(state, cols, slots, valid or {},
                                     pane_idx, n_rows)
        n = n_rows if n_rows is not None else len(slots)
        pane_vec = pane_hi = None
        if isinstance(pane_idx, np.ndarray):
            pane_vec = np.asarray(pane_idx)[:n]
            pane = 0
            if n:
                pane_hi = int(pane_vec.max())
                if pane_vec.min() < 0 or pane_hi >= self.n_panes:
                    raise ValueError(f"pane outside [0, {self.n_panes})")
            pane_vec = pane_vec.astype(np.uint8)
        else:
            pane = int(pane_idx)
            if not 0 <= pane < self.n_panes:
                raise ValueError(f"pane {pane} outside [0, {self.n_panes})")
        slots = np.asarray(slots)
        if n and (slots[:n].min() < 0 or slots[:n].max() >= self.capacity):
            raise ValueError(
                f"slot outside [0, {self.capacity}): grow the state first")
        valid = valid or {}
        cols = materialize_hll_columns(self.plan.columns, cols, n)
        mb = self.micro_batch
        for start in range(0, n, mb):
            end = min(start + mb, n)
            cnt = end - start
            dev_cols: Dict[str, torch.Tensor] = {}
            for name in self.plan.columns:
                dev_cols[name] = self.upload(
                    cols[name][start:end], np.float32)
                vm = valid.get(name)
                if vm is not None:
                    dev_cols["__valid_" + name] = self.upload(
                        vm[start:end], np.bool_)
            s_dev = self.upload(slots[start:end], np.int32)
            p_dev = (None if pane_vec is None
                     else self.upload(pane_vec[start:end], np.uint8))
            self._fold_chunk(state, dev_cols, cnt, s_dev, pane, p_dev,
                             pane_hi)
        return state

    def _fold_device(self, state: Dict[str, torch.Tensor],
                     cols: Dict[str, torch.Tensor], slots: torch.Tensor,
                     valid: Dict[str, torch.Tensor], pane_idx,
                     n_rows: Optional[int]) -> Dict[str, torch.Tensor]:
        """fold() of pre-padded device inputs: their first n_rows rows
        (views, so no copy) as one chunk."""
        n = int(n_rows) if n_rows is not None else len(slots)
        if n > self.micro_batch or n > len(slots):
            raise ValueError(f"pre-uploaded inputs hold one chunk of at most "
                             f"{self.micro_batch} rows, got {n}")
        pane, p_dev, pane_hi = 0, None, None
        if isinstance(pane_idx, np.ndarray):
            pv = np.asarray(pane_idx)[:n]
            if n:
                pane_hi = int(pv.max())
                if pv.min() < 0 or pane_hi >= self.n_panes:
                    raise ValueError(f"pane outside [0, {self.n_panes})")
            p_dev = self.upload(pv, np.uint8)
        else:
            pane = int(pane_idx)
            if not 0 <= pane < self.n_panes:
                raise ValueError(f"pane {pane} outside [0, {self.n_panes})")
        if n == 0:
            return state
        dev_cols = {name: cols[name][:n] for name in self.plan.columns}
        for name, vm in valid.items():
            if vm is not None:
                dev_cols["__valid_" + name] = vm[:n]
        self._fold_chunk(state, dev_cols, n, slots[:n], pane, p_dev, pane_hi)
        return state

    def fold_masked(self, state: Dict[str, torch.Tensor],
                    dev_cols: Dict[str, Optional[torch.Tensor]],
                    slots_dev: torch.Tensor, mask: np.ndarray,
                    pane_idx: int) -> Dict[str, torch.Tensor]:
        """Refold a cached pre-padded device batch into pane `pane_idx`
        under a host (micro_batch,) bool row mask, in place (the
        reference's fold_masked; rows outside the mask, the padding among
        them, contribute nothing): fold_masked_many of one segment."""
        if len(mask) != len(slots_dev):
            raise ValueError(f"row mask of {len(mask)} for a batch of "
                             f"{len(slots_dev)}")
        return self.fold_masked_many(state, [(dev_cols, slots_dev, mask)],
                                     pane_idx)

    def fold_masked_many(self, state: Dict[str, torch.Tensor],
                         segments: Sequence[Tuple[
                             Dict[str, Optional[torch.Tensor]], torch.Tensor,
                             np.ndarray]],
                         pane_idx: int) -> Dict[str, torch.Tensor]:
        """Refold cached pre-padded device batches into pane `pane_idx`,
        each under its host bool row mask, in place: the reference's
        fold_masked of each segment in turn, in one masked-fold (#2) launch
        a group of segments.

        segments: (dev_cols, slots_dev, mask) each, dev_cols every plan
        column and its `__valid_<col>` mask (None where absent), as
        cached, mask one bool a row of slots_dev, or fewer (the rows past
        it, a batch's padding, are off). Every mask crosses to the card
        in ONE pinned, non-blocking copy, packed eight rows a byte. The
        segments go in groups of consecutive segments whose columns,
        slots, values and masks take at most FOLD_MASKED_GROUP_BYTES (64
        MB; a segment alone past it is a group of its own). A group's
        columns and slots are concatenated (the slots as int32 where the
        group mixes uint16 and int32), a transient device copy within that
        bound (a group of one segment reads its cached tensors in place);
        its closures (WHERE, each spec's value and mask) run once over
        them, then one launch folds the group."""
        pane = int(pane_idx)
        if not 0 <= pane < self.n_panes:
            raise ValueError(f"pane {pane} outside [0, {self.n_panes})")
        segs, masks = [], []
        for dev_cols, slots_dev, mask in segments:
            if len(mask) > len(slots_dev):
                raise ValueError(f"row mask of {len(mask)} for a batch of "
                                 f"{len(slots_dev)}")
            segs.append(({k: v for k, v in dev_cols.items()
                          if v is not None}, slots_dev))
            masks.append(mask)
        if not segs:
            return state
        rows = [len(s) for _, s in segs]
        packed, first = self._upload_masks(masks, rows)
        j = 0
        for group in self._masked_groups(segs):
            k = j + len(group)
            n = sum(rows[j:k])
            if len(group) == 1:
                cols, slots = group[0]
            else:
                cols = self._concat_columns(group)
                slots = concat_slots([s for _, s in group])
            base = self._where(cols, (n,)) & self._unpack_rows(
                packed, first[j:k], rows[j:k])
            V, M = self._spec_values(cols, n)
            kernels.groupby_fold_masked(state, base, V, M & base, slots,
                                        pane, self._colmap, self._widemap)
            j = k
        return state

    #: the transient device bytes of one group of masked-fold segments
    FOLD_MASKED_GROUP_BYTES = 64 << 20

    def _masked_groups(self, segs):
        """fold_masked_many's groups of (columns, slots) segments, in
        order."""
        ncols = len(self.plan.columns)
        # per row: each column and its validity mask, the int32 slot, each
        # spec's value and mask with their temporaries, the WHERE, row and
        # base masks
        row_bytes = 5 * ncols + 10 * len(self.plan.specs) + 7
        most = max(self.FOLD_MASKED_GROUP_BYTES // row_bytes, 1)
        group, rows = [], 0
        for seg in segs:
            n = len(seg[1])
            if group and rows + n > most:
                yield group
                group, rows = [], 0
            group.append(seg)
            rows += n
        if group:
            yield group

    def _concat_columns(self, group) -> Dict[str, torch.Tensor]:
        """A group's columns, segment after segment; a validity mask that
        some segments lack is all true in those."""
        names = {k for cols, _ in group for k in cols}
        out = {}
        for name in names:
            parts = []
            for cols, s in group:
                t = cols.get(name)
                if t is None:
                    if not name.startswith("__valid_"):
                        raise ValueError(f"a cached segment lacks {name}")
                    t = torch.ones(len(s), dtype=torch.bool,
                                   device=self.device)
                parts.append(t)
            out[name] = torch.cat(parts)
        return out

    def _upload_masks(self, masks: Sequence[np.ndarray],
                      rows: Sequence[int]) -> Tuple[torch.Tensor, List[int]]:
        """fold_masked_many's row masks as one uint8 tensor on the device,
        each segment's a run of ceil(rows / 8) bytes, row r its bit r % 8
        of byte r // 8 (the bits past a shorter mask off), through a pinned
        staging buffer and ONE non-blocking copy on a CUDA device; and each
        run's first byte."""
        nbytes = [(n + 7) // 8 for n in rows]
        first = np.cumsum([0] + nbytes[:-1]).tolist()
        host = torch.zeros(sum(nbytes), dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")
        flat = host.numpy()
        for f, m in zip(first, masks):
            bits = np.packbits(np.asarray(m, dtype=np.bool_),
                               bitorder="little")
            flat[f:f + len(bits)] = bits
        if self.device.type != "cuda":
            return host, first
        return host.to(self.device, non_blocking=True), first

    def _unpack_rows(self, packed: torch.Tensor, first: Sequence[int],
                     rows: Sequence[int]) -> torch.Tensor:
        """The bool rows of consecutive segments from their packed runs
        (_upload_masks), segment after segment."""
        lo, hi = first[0], first[-1] + (rows[-1] + 7) // 8
        shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
        bits = ((packed[lo:hi, None] >> shifts) & 1).reshape(-1).bool()
        if all(n % 8 == 0 for n in rows[:-1]):
            return bits[:sum(rows)]
        return torch.cat([bits[8 * (f - lo):8 * (f - lo) + n]
                          for f, n in zip(first, rows)])

    def _fold_chunk(self, state: Dict[str, torch.Tensor],
                    cols: Dict[str, torch.Tensor], n: int,
                    slots: torch.Tensor, pane: int,
                    pane_vec: Optional[torch.Tensor],
                    pane_hi: Optional[int] = None) -> None:
        """The launches of one uploaded chunk of `n` rows: the closures,
        then the fold, one kernel for act, the scalar, touch and sketch
        columns. pane_hi: pane_vec's largest pane, checked on the host (the
        single rule's fold takes the caller's check as it is)."""
        base, V, M = self.spec_inputs(cols, n)
        kernels.groupby_fold(state, base, V, M, slots, pane, self._colmap,
                             self._widemap, pane_vec)

    # --------------------------------------------------------------- finalize
    def _pane_mask(self, panes: Optional[List[int]]) -> torch.Tensor:
        pm = np.zeros(self.n_panes, dtype=np.bool_)
        if panes is None:
            pm[:] = True
        else:
            pm[panes] = True
        return self._mask_tensor(pm)

    def _mask_tensor(self, pm: np.ndarray) -> torch.Tensor:
        key = tuple(np.asarray(pm, dtype=np.bool_).tolist())
        t = self._masks.get(key)
        if t is None:  # one small upload per distinct mask, then cached
            t = self._masks[key] = torch.tensor(key, dtype=torch.bool,
                                                device=self.device)
        return t

    def _finalize(self, state: Dict[str, torch.Tensor],
                  pm: torch.Tensor) -> torch.Tensor:
        """Launch the finalize kernels into one (rows, C) result on the
        device: the scalar, sketch and heavy-hitters kernels fill one
        stacked result, which crosses to the host in ONE copy."""
        out = kernels.groupby_finalize_scalar(state, pm, self._spectab,
                                              self._rows)
        if len(self._widetab):
            kernels.groupby_finalize_wide(state, pm, self._widetab,
                                          self._fracs, out)
        if len(self._hhtab):
            kernels.groupby_hh_finalize(state, pm, self._hhtab, out)
        return out

    def finalize(self, state: Dict[str, torch.Tensor], n_keys: int,
                 panes: Optional[List[int]] = None
                 ) -> Tuple[List[np.ndarray], np.ndarray]:
        """Emit final aggregate values for slots [0, n_keys).

        Returns (per-spec value arrays, active-row-count array); keys with
        active == 0 did not appear in this window and must not emit a group.
        NaN encodes NULL for empty-group sum/avg/min/max; a heavy_hitters
        spec gives an object array of [(code, count), ...] lists.
        """
        out = self._finalize(state, self._pane_mask(panes))
        return self.host_tail(out.cpu().numpy(), n_keys)

    def host_tail(self, stacked: np.ndarray, n_keys: int
                  ) -> Tuple[List[np.ndarray], np.ndarray]:
        """(outs, act) of a finalize result on the host."""
        if self._host_finalize_only:
            return self.hh_assemble(stacked, n_keys)
        host = [stacked[i][:n_keys] for i in range(len(self.plan.specs))]
        host = apply_int_semantics(self.plan.specs, host)
        return host, stacked[-1][:n_keys]

    def _fetch_pool(self) -> Optional[FetchPool]:
        if self.device.type != "cuda":
            return None
        if self._fetch is None:
            self._fetch = FetchPool(self.device)
        return self._fetch

    def finalize_begin(self, state: Dict[str, torch.Tensor],
                       pane_mask: Optional[np.ndarray] = None
                       ) -> PendingFinalize:
        """Launch the finalize over every pane, or over the (P,) bool
        `pane_mask` (the sliding refold's window: its full panes and the
        scratch pane), and start its copy to the host; the async emit reads
        it with host_tail (the reference's _finalize / _finalize_dyn /
        _hh_fin dispatch + copy_to_host_async). The result is a fresh
        tensor whose copy waits for an event recorded right after the
        launch, so a pane reset or fold launched next cannot reach it."""
        pm = (self._pane_mask(None) if pane_mask is None
              else self._mask_tensor(pane_mask))
        out = self._finalize(state, pm)
        return begin_pending(out, None, self._fetch_pool())

    def finalize_later(self, state: Dict[str, torch.Tensor]) -> DeferredFetch:
        """Launch the finalize over every pane; its copy starts only if
        the result is asked for (the deferred boundary's backup)."""
        return DeferredFetch(self._finalize(state, self._pane_mask(None)),
                             self._fetch_pool())

    # ------------------------------------------------------------ prefinalize
    def _components_layout(self):
        """(comp, col_start, width, per-key shape) for the stacked
        components array: one flat (capacity, W) float32 array, so one
        copy per fetch."""
        layout = []
        col = 0
        for comp in sorted(self.comp_specs):
            shape: Tuple[int, ...] = (len(self.comp_specs[comp]),)
            if comp in WIDE_COMPONENTS:
                shape = shape + (kernels.WIDE_W[comp],)
            w = int(np.prod(shape))
            layout.append((comp, col, w, shape))
            col += w
        layout.append(("act", col, 1, ()))
        return layout

    def prefinalize_begin(self, state: Dict[str, torch.Tensor],
                          panes: Optional[List[int]] = None
                          ) -> PendingFinalize:
        """Launch the pane-merged components kernel and start the async
        copy to the host; returns a PendingFinalize. Folds issued later on
        the compute stream run after the kernel, so they cannot reach the
        fetched components."""
        return self._components_begin(state, self._pane_mask(panes))

    def components_begin_dyn(self, state: Dict[str, torch.Tensor],
                             pane_mask: np.ndarray) -> PendingFinalize:
        """As prefinalize_begin, over an arbitrary live-pane subset given
        as a (P,) bool array."""
        return self._components_begin(state, self._mask_tensor(pane_mask))

    def _components_begin(self, state, pm: torch.Tensor) -> PendingFinalize:
        out = kernels.groupby_components(state, pm, self._comp_order)
        return begin_pending(out, self._components_layout(),
                             self._fetch_pool())

    def _final_from_components(
        self, comb: Dict[str, np.ndarray], n_keys: int,
    ) -> Tuple[List[np.ndarray], np.ndarray]:
        """Numpy final values from pane-merged host components."""
        act = comb["act"]
        outs: List[np.ndarray] = []
        for i, spec in enumerate(self.plan.specs):
            c = {
                comp: comb[comp][:, self.comp_specs[comp].index(i)]
                for comp in spec.components
            }
            outs.append(np.asarray(final_value_np(spec, c))[:n_keys])
        outs = apply_int_semantics(self.plan.specs, outs)
        return outs, np.asarray(act[:n_keys])

    def prefinalize_merge(self, pending, shadow, n_keys: int
                          ) -> Tuple[List[np.ndarray], np.ndarray]:
        """Complete a pre-issued finalize: the fetched components (usually
        landed already) ⊕ the tail shadow, final values in numpy. Same
        (outs, act) contract as finalize()."""
        # capacity may have grown during a frozen tail (new keys live only
        # in the shadow): merge at the widest extent so no slot is cut
        cap = max(self.capacity,
                  shadow.capacity if shadow is not None else 0)
        comb = merge_components(pending.get(), shadow, cap)
        return self._final_from_components(comb, n_keys)

    def hh_assemble(self, stacked: np.ndarray, n_keys: int
                    ) -> Tuple[List[np.ndarray], np.ndarray]:
        """Host tail of the heavy-hitters finalize: dedupe candidates (a
        code can appear once per depth) and trim to top-k; plain specs read
        their final-value row."""
        outs: List[np.ndarray] = []
        r = 0
        for spec in self.plan.specs:
            if spec.kind == "heavy_hitters":
                k2 = 2 * spec.topk
                codes = stacked[r:r + k2, :n_keys]
                est = stacked[r + k2:r + 2 * k2, :n_keys]
                r += 2 * k2
                col = np.empty(n_keys, dtype=np.object_)
                for j in range(n_keys):
                    col[j] = hh_dedupe_topk(codes[:, j], est[:, j],
                                            spec.topk)
                outs.append(col)
            else:
                outs.append(stacked[r, :n_keys].copy())
                r += 1
        act = stacked[-1]
        outs = apply_int_semantics(self.plan.specs, outs)
        return outs, np.asarray(act[:n_keys])

    # ----------------------------------------------------------------- absorb
    def absorb(self, state: Dict[str, torch.Tensor],
               shadow_data: Dict[str, np.ndarray],
               pane_idx: int) -> Dict[str, torch.Tensor]:
        """Merge host-shadow components into one pane of the state, in
        place: a checkpoint in a host-only window tail flushes the tail's
        rows to the card so the snapshot is complete. The shadow arrays go
        up through pinned, non-blocking copies."""
        sh = {k: self.upload(v, np.float32) for k, v in shadow_data.items()
              if k in state}
        kernels.groupby_absorb(state, sh, int(pane_idx))
        return state

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
        """State tensors from a snapshot of either package (a `touch`
        column as uint32, every other component float32), reconciled with
        this kernel's track_touch by host_from_partials."""
        want = set(self.comp_specs) | {"act"}
        got = set(host) - {"touch"}
        if got != want:
            raise ValueError(f"snapshot components {sorted(got)} do not "
                             f"match this plan's {sorted(want)}")
        return {k: torch.tensor(np.asarray(v), dtype=(
                    torch.uint32 if k == "touch" else torch.float32),
                    device=self.device)
                for k, v in host.items()}

    def host_from_partials(self, partials: Dict[str, object]
                           ) -> Tuple[Dict[str, np.ndarray], int]:
        """Checkpoint partials -> (typed host arrays, capacity: act's last
        axis): float32, but the uint32 touch column, which is kept when this
        kernel tracks touch (zero-filled for a pre-tier checkpoint) and
        dropped when it does not (the reference's reconciliation)."""
        host = {k: np.asarray(v, dtype=(np.uint32 if k == "touch"
                                        else np.float32))
                for k, v in partials.items()}
        cap = host["act"].shape[-1]
        if self.track_touch:
            if "touch" not in host:
                host["touch"] = np.zeros(cap, dtype=np.uint32)
        else:
            host.pop("touch", None)
        return host, cap


def concat_slots(slots: Sequence[torch.Tensor]) -> torch.Tensor:
    """Segments' slots, one after another: uint16 kept where every segment
    has it (joined as int16 views, the same bits), else int32."""
    if all(s.dtype == torch.uint16 for s in slots):
        return torch.cat([s.view(torch.int16) for s in slots]).view(
            torch.uint16)
    return torch.cat([s.view(torch.int16).to(torch.int32) & 0xFFFF
                      if s.dtype == torch.uint16 else s for s in slots])
