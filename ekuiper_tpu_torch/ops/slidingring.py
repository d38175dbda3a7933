"""Constant-time sliding aggregation rings, the DABA path of SLIDINGWINDOW
rules (counterpart of ekuiper_tpu/ops/slidingring.py; "In-Order
Sliding-Window Aggregation in Worst-Case Constant Time", PAPERS.md).

The fold keeps one pane per time bucket (ops/groupby.py state); this
module keeps per-key running partials over the CLOSED panes, so a trigger
is one combine of two running partials instead of a window-length merge:

- **subtract-on-evict totals** for the components whose combine is
  addition (`n`, `s1`, `s2`, `hist`, `hh`, `act`): `tot_<comp>` of shape
  (capacity, *dims); closing a bucket adds its pane, evicting the expired
  bucket subtracts it.
- **two-stack partials** for min/max combines (`mn`, `mx`, `hll`):
  `back_<comp>` (capacity, *dims) accumulates the panes closed since the
  last flip; `front_<comp>` (R, capacity, *dims) holds suffix combines over
  the older panes, rebuilt by one reverse cumulative scan (the flip). A
  query is combine(front[j], back).

The state layout and names are the reference's. Its three device programs
are the port's CUDA kernels `ring_advance`, `ring_flip` and `ring_query`
(csrc/slidingring.cu, wrappers in ops/kernels.py). Unlike the reference,
which donates the ring to each program, `advance` and `flip` update the
ring tensors in place; `query_begin` launches the query into a fresh
output tensor on the compute stream and starts its copy to pinned host
memory after an event recorded at the launch, so a fold, advance, flip or
pane reset launched after it cannot reach what it fetches (the pre-issue
protocol of ops/prefinalize.py).

The ring partials are caches of the pane state: a checkpoint restore, late
rows into closed buckets or a time gap mark them dirty in the fused node,
and the next trigger rebuilds them with one flip.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from . import kernels
from .aggspec import WIDE_COMPONENTS
from .prefinalize import PendingFinalize, begin_pending

_INIT = kernels.INIT

#: components whose pane combine is elementwise addition: the
#: subtract-on-evict path ("touch", the reference's tiered-state column,
#: keeps the classification total over its state components)
ADD_COMBINE = frozenset({"n", "s1", "s2", "hist", "hh", "act", "touch"})
#: min-merge components (two-stack discipline; subtraction undefined)
MIN_COMBINE = frozenset({"mn"})
#: max-merge components (hll registers merge by max)
MAX_COMBINE = frozenset({"mx", "hll"})

#: pane-slice adjustments a query carries: up to two low-edge
#: subtractions, the live head pane, one spare
QUERY_ADJ = kernels.QUERY_ADJ


@dataclass(frozen=True)
class RingLayout:
    """Plan-time sliding ring geometry, shared by the planner and the fused
    node so both agree on bucket routing."""

    bucket_ms: int      # time-pane width rows route into
    n_ring_panes: int   # pane ring slots (window span + slack)
    n_panes: int        # n_ring_panes + 1 (the reference's scratch pane)
    span_buckets: int   # buckets a full window spans (ceil((L+delay)/B))
    scratch_pane: int   # scratch slot index (the reference's refold path)


def plan_ring_layout(length_ms: int, delay_ms: int, wide: bool,
                     budget_bytes: Optional[int] = None,
                     mm_slot_bytes: int = 0,
                     fixed_bytes: int = 0) -> RingLayout:
    """Ring geometry for a sliding window, the reference's: finer buckets
    shrink the per-trigger edge folds, bounded by the uint8 pane budget;
    wide sketch plans start coarser, and with `budget_bytes` (the
    slidingDevRingMb budget) the bucket target walks down a ladder until
    the ring's static footprint `fixed_bytes + (1 + R) * mm_slot_bytes`
    fits. Returns the coarsest rung when none fits."""
    targets = (48,) if wide else (128,)
    if budget_bytes is not None:
        targets = (48, 32, 24, 16, 12, 8) if wide \
            else (128, 64, 48, 32, 24, 16, 12, 8)
    layout = None
    for target in targets:
        bucket_ms = max(length_ms // target, 25,
                        -(-(length_ms + delay_ms) // 250))
        span = -(-(length_ms + delay_ms) // bucket_ms)
        n_ring = span + 3
        n_panes = n_ring + 1
        if n_panes > 255:
            raise ValueError(
                f"sliding window needs {n_panes} panes (max 255)")
        layout = RingLayout(
            bucket_ms=int(bucket_ms), n_ring_panes=int(n_ring),
            n_panes=int(n_panes), span_buckets=int(span),
            scratch_pane=int(n_ring))
        if budget_bytes is None:
            return layout
        if fixed_bytes + (1 + n_ring) * mm_slot_bytes <= budget_bytes:
            return layout
    return layout


def _comp_dims(comp: str, k: int):
    """Per-key trailing dims of a component with k spec columns."""
    if comp == "act":
        return ()
    if comp in WIDE_COMPONENTS:
        return (k, kernels.WIDE_W[comp])
    return (k,)


def _plan_ring_bytes(plan, capacity: int):
    """(mm_slot_bytes, fixed_bytes) of a plan's ring state at `capacity`,
    without building the group-by: the arithmetic of
    SlidingRing.estimate_bytes (one per-slot unit covers the back stack)."""
    comp_specs: dict = {}
    for i, spec in enumerate(plan.specs):
        for comp in spec.components:
            comp_specs.setdefault(comp, []).append(i)
    mm_slot = 0
    fixed = 0
    for comp in sorted(list(comp_specs) + ["act"]):
        per = capacity * int(np.prod(
            _comp_dims(comp, len(comp_specs.get(comp, ()))),
            dtype=np.int64)) * 4
        if comp in ADD_COMBINE:
            fixed += per
        else:
            mm_slot += per
    return mm_slot, fixed


def ring_layout_for(window, plan, capacity: Optional[int] = None,
                    budget_mb: Optional[int] = None) -> RingLayout:
    """Layout from the parsed window and the kernel plan (the planner's
    entry); with `capacity` and `budget_mb` it coarsens until the ring's
    static estimate fits slidingDevRingMb."""
    wide = any(set(s.components) & WIDE_COMPONENTS for s in plan.specs)
    if capacity is None or budget_mb is None:
        return plan_ring_layout(window.length_ms(), window.delay_ms(), wide)
    mm_slot, fixed = _plan_ring_bytes(plan, int(capacity))
    return plan_ring_layout(window.length_ms(), window.delay_ms(), wide,
                            budget_bytes=int(budget_mb) << 20,
                            mm_slot_bytes=mm_slot, fixed_bytes=fixed)


class SlidingRing:
    """The DABA ring over a TorchGroupBy's pane state: its state and its
    three kernels. The bucket bookkeeping (which bucket is closed, evicted
    or queried) lives in the fused node."""

    def __init__(self, gb, layout: RingLayout) -> None:
        self.gb = gb
        self.layout = layout
        self.capacity = int(gb.capacity)
        self.n_ring_panes = int(layout.n_ring_panes)
        comps = sorted(list(gb.comp_specs) + ["act"])
        self.add_comps = [c for c in comps if c in ADD_COMBINE]
        self.mm_comps = [c for c in comps
                         if c in MIN_COMBINE or c in MAX_COMBINE]
        unknown = [c for c in comps
                   if c not in ADD_COMBINE
                   and c not in MIN_COMBINE and c not in MAX_COMBINE]
        if unknown:
            raise ValueError(
                f"no sliding-ring combine class for components {unknown}")
        self._comps = self.add_comps + self.mm_comps
        # the query's output order: the components layout
        self._query_comps = sorted(gb.comp_specs) + ["act"]

    # ------------------------------------------------------------ layout
    def _comp_dims(self, comp: str):
        return _comp_dims(comp, len(self.gb.comp_specs.get(comp, ())))

    def init_state(self) -> Dict[str, torch.Tensor]:
        dev = self.gb.device
        out: Dict[str, torch.Tensor] = {}
        for c in self.add_comps:
            out[f"tot_{c}"] = torch.zeros(
                (self.capacity,) + self._comp_dims(c), dtype=torch.float32,
                device=dev)
        for c in self.mm_comps:
            shape = (self.capacity,) + self._comp_dims(c)
            out[f"back_{c}"] = torch.full(shape, _INIT[c],
                                          dtype=torch.float32, device=dev)
            out[f"front_{c}"] = torch.full(
                (self.n_ring_panes,) + shape, _INIT[c], dtype=torch.float32,
                device=dev)
        return out

    def grow(self, ring: Dict[str, torch.Tensor],
             new_capacity: int) -> Dict[str, torch.Tensor]:
        """Pad the key axis to a grown capacity with each component's
        identity, keeping the partials."""
        out: Dict[str, torch.Tensor] = {}
        for key, arr in ring.items():
            comp = key.split("_", 1)[1]
            axis = 1 if key.startswith("front_") else 0
            pad_shape = list(arr.shape)
            pad_shape[axis] = int(new_capacity) - arr.shape[axis]
            pad = torch.full(pad_shape, _INIT[comp], dtype=arr.dtype,
                             device=arr.device)
            out[key] = torch.cat([arr, pad], dim=axis)
        self.capacity = int(new_capacity)
        return out

    @staticmethod
    def state_nbytes(ring: Dict[str, torch.Tensor]) -> int:
        return sum(a.numel() * a.element_size() for a in ring.values())

    def estimate_bytes(self, capacity: int) -> int:
        """Static footprint at a key capacity, checked against the
        slidingDevRingMb budget before the ring is allocated."""
        total = 0
        for c in self.add_comps:
            total += int(np.prod((capacity,) + self._comp_dims(c),
                                 dtype=np.int64)) * 4
        for c in self.mm_comps:
            per = int(np.prod((capacity,) + self._comp_dims(c),
                              dtype=np.int64)) * 4
            total += per * (1 + self.n_ring_panes)
        return total

    # ---------------------------------------------------------- kernels
    def advance(self, ring, pane_state, closed_slot: int, closed_on: bool,
                evict_slot: int, evict_on: bool):
        """Absorb the just-closed pane into the running partials and
        subtract the evicted pane from the additive totals (in place;
        returns the ring)."""
        kernels.ring_advance(ring, pane_state, self._comps, int(closed_slot),
                             bool(closed_on), int(evict_slot), bool(evict_on))
        return ring

    def flip(self, ring, pane_state, base_slot: int, valid: np.ndarray):
        """Rebuild the partials over the age-ordered rotation starting at
        `base_slot`; `valid[i]` says whether slot (base + i) % R holds live
        data for the flip span (in place; returns the ring)."""
        order = ((int(base_slot)
                  + np.arange(self.n_ring_panes, dtype=np.int64))
                 % self.n_ring_panes).astype(np.int32)
        kernels.ring_flip(ring, pane_state, self._comps, order,
                          np.asarray(valid, dtype=np.bool_))
        return ring

    def query_begin(self, ring, pane_state, *, body_on: bool, f_on: bool,
                    f_slot: int, adj_slots: np.ndarray,
                    adj_weights: np.ndarray,
                    adj_mm: np.ndarray) -> PendingFinalize:
        """Launch the window-body combine and start its copy to the host;
        returns a PendingFinalize over the (capacity, W) components layout
        that the emit worker merges with the trigger's host edge shadow."""
        out = kernels.ring_query(ring, pane_state, self._query_comps,
                                 bool(body_on), bool(f_on), int(f_slot),
                                 adj_slots, adj_weights, adj_mm)
        return begin_pending(out, self.gb._components_layout(),
                             self.gb._fetch_pool())
