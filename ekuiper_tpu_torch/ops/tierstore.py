"""Tiered key state: a hot set of keys on the card, cold keys' per-pane
partials spilled to a host arena (counterpart of
ekuiper_tpu/ops/tierstore.py; docs/TIERED_STATE.md describes the design).

A GROUP BY whose distinct keys outgrow the device budget keeps a hot core
in its dense device slots:

- **hot**: keys keep their slots in the group-by state (ops/groupby.py).
  A uint32 touch column rides the state and is bumped by the fold kernel,
  the placement policy's recency signal with no extra host sync.
- **cold**: keys whose touch count stays idle for `min_idle_scans` scans
  are demoted at a pane boundary: one `tier_demote` launch
  (csrc/tierstore.cu) packs their per-pane partials into a (D, Wp) block
  and resets the slots to the fold identity, and the key table recycles
  the slots. The block is copied into pinned host memory on a side stream
  after an event, and the emit worker harvests it into `HostTierStore`.

A demoted key that reappears in a batch is a new key of the key table's
log; `admit`, before the batch folds, merges its spilled partials into its
fresh slot with one `tier_promote` launch (add / min / max per component,
the absorb's algebra), so its state equals never having left. A key that
returns before its block was harvested is read straight off the pending
block.

Each spilled row remembers the pane reset epochs it was packed under; a
pane reset bumps that pane's epoch, so stale pane slices are masked to the
identity at promote and emit time instead of leaking a closed window's rows
into a newer one. Spilled keys with live panes still reach each window's
emission: `window_groups` computes their final values on the host.

Left out of the port for now (ROADMAP.md): the ingest prefetch
(`TierManager.prefetch`), the quiescent-only mode of tiered sliding rules
(the fused node refuses them), and the telemetry registry.
"""
from __future__ import annotations

import base64
import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..utils import timex
from . import kernels
from .aggspec import WIDE_COMPONENTS
from .groupby import apply_int_semantics
from .prefinalize import begin_pending, final_value_np

_INIT = kernels.INIT


# ---------------------------------------------------------------- geometry
@dataclass(frozen=True)
class TierLayout:
    """Tier geometry, chosen once at plan time (plan_tier_layout)."""

    #: resident-slot target: the policy demotes cold keys once live
    #: (non-free) slots exceed it
    hot_slots: int
    #: D: slots per demote / promote launch
    demote_batch: int
    #: placement-policy cadence (engine clock, ms)
    scan_interval_ms: int
    #: consecutive zero-touch-delta scans before a key is demotable
    min_idle_scans: int

    def hot_capacity(self) -> int:
        """The power-of-two construction capacity the hot target implies."""
        return max(1 << max(self.hot_slots - 1, 1).bit_length(), 1024)


def env_hbm_budget_mb() -> float:
    """KUIPER_HBM_BUDGET_MB, 0 when unset or unparseable."""
    try:
        return max(float(os.environ.get("KUIPER_HBM_BUDGET_MB", "0")
                         or 0), 0.0)
    except ValueError:
        return 0.0


def state_bytes_per_key(plan, n_panes: int) -> int:
    """Device bytes per key slot of a plan's group-by state (float32
    components, act, the uint32 touch column)."""
    comp_specs: Dict[str, int] = {}
    for spec in plan.specs:
        for comp in spec.components:
            comp_specs[comp] = comp_specs.get(comp, 0) + 1
    total = n_panes  # act
    for comp, k in comp_specs.items():
        total += n_panes * k * (kernels.WIDE_W[comp]
                                if comp in WIDE_COMPONENTS else 1)
    return total * 4 + 4  # + uint32 touch


#: share of the budget the hot group-by state may claim (the rest covers
#: micro-batch staging, sliding rings, emit transfers)
HOT_BUDGET_FRACTION = 0.5
DEFAULT_DEMOTE_BATCH = 2048
DEFAULT_MIN_IDLE_SCANS = 2
#: demote launches per boundary (D x this = most slots freed per boundary)
MAX_DEMOTE_BATCHES = 8


def plan_tier_layout(plan, n_panes: int, capacity: int,
                     budget_mb: float, scan_interval_ms: int = 0,
                     window_ms: int = 0) -> Optional[TierLayout]:
    """The hot-slot target from the budget and the plan's per-key state
    width; None when the budget covers four times the requested capacity
    (tiering would be a no-op) or is 0."""
    if budget_mb <= 0:
        return None
    per_key = max(state_bytes_per_key(plan, n_panes), 1)
    budget_keys = int(budget_mb * HOT_BUDGET_FRACTION * (1 << 20) / per_key)
    if budget_keys >= capacity * 4:
        return None
    hot = max(min(budget_keys, capacity * 4), 1024)
    scan = int(scan_interval_ms) or max(min(int(window_ms) or 1000, 5000),
                                        250)
    return TierLayout(hot_slots=hot, demote_batch=DEFAULT_DEMOTE_BATCH,
                      scan_interval_ms=scan,
                      min_idle_scans=DEFAULT_MIN_IDLE_SCANS)


# ----------------------------------------------------------- device kernels
class TierStore:
    """Demote and promote over one group-by's state. A packed row (one
    key, float32[packed_w]): each component's per-pane block (P, k[, W])
    flattened in C order, the components sorted, then the (P,) act block;
    the reference's layout, so spilled rows cross both packages."""

    def __init__(self, gb, layout: TierLayout) -> None:
        self.gb = gb
        self.layout = layout
        self.demote_batch = int(layout.demote_batch)
        self.n_panes = int(gb.n_panes)
        self.blocks: List[Tuple[str, int, Tuple[int, ...]]] = []
        col = 0
        for comp in sorted(gb.comp_specs):
            tail: Tuple[int, ...] = (len(gb.comp_specs[comp]),)
            if comp in WIDE_COMPONENTS:
                tail = tail + (kernels.WIDE_W[comp],)
            self.blocks.append((comp, col, tail))
            col += self.n_panes * int(np.prod(tail))
        self.blocks.append(("act", col, ()))
        col += self.n_panes
        self.packed_w = col
        self.comps = [comp for comp, _, _ in self.blocks]

    # ------------------------------------------------------------- rows
    def init_row(self) -> np.ndarray:
        """The identity row (promote's no-op; a demoted idle slot's row)."""
        row = np.empty(self.packed_w, dtype=np.float32)
        for comp, off, tail in self.blocks:
            row[off:off + self.n_panes * int(np.prod(tail))] = _INIT[comp]
        return row

    def row_is_idle(self, row: np.ndarray) -> bool:
        """True when a row holds no live data: its act block is all zero
        (every other component is at its identity exactly when act is)."""
        _, off, _ = self.blocks[-1]
        return not row[off:off + self.n_panes].any()

    def mask_stale_panes(self, row: np.ndarray,
                         stale: np.ndarray) -> np.ndarray:
        """Reset the pane slices of `row` flagged in `stale` (bool (P,)) to
        the identity, in place."""
        if not stale.any():
            return row
        for comp, off, tail in self.blocks:
            w = int(np.prod(tail))
            seg = row[off:off + self.n_panes * w].reshape(self.n_panes, w)
            seg[stale] = _INIT[comp]
        return row

    # ----------------------------------------------------------- device
    def _slots(self, slots: np.ndarray) -> Tuple[np.ndarray, int]:
        """`slots` padded to D with slots[0], checked: distinct, inside the
        state (the kernels' contract)."""
        s = np.asarray(slots, dtype=np.int32)
        n = len(s)
        if not 0 < n <= self.demote_batch:
            raise ValueError(f"{n} slots for a block of {self.demote_batch}")
        if s.min() < 0 or s.max() >= self.gb.capacity:
            raise ValueError(f"slot outside [0, {self.gb.capacity})")
        if len(np.unique(s)) != n:
            raise ValueError("slots of one block must be distinct")
        if n < self.demote_batch:
            s = np.concatenate([s, np.full(self.demote_batch - n, s[0],
                                           np.int32)])
        return s, n

    def demote(self, state, slots: np.ndarray):
        """Gather `slots`' partials into a fresh (D, packed_w) block on the
        state's device and reset the slots (touch included) to the
        identity. Returns (state, block)."""
        s, n = self._slots(slots)
        packed = kernels.tier_demote(state, self.gb.upload(s, np.int32), n,
                                     self.comps)
        return state, packed

    def promote(self, state, packed, slots: np.ndarray):
        """Merge packed rows (a host array of at least len(slots) rows)
        into `slots`: pad rows are `init_row()`, so the repeated pad slot
        is merged with the identity only. The block goes up non-blocking
        on the current (fold) stream, ordered before the next fold."""
        s, n = self._slots(slots)
        block = np.tile(self.init_row(), (self.demote_batch, 1))
        block[:n] = np.asarray(packed, dtype=np.float32)[:n]
        kernels.tier_promote(state, self.gb.upload(block, np.float32),
                             self.gb.upload(s, np.int32), self.comps)
        return state


# ------------------------------------------------------------- host store
class HostTierStore:
    """Host arena of spilled rows: one growable float32 (rows, Wp) block
    and an int64 (rows, P) epoch sidecar."""

    def __init__(self, packed_w: int, n_panes: int,
                 initial_rows: int = 1024) -> None:
        self.packed_w = int(packed_w)
        self.n_panes = int(n_panes)
        n = max(int(initial_rows), 16)
        self._rows = np.zeros((n, self.packed_w), dtype=np.float32)
        self._epochs = np.zeros((n, self.n_panes), dtype=np.int64)
        self._key_row: Dict[Any, int] = {}
        self._row_key: List[Any] = [None] * n
        self._free: List[int] = list(range(n - 1, -1, -1))

    def __len__(self) -> int:
        return len(self._key_row)

    def __contains__(self, key) -> bool:
        return key in self._key_row

    def nbytes(self) -> int:
        return int(self._rows.nbytes + self._epochs.nbytes)

    def _grow(self) -> None:
        n = len(self._row_key)
        self._rows = np.concatenate(
            [self._rows, np.zeros_like(self._rows)], axis=0)
        self._epochs = np.concatenate(
            [self._epochs, np.zeros_like(self._epochs)], axis=0)
        self._row_key.extend([None] * n)
        self._free.extend(range(2 * n - 1, n - 1, -1))

    def put(self, key, row: np.ndarray, epochs: np.ndarray) -> None:
        at = self._key_row.get(key)
        if at is None:
            if not self._free:
                self._grow()
            at = self._free.pop()
            self._key_row[key] = at
            self._row_key[at] = key
        self._rows[at] = row
        self._epochs[at] = epochs

    def take(self, key) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Remove and return (row copy, epochs copy) of a promoted key."""
        at = self._key_row.pop(key, None)
        if at is None:
            return None
        self._row_key[at] = None
        self._free.append(at)
        return self._rows[at].copy(), self._epochs[at].copy()

    def drop(self, key) -> bool:
        at = self._key_row.pop(key, None)
        if at is None:
            return False
        self._row_key[at] = None
        self._free.append(at)
        return True

    def items_arrays(self):
        """(keys, rows, epochs) of the resident set; the arrays are
        fancy-indexed copies."""
        if not self._key_row:
            return [], None, None
        idx = np.fromiter(self._key_row.values(), dtype=np.int64,
                          count=len(self._key_row))
        keys = [self._row_key[i] for i in idx]
        return keys, self._rows[idx], self._epochs[idx]


# ---------------------------------------------------------------- manager
class TierManager:
    """The placement policy and the host tier of one fused node.

    - fold thread: `admit` (promotions at the admission point),
      `on_boundary` (apply the pending demote plan, start the touch scan),
      `note_pane_reset`, `window_groups`.
    - emit worker: `worker_task` (harvest landed demote blocks, run the
      scan policy, prune stale rows).

    `_mu` guards the store, the policy mirror and the plan; the key table
    is only ever touched from the fold thread."""

    def __init__(self, gb, kt, layout: TierLayout, *,
                 submit: Optional[Callable[[tuple], None]] = None) -> None:
        self.gb = gb
        self.kt = kt
        self.layout = layout
        self.ts = TierStore(gb, layout)
        self.store = HostTierStore(self.ts.packed_w, self.ts.n_panes)
        self._submit = submit
        self._mu = threading.Lock()
        self._pane_epoch = np.zeros(self.ts.n_panes, dtype=np.int64)
        self._mirror = np.zeros(0, dtype=np.int64)
        self._idle = np.zeros(0, dtype=np.int32)
        self._plan: List[int] = []  # slots to demote (worker-chosen)
        # demote blocks in flight, not yet harvested: key -> (pending
        # fetch, row, epochs); a key returning meanwhile is read straight
        # off the pending block
        self._inflight: Dict[Any, Tuple[Any, int, np.ndarray]] = {}
        self._last_scan_ms = 0
        self.demoted_total = 0
        self.promoted_total = 0
        self.recycled_total = 0
        kt.track_new = True

    # ------------------------------------------------------------ epochs
    def note_pane_reset(self, pane: int) -> None:
        with self._mu:
            self._pane_epoch[int(pane)] += 1

    # ------------------------------------------------------- fold thread
    def admit(self, state):
        """Promotion at the admission point: drain the key table's new-key
        log; a returning key (in the cold tier, or in a block in flight)
        gets its spilled partials merged into its fresh slot before the
        batch folds."""
        new = self.kt.drain_new_keys()
        if not new:
            return state
        with self._mu:
            epoch = self._pane_epoch.copy()
            hits = [(k, s) for (k, s) in new if k in self.store]
            rows = {k: self.store.take(k) for (k, _s) in hits}
            for k, s in new:
                entry = self._inflight.pop(k, None)
                if entry is not None:
                    # returned before its block was harvested: read off the
                    # block (this waits for its copy only), under the lock,
                    # so the harvest cannot hand the buffer back meanwhile
                    fetch, idx, row_epochs = entry
                    rows[k] = (fetch.get()[idx].copy(), row_epochs.copy())
                    hits.append((k, s))
        keys: List[Any] = []
        slots: List[int] = []
        block: List[np.ndarray] = []
        for key, slot in hits:
            row, row_epochs = rows[key]
            self.ts.mask_stale_panes(row, row_epochs != epoch)
            if self.ts.row_is_idle(row):
                # nothing live survived the stale mask: a fresh identity
                # slot is all the key needs
                self.recycled_total += 1
                continue
            keys.append(key)
            slots.append(slot)
            block.append(row)
        D = self.ts.demote_batch
        for start in range(0, len(keys), D):
            state = self.ts.promote(state, np.stack(block[start:start + D]),
                                    np.asarray(slots[start:start + D]))
        self.promoted_total += len(keys)
        return state

    def on_boundary(self, state):
        """Pane-boundary hook (fold thread): apply the worker's demote plan
        (tier_demote, then the block's copy into pinned memory on a side
        stream; the worker harvests it) and, on cadence, start the touch
        scan the next plan is computed from."""
        with self._mu:
            plan, self._plan = self._plan, []
        if plan:
            keys: List[Any] = []
            slots: List[int] = []
            cap = self.ts.demote_batch * MAX_DEMOTE_BATCHES
            for slot in plan:
                if len(keys) >= cap:
                    break
                if slot >= self.kt.n_keys:
                    continue
                key = self.kt.decode(slot)
                if key is None or not self._retirable(key):
                    continue
                keys.append(key)
                slots.append(int(slot))
            D = self.ts.demote_batch
            pool = self.gb._fetch_pool()
            for start in range(0, len(keys), D):
                ck = keys[start:start + D]
                cs = slots[start:start + D]
                state, packed = self.ts.demote(state, np.asarray(cs))
                # a fresh block copied after an event recorded right after
                # the launch: later folds cannot reach it
                fetch = begin_pending(packed, None, pool)
                self.kt.retire(cs, ck)
                self.demoted_total += len(ck)
                with self._mu:
                    epochs = self._pane_epoch.copy()
                    for i, key in enumerate(ck):
                        self._inflight[key] = (fetch, i, epochs)
                self._dispatch(("harvest", fetch, ck, epochs))
        now = timex.now_ms()
        if now - self._last_scan_ms >= self.layout.scan_interval_ms \
                and "touch" in (state or {}):
            self._last_scan_ms = now
            # a clone, not the live column: the folds launched next bump
            # the live one in place (the clone runs before them on the
            # compute stream, its copy waits for an event after it)
            fetch = begin_pending(state["touch"].clone(), None,
                                  self.gb._fetch_pool())
            self._dispatch(("scan", fetch, self.kt.n_keys,
                            self.kt.free_slots(), now))
        return state

    @staticmethod
    def _retirable(key) -> bool:
        """Keys whose normalized form aliases a raw form ("" from a nil
        key, tuples holding "") stay resident: retiring them would leave a
        dangling alias in the key table."""
        if key == "":
            return False
        if isinstance(key, tuple) and any(v == "" for v in key):
            return False
        return True

    def _dispatch(self, payload: tuple) -> None:
        if self._submit is not None:
            self._submit(payload)
        else:
            self.worker_task(payload)

    # ------------------------------------------------------ worker thread
    def worker_task(self, payload: tuple) -> None:
        """The emit worker's half: harvest a landed demote block, or run the
        placement policy on a touch snapshot. Never touches the key
        table."""
        kind = payload[0]
        if kind == "harvest":
            self._harvest(payload[1], payload[2], payload[3])
        elif kind == "scan":
            self._scan(payload[1], payload[2], payload[3], payload[4])

    def _harvest(self, fetch, keys: List[Any], epochs: np.ndarray) -> None:
        arr = fetch.get()
        with self._mu:
            for i, key in enumerate(keys):
                entry = self._inflight.get(key)
                if entry is None or entry[0] is not fetch:
                    # admit() took this key off the pending block, or a
                    # newer demote of the same key superseded it
                    continue
                del self._inflight[key]
                row = arr[i]
                if self.ts.row_is_idle(row):
                    self.recycled_total += 1  # a pure slot recycle
                    continue
                self.store.put(key, row, epochs)
            # every key of the block is settled (put copies the row): the
            # pinned buffer goes back to the pool
            fetch.release()

    def _scan(self, fetch, n_slots: int, free: List[int],
              now_ms: int) -> None:
        counts = fetch.get()[:n_slots].astype(np.int64)
        fetch.release()
        with self._mu:
            if len(self._mirror) < len(counts):
                pad = len(counts) - len(self._mirror)
                self._mirror = np.concatenate(
                    [self._mirror, np.zeros(pad, np.int64)])
                self._idle = np.concatenate(
                    [self._idle, np.zeros(pad, np.int32)])
            delta = counts - self._mirror[:len(counts)]
            idle = self._idle[:len(counts)]
            idle[delta != 0] = 0
            idle[delta == 0] += 1
            self._mirror[:len(counts)] = counts
            overflow = n_slots - len(free) - self.layout.hot_slots
            plan: List[int] = []
            if overflow > 0:
                cand = np.nonzero(idle >= self.layout.min_idle_scans)[0]
                if len(cand):
                    free_set = set(free)
                    order = np.argsort(-idle[cand], kind="stable")
                    want = min(overflow, self.layout.demote_batch
                               * MAX_DEMOTE_BATCHES)
                    for slot in cand[order].tolist():
                        if slot in free_set:
                            continue
                        plan.append(int(slot))
                        if len(plan) >= want:
                            break
            self._plan = plan
            # resident rows whose every pane went stale carry nothing: a
            # reappearance is just a fresh key
            self._prune_locked()

    def _prune_locked(self) -> None:
        keys, rows, epochs = self.store.items_arrays()
        if rows is None:
            return
        _, off, _ = self.ts.blocks[-1]  # act
        act = rows[:, off:off + self.ts.n_panes]
        valid = epochs == self._pane_epoch[None, :]
        dead = ~np.any((act > 0) & valid, axis=1)
        for i in np.nonzero(dead)[0].tolist():
            self.store.drop(keys[i])

    def _settle_inflight_locked(self) -> None:
        """Land any unharvested demote blocks into the store now: a window's
        emission and a checkpoint need the whole cold tier. Caller holds
        _mu."""
        if not self._inflight:
            return
        items = list(self._inflight.items())
        self._inflight.clear()
        for key, (fetch, idx, epochs) in items:
            row = fetch.get()[idx]
            if self.ts.row_is_idle(row):
                self.recycled_total += 1
                continue
            self.store.put(key, row, epochs)

    # -------------------------------------------------------- emissions
    def window_groups(self, plan, panes: Optional[List[int]] = None):
        """Spilled keys' share of a closing window: each resident row's
        still-valid panes (the subset `panes`, default all) merged, final
        values by the numpy tail. (keys, outs, act) as the group-by's
        finalize, or None when no spilled key has live data."""
        with self._mu:
            self._settle_inflight_locked()
            keys, rows, epochs = self.store.items_arrays()
            if rows is None:
                return None
            valid = epochs == self._pane_epoch[None, :]
        if panes is not None:
            pane_mask = np.zeros(self.ts.n_panes, dtype=np.bool_)
            pane_mask[list(panes)] = True
            valid = valid & pane_mask[None, :]
        comb: Dict[str, np.ndarray] = {}
        for comp, off, tail in self.ts.blocks:
            w = int(np.prod(tail))
            seg = rows[:, off:off + self.ts.n_panes * w].reshape(
                len(keys), self.ts.n_panes, *tail)
            vm = valid.reshape(len(keys), self.ts.n_panes,
                               *([1] * len(tail)))
            if comp == "mn":
                m = np.min(np.where(vm, seg, np.inf), axis=1)
            elif comp in ("mx", "hll"):
                m = np.max(np.where(vm, seg, -np.inf), axis=1)
            else:
                m = np.sum(np.where(vm, seg, 0.0), axis=1)
            comb[comp] = m
        act = comb.pop("act")
        alive = np.nonzero(act > 0)[0]
        if not len(alive):
            return None
        comp_specs = self.gb.comp_specs
        outs: List[np.ndarray] = []
        for i, spec in enumerate(plan.specs):
            c = {comp: comb[comp][alive][:, comp_specs[comp].index(i)]
                 for comp in spec.components}
            outs.append(np.asarray(final_value_np(spec, c)))
        outs = apply_int_semantics(plan.specs, outs)
        return [keys[j] for j in alive.tolist()], outs, act[alive]

    # ------------------------------------------------------- checkpoint
    def snapshot(self) -> Dict[str, Any]:
        """The cold tier in the reference's format: base64 rows and epochs,
        the pane epochs, the (always empty here) requeue, the counters."""
        with self._mu:
            self._settle_inflight_locked()
            keys, rows, epochs = self.store.items_arrays()
            if rows is None:
                rows = np.zeros((0, self.ts.packed_w), np.float32)
                epochs = np.zeros((0, self.ts.n_panes), np.int64)
            return {
                "keys": [list(k) if isinstance(k, tuple) else k
                         for k in keys],
                "rows": base64.b64encode(np.ascontiguousarray(
                    rows).tobytes()).decode("ascii"),
                "epochs": base64.b64encode(np.ascontiguousarray(
                    epochs).tobytes()).decode("ascii"),
                "pane_epoch": self._pane_epoch.tolist(),
                "requeue": [],
                "counters": {"demoted": self.demoted_total,
                             "promoted": self.promoted_total,
                             "recycled": self.recycled_total},
            }

    def restore(self, snap: Dict[str, Any]) -> None:
        if snap.get("requeue"):
            raise NotImplementedError(
                "a checkpoint holding requeued rows comes from a tiered "
                "sliding rule (quiescent-only tiering), which is not "
                "ported yet")
        keys = [tuple(k) if isinstance(k, list) else k
                for k in snap.get("keys", [])]
        rows = np.frombuffer(base64.b64decode(snap.get("rows", "")),
                             dtype=np.float32).reshape(-1, self.ts.packed_w)
        epochs = np.frombuffer(base64.b64decode(snap.get("epochs", "")),
                               dtype=np.int64).reshape(-1, self.ts.n_panes)
        with self._mu:
            self._pane_epoch = np.asarray(
                snap.get("pane_epoch", [0] * self.ts.n_panes),
                dtype=np.int64)
            counters = snap.get("counters", {})
            self.demoted_total = int(counters.get("demoted", 0))
            self.promoted_total = int(counters.get("promoted", 0))
            self.recycled_total = int(counters.get("recycled", 0))
            for i, key in enumerate(keys):
                self.store.put(key, rows[i], epochs[i])

