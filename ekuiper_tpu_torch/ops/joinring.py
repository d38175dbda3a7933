"""Device stream-stream joins — the banded-gather join ring (counterpart of
ekuiper_tpu/ops/joinring.py).

The reference joins two windowed streams with a per-pair nested loop
(runtime/nodes_join.py): every (left, right) candidate runs the ON
expression through the row interpreter. Here both sides key-encode through
one KeyTable (identical values get identical int32 slots), event time
rebases to a per-call int32 offset, and the join predicate becomes index
arithmetic over a padded [PL, PR] candidate block, one CUDA kernel
(ops/kernels.py `join_match`, csrc/relational.cu) that writes the mask
packed one bit a pair; the packed rows come back through a pinned buffer
the ring keeps and are unpacked on the host (`unpack_mask`):

    eq[i,j]   = slot_l[i] == slot_r[j]           -- equi-key conjuncts
    band[i,j] = lo <= ts_l[i] - ts_r[j] <= hi    -- interval conjuncts
    mask      = eq & band & valid & residual      -- expr-IR 3VL residual

NULL key components encode as one reserved dictionary value (KEY_NULL):
this engine's `=` evaluates NULL = NULL as true (sql/eval.py), so NULL keys
pair with each other but never with a real value, and LEFT/RIGHT/FULL
validity falls out of the row-wise any() reductions of the same mask. The
ON residual (conjuncts that are neither equi-key nor band) compiles through
the port's expression IR (sql/expr_ir.py) with want="bool": NULL folds to
False, exactly the host evaluator's `v is True` join semantics; torch
evaluates it on the card over the broadcast [PL, 1] / [1, PR] columns
before the launch, and the kernel ANDs it in.

Ring storage: each side keeps time-bucketed columnar chunks; a banded
lookup visits only the buckets an interval can reach, and eviction drops
whole buckets below the watermark (append / window / evict).

Exactness: slot equality is exact (dictionary encoding), the band is exact
integer arithmetic (rebased int32; per-call range bounded by TS_RANGE_CAP),
and the residual shares host NULL semantics by IR construction — so the
device mask is bit-identical to the nested-loop decision on every
supported plan. Anything outside that contract raises JoinWindowFallback
and the window runs the host nested loop instead.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import Device, resolve_device
from . import kernels
from .keytable import KeyTable

#: pow-2 pad floor per join side (doublings cover the rest)
JOIN_PAD_FLOOR = 256

#: max rebased event-time range per match call; with band bounds clamped
#: to +-BAND_CLAMP every dt the kernel forms stays inside int32
TS_RANGE_CAP = 1 << 28
BAND_CLAMP = 1 << 28

#: "no band predicate" bounds — admit every dt the data range can form
BAND_OPEN = 1 << 30

#: NULL event-time sentinels: dt against a real ts (range-capped) can never
#: re-enter the clamped band, so a NULL-timestamped row matches nothing
_TS_NULL_L = -(1 << 30)
_TS_NULL_R = 1 << 30

#: reserved key value a NULL equi-key component encodes as — NULL = NULL is
#: true in this engine, so NULLs share one dictionary slot. Distinct from ""
#: (KeyTable normalizes None to "", which would conflate the two)
KEY_NULL = "\x00\x00sql-null\x00\x00"


class JoinWindowFallback(Exception):
    """One window's data stepped outside the device contract (non-integer
    event time, range past TS_RANGE_CAP). The caller runs the host nested
    loop for that window; the plan stays lifted."""

    def __init__(self, msg: str, reason: str = "join_runtime") -> None:
        super().__init__(msg)
        self.reason = reason


#: bits of a packed mask one unpack task covers, in whole rows; a mask of
#: one task is unpacked on the calling thread, a larger one on the pool
#: (smaller tasks lose to one thread at 2,048² and to this size at 16,384²:
#: `ab_tumbling.py --phase join`)
UNPACK_TASK_BITS = 1 << 24

#: the unpack's workers (their threads start at the first mask of two tasks)
_UNPACK_POOL = ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                                  thread_name_prefix="join-unpack")


def _popcount(packed: np.ndarray) -> int:
    return int(np.bitwise_count(packed.view(np.uint64)).sum())


def unpack_mask(packed: np.ndarray, nr: int) -> Tuple[np.ndarray, int]:
    """The bool (rows, nr) mask of join_match's packed rows and its count
    of True. A packed row is whole 64-bit words (bit j % 8 of byte j // 8;
    its pad bits from nr on are 0, as join_match writes them), so the count
    is a popcount of the words. A mask of more than UNPACK_TASK_BITS is
    unpacked and counted in tasks of that many bits of whole rows on the
    pool (numpy's unpackbits and bitwise_count release the GIL)."""
    rows = packed.shape[0]
    step = max(1, UNPACK_TASK_BITS // max(nr, 1))
    if rows <= step:
        out = np.unpackbits(packed, axis=1, count=nr, bitorder="little")
        return out.view(bool), _popcount(packed)
    out = np.empty((rows, nr), dtype=np.uint8)

    def task(lo: int) -> int:
        part = packed[lo:lo + step]
        out[lo:lo + step] = np.unpackbits(part, axis=1, count=nr,
                                          bitorder="little")
        return _popcount(part)

    return out.view(bool), sum(_UNPACK_POOL.map(task, range(0, rows, step)))


def _pad_pow2(n: int) -> int:
    b = JOIN_PAD_FLOOR
    while b < n:
        b <<= 1
    return b


def _is_null(v: Any) -> bool:
    return v is None or (isinstance(v, float) and v != v)


def _num32(values: Sequence[Any], n: int) -> np.ndarray:
    """Raw column -> float32 with NaN at NULL/non-numeric rows (the
    expression IR's null encoding for plain numeric columns)."""
    if len(values) == n and n:
        arr = np.asarray(values)
        # homogeneous numeric column: no None/str possible, NaN rows are
        # already the null encoding — skip the per-element scan
        if arr.ndim == 1 and arr.dtype.kind in "iufb":
            return arr.astype(np.float32)
    out = np.full(n, np.nan, dtype=np.float32)
    for i, v in enumerate(values):
        if isinstance(v, bool):
            out[i] = 1.0 if v else 0.0
        elif isinstance(v, (int, float)):
            out[i] = v
    return out


@dataclass
class SideBatch:
    """One join side, staged columnar in arrival order. `key_cols` holds one
    value-list per equi-key component; `band` the raw event-time column
    (None entries are SQL NULL); `cols` the raw columns the ON residual
    reads, keyed by their stream-renamed device name."""

    n: int
    key_cols: List[List[Any]] = field(default_factory=list)
    band: Optional[List[Any]] = None
    cols: Dict[str, List[Any]] = field(default_factory=dict)


class JoinRing:
    """Dual-side, time-bucketed join state + the match kernel.

    `match(left, right)` returns the exact [nl, nr] boolean join mask from
    the kernel on `device`; `match_host` is the numpy shadow twin from the
    same lowering (same slots, same rebased band, same residual IR in host
    mode). Ring append/evict/window give interval-mode streaming the banded
    bucket gather. Counters: `rows_total` (by side), `matches_total`,
    `fallback_windows_total` (windows the owning node ran on the nested
    loop)."""

    def __init__(self, n_key_cols: int = 1, band: bool = False,
                 lo: Optional[int] = None, hi: Optional[int] = None,
                 residual=None, residual_host=None, bucket_ms: int = 1000,
                 device: Device = None) -> None:
        self.device = resolve_device(device)
        self.n_key_cols = int(n_key_cols)
        self.band = bool(band)
        self.lo = BAND_OPEN * -1 if lo is None else max(lo, -BAND_CLAMP)
        self.hi = BAND_OPEN if hi is None else min(hi, BAND_CLAMP)
        self._residual = residual            # CompiledIR, mode="device"
        self._residual_host = residual_host  # CompiledIR, mode="host"
        self.bucket_ms = max(int(bucket_ms), 1)
        self.keys = KeyTable(initial_capacity=16384)
        # device column names per side (sorted, as the reference's)
        res_cols = sorted(residual.columns) if residual is not None else []
        self.resid_l = [c for c in res_cols if "__jl_" in c]
        self.resid_r = [c for c in res_cols if "__jr_" in c]
        # event-time ring: side -> {bucket_id: [(SideBatch, ts), ...]}
        self._buckets: Dict[str, Dict[int, List[Tuple[SideBatch,
                                                      np.ndarray]]]] = {
            "l": {}, "r": {}}
        self._ring_rows = {"l": 0, "r": 0}
        self.rows_total = {"l": 0, "r": 0}
        self.matches_total = 0
        self.fallback_windows_total = 0
        # pinned host bytes the packed mask comes back into (grown on
        # demand; a CUDA ring only)
        self._pinned: Optional[torch.Tensor] = None

    # --------------------------------------------------------- host prep
    def _slots(self, batch: SideBatch) -> np.ndarray:
        """Dictionary-encode one side's equi-key columns to int32 slots. A
        NULL component encodes as the reserved KEY_NULL, shared by both
        sides — NULL keys pair with each other but never with a real value
        (including "")."""
        if self.n_key_cols == 0:
            return np.zeros(batch.n, dtype=np.int32)  # CROSS: all pairs
        arrays = []
        for comp in batch.key_cols:
            raw = np.asarray(comp, dtype=object)
            if raw.ndim == 1 and len(raw) == batch.n:
                probe = np.asarray(comp)
                if probe.ndim == 1 and probe.dtype.kind in "USiub":
                    # homogeneous str/int/bool column: no NULL possible
                    arrays.append(raw)
                    continue
            col = np.empty(batch.n, dtype=object)
            for i, v in enumerate(comp):
                col[i] = KEY_NULL if _is_null(v) else v
            arrays.append(col)
        slots, _ = self.keys.encode_multi(arrays)
        return slots.astype(np.int32, copy=True)

    def _ts32(self, left: SideBatch, right: SideBatch
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Rebase both sides' raw event-time columns to a shared int32
        offset. Differences are invariant under the rebase, so the band
        compare is exact for any integral input whose per-call range fits
        TS_RANGE_CAP."""
        if not self.band:
            return (np.zeros(left.n, dtype=np.int32),
                    np.zeros(right.n, dtype=np.int32))
        sides = [self._ts_col(left.band, left.n),
                 self._ts_col(right.band, right.n)]
        lo = hi = None
        for ints, null in sides:
            if not null.all():
                live = ints[~null]
                lo = int(live.min()) if lo is None else min(lo, int(live.min()))
                hi = int(live.max()) if hi is None else max(hi, int(live.max()))
        base = lo if lo is not None else 0
        if hi is not None and hi - base > TS_RANGE_CAP:
            raise JoinWindowFallback(
                f"event-time range {hi - base} past TS_RANGE_CAP",
                reason="join_ts_range")
        out = []
        for (ints, null), sent in zip(sides, (_TS_NULL_L, _TS_NULL_R)):
            out.append(np.where(null, np.int64(sent),
                                ints - base).astype(np.int32))
        return out[0], out[1]

    @staticmethod
    def _ts_col(vals: Optional[List[Any]],
                n: int) -> Tuple[np.ndarray, np.ndarray]:
        """One side's raw event-time column -> (int64 values, null mask),
        validating the device contract: integral numerics only."""
        vals = vals or []
        if len(vals) == n and n:
            arr = np.asarray(vals)
            if arr.ndim == 1:
                if arr.dtype.kind in "iu":
                    return arr.astype(np.int64), np.zeros(n, dtype=bool)
                if arr.dtype.kind == "f":
                    null = np.isnan(arr)
                    live = arr[~null]
                    if live.size and (
                            not np.isfinite(live).all()
                            or (live != np.rint(live)).any()):
                        raise JoinWindowFallback(
                            "non-integral event time in window",
                            reason="join_ts_type")
                    return (np.where(null, 0.0, arr).astype(np.int64),
                            null)
        null = np.ones(n, dtype=bool)
        ints = np.zeros(n, dtype=np.int64)
        for i, v in enumerate(vals):
            if _is_null(v):
                continue
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise JoinWindowFallback(
                    f"non-numeric event time {v!r}", reason="join_ts_type")
            if isinstance(v, float) and not v.is_integer():
                raise JoinWindowFallback(
                    f"non-integral event time {v!r}", reason="join_ts_type")
            ints[i] = int(v)
            null[i] = False
        return ints, null

    def _prep_cols(self, batch: SideBatch, names: List[str],
                   pad: int) -> Dict[str, np.ndarray]:
        """Residual columns for one side, float32 with NaN at NULL, padded
        (the port's IR has no string or event-time column: lower_join
        refuses such a residual)."""
        out: Dict[str, np.ndarray] = {}
        for name in names:
            col = _num32(batch.cols.get(name, []), batch.n)
            if pad > batch.n:
                col = np.pad(col, (0, pad - batch.n))
            out[name] = col
        return out

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _residual_mask(self, left: SideBatch, right: SideBatch, pl: int,
                       pr: int) -> Optional[torch.Tensor]:
        """The ON residual over the broadcast padded columns, on the card:
        a bool tensor broadcastable to (pl, pr), or None (no residual)."""
        if self._residual is None:
            return None
        cols = {k: self._to_dev(v)[:, None] for k, v in
                self._prep_cols(left, self.resid_l, pl).items()}
        cols.update({k: self._to_dev(v)[None, :] for k, v in
                      self._prep_cols(right, self.resid_r, pr).items()})
        res = self._residual(cols)
        if not isinstance(res, torch.Tensor):  # a constant residual
            res = torch.full((1, 1), bool(res), device=self.device)
        res = res.to(torch.bool)
        while res.dim() < 2:
            res = res[None]
        return res

    # -------------------------------------------------------------- match
    def match(self, left: SideBatch, right: SideBatch) -> np.ndarray:
        """The exact [nl, nr] join decision mask, via the match kernel.
        Raises JoinWindowFallback when this window's data steps outside the
        device contract."""
        nl, nr = left.n, right.n
        slot_l, slot_r = self._slots(left), self._slots(right)
        ts_l, ts_r = self._ts32(left, right)
        side_l, side_r = self._upload(slot_l, ts_l, slot_r, ts_r)
        packed = kernels.join_match(
            *side_l, *side_r, self.lo, self.hi,
            self._residual_mask(left, right, len(side_l[0]),
                                len(side_r[0])))
        out, hits = self._fetch(packed, nl, nr)
        self.rows_total["l"] += nl
        self.rows_total["r"] += nr
        self.matches_total += hits
        return out

    def _upload(self, slot_l: np.ndarray, ts_l: np.ndarray,
                slot_r: np.ndarray, ts_r: np.ndarray):
        """Each side's (slots, times, validity), padded to a power of two,
        on the ring's device."""
        sides = []
        for slot, ts in ((slot_l, ts_l), (slot_r, ts_r)):
            n = len(slot)
            p = _pad_pow2(n)
            valid = np.zeros(p, dtype=bool)
            valid[:n] = True
            sides.append((self._to_dev(np.pad(slot, (0, p - n))),
                          self._to_dev(np.pad(ts, (0, p - n))),
                          self._to_dev(valid)))
        return sides

    def _fetch(self, packed: torch.Tensor, nl: int,
               nr: int) -> Tuple[np.ndarray, int]:
        """The packed mask's first nl rows on the host, unpacked to a bool
        [nl, nr], and its count of matches. From a card the rows are
        copied into the ring's pinned buffer on the current stream, which
        is then synchronized."""
        rows = packed[:nl]
        if rows.device.type == "cuda":
            n = rows.numel()
            if self._pinned is None or self._pinned.numel() < n:
                self._pinned = torch.empty(n, dtype=torch.uint8,
                                           pin_memory=True)
            host = self._pinned[:n].view(rows.shape)
            host.copy_(rows, non_blocking=True)
            torch.cuda.current_stream(rows.device).synchronize()
            rows = host
        return unpack_mask(rows.numpy(), nr)

    def match_host(self, left: SideBatch, right: SideBatch) -> np.ndarray:
        """Numpy shadow twin of `match` from the same lowering — same slots,
        same rebased band, same residual IR compiled for host."""
        nl, nr = left.n, right.n
        slot_l, slot_r = self._slots(left), self._slots(right)
        ts_l, ts_r = self._ts32(left, right)
        eq = slot_l[:, None] == slot_r[None, :]
        dt = ts_l[:, None].astype(np.int64) - ts_r[None, :]
        mask = eq & (dt >= self.lo) & (dt <= self.hi)
        if self._residual_host is not None:
            cols = {k: v[:, None] for k, v in
                    self._prep_cols(left, self.resid_l, nl).items()}
            cols.update({k: v[None, :] for k, v in
                         self._prep_cols(right, self.resid_r, nr).items()})
            mask = mask & np.asarray(self._residual_host(cols), dtype=bool)
        return mask

    # ---------------------------------------------------------- ring store
    def append(self, side: str, batch: SideBatch) -> None:
        """Stage one side's rows into the event-time ring. Band values
        bucket by `bucket_ms`; NULL-timestamped rows ride bucket 0 (they can
        never match a band predicate but LEFT/FULL still emit them)."""
        ts = np.zeros(batch.n, dtype=np.int64)
        if self.band and batch.band is not None:
            for i, v in enumerate(batch.band):
                if not _is_null(v) and isinstance(v, (int, float)):
                    ts[i] = int(v)
        buckets = self._buckets[side]
        for b in np.unique(ts // self.bucket_ms):
            sel = np.nonzero(ts // self.bucket_ms == b)[0]
            sub = SideBatch(
                n=len(sel),
                key_cols=[[c[i] for i in sel] for c in batch.key_cols],
                band=([batch.band[i] for i in sel]
                      if batch.band is not None else None),
                cols={k: [v[i] for i in sel]
                      for k, v in batch.cols.items()})
            buckets.setdefault(int(b), []).append((sub, ts[sel]))
            self._ring_rows[side] += len(sel)

    def window(self, side: str, lo_ts: int, hi_ts: int) -> SideBatch:
        """The banded gather: concatenate only the buckets an interval
        [lo_ts, hi_ts] can reach (bucket selection is index arithmetic over
        bucket ids, never a scan of resident rows)."""
        b_lo = lo_ts // self.bucket_ms
        b_hi = hi_ts // self.bucket_ms
        out = SideBatch(n=0, key_cols=[[] for _ in range(self.n_key_cols)])
        if self.band:
            out.band = []
        for b in sorted(self._buckets[side]):
            if b < b_lo or b > b_hi:
                continue
            for sub, ts in self._buckets[side][b]:
                keep = np.nonzero((ts >= lo_ts) & (ts <= hi_ts))[0]
                for ci in range(self.n_key_cols):
                    out.key_cols[ci].extend(
                        sub.key_cols[ci][i] for i in keep)
                if out.band is not None and sub.band is not None:
                    out.band.extend(sub.band[i] for i in keep)
                for k, v in sub.cols.items():
                    out.cols.setdefault(k, []).extend(v[i] for i in keep)
                out.n += len(keep)
        return out

    def evict(self, before_ts: int) -> int:
        """Drop whole buckets strictly below `before_ts` (a bucket is
        evicted only when no legal band can reach it). Returns rows
        dropped."""
        cut = before_ts // self.bucket_ms
        dropped = 0
        for buckets in self._buckets.values():
            for b in [b for b in buckets if b < cut]:
                dropped += sum(s.n for s, _ in buckets.pop(b))
        for side in self._ring_rows:
            self._ring_rows[side] = sum(
                s.n for chunks in self._buckets[side].values()
                for s, _ in chunks)
        return dropped

    def reset_ring(self) -> None:
        self._buckets = {"l": {}, "r": {}}
        self._ring_rows = {"l": 0, "r": 0}

    def ring_rows(self, side: str) -> int:
        return self._ring_rows[side]
