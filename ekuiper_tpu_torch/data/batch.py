"""Columnar micro-batch (subset of ekuiper_tpu/data/batch.py).

Runs of events become a struct-of-arrays ColumnBatch; its numeric columns
upload to the card as tensors, so the window/aggregate kernels fold a whole
batch per launch. String columns stay host-side; GROUP BY keys are
dictionary-encoded to int32 slot ids by the key table (ops/keytable.py)
before upload.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .rows import Tuple


@dataclass
class ColumnBatch:
    """Struct-of-arrays batch. All columns have equal length `n`.

    - numeric columns: np.float32 / np.int64 / np.bool_
    - host columns (strings, arrays, structs, schemaless): dtype=object
    - `valid[name]`: optional bool mask (absent = all valid)
    - `timestamps`: int64 ms (event time when configured, else ingest time)
    """

    n: int
    columns: Dict[str, np.ndarray] = field(default_factory=dict)
    valid: Dict[str, np.ndarray] = field(default_factory=dict)
    timestamps: Optional[np.ndarray] = None
    emitter: str = ""

    def __len__(self) -> int:
        return self.n

    def is_valid(self, name: str) -> np.ndarray:
        v = self.valid.get(name)
        if v is None:
            return np.ones(self.n, dtype=np.bool_)
        return v

    def select(self, mask: np.ndarray) -> "ColumnBatch":
        return self.take(np.nonzero(mask)[0])

    def to_tuples(self) -> List[Tuple]:
        """Back to row objects (the host operator chain's path): one Tuple
        per row, an invalid value left out of its message, numpy scalars
        as Python values, the batch's emitter and timestamps (0 without)."""
        out: List[Tuple] = []
        names = list(self.columns)
        cols = [self.columns[k] for k in names]
        valids = [self.valid.get(k) for k in names]
        ts = self.timestamps
        for i in range(self.n):
            msg: Dict[str, Any] = {}
            for name, col, v in zip(names, cols, valids):
                if v is not None and not v[i]:
                    continue
                val = col[i]
                if isinstance(val, np.generic):
                    val = val.item()
                msg[name] = val
            out.append(Tuple(emitter=self.emitter, message=msg,
                             timestamp=int(ts[i]) if ts is not None else 0))
        return out

    def take(self, idx: np.ndarray) -> "ColumnBatch":
        """The rows at `idx`, every column, mask and timestamp with them."""
        return ColumnBatch(
            n=len(idx),
            columns={k: v[idx] for k, v in self.columns.items()},
            valid={k: v[idx] for k, v in self.valid.items()},
            timestamps=None if self.timestamps is None else self.timestamps[idx],
            emitter=self.emitter)

    @staticmethod
    def concat(batches: Sequence["ColumnBatch"]) -> "ColumnBatch":
        """One batch of `batches`' rows in order (the reference's concat):
        a column some batch lacks is zero there and invalid, and the
        timestamps are kept when every batch has them."""
        batches = [b for b in batches if b.n > 0]
        if not batches:
            return ColumnBatch(n=0)
        if len(batches) == 1:
            return batches[0]
        names: List[str] = []
        for b in batches:
            names.extend(k for k in b.columns if k not in names)
        columns: Dict[str, np.ndarray] = {}
        valid: Dict[str, np.ndarray] = {}
        for name in names:
            dtype = next(b.columns[name].dtype for b in batches
                         if name in b.columns)
            parts, vparts, need_valid = [], [], False
            for b in batches:
                col = b.columns.get(name)
                if col is None:
                    col = np.zeros(b.n, dtype=dtype)
                    vp = np.zeros(b.n, dtype=np.bool_)
                    need_valid = True
                else:
                    vp = b.valid.get(name)
                    if vp is None:
                        vp = np.ones(b.n, dtype=np.bool_)
                    else:
                        need_valid = need_valid or not vp.all()
                parts.append(col)
                vparts.append(vp)
            columns[name] = np.concatenate(parts)
            if need_valid:
                valid[name] = np.concatenate(vparts)
        ts = None
        if all(b.timestamps is not None for b in batches):
            ts = np.concatenate([b.timestamps for b in batches])
        return ColumnBatch(n=sum(b.n for b in batches), columns=columns,
                           valid=valid, timestamps=ts,
                           emitter=batches[0].emitter)


def from_tuples(tuples: Sequence[Tuple], emitter: str = "") -> ColumnBatch:
    """Columnarize a run of rows (the reference's schemaless path): each
    column's dtype is inferred from the Python types it holds (float32,
    int64, bool, else object), an absent value is invalid; the rows'
    timestamps are kept."""
    n = len(tuples)
    if n == 0:
        return ColumnBatch(n=0, emitter=emitter)
    names: List[str] = []
    seen = set()
    for t in tuples:
        for k in t.message:
            if k not in seen:
                seen.add(k)
                names.append(k)
    columns: Dict[str, np.ndarray] = {}
    valid: Dict[str, np.ndarray] = {}
    for name in names:
        raw = [t.message.get(name) for t in tuples]
        mask = np.array([r is not None for r in raw], dtype=np.bool_)
        dtype = _infer_dtype(raw, mask)
        if dtype == np.object_:
            col = np.empty(n, dtype=np.object_)
            col[:] = raw
        else:
            col = np.zeros(n, dtype=dtype)
            if mask.all():
                try:
                    col[:] = raw
                except (ValueError, TypeError, OverflowError):
                    col = np.empty(n, dtype=np.object_)
                    col[:] = raw
                    dtype = np.object_
            else:
                for i, r in enumerate(raw):
                    if mask[i]:
                        try:
                            col[i] = r
                        except (ValueError, TypeError, OverflowError):
                            mask[i] = False
                if dtype == np.float32:
                    col[~mask] = np.nan
        columns[name] = col
        if not mask.all():
            valid[name] = mask
    ts = np.fromiter((t.timestamp for t in tuples), dtype=np.int64, count=n)
    return ColumnBatch(n=n, columns=columns, valid=valid, timestamps=ts,
                       emitter=emitter)


def _infer_dtype(raw: List[Any], mask: np.ndarray):
    saw_float = saw_int = saw_bool = saw_other = False
    for r, ok in zip(raw, mask):
        if not ok:
            continue
        if isinstance(r, bool):
            saw_bool = True
        elif isinstance(r, int):
            saw_int = True
        elif isinstance(r, float):
            saw_float = True
        else:
            saw_other = True
    if saw_other:
        return np.object_
    if saw_bool and (saw_int or saw_float):
        # don't silently coerce True/False into 1/1.0 — keep originals
        return np.object_
    if saw_float:
        return np.float32
    if saw_int:
        return np.int64
    if saw_bool:
        return np.bool_
    return np.object_
