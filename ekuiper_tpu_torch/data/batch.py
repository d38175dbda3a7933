"""Columnar micro-batch (subset of ekuiper_tpu/data/batch.py).

Runs of events become a struct-of-arrays ColumnBatch; its numeric columns
upload to the card as tensors, so the window/aggregate kernels fold a whole
batch per launch. String columns stay host-side; GROUP BY keys are
dictionary-encoded to int32 slot ids by the key table (ops/keytable.py)
before upload.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np


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
