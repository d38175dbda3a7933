"""Columnar micro-batch (subset of ekuiper_tpu/data/batch.py).

Runs of events become a struct-of-arrays ColumnBatch; its numeric columns
upload to the card as tensors, so the window/aggregate kernels fold a whole
batch per launch. String columns stay host-side; GROUP BY keys are
dictionary-encoded to int32 slot ids by the key table (ops/keytable.py)
before upload.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

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
