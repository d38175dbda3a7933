"""A stream's entry into a host operator chain (the part of the reference's
SourceNode, ekuiper_tpu/runtime/nodes_source.py, that the chain sees): the
rows it is given leave stamped with the stream's name as their emitter —
the name a join matches rows by — and, where they carry no time, with the
engine clock's now as their ingest timestamp. Decoding, batching and the
source connectors are not ported (ROADMAP Queue 1 items 4 and 5): the
caller hands it ColumnBatches, Tuples or message dicts.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from ..data.batch import ColumnBatch
from ..utils import timex
from .events import EOF
from .node import Node


class EntryNode(Node):
    def process(self, item: Any) -> None:
        if isinstance(item, ColumnBatch):
            ts = item.timestamps
            if ts is None:
                ts = np.full(item.n, timex.now_ms(), dtype=np.int64)
            item = dataclasses.replace(item, emitter=self.name,
                                       timestamps=ts)
            self.emit(item, count=item.n)
        else:
            self.emit(item)

    def on_eof(self, eof: EOF) -> None:
        """The stream ended: the next node takes the EOF as the control
        event it is (a window node flushes its buffer), not as data."""
        for out in self.outputs:
            out.put_control(eof)
