"""Host tail of the heavy-hitters finalize (counterpart of the one function
of ekuiper_tpu/ops/prefinalize.py that the port's synchronous finalize
needs; the latency-hiding prefinalize pipeline is not ported).
"""
from __future__ import annotations


def hh_dedupe_topk(codes_row, est_row, k: int):
    """Dedupe estimate-descending candidates (a code can appear once per
    depth) and trim to top-k (code, count) pairs."""
    seen = set()
    row = []
    for c, e in zip(codes_row, est_row):
        if e <= 0:
            break
        c = int(c)
        if c in seen:
            continue
        seen.add(c)
        row.append((c, int(round(e))))
        if len(row) >= k:
            break
    return row
