"""Segmented-scan analytic kernels — ROW_NUMBER / RANK / DENSE_RANK / LAG /
LEAD and running sums on the card (counterpart of ekuiper_tpu/ops/segscan.py).

The reference key-sorts a micro-batch inside its XLA programs (jnp.lexsort,
stable, arrival index as tiebreak) and turns every function into a
segmented `associative_scan` over the sorted order. The port's two kernels
(ops/kernels.py `segscan_shift`, `segscan_sort`; csrc/relational.cu) sort
the padded batch by hand (a bitonic sort of packed keys) and walk each
segment in order, one thread a segment:

  * `shift` (the reference's `segscan.shift` site, segscan.py:124): the
    stateful per-partition ROW_NUMBER, LAG(1) and running sum of one
    micro-batch, continuing a carry of O(partitions) scalars — count, last
    value, has-last, running sum per key slot — never buffered rows. The
    carry is four tensors of the key capacity on the card, updated in
    place (the reference donates them), growing on the same doubling
    ladder as every other kernel's state.
  * `ranks` (`segscan.sort`, segscan.py:165): the stateless per-collection
    ROW_NUMBER / RANK / DENSE_RANK / LEAD(1) (window functions see one
    complete collection at a time).

NULL semantics match the host evaluator: a NULL value ranks as NULL
(rank/dense_rank skip it and it never counts as "smaller"), LAG records
NULL rows in history (NaN-encoded), running sums are NULL-transparent.
`snapshot`/`restore` keep the reference's JSON form, so a carry crosses
both packages. `sort_host` and `shift_host` are the reference's numpy
twins, kept as they are.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..utils.device import Device, resolve_device
from . import kernels

#: pow-2 pad floor per micro-batch — doublings cover the rest
SEG_PAD_FLOOR = 256

#: pad-row segment id: sorts after every real slot
_SEG_PAD = kernels.SEG_PAD


def _pad_pow2(n: int) -> int:
    b = SEG_PAD_FLOOR
    while b < n:
        b <<= 1
    return b


class SegScan:
    """Owner of the two segmented-scan kernels and the shift's carry. One
    instance per lifted node, its tensors on `device` (CUDA unless the
    caller names the CPU, where the kernels' plain versions run)."""

    def __init__(self, capacity: int = 4096, device: Device = None) -> None:
        self.device = resolve_device(device)
        self.capacity = int(capacity)
        self._carry = self._zeros(self.capacity)
        self.rows_total = 0
        self.spills_total = 0  # partitions continued across micro-batches

    def _zeros(self, n: int):
        dev = self.device
        return (torch.zeros(n, dtype=torch.int32, device=dev),    # count
                torch.zeros(n, dtype=torch.float32, device=dev),  # last
                torch.zeros(n, dtype=torch.bool, device=dev),     # has last
                torch.zeros(n, dtype=torch.float32, device=dev))  # run sum

    def _padded(self, seg: np.ndarray, vals: np.ndarray, n: int):
        b = _pad_pow2(n)
        sg = np.zeros(b, dtype=np.int32)
        sg[:n] = seg[:n]
        va = np.full(b, np.nan, dtype=np.float32)
        va[:n] = vals[:n]
        valid = np.zeros(b, dtype=bool)
        valid[:n] = True
        return tuple(torch.from_numpy(a).to(self.device)
                     for a in (sg, va, valid))

    # -------------------------------------------------------- host entry
    def shift(self, slots: np.ndarray, vals: np.ndarray, n: int
              ) -> Dict[str, np.ndarray]:
        """Streaming analytics for one micro-batch (arrival order):
        per-partition ROW_NUMBER, LAG(1), running sum, continuing the carry
        on the card."""
        while int(np.max(slots, initial=0)) >= self.capacity:
            self.grow(self.capacity * 2)
        rn, lag, lhas, run, cont = kernels.segscan_shift(
            self._carry, *self._padded(slots, vals, n))
        self.rows_total += n
        self.spills_total += int(cont.item())
        return {"row_number": rn[:n].cpu().numpy(),
                "lag": lag[:n].cpu().numpy(),
                "lag_has": lhas[:n].cpu().numpy(),
                "run_sum": run[:n].cpu().numpy()}

    def ranks(self, seg: np.ndarray, vals: np.ndarray, n: int
              ) -> Dict[str, np.ndarray]:
        """Whole-collection window functions: ROW_NUMBER / RANK /
        DENSE_RANK / LEAD(1) over one complete (padded) collection."""
        out = kernels.segscan_sort(*self._padded(seg, vals, n))
        self.rows_total += n
        names = ("row_number", "lead", "lead_has", "rank", "dense_rank",
                 "rank_has")
        return {k: v[:n].cpu().numpy() for k, v in zip(names, out)}

    # ------------------------------------------------------------- state
    def grow(self, new_capacity: int) -> None:
        """Capacity doubling: the carry pads with the fold identities
        (count 0, no last value, sum 0)."""
        if new_capacity <= self.capacity:
            return
        pad = self._zeros(new_capacity - self.capacity)
        self._carry = tuple(torch.cat([c, p])
                            for c, p in zip(self._carry, pad))
        self.capacity = new_capacity

    def snapshot(self) -> Dict[str, Any]:
        """JSON-serializable carry state (the reference's checkpoint form;
        NaN floats survive the json round-trip)."""
        c = self.peek_carry()
        return {"capacity": self.capacity,
                "cnt": [int(x) for x in c["cnt"]],
                "last": [float(x) for x in c["last"]],
                "has": [bool(x) for x in c["has"]],
                "acc": [float(x) for x in c["acc"]]}

    def restore(self, state: Dict[str, Any]) -> None:
        self.capacity = int(state["capacity"])
        self._carry = tuple(
            torch.from_numpy(np.asarray(state[k], dtype=dt)).to(self.device)
            for k, dt in (("cnt", np.int32), ("last", np.float32),
                          ("has", bool), ("acc", np.float32)))

    def peek_carry(self) -> Dict[str, np.ndarray]:
        """Host view of the carry partials (lag-state migration and the
        parity tests read this; never on the hot path)."""
        return {k: t.cpu().numpy()
                for k, t in zip(("cnt", "last", "has", "acc"), self._carry)}


# ------------------------------------------------------------- host twins
def sort_host(seg: np.ndarray, vals: np.ndarray, n: int
              ) -> Dict[str, np.ndarray]:
    """Numpy shadow twin of `ranks` (the reference's, unchanged)."""
    seg = np.asarray(seg[:n], dtype=np.int64)
    vals = np.asarray(vals[:n], dtype=np.float32)
    rn = np.zeros(n, dtype=np.int32)
    rank = np.zeros(n, dtype=np.int32)
    dense = np.zeros(n, dtype=np.int32)
    rhas = np.zeros(n, dtype=bool)
    lead = np.full(n, np.nan, dtype=np.float32)
    lead_has = np.zeros(n, dtype=bool)
    for s in np.unique(seg):
        sel = np.nonzero(seg == s)[0]
        rn[sel] = np.arange(1, len(sel) + 1, dtype=np.int32)
        lead[sel[:-1]] = vals[sel[1:]]
        lead_has[sel[:-1]] = True
        sv = vals[sel]
        ok = ~np.isnan(sv)
        rhas[sel] = ok
        vv = sv[ok]
        if len(vv):
            uniq = np.unique(vv)
            rank[sel[ok]] = 1 + np.searchsorted(np.sort(vv), vv,
                                                side="left").astype(np.int32)
            dense[sel[ok]] = 1 + np.searchsorted(uniq, vv).astype(np.int32)
    return {"row_number": rn, "rank": rank, "dense_rank": dense,
            "rank_has": rhas, "lead": lead, "lead_has": lead_has}


def shift_host(carry: Dict[str, np.ndarray], slots: np.ndarray,
               vals: np.ndarray, n: int) -> Dict[str, np.ndarray]:
    """Numpy shadow twin of `shift` (mutates `carry` in place — dict of
    cnt/last/has/acc arrays; the reference's, unchanged)."""
    rn = np.zeros(n, dtype=np.int32)
    lag = np.full(n, np.nan, dtype=np.float32)
    lhas = np.zeros(n, dtype=bool)
    run = np.zeros(n, dtype=np.float32)
    for i in range(n):
        s = int(slots[i])
        carry["cnt"][s] += 1
        rn[i] = carry["cnt"][s]
        lag[i] = carry["last"][s] if carry["has"][s] else np.nan
        lhas[i] = bool(carry["has"][s])
        v = float(vals[i])
        if not np.isnan(v):
            carry["acc"][s] += np.float32(v)
        run[i] = carry["acc"][s]
        carry["last"][s] = v
        carry["has"][s] = True
    return {"row_number": rn, "lag": lag, "lag_has": lhas, "run_sum": run}
