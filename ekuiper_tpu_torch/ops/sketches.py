"""Sketch primitives of the fused group-by (counterpart of
ekuiper_tpu/ops/sketches.py): HyperLogLog registers, the signed
log-histogram for percentiles, the linear heavy-hitters sketch, and the
window-level `CountMinSketch`. Constants and layouts are the reference's,
so the wide state components `hll` (.., HLL_M), `hist` (.., HIST_BINS) and
`hh` (.., HH_SIZE) cross between the packages.

These are the plain PyTorch versions of what the CUDA kernels compute
(csrc/sketches.cu). Torch on the CPU has no `>>` or `%` on uint32, so every
hash runs in int64 and is masked to 32 bits after each multiply: the low
32 bits of a product survive the signed wrap.

The float steps follow the reference as XLA compiles it inside the
JAX package's jitted programs, not its source text: XLA turns a division
by a constant into a multiply by the float32 reciprocal (`hist_bin`), and
folds the two constant factors of the bin centre into one
(`hist_quantile`). Written as the source reads, the port would put a few
values within ~2e-5 of a bin edge into the neighbouring bin.

One deliberate difference from the reference: `hll_parts` takes the
position of the highest set bit of float32(h2) from the float's exponent
field, where the reference computes floor(log2(float32(h2))) + 1 with a
float log2. The two agree wherever log2 is exact about powers of two; an
approximate log2 (XLA's on the CPU, and the TPU's) misses a few values,
which then land one rho apart (PERF.md, Findings).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import Device, resolve_device

HLL_M = 256  # registers per key (power of two)
HIST_BINS = 1024
_HIST_LO = 1e-9
_HIST_HI = 1e12
# signed layout: bins [0, HALF) negative values, most negative first;
# bin HALF zeros; bins (HALF, 2*HALF] positive values, ascending
_HIST_HALF = (HIST_BINS - 1) // 2
_GAMMA = (_HIST_HI / _HIST_LO) ** (1.0 / (_HIST_HALF - 1))
_LOG_GAMMA = float(np.log(_GAMMA))
# the float32 constants of the compiled reference: the reciprocals its
# divisions by _HIST_LO and _LOG_GAMMA become, and the centre's folded
# factor _HIST_LO · sqrt(_GAMMA)
_F1 = np.float32(1.0)
_INV_LO = float(_F1 / np.float32(_HIST_LO))
_INV_LOG_GAMMA = float(_F1 / np.float32(_LOG_GAMMA))
_CENTER_SCALE = float(np.float32(_HIST_LO) * np.float32(np.sqrt(_GAMMA)))

# heavy hitters: per depth row d, code c updates slot h_d(c) with
# counters[0] += 1 and counters[1 + b] += bit_b(c) for every bit b
HH_DEPTH = 2
HH_WIDTH = 64
HH_BITS = 20  # dictionary codes < 2^20
HH_SIZE = HH_DEPTH * HH_WIDTH * (1 + HH_BITS)
HH_MAX_CODES = 1 << HH_BITS

_M32 = 0xFFFFFFFF
_MIX1, _MIX2 = 0x7FEB352D, 0x846CA68B


# ------------------------------------------------------------------ hashing
def _splitmix32(x: torch.Tensor, c1: int, c2: int) -> torch.Tensor:
    """x: int64 tensor of uint32 values; returns the same, hashed."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = (x * c1) & _M32
    x = x ^ (x >> 15)
    x = (x * c2) & _M32
    return x ^ (x >> 16)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 constant on `like`'s device. Dividing by it is a true
    division on every device (a Python scalar divisor becomes a multiply
    by its reciprocal on CUDA), as in the reference and the kernels."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _f32_bits(v) -> torch.Tensor:
    """float32 bit patterns as int64 in [0, 2^32)."""
    return torch.as_tensor(v, dtype=torch.float32).view(torch.int32).to(
        torch.int64) & _M32


def hash_f32(v, salt: int = 0) -> torch.Tensor:
    """Hash float32 values (bit pattern) to uint32 values (int64)."""
    bits = _f32_bits(v) ^ ((0x9E3779B9 * (salt + 1)) & _M32)
    return _splitmix32(bits, _MIX1, _MIX2)


def hll_parts(values) -> tuple:
    """(register index int64, rho float32) per value for the HLL update.
    rho = 33 - (position of the highest set bit of float32(max(h2, 1))),
    read from the rounded float's exponent field."""
    h1 = hash_f32(values, salt=0)
    h2 = hash_f32(values, salt=1)
    reg = h1 & (HLL_M - 1)
    hv = torch.clamp(h2, min=1).to(torch.float32)
    expo = (hv.view(torch.int32).to(torch.int64) >> 23) & 0xFF
    rho = (159 - expo).to(torch.float32)  # 33 - (expo - 126)
    return reg, rho


def hll_estimate(registers: torch.Tensor) -> torch.Tensor:
    """HLL cardinality estimate; registers (..., m) float32."""
    m = registers.shape[-1]
    alpha = 0.7213 / (1.0 + 1.079 / m)
    z = torch.sum(torch.exp2(-registers), dim=-1)
    raw = _f32(alpha * m * m, z) / z
    zeros = torch.sum(registers == 0.0, dim=-1)
    small = m * torch.log(
        _f32(m, z) / torch.clamp(zeros, min=1).to(torch.float32))
    return torch.where((raw < 2.5 * m) & (zeros > 0), small, raw)


# --------------------------------------------------------------- log histogram
def _mag_bin(mag: torch.Tensor) -> torch.Tensor:
    """Log bin of a magnitude in [0, HALF-1]."""
    clamped = torch.clamp(mag, _HIST_LO, _HIST_HI * 0.999)
    idx = torch.floor(torch.log(clamped * _INV_LO) * _INV_LOG_GAMMA).to(
        torch.int64)
    return torch.clamp(idx, 0, _HIST_HALF - 1)


def hist_bin(values) -> torch.Tensor:
    """Float values (any sign) → bin of the signed log layout (int64)."""
    v = torch.as_tensor(values, dtype=torch.float32)
    mag = _mag_bin(torch.abs(v))
    pos = _HIST_HALF + 1 + mag
    neg = _HIST_HALF - 1 - mag
    return torch.where(v > 0, pos, torch.where(v < 0, neg, _HIST_HALF))


def hist_quantile(hist: torch.Tensor, frac: float) -> torch.Tensor:
    """Quantile from per-key signed histograms (..., B); NaN where a key's
    histogram is empty."""
    total = torch.sum(hist, dim=-1)
    cum = torch.cumsum(hist, dim=-1)
    target = torch.clamp(frac * total[..., None], min=1e-9)
    ge = cum >= target
    # first bin where cum >= target (0 when there is none, as argmax)
    idx = torch.argmax(ge.to(torch.int8), dim=-1)
    mag_idx = torch.where(idx > _HIST_HALF, idx - _HIST_HALF - 1,
                          _HIST_HALF - 1 - idx).to(torch.float32)
    center = torch.exp(mag_idx * _LOG_GAMMA) * _CENTER_SCALE
    val = torch.where(idx == _HIST_HALF, 0.0,
                      torch.where(idx > _HIST_HALF, center, -center))
    return torch.where(total > 0, val, float("nan"))


# ------------------------------------------------- heavy hitters (linear)
def _hh_salt(d: int) -> int:
    return (0x9E3779B9 * (d + 7)) & _M32


def _hh_slot(code: torch.Tensor, d: int) -> torch.Tensor:
    return _splitmix32(code ^ _hh_salt(d), _MIX1, _MIX2) & (HH_WIDTH - 1)


def hh_update_parts(codes: torch.Tensor, mf: torch.Tensor) -> tuple:
    """Scatter indices + weights for one micro-batch of dictionary codes.

    codes: (mb,) float32 integer codes (NaN rows carry weight 0 via mf).
    mf: (mb,) float32 row mask. Returns (idx int64, wts float32), each
    (mb, HH_DEPTH*(1+HH_BITS)), addressing the flat per-key hh component.
    """
    code = torch.nan_to_num(codes, nan=0.0).to(torch.int64)
    bits = [((code >> b) & 1).to(torch.float32) for b in range(HH_BITS)]
    idx_parts, w_parts = [], []
    for d in range(HH_DEPTH):
        base = (d * HH_WIDTH + _hh_slot(code, d)) * (1 + HH_BITS)
        idx_parts.append(base)
        w_parts.append(mf)
        for b in range(HH_BITS):
            idx_parts.append(base + 1 + b)
            w_parts.append(mf * bits[b])
    return torch.stack(idx_parts, dim=1), torch.stack(w_parts, dim=1)


def hh_candidates(hh: torch.Tensor, k2: int) -> tuple:
    """Heavy-hitter recovery from the pane-merged sketch.

    hh: (cap, HH_SIZE) float32. Returns (codes, est), each float32
    (cap, k2): per key the k2 bit-majority candidates of largest
    count-min estimate, in lax.top_k's order (estimate descending, the
    lower (depth, slot) index first among equal estimates), before the
    dedupe (a code can appear once per depth).
    """
    cap = hh.shape[0]
    a = hh.reshape(cap, HH_DEPTH, HH_WIDTH, 1 + HH_BITS)
    tot = a[..., 0]  # (cap, D, W)
    bits = (a[..., 1:] * 2.0) > tot[..., None]
    shifts = torch.arange(HH_BITS, dtype=torch.int64, device=hh.device)
    codes = torch.sum(bits.to(torch.int64) << shifts, dim=-1)  # (cap, D, W)
    # a recovered code must hash back to its own slot, with traffic there
    wslots = torch.arange(HH_WIDTH, dtype=torch.int64, device=hh.device)
    ok = torch.stack([(tot[:, d, :] > 0) & (_hh_slot(codes[:, d, :], d)
                                             == wslots)
                      for d in range(HH_DEPTH)], dim=1)
    # count-min estimate: min over depths of the total at the code's slot
    flat = codes.reshape(cap, -1)  # (cap, D*W)
    est = torch.full(flat.shape, float("inf"), dtype=torch.float32,
                     device=hh.device)
    for d2 in range(HH_DEPTH):
        s = _hh_slot(flat, d2)
        est = torch.minimum(est, torch.gather(tot[:, d2, :], 1, s))
    est = torch.where(ok.reshape(cap, -1), est, 0.0)
    order = torch.sort(est, dim=1, descending=True, stable=True).indices
    top = order[:, :k2]
    return (torch.gather(flat, 1, top).to(torch.float32),
            torch.gather(est, 1, top))


# ----------------------------------------------------------------- count-min
class CountMinSketch:
    """Window-level count-min sketch with host candidate tracking for heavy
    hitters (top-k most frequent values); the reference's class.

    Device: (d, w) float32 counts, updated and queried by the cms_update /
    cms_query kernels (csrc/countmin.cu). Host: the bounded candidate set of
    distinct values seen, whose estimates are read from the sketch. The
    reference pads each batch to a pow-2 ladder to close its compile cache;
    the kernels take any length, so nothing is padded here.
    """

    def __init__(self, depth: int = 4, width: int = 8192,
                 max_candidates: int = 4096, device: Device = None) -> None:
        self.device = resolve_device(device)
        self.depth = depth
        self.width = width
        self.max_candidates = max_candidates
        self.counts = torch.zeros((depth, width), dtype=torch.float32,
                                  device=self.device)
        self.candidates: dict = {}

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _query(self, cand: np.ndarray) -> np.ndarray:
        from . import kernels

        return kernels.cms_query(self.counts, self._upload(cand)).cpu().numpy()

    def update(self, values) -> None:
        from . import kernels

        arr = np.asarray(values, dtype=np.float32)
        kernels.cms_update(self.counts, self._upload(arr))
        new = [
            float(x) for x in np.unique(arr) if float(x) not in self.candidates
        ]
        if not new:
            return
        if len(self.candidates) + len(new) <= self.max_candidates:
            for x in new:
                self.candidates[x] = True
            return
        # saturated: keep the max_candidates values of highest estimate, so a
        # late frequent value can displace a rare incumbent
        cand = np.concatenate([
            np.fromiter(self.candidates.keys(), dtype=np.float32,
                        count=len(self.candidates)),
            np.asarray(new, dtype=np.float32),
        ])
        ests = self._query(cand)
        keep = np.argsort(-ests)[: self.max_candidates]
        self.candidates = {float(cand[i]): True for i in keep}

    def heavy_hitters(self, k: int):
        if not self.candidates:
            return []
        cand = np.fromiter(self.candidates.keys(), dtype=np.float32)
        ests = self._query(cand)
        order = np.argsort(-ests)[:k]
        return [(float(cand[i]), float(ests[i])) for i in order]

    def reset(self) -> None:
        self.counts.zero_()
        self.candidates.clear()
