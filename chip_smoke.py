#!/usr/bin/env python3
"""Proof on one CUDA card that the PyTorch/CUDA port (ekuiper_tpu_torch)
builds, runs its main path and gives right answers.

Run from the repository root on a machine with a card:

    python3 chip_smoke.py [--seed 0]

Phases (each prints its own lines; any failure exits non-zero and prints
no result):

1. the card (nvidia-smi name and power limit) and the kernels' build time
   (csrc/groupby.cu and csrc/sketches.cu, one nvcc each for sm_90a, run
   together);
2. each kernel against its plain PyTorch version on the card, at the main
   path's shapes (65,536 rows, 16,384 slots; the sketch kernels at the
   sketch rules' state, up to 2 panes x 16,384 x 2,688 floats): error,
   kernel time (CUDA events), the kernel body's own device time (profiler
   trace) and the host time of one wrapper call, plain time, a library
   yardstick and the bytes/operations bound;
3. end to end, tumbling: the flagship rule
   `SELECT deviceId, avg(temperature), count(*), min(temperature),
   max(temperature) FROM demo GROUP BY deviceId, TUMBLINGWINDOW(ss, 10)`
   over 10,000 device keys, temperature ~ N(20, 5), 65,536-row batches,
   every emitted row held against an independent numpy float64 group-by;
4. end to end, hopping: the same with HOPPINGWINDOW(ss, 10, 5) and
   stddev(temperature);
A. heavy hitters (BASELINE config #2, bench.py:459):
   `SELECT deviceId, heavy_hitters(code, 3) AS top, count(*) AS c FROM demo
   GROUP BY deviceId, HOPPINGWINDOW(ss, 10, 5)` over 10,000 keys, skewed
   codes (7 at 35 %, 13 at 20 %, 99 at 15 %, a 2,000-value tail), 65,536-row
   batches, 9 hop boundaries; the state grows from 2,048 to 16,384 slots;
   every emitted top list held against an independent numpy twin of the
   sketch (its own dictionary, fold, recovery, dedupe and trim);
B. the wide finalize: bench.py:1623 (`stddev` + `percentile_approx
   (temperature, 0.9)`, tumbling) and bench.py:1626 (`hll(humidity)`,
   hopping), every emitted value held against numpy twins of the bins and
   registers (the percentile in the same bin, hll within ±1), and the
   sketches' error against exact quantiles and distinct counts printed;
5. each kernel's launch count on the paths that use it (each must be
   > 0), then the JSON kernel table and the one-line result.
"""
from __future__ import annotations

import argparse
import functools
import json
import statistics
import subprocess
import sys
import time

import numpy as np

TUMBLING = (
    "SELECT deviceId, avg(temperature) AS avg_t, count(*) AS cnt, "
    "min(temperature) AS min_t, max(temperature) AS max_t "
    "FROM demo GROUP BY deviceId, TUMBLINGWINDOW(ss, 10)"
)
HOPPING = (
    "SELECT deviceId, avg(temperature) AS avg_t, count(*) AS cnt, "
    "min(temperature) AS min_t, max(temperature) AS max_t, "
    "stddev(temperature) AS sd_t "
    "FROM demo GROUP BY deviceId, HOPPINGWINDOW(ss, 10, 5)"
)
#: the main path's sizes (bench.py's 10k-device tumbling GROUP BY)
N_KEYS, ROWS, SLOTS = 10_000, 65_536, 16_384
HH_RULE = (
    "SELECT deviceId, heavy_hitters(code, 3) AS top, count(*) AS c "
    "FROM demo GROUP BY deviceId, HOPPINGWINDOW(ss, 10, 5)"
)
PCT_RULE = (
    "SELECT deviceId, stddev(temperature) AS sd, percentile_approx"
    "(temperature, 0.9) AS p90 FROM demo "
    "GROUP BY deviceId, TUMBLINGWINDOW(ss, 10)"
)
HLL_RULE = (
    "SELECT deviceId, hll(humidity) AS u FROM demo "
    "GROUP BY deviceId, HOPPINGWINDOW(ss, 10, 5)"
)
#: emitted windows per end-to-end phase, 65,536-row batches per trigger
#: interval, timed runs per kernel
WINDOWS, BATCHES, REPS = 8, 16, 30
#: phases A and B: hop boundaries / windows, and batches per interval
#: (bench.py's heavy-hitters rule: one boundary per 16 batches)
SKETCH_WINDOWS, SKETCH_BATCHES = 9, 16
#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 (non-tensor)
#: operations/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
EPS32 = float(np.finfo(np.float32).eps)
SOURCE = {
    "groupby_fold_scalar": "ekuiper_tpu_torch/csrc/groupby.cu",
    "groupby_finalize_scalar": "ekuiper_tpu_torch/csrc/groupby.cu",
    "groupby_reset_pane": "ekuiper_tpu_torch/csrc/groupby.cu",
    "groupby_fold_wide": "ekuiper_tpu_torch/csrc/sketches.cu",
    "groupby_finalize_wide": "ekuiper_tpu_torch/csrc/sketches.cu",
    "groupby_hh_finalize": "ekuiper_tpu_torch/csrc/sketches.cu",
}
REPLACES = {
    "groupby_fold_scalar": "ekuiper_tpu/ops/groupby.py:348",
    "groupby_finalize_scalar": "ekuiper_tpu/ops/groupby.py:459",
    "groupby_reset_pane": "ekuiper_tpu/ops/groupby.py:763",
    "groupby_fold_wide": "ekuiper_tpu/ops/groupby.py:419",
    "groupby_finalize_wide": "ekuiper_tpu/ops/groupby.py:510",
    "groupby_hh_finalize": "ekuiper_tpu/ops/groupby.py:628",
}
#: which end-to-end paths launch each kernel (phase 5 checks each > 0)
PATHS = {
    "groupby_fold_scalar": ("tumbling", "hopping", "hh", "pct", "hll"),
    "groupby_finalize_scalar": ("tumbling", "hopping", "hh", "pct", "hll"),
    "groupby_reset_pane": ("tumbling", "hopping", "hh", "pct", "hll"),
    "groupby_fold_wide": ("hh", "pct", "hll"),
    "groupby_finalize_wide": ("pct", "hll"),
    "groupby_hh_finalize": ("hh",),
}


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ------------------------------------------------------------------ timing
def time_ms(torch, fn, reps: int) -> float:
    """Median device time of `fn` over `reps` runs, by CUDA events. Each run
    is queued behind a device-side sleep, so the host has enqueued the whole
    of `fn` before the start event executes: the interval is device time,
    not host enqueue time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def body_ms(torch, fn, kernel: str, reps: int):
    """Mean device time of the CUDA kernel `kernel` inside `fn`, from the
    profiler's CUPTI trace: the kernel body alone, without the launch and
    the timing events around it. None when the trace holds no such
    kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    us = [e.time_range.elapsed_us() for e in prof.events()
          if kernel in e.name and e.device_type == cuda]
    return statistics.median(us) / 1e3 if len(us) == reps else None


def host_ms(torch, fn, reps: int) -> float:
    """Median host wall time of one call of `fn` (the wrapper's checks,
    the ctypes call and the enqueue), each queued behind a device-side
    sleep so the call never waits for the card."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
    return statistics.median(times)


def launch_split(torch, fn, kernel: str, reps: int) -> dict:
    """The kernel's body time and the host time of one wrapper call."""
    return {"body_ms": body_ms(torch, fn, kernel, reps),
            "host_ms": host_ms(torch, fn, reps)}


def split_text(split: dict) -> str:
    b = split["body_ms"]
    return (f"body_ms={'not measured' if b is None else f'{b:.4f}'} "
            f"host_ms={split['host_ms']:.4f}")


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------- phase 2
def clone_state(state):
    return {k: v.clone() for k, v in state.items()}


def worst_errs(worst, d, r):
    """(max abs, max rel) of `worst` updated with differences d against
    reference values r (rel over r != 0)."""
    nz = r != 0
    rel = d[nz] / np.abs(r[nz]).astype(np.float64)
    return (max(worst[0], float(d.max(initial=0.0))),
            max(worst[1], float(rel.max(initial=0.0))))


def state_err(got, ref, exact=("n", "act", "mn", "mx"), rtol=1e-5):
    """(max abs, max rel) |got - ref| over every component; exact
    components must be bit-equal, summed ones (float32 atomics in another
    order than the plain version's index_put_) within rtol."""
    worst = (0.0, 0.0)
    for comp in ref:
        g, r = got[comp].cpu().numpy(), ref[comp].cpu().numpy()
        fin = np.isfinite(r)
        check((np.isfinite(g) == fin).all(), f"{comp}: non-finite mismatch")
        check((g[~fin] == r[~fin]).all(), f"{comp}: identity mismatch")
        d = np.abs(g[fin].astype(np.float64) - r[fin])
        worst = worst_errs(worst, d, r[fin])
        if comp in exact:
            check((d == 0).all(), f"{comp}: differs (max {d.max(initial=0.0)})")
        else:
            check((d <= rtol * np.abs(r[fin])).all(),
                  f"{comp}: beyond rtol {rtol} (max {d.max(initial=0.0)})")
    return worst


def kernel_checks(torch, seed, kernels, plan_fused_rule, dev):
    """Each kernel against its plain version at the main path's shapes."""
    rows = {}

    def path_inputs(node, seed_off):
        gb = node.gb
        r = np.random.default_rng(seed + seed_off)
        temp = r.normal(20, 5, ROWS).astype(np.float32)
        slots = r.integers(0, N_KEYS, ROWS).astype(np.int32)
        cols = {"temperature": torch.from_numpy(temp).to(dev)}
        base, V, M = gb.spec_inputs(cols, ROWS)
        return gb, base, V, M, torch.from_numpy(slots).to(dev), slots

    fold_errs = []
    for sql, P in ((TUMBLING, 1), (HOPPING, 2)):
        node = plan_fused_rule(sql, key_slots=SLOTS, micro_batch=ROWS,
                               device=dev)
        gb, base, V, M, s_dev, s_host = path_inputs(node, P)
        colmap = gb._colmap
        pane = P - 1
        st = gb.init_state()
        if P == 2:  # both panes hold data, the fold lands in pane 1
            kernels.fold_scalar_plain(st, base, V, M, s_dev, 0, colmap)
        ref = clone_state(st)
        got = clone_state(st)
        kernels.fold_scalar_plain(ref, base, V, M, s_dev, pane, colmap)
        kernels.groupby_fold_scalar(got, base, V, M, s_dev, pane, colmap)
        torch.cuda.synchronize()
        err = state_err(got, ref)
        fold = functools.partial(kernels.groupby_fold_scalar, got, base, V,
                                 M, s_dev, pane, colmap)
        t_k = time_ms(torch, fold, REPS)
        split = launch_split(torch, fold, "fold_scalar_kernel", REPS)
        t_p = time_ms(torch, lambda: kernels.fold_scalar_plain(
            ref, base, V, M, s_dev, pane, colmap), REPS)
        t_l = time_ms(torch, lambda: library_fold(
            torch, ref, base, V, M, s_dev, pane, colmap, kernels), REPS)
        S, R = V.shape
        touched = len(np.unique(s_host))
        width = sum(a.shape[2] for k, a in st.items() if k != "act") + 1
        nbytes = V.numel() * 4 + M.numel() + R * 4 + R + touched * width * 8
        b_ms, b_by = bound(nbytes, R * (len(colmap) + 1))
        print(f"kernel groupby_fold_scalar P={P} R={R} C={SLOTS} "
              f"cols={len(colmap)}: max_abs_err={err[0]:.3g} "
              f"max_rel_err={err[1]:.3g} "
              f"kernel_ms={t_k:.4f} {split_text(split)} plain_ms={t_p:.4f} "
              f"library_ms={t_l:.4f} bound_ms={b_ms:.5f} ({b_by})")
        if P == 1:
            rows["groupby_fold_scalar"] = dict(
                max_abs_err=err[0], max_rel_err=err[1], ms=t_k, **split,
                plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=t_l)
        fold_errs.append(err)

        # finalize: full mask, and (P=2) a subset mask, on the folded state
        spectab = gb._spectab
        masks = [None] + ([[1]] if P == 2 else [])
        for panes in masks:
            pm = gb._pane_mask(panes)
            out_k = kernels.groupby_finalize_scalar(got, pm, spectab)
            out_p = kernels.finalize_scalar_plain(got, pm, spectab)
            err = finalize_err(out_k, out_p, spectab, kernels)
            fin = functools.partial(kernels.groupby_finalize_scalar, got,
                                    pm, spectab)
            t_k = time_ms(torch, fin, REPS)
            split = launch_split(torch, fin, "finalize_scalar_kernel", REPS)
            t_p = time_ms(torch, lambda: kernels.finalize_scalar_plain(
                got, pm, spectab), REPS)
            n_live = int(pm.sum().item())
            nbytes = (n_live * SLOTS * width * 4
                      + out_k.numel() * 4 + P)
            b_ms, b_by = bound(nbytes, SLOTS * (len(spectab) * 8
                                                + width * n_live))
            tag = "full" if panes is None else f"subset{panes}"
            print(f"kernel groupby_finalize_scalar P={P} mask={tag} "
                  f"S={len(spectab)} C={SLOTS}: "
                  f"max_abs_err={err[0]:.3g} max_rel_err={err[1]:.3g} "
                  f"kernel_ms={t_k:.4f} {split_text(split)} "
                  f"plain_ms={t_p:.4f} library_ms=null "
                  f"bound_ms={b_ms:.5f} ({b_by})")
            if P == 1:
                rows["groupby_finalize_scalar"] = dict(
                    max_abs_err=err[0], max_rel_err=err[1], ms=t_k, **split,
                    plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                    library_ms=None)

        # reset: one pane of every component
        a, b = clone_state(got), clone_state(got)
        kernels.groupby_reset_pane(a, pane)
        kernels.reset_pane_plain(b, pane)
        torch.cuda.synchronize()
        err = state_err(a, b, exact=tuple(a))
        reset = functools.partial(kernels.groupby_reset_pane, a, pane)
        t_k = time_ms(torch, reset, REPS)
        split = launch_split(torch, reset, "reset_pane_kernel", REPS)
        t_p = time_ms(torch, lambda: kernels.reset_pane_plain(b, pane),
                      REPS)
        t_l = time_ms(torch, lambda: library_reset(b, pane, kernels), REPS)
        b_ms, b_by = bound(SLOTS * width * 4, 0)
        print(f"kernel groupby_reset_pane P={P} C={SLOTS}: "
              f"max_abs_err={err[0]:.3g} max_rel_err={err[1]:.3g} "
              f"kernel_ms={t_k:.4f} {split_text(split)} plain_ms={t_p:.4f} "
              f"library_ms={t_l:.4f} bound_ms={b_ms:.5f} ({b_by})")
        if P == 1:
            rows["groupby_reset_pane"] = dict(
                max_abs_err=err[0], max_rel_err=err[1], ms=t_k, **split,
                plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=t_l)
    rows["groupby_fold_scalar"]["max_abs_err"] = max(e[0] for e in fold_errs)
    rows["groupby_fold_scalar"]["max_rel_err"] = max(e[1] for e in fold_errs)
    return rows


def library_fold(torch, state, base, V, M, slots, pane, colmap, kernels):
    """Yardstick, never called by the port: the fold as PyTorch's own
    scatter calls (index_add_ for the sums, scatter_reduce_ for min/max)."""
    act = state["act"]
    C = act.shape[1]
    pc = pane * C + slots.long()
    act.view(-1).index_add_(0, pc, base.float())
    names = {j: c for c, j in kernels.COMP_IDS.items()}
    for comp_id, k, s in colmap.tolist():
        comp = names[comp_id]
        arr = state[comp]
        idx = pc * arr.shape[2] + k
        m, v = M[s], V[s]
        flat = arr.view(-1)
        if comp == "n":
            flat.index_add_(0, idx, m.float())
        elif comp == "s1":
            flat.index_add_(0, idx, torch.where(m, v, 0.0))
        elif comp == "s2":
            flat.index_add_(0, idx, torch.where(m, v * v, 0.0))
        else:
            ident = float("inf") if comp == "mn" else float("-inf")
            flat.scatter_reduce_(0, idx, torch.where(m, v, ident),
                                 "amin" if comp == "mn" else "amax",
                                 include_self=True)


def finalize_err(out_k, out_p, spectab, kernels):
    """Kernel vs plain finalize: count, min, max and act bit-equal; the
    others rtol 1e-6 (the kernel rounds each step as the plain version
    does; the slack covers torch's own reduction order)."""
    kinds = {v: k for k, v in kernels.KIND_IDS.items()}
    g, r = out_k.cpu().numpy(), out_p.cpu().numpy()
    check(g.shape == r.shape, "finalize shape")
    worst = (0.0, 0.0)
    for i in range(len(r)):
        kind = kinds[int(spectab[i, 0])] if i < len(spectab) else "act"
        nan = np.isnan(r[i])
        check((np.isnan(g[i]) == nan).all(), f"finalize {kind}: NaN mismatch")
        d = np.abs(g[i][~nan].astype(np.float64) - r[i][~nan])
        worst = worst_errs(worst, d, r[i][~nan])
        if kind in ("count", "min", "max", "act"):
            check((d == 0).all(), f"finalize {kind}: differs")
        else:
            check((d <= 1e-6 * np.abs(r[i][~nan])).all(),
                  f"finalize {kind}: beyond rtol 1e-6 (max {d.max(initial=0.0)})")
    return worst


# ------------------------------------------------- phase 2, the sketches
WIDE = ("hll", "hist", "hh")


def skewed_codes(rng, n):
    """bench.py's heavy-hitters codes: 7 at 35 %, 13 at 20 %, 99 at 15 %,
    the rest uniform over a 2,000-value tail."""
    p = rng.random(n)
    return np.where(p < 0.35, 7, np.where(p < 0.55, 13, np.where(
        p < 0.70, 99, rng.integers(100, 2100, n)))).astype(np.int64)


def sketch_inputs(torch, gb, seed, dev):
    """The sketch rules' kernel inputs for one 65,536-row batch: codes as
    dictionary codes, temperature N(20, 5), humidity on 1,000 one-decimal
    values (its hll encoding is the value itself)."""
    r = np.random.default_rng(seed)
    host = {"__hhc__code": skewed_codes(r, ROWS).astype(np.float32),
            "temperature": r.normal(20, 5, ROWS).astype(np.float32),
            "__hll__humidity": (r.integers(0, 1000, ROWS) / 10).astype(
                np.float32)}
    cols = {k: torch.from_numpy(v).to(dev) for k, v in host.items()
            if k in gb.plan.columns}
    base, V, M = gb.spec_inputs(cols, ROWS)
    slots = r.integers(0, N_KEYS, ROWS).astype(np.int32)
    return base, V, M, torch.from_numpy(slots).to(dev), slots


def wide_updates(torch, gb, V, M, slots, pane, sketches):
    """Per wide column: (flat state tensor, flat index, value, reduce op)
    of its nonzero updates, as the library yardstick scatters them."""
    C = gb.capacity
    pc = pane * C + slots.long()
    out = []
    for comp_id, k, s in gb._widemap.tolist():
        comp = WIDE[comp_id]
        m = M[s]
        v = V[s][m]
        W = {"hll": sketches.HLL_M, "hist": sketches.HIST_BINS,
             "hh": sketches.HH_SIZE}[comp]
        row = (pc[m] * len(gb.comp_specs[comp]) + k) * W
        if comp == "hll":
            reg, rho = sketches.hll_parts(v)
            out.append((comp, row + reg, rho, "amax"))
        elif comp == "hist":
            out.append((comp, row + sketches.hist_bin(v),
                        torch.ones_like(v), "sum"))
        else:
            idx, wts = sketches.hh_update_parts(v, torch.ones_like(v))
            flat = (row[:, None] + idx).reshape(-1)
            w = wts.reshape(-1)
            nz = w != 0
            out.append((comp, flat[nz], w[nz], "sum"))
    return out


def library_fold_wide(torch, state, updates):
    """Yardstick, never called by the port: the wide fold's scatters as
    PyTorch's own calls on precomputed indices (index_add_ for the
    counters, scatter_reduce_ amax for the hll registers)."""
    for comp, idx, val, op in updates:
        flat = state[comp].view(-1)
        if op == "sum":
            flat.index_add_(0, idx, val)
        else:
            flat.scatter_reduce_(0, idx, val, "amax", include_self=True)


EXACT = ("n", "act", "mn", "mx") + WIDE


def sketch_kernel_checks(torch, seed, kernels, sketches, plan_fused_rule,
                         TorchGroupBy, dev):
    """The three sketch kernels (and the pane reset over wide state)
    against their plain versions at the sketch rules' full state."""
    rows = {}
    for tag, sql in (("hh", HH_RULE), ("pct", PCT_RULE), ("hll", HLL_RULE)):
        node = plan_fused_rule(sql, key_slots=SLOTS, micro_batch=ROWS,
                               device=dev)
        gb = TorchGroupBy(node.plan, capacity=SLOTS, n_panes=node.n_panes,
                          micro_batch=ROWS, device=dev)
        P = gb.n_panes
        pane = P - 1
        st = gb.init_state()
        if P == 2:  # both panes hold data, the fold lands in pane 1
            base, V, M, s_dev, _ = sketch_inputs(torch, gb, seed + 40, dev)
            kernels.fold_scalar_plain(st, base, V, M, s_dev, 0, gb._colmap)
            kernels.fold_wide_plain(st, V, M, s_dev, 0, gb._widemap)
        base, V, M, s_dev, s_host = sketch_inputs(torch, gb, seed + 41, dev)
        kernels.fold_scalar_plain(st, base, V, M, s_dev, pane, gb._colmap)
        ref, got = clone_state(st), clone_state(st)
        kernels.fold_wide_plain(ref, V, M, s_dev, pane, gb._widemap)
        kernels.groupby_fold_wide(got, V, M, s_dev, pane, gb._widemap)
        torch.cuda.synchronize()
        err = state_err(got, ref, exact=EXACT)
        fold = functools.partial(kernels.groupby_fold_wide, got, V, M, s_dev,
                                 pane, gb._widemap)
        t_k = time_ms(torch, fold, REPS)
        split = launch_split(torch, fold, "fold_wide_kernel", REPS)
        t_p = time_ms(torch, lambda: kernels.fold_wide_plain(
            ref, V, M, s_dev, pane, gb._widemap), REPS)
        upd = wide_updates(torch, gb, V, M, s_dev, pane, sketches)
        t_l = time_ms(torch, lambda: library_fold_wide(torch, ref, upd),
                      REPS)
        # bytes: V, M and slots read once, each touched state float read
        # and written once; operations: one atomic per nonzero update
        touched = sum(len(torch.unique(idx)) for _, idx, _, _ in upd)
        n_upd = sum(len(idx) for _, idx, _, _ in upd)
        nbytes = V.numel() * 4 + M.numel() + ROWS * 4 + touched * 8
        b_ms, b_by = bound(nbytes, n_upd)
        print(f"kernel groupby_fold_wide {tag} P={P} R={ROWS} C={SLOTS} "
              f"cols={len(gb._widemap)} updates={n_upd}: "
              f"max_abs_err={err[0]:.3g} kernel_ms={t_k:.4f} "
              f"{split_text(split)} plain_ms={t_p:.4f} library_ms={t_l:.4f} "
              f"bound_ms={b_ms:.5f} ({b_by})")
        rows[f"groupby_fold_wide/{tag}"] = dict(
            max_abs_err=err[0], ms=t_k, **split, plain_ms=t_p, bound_ms=b_ms,
            bound_by=b_by, library_ms=t_l)

        for panes in [None] + ([[1]] if P == 2 else []):
            pm = gb._pane_mask(panes)
            live = int(pm.sum().item())
            mtag = "full" if panes is None else f"subset{panes}"
            if len(gb._widetab):
                out_k = torch.full((gb._rows, SLOTS), -1.0, device=dev)
                out_p = out_k.clone()
                kernels.groupby_finalize_wide(got, pm, gb._widetab,
                                              gb._fracs, out_k)
                kernels.finalize_wide_plain(got, pm, gb._widetab, gb._fracs,
                                            out_p)
                err = wide_finalize_err(out_k, out_p, gb._widetab, kernels)
                fin = functools.partial(kernels.groupby_finalize_wide, got,
                                        pm, gb._widetab, gb._fracs, out_k)
                t_k = time_ms(torch, fin, REPS)
                split = launch_split(torch, fin, "finalize_wide_kernel", REPS)
                t_p = time_ms(torch, lambda: kernels.finalize_wide_plain(
                    got, pm, gb._widetab, gb._fracs, out_p), REPS)
                nbytes = sum(live * got[c][0].numel() * 4
                             for c in ("hll", "hist") if c in got)
                nbytes += len(gb._widetab) * SLOTS * 4
                b_ms, b_by = bound(nbytes, 0)
                print(f"kernel groupby_finalize_wide {tag} P={P} mask={mtag} "
                      f"C={SLOTS}: max_abs_err={err:.3g} kernel_ms={t_k:.4f} "
                      f"{split_text(split)} plain_ms={t_p:.4f} "
                      f"library_ms=null bound_ms={b_ms:.5f} ({b_by})")
                key = f"groupby_finalize_wide/{tag}/{mtag}"
                rows[key] = dict(max_abs_err=err, ms=t_k, **split,
                                 plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                                 library_ms=None)
            if len(gb._hhtab):
                out_k = torch.full((gb._rows, SLOTS), -1.0, device=dev)
                out_p = out_k.clone()
                kernels.groupby_hh_finalize(got, pm, gb._hhtab, out_k)
                kernels.hh_finalize_plain(got, pm, gb._hhtab, out_p)
                g, r = out_k.cpu().numpy(), out_p.cpu().numpy()
                check((g == r).all(), f"hh finalize {mtag}: differs from plain "
                      f"at {int((g != r).sum())} places")
                fin = functools.partial(kernels.groupby_hh_finalize, got, pm,
                                        gb._hhtab, out_k)
                t_k = time_ms(torch, fin, REPS)
                split = launch_split(torch, fin, "hh_finalize_kernel", REPS)
                t_p = time_ms(torch, lambda: kernels.hh_finalize_plain(
                    got, pm, gb._hhtab, out_p), REPS)
                nbytes = (live * got["hh"][0].numel() * 4
                          + int(gb._hhtab[:, 1].sum()) * 2 * SLOTS * 4)
                b_ms, b_by = bound(nbytes, 0)
                print(f"kernel groupby_hh_finalize P={P} mask={mtag} "
                      f"C={SLOTS}: max_abs_err=0 kernel_ms={t_k:.4f} "
                      f"{split_text(split)} plain_ms={t_p:.4f} "
                      f"library_ms=null bound_ms={b_ms:.5f} ({b_by})")
                rows[f"groupby_hh_finalize/{mtag}"] = dict(
                    max_abs_err=0.0, ms=t_k, **split, plain_ms=t_p,
                    bound_ms=b_ms, bound_by=b_by, library_ms=None)

        if tag == "hh":  # the pane reset over the widest state
            a, b = clone_state(got), clone_state(got)
            kernels.groupby_reset_pane(a, pane)
            kernels.reset_pane_plain(b, pane)
            torch.cuda.synchronize()
            state_err(a, b, exact=tuple(a))
            reset = functools.partial(kernels.groupby_reset_pane, a, pane)
            t_k = time_ms(torch, reset, REPS)
            split = launch_split(torch, reset, "reset_pane_kernel", REPS)
            t_p = time_ms(torch, lambda: kernels.reset_pane_plain(b, pane),
                          REPS)
            t_l = time_ms(torch, lambda: library_reset(b, pane, kernels),
                          REPS)
            b_ms, b_by = bound(sum(x[0].numel() for x in a.values()) * 4, 0)
            print(f"kernel groupby_reset_pane hh P={P} C={SLOTS}: "
                  f"max_abs_err=0 kernel_ms={t_k:.4f} {split_text(split)} "
                  f"plain_ms={t_p:.4f} library_ms={t_l:.4f} "
                  f"bound_ms={b_ms:.5f} ({b_by})")
            rows["groupby_reset_pane/hh"] = dict(
                max_abs_err=0.0, ms=t_k, **split, plain_ms=t_p,
                bound_ms=b_ms, bound_by=b_by, library_ms=t_l)
        del st, ref, got
        torch.cuda.empty_cache()
    return rows


def library_reset(state, pane, kernels):
    """Yardstick: one fill_ per component."""
    for comp, arr in state.items():
        arr[pane].fill_(kernels.INIT[comp])


def wide_finalize_err(out_k, out_p, widetab, kernels):
    """Kernel vs plain wide finalize: hll within ±1 (a 256-term sum in
    another order), the percentile within 4 ulp (the same bin; expf in
    both, rounded alike in every other step). Returns max abs error."""
    g, r = out_k.cpu().numpy(), out_p.cpu().numpy()
    worst = 0.0
    for kind, _, row in widetab.tolist():
        nan = np.isnan(r[row])
        check((np.isnan(g[row]) == nan).all(), "wide finalize: NaN mismatch")
        d = np.abs(g[row][~nan].astype(np.float64) - r[row][~nan])
        worst = max(worst, float(d.max(initial=0.0)))
        if kind == kernels.WIDE_KIND_IDS["hll"]:
            check((d <= 1).all(), f"hll estimate off by {d.max()}")
        else:
            check((d <= 4 * 2.0 ** -23 * np.abs(r[row][~nan])).all(),
                  f"percentile beyond 4 ulp (max {d.max(initial=0.0)})")
    untouched = np.setdiff1d(np.arange(len(g)), widetab[:, 2])
    check((g[untouched] == -1.0).all(), "wide finalize wrote another row")
    return worst


# ------------------------------------------------------------ phases 3, 4
def make_batches(rng, ColumnBatch, n_batches):
    ids = np.array([f"dev_{i}" for i in range(N_KEYS)], dtype=np.object_)
    idx = rng.integers(0, N_KEYS, (n_batches, ROWS))
    temp = rng.normal(20, 5, (n_batches, ROWS)).astype(np.float32)
    batches = [ColumnBatch(n=ROWS,
                           columns={"deviceId": ids[idx[b]],
                                    "temperature": temp[b]},
                           emitter="demo")
               for b in range(n_batches)]
    return batches, idx, temp


def reference_aggs(idx, temp, keys):
    """Independent numpy float64 group-by of one span of rows."""
    i = idx.ravel()
    t = temp.ravel().astype(np.float64)
    agg = {"cnt": np.zeros(keys), "sum": np.zeros(keys),
           "sumsq": np.zeros(keys), "sumabs": np.zeros(keys),
           "min": np.full(keys, np.inf), "max": np.full(keys, -np.inf)}
    np.add.at(agg["cnt"], i, 1.0)
    np.add.at(agg["sum"], i, t)
    np.add.at(agg["sumsq"], i, t * t)
    np.add.at(agg["sumabs"], i, np.abs(t))
    np.minimum.at(agg["min"], i, t)
    np.maximum.at(agg["max"], i, t)
    return agg


def merge_aggs(parts):
    out = {k: sum(p[k] for p in parts) for k in ("cnt", "sum", "sumsq",
                                                  "sumabs")}
    out["min"] = np.minimum.reduce([p["min"] for p in parts])
    out["max"] = np.maximum.reduce([p["max"] for p in parts])
    return out


def check_window(cb, ref, with_sd: bool, what: str) -> float:
    """Every emitted row against the float64 reference. Tolerances are the
    float32 rounding bounds of the device arithmetic: keys and counts
    exact; min/max exact (they pick an input); avg within
    ε·(Σ|x| + |mean|) — a float32 sum of n terms in any order is within
    (n-1)·ε·Σ|x| of the exact sum; stddev within the same bound carried
    through s2/n - mean²."""
    live = np.nonzero(ref["cnt"] > 0)[0]
    check(cb is not None and cb.n == len(live),
          f"{what}: {0 if cb is None else cb.n} rows, want {len(live)}")
    keys = np.array([int(k[4:]) for k in cb.columns["deviceId"].tolist()])
    order = np.argsort(keys)
    keys = keys[order]
    check((keys == live).all(), f"{what}: emitted keys differ")
    col = {k: np.asarray(v)[order] for k, v in cb.columns.items()}
    n = ref["cnt"][keys]
    check((col["cnt"].astype(np.float64) == n).all(), f"{what}: count")
    check((col["min_t"].astype(np.float64) == ref["min"][keys]).all(),
          f"{what}: min")
    check((col["max_t"].astype(np.float64) == ref["max"][keys]).all(),
          f"{what}: max")
    mean = ref["sum"][keys] / n
    sumabs = ref["sumabs"][keys]
    d_avg = np.abs(col["avg_t"].astype(np.float64) - mean)
    tol_avg = EPS32 * (sumabs + np.abs(mean))
    check((d_avg <= tol_avg).all(),
          f"{what}: avg beyond bound (max {d_avg.max()})")
    worst = float(d_avg.max())
    if with_sd:
        s2n = ref["sumsq"][keys] / n
        var = np.maximum(s2n - mean * mean, 0.0)
        tol_var = EPS32 * (ref["sumsq"][keys] + s2n
                           + 2 * np.abs(mean) * (sumabs + np.abs(mean))
                           + mean * mean + var)
        sd = col["sd_t"].astype(np.float64)
        d_sd = np.abs(sd * sd - var)  # compare in variance: |a²-b²| bound
        check((d_sd <= tol_var + 2 * EPS32 * sd * sd).all(),
              f"{what}: stddev beyond bound (max {d_sd.max()})")
        worst = max(worst, float(np.abs(sd - np.sqrt(var)).max()))
    return worst


def timed(fn, acc: dict, key: str):
    """`fn` with its host wall time added to acc[key]."""
    def run(*a, **k):
        t = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            acc[key] += time.perf_counter() - t
    return run


def run_rule(torch, seed, sql, interval_ms, span, kernels, mods):
    """Drive `sql` through process/on_trigger on the card; return
    (launch counts, rows/s, emit ms samples, worst abs error, host seconds
    by stage)."""
    plan_fused_rule, ColumnBatch, Trigger = mods
    rng = np.random.default_rng(seed)
    n_int, per = WINDOWS, BATCHES
    batches, idx, temp = make_batches(rng, ColumnBatch, n_int * per)
    parts = [reference_aggs(idx[w * per:(w + 1) * per],
                            temp[w * per:(w + 1) * per], N_KEYS)
             for w in range(n_int)]
    node = plan_fused_rule(sql, key_slots=SLOTS, micro_batch=ROWS)
    check(node.gb.device.type == "cuda", "rule is not on the card")
    emitted = []
    node.broadcast = emitted.append
    # host time by stage: key encode + column build, upload + closures +
    # fold launch (the rest of the wall is the boundary emit)
    stages = {"encode": 0.0, "fold": 0.0}
    node._build_kernel_inputs = timed(node._build_kernel_inputs, stages,
                                      "encode")
    node.gb.fold = timed(node.gb.fold, stages, "fold")
    # warm the path (allocator, pinned pool) on a throwaway node
    warm = plan_fused_rule(sql, key_slots=SLOTS, micro_batch=ROWS)
    warm.broadcast = lambda item: None
    warm.process(batches[0])
    warm.on_trigger(Trigger(ts=interval_ms))
    torch.cuda.synchronize()
    kernels.reset_launches()
    emit_ms = []
    t0 = time.perf_counter()
    for w in range(n_int):
        for b in batches[w * per:(w + 1) * per]:
            node.process(b)
        te = time.perf_counter()
        node.on_trigger(Trigger(ts=(w + 1) * interval_ms))
        torch.cuda.synchronize()
        emit_ms.append((time.perf_counter() - te) * 1e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    check(len(emitted) == n_int, f"{len(emitted)} windows, want {n_int}")
    worst = 0.0
    for w, cb in enumerate(emitted):
        ref = merge_aggs(parts[max(0, w - span + 1):w + 1])
        worst = max(worst, check_window(cb, ref, "sd_t" in cb.columns,
                                        f"window {w}"))
    return counts, n_int * per * ROWS / wall, emit_ms, worst, stages


# ------------------------------------------------------- phases A and B
# numpy twins of the sketches, written from their definitions (numpy has
# native uint32 shifts and wrapping products)
U32 = np.uint32
HH_DEPTH, HH_WIDTH, HH_BITS = 2, 64, 20
HH_CELL = 1 + HH_BITS
HH_SIZE = HH_DEPTH * HH_WIDTH * HH_CELL
HLL_M, HIST_BINS, HIST_HALF = 256, 1024, 511
HIST_LO, HIST_HI = 1e-9, 1e12
LOG_GAMMA = np.log((HIST_HI / HIST_LO) ** (1.0 / (HIST_HALF - 1)))


def np_splitmix32(x):
    x = x ^ (x >> U32(16))
    x = x * U32(0x7FEB352D)
    x = x ^ (x >> U32(15))
    x = x * U32(0x846CA68B)
    return x ^ (x >> U32(16))


def np_hh_slot(code, d):
    salt = U32((0x9E3779B9 * (d + 7)) & 0xFFFFFFFF)
    return np_splitmix32(code ^ salt) & U32(HH_WIDTH - 1)


class TwinCodes:
    """The dictionary of a heavy_hitters column: new values of a batch
    take the next codes in sorted order (np.unique), as the node's
    dictionary assigns them to an integer column."""

    def __init__(self):
        self.codes = {}
        self.values = []

    def encode(self, col):
        uniq, inv = np.unique(col, return_inverse=True)
        for u in uniq.tolist():
            if u not in self.codes:
                self.codes[u] = len(self.values)
                self.values.append(u)
        return np.array([self.codes[u] for u in uniq.tolist()],
                        dtype=np.uint32)[inv]


def twin_hh_fold(counters, keys, codes):
    """Add one batch into counters (n_keys * HH_SIZE,) float64: per depth,
    the cell total and the code's set bits."""
    flat = []
    for d in range(HH_DEPTH):
        base = (keys * HH_SIZE + (d * HH_WIDTH + np_hh_slot(codes, d)
                                  .astype(np.int64)) * HH_CELL)
        flat.append(base)
        for b in range(HH_BITS):
            bit = ((codes >> U32(b)) & U32(1)).astype(bool)
            flat.append(base[bit] + 1 + b)
    counters += np.bincount(np.concatenate(flat), minlength=len(counters))


def twin_hh_top(merged, k):
    """Top-k (code, count) lists per key from a pane-merged sketch
    (n_keys, HH_SIZE): bit-majority codes, hash-back validation, count-min
    estimates, estimate-descending order with the lower cell first among
    ties, dedupe, trim."""
    n = len(merged)
    a = merged.reshape(n, HH_DEPTH, HH_WIDTH, HH_CELL)
    tot = a[..., 0]
    bits = (a[..., 1:] * 2.0) > tot[..., None]
    codes = (bits.astype(np.uint32) << np.arange(HH_BITS, dtype=U32)).sum(
        axis=-1, dtype=U32)
    ok = np.stack([(tot[:, d] > 0) & (np_hh_slot(codes[:, d], d)
                                      == np.arange(HH_WIDTH, dtype=U32))
                   for d in range(HH_DEPTH)], axis=1).reshape(n, -1)
    flat = codes.reshape(n, -1)
    est = np.full(flat.shape, np.inf)
    for d2 in range(HH_DEPTH):
        s = np_hh_slot(flat, d2).astype(np.int64)
        est = np.minimum(est, np.take_along_axis(tot[:, d2], s, axis=1))
    est = np.where(ok, est, 0.0)
    order = np.argsort(-est, axis=1, kind="stable")[:, :2 * k]
    top_c = np.take_along_axis(flat, order, axis=1)
    top_e = np.take_along_axis(est, order, axis=1)
    out = []
    for cs, es in zip(top_c.tolist(), top_e.tolist()):
        row, seen = [], set()
        for c, e in zip(cs, es):
            if e <= 0:
                break
            if c not in seen:
                seen.add(c)
                row.append((c, int(round(e))))
                if len(row) == k:
                    break
        out.append(row)
    return out


def key_ids(col):
    return np.array([int(k[4:]) for k in col.tolist()])


def run_hh_rule(torch, seed, kernels, mods):
    """Phase A: the heavy-hitters hopping rule on the card, every emitted
    row held against the numpy twin."""
    plan_fused_rule, ColumnBatch, Trigger = mods
    rng = np.random.default_rng(seed + 7)
    ids = np.array([f"dev_{i}" for i in range(N_KEYS)], dtype=np.object_)
    node = plan_fused_rule(HH_RULE, key_slots=SLOTS, micro_batch=ROWS)
    check(node.gb.device.type == "cuda", "rule is not on the card")
    check(node.gb.capacity == 2048, "heavy-hitters state does not start "
          f"at 2,048 slots ({node.gb.capacity})")
    emitted = []
    node.broadcast = emitted.append
    # host time by stage: key encode + the value dictionary + column build,
    # upload + closures + fold launches; at each boundary the finalize
    # (kernels, one copy, the top-k dedupe), its dedupe alone, the value
    # decode
    stages = dict.fromkeys(("encode", "fold", "finalize", "assemble",
                            "decode"), 0.0)
    node._build_kernel_inputs = timed(node._build_kernel_inputs, stages,
                                      "encode")
    node.gb.fold = timed(node.gb.fold, stages, "fold")
    node.gb.finalize = timed(node.gb.finalize, stages, "finalize")
    node.gb.hh_assemble = timed(node.gb.hh_assemble, stages, "assemble")
    node._decode_hh = timed(node._decode_hh, stages, "decode")
    twin_dict = TwinCodes()
    panes = [np.zeros(N_KEYS * HH_SIZE), np.zeros(N_KEYS * HH_SIZE)]
    counts = [np.zeros(N_KEYS), np.zeros(N_KEYS)]
    sevens = [np.zeros(N_KEYS), np.zeros(N_KEYS)]  # exact rows of code 7
    expect = []
    kernels.reset_launches()
    emit_ms, wall = [], 0.0
    for w in range(SKETCH_WINDOWS):
        cur = w % 2
        idx = rng.integers(0, N_KEYS, (SKETCH_BATCHES, ROWS))
        code = skewed_codes(rng, SKETCH_BATCHES * ROWS).reshape(idx.shape)
        last = w == SKETCH_WINDOWS - 1
        with device_trace(torch, last) as trace:
            t0 = time.perf_counter()
            for b in range(SKETCH_BATCHES):
                node.process(ColumnBatch(n=ROWS, columns={
                    "deviceId": ids[idx[b]], "code": code[b]},
                    emitter="demo"))
            t = time.perf_counter()
            node.on_trigger(Trigger(ts=(w + 1) * 5_000))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        emit_ms.append((t1 - t) * 1e3)
        wall += t1 - t0
        if last:
            busy = trace.busy_us() / ((t1 - t0) * 1e6)
        for b in range(SKETCH_BATCHES):
            twin_hh_fold(panes[cur], idx[b], twin_dict.encode(code[b]))
            counts[cur] += np.bincount(idx[b], minlength=N_KEYS)
            sevens[cur] += np.bincount(idx[b][code[b] == 7],
                                       minlength=N_KEYS)
        merged = (panes[0] + panes[1]).reshape(N_KEYS, HH_SIZE)
        expect.append((twin_hh_top(merged, 3), counts[0] + counts[1],
                       sevens[0] + sevens[1]))
        for x in (panes, counts, sevens):  # the pane that expires now
            x[1 - cur][:] = 0.0
    launches = dict(kernels.LAUNCHES)
    check(node.gb.capacity == SLOTS and node.state["hh"].shape[1] == SLOTS,
          f"heavy-hitters state at {node.gb.capacity} slots, want {SLOTS}")
    check(len(emitted) == SKETCH_WINDOWS,
          f"{len(emitted)} windows, want {SKETCH_WINDOWS}")
    n_rows, led = 0, 0
    for w, (cb, (tops, cnt, seven)) in enumerate(zip(emitted, expect)):
        keys = key_ids(cb.columns["deviceId"])
        live = np.nonzero(cnt > 0)[0]
        check(cb.n == len(live) and (np.sort(keys) == live).all(),
              f"window {w}: emitted keys differ")
        check((cb.columns["c"] == cnt[keys]).all(), f"window {w}: count")
        for key, top in zip(keys.tolist(), cb.columns["top"].tolist()):
            want = [{"value": twin_dict.values[c], "count": n}
                    for c, n in tops[key]]
            check(top == want, f"window {w} key {key}: {top} != {want}")
            led += bool(top) and top[0]["value"] == 7
            # another code leads only where 7's exact count does not
            # exceed the leader's (over-)estimate
            check(top[0]["value"] == 7 or seven[key] <= top[0]["count"],
                  f"window {w} key {key}: 7 ({seven[key]:.0f} rows) "
                  f"behind {top[0]}")
        n_rows += cb.n
    check(led >= 0.99 * n_rows, f"7 leads only {led} of {n_rows} lists")
    n_b = SKETCH_WINDOWS * SKETCH_BATCHES
    return launches, dict(
        rows=n_rows, led_by_7=led, rows_per_s=n_b * ROWS / wall,
        emit_ms=emit_ms, busy=busy,
        stages={k: v * 1e3 / (n_b if k in ("encode", "fold")
                              else SKETCH_WINDOWS)
                for k, v in stages.items()})


class device_trace:
    """Optionally profile the card's activity (CUPTI) over a block;
    busy_us() sums the device time of its kernels and copies."""

    def __init__(self, torch, on: bool):
        self.torch, self.on, self.prof = torch, on, None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def busy_us(self) -> float:
        cuda = self.torch.autograd.DeviceType.CUDA
        return float(sum(e.time_range.elapsed_us() for e in self.prof.events()
                         if e.device_type == cuda))


def twin_hll(values):
    """(register, rho) per float32 value, from the definition: two salted
    splitmix32 hashes of the bits; rho = 33 - (highest set bit of
    float32(max(h2, 1)))."""
    bits = values.view(U32)
    h1 = np_splitmix32(bits ^ U32(0x9E3779B9))
    h2 = np_splitmix32(bits ^ U32((0x9E3779B9 * 2) & 0xFFFFFFFF))
    hv = np.maximum(h2, U32(1)).astype(np.float32)
    rho = 159 - ((hv.view(U32) >> U32(23)) & U32(0xFF)).astype(np.int64)
    return (h1 & U32(HLL_M - 1)).astype(np.int64), rho


def twin_registers(flat, rho):
    """(N_KEYS, HLL_M) registers: the largest rho at each flat index."""
    u = np.unique(flat * 64 + rho)  # sorted by index, then by rho
    idx, r = u // 64, u % 64
    last = np.append(np.nonzero(np.diff(idx))[0], len(u) - 1)
    regs = np.zeros(N_KEYS * HLL_M, dtype=np.int64)
    regs[idx[last]] = r[last]
    return regs.reshape(N_KEYS, HLL_M)


def twin_hll_estimate(regs):
    """float32 HLL estimate, rounded half to even, per row of regs."""
    regs = regs.astype(np.float32)
    m = np.float32(HLL_M)
    z = np.exp2(-regs).sum(axis=1, dtype=np.float32)
    raw = np.float32(0.7213 / (1.0 + 1.079 / HLL_M) * HLL_M * HLL_M) / z
    zeros = (regs == 0).sum(axis=1)
    small = m * np.log(m / np.maximum(zeros, 1).astype(np.float32))
    return np.rint(np.where((raw < 2.5 * HLL_M) & (zeros > 0), small, raw))


def twin_bins(values):
    """(bin, near_edge) per value: the signed log bin from the float64
    bin position, and whether that position lies within 1e-5 of a bin
    edge (where the card's float32 log may land one bin over)."""
    mag = np.clip(np.abs(values.astype(np.float64)), HIST_LO,
                  HIST_HI * 0.999)
    pos = np.log(mag / HIST_LO) / LOG_GAMMA
    idx = np.clip(np.floor(pos), 0, HIST_HALF - 1).astype(np.int64)
    near = np.abs(pos - np.round(pos)) < 1e-5
    b = np.where(values > 0, HIST_HALF + 1 + idx,
                 np.where(values < 0, HIST_HALF - 1 - idx, HIST_HALF))
    return b, near


def twin_quantile_bin(hist, frac):
    total = hist.sum(axis=1).astype(np.float32)
    cum = np.cumsum(hist, axis=1)
    target = np.maximum(np.float32(frac) * total, np.float32(1e-9))
    return np.argmax(cum >= target[:, None], axis=1), total


def value_bin(v):
    """The bin whose centre the card's percentile value is (nearest centre
    in float64; centres lie ~5 % apart)."""
    mag = np.arange(HIST_HALF)
    centre = HIST_LO * np.exp(mag * LOG_GAMMA) * np.sqrt(np.exp(LOG_GAMMA))
    a = np.maximum(np.abs(v.astype(np.float64)), HIST_LO)
    m = np.abs(np.log(a[:, None] / centre[None, :])).argmin(axis=1)
    return np.where(v > 0, HIST_HALF + 1 + m,
                    np.where(v < 0, HIST_HALF - 1 - m, HIST_HALF))


def run_wide_rules(torch, seed, kernels, mods):
    """Phase B: the percentile tumbling rule and the hll hopping rule on
    the card against the twins; prints the sketches' error against exact
    quantiles and distinct counts (not gated)."""
    plan_fused_rule, ColumnBatch, Trigger = mods
    rng = np.random.default_rng(seed + 8)
    ids = np.array([f"dev_{i}" for i in range(N_KEYS)], dtype=np.object_)
    out = {}
    for tag, sql, interval, span in (("pct", PCT_RULE, 10_000, 1),
                                     ("hll", HLL_RULE, 5_000, 2)):
        node = plan_fused_rule(sql, key_slots=SLOTS, micro_batch=ROWS)
        check(node.gb.device.type == "cuda", "rule is not on the card")
        emitted = []
        node.broadcast = emitted.append
        spans = []  # per interval: (key idx, values)
        kernels.reset_launches()
        emit_ms = []
        for w in range(SKETCH_WINDOWS):
            idx = rng.integers(0, N_KEYS, (SKETCH_BATCHES, ROWS))
            if tag == "pct":
                vals = rng.normal(20, 5, (SKETCH_BATCHES, ROWS)).astype(
                    np.float32)
                col = "temperature"
            else:
                vals = (rng.integers(0, 1000, (SKETCH_BATCHES, ROWS))
                        / 10).astype(np.float32)
                col = "humidity"
            for b in range(SKETCH_BATCHES):
                node.process(ColumnBatch(n=ROWS, columns={
                    "deviceId": ids[idx[b]], col: vals[b]}, emitter="demo"))
            t = time.perf_counter()
            node.on_trigger(Trigger(ts=(w + 1) * interval))
            torch.cuda.synchronize()
            emit_ms.append((time.perf_counter() - t) * 1e3)
            spans.append((idx.ravel(), vals.ravel()))
        launches = dict(kernels.LAUNCHES)
        check(len(emitted) == SKETCH_WINDOWS, f"{tag}: {len(emitted)} windows")
        n_rows, edge_rows, errs = 0, 0, []
        for w, cb in enumerate(emitted):
            ks = np.concatenate([s[0] for s in spans[max(0, w - span + 1):
                                                     w + 1]])
            vs = np.concatenate([s[1] for s in spans[max(0, w - span + 1):
                                                     w + 1]])
            keys = key_ids(cb.columns["deviceId"])
            live = np.unique(ks)
            check(cb.n == len(live) and (np.sort(keys) == live).all(),
                  f"{tag} window {w}: emitted keys differ")
            if tag == "pct":
                b, near = twin_bins(vs)
                hist = np.bincount(ks * HIST_BINS + b,
                                   minlength=N_KEYS * HIST_BINS).reshape(
                                       N_KEYS, HIST_BINS)
                qb, _ = twin_quantile_bin(hist, 0.9)
                edge_key = np.zeros(N_KEYS, dtype=bool)
                edge_key[ks[near]] = True
                got = value_bin(np.asarray(cb.columns["p90"],
                                           dtype=np.float32))
                d = np.abs(got - qb[keys])
                check(((d == 0) | ((d == 1) & edge_key[keys])).all(),
                      f"pct window {w}: percentile bin differs")
                edge_rows += int((d == 1).sum())
                errs.append(exact_quantile_err(ks, vs, keys,
                                               cb.columns["p90"], 0.9))
            else:
                reg, rho = twin_hll(vs)
                regs = twin_registers(ks * HLL_M + reg, rho)
                est = twin_hll_estimate(regs)
                u = np.asarray(cb.columns["u"], dtype=np.float64)
                check((np.abs(u - est[keys]) <= 1).all(),
                      f"hll window {w}: estimate beyond ±1 "
                      f"(max {np.abs(u - est[keys]).max()})")
                exact = np.bincount(np.unique(ks * 1000 + np.rint(
                    vs * 10).astype(np.int64)) // 1000, minlength=N_KEYS)
                errs.append(float(np.mean(np.abs(u - exact[keys])
                                          / exact[keys])))
            n_rows += cb.n
        out[tag] = dict(launches=launches, rows=n_rows, edge_rows=edge_rows,
                        sketch_err=float(np.mean(errs)), emit_ms=emit_ms)
    return out


def exact_quantile_err(ks, vs, keys, got, q):
    """Mean relative error of the card's percentile against np.quantile
    of each emitted key's values (linear interpolation)."""
    order = np.lexsort((vs, ks))
    ks, vs = ks[order], vs[order].astype(np.float64)
    start = np.searchsorted(ks, keys)
    n = np.searchsorted(ks, keys, side="right") - start
    pos = q * (n - 1)
    lo, hi = np.floor(pos).astype(np.int64), np.ceil(pos).astype(np.int64)
    exact = vs[start + lo] + (vs[start + hi] - vs[start + lo]) * (pos - lo)
    return float(np.mean(np.abs(np.asarray(got, dtype=np.float64) - exact)
                         / np.abs(exact)))


def pct(xs, q):
    return float(np.percentile(np.asarray(xs), q))


# -------------------------------------------------------------------- main
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the generated rows")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a card",
              file=sys.stderr)
        return 1
    from ekuiper_tpu_torch.data.batch import ColumnBatch
    from ekuiper_tpu_torch.ops import kernels, sketches
    from ekuiper_tpu_torch.ops.groupby import TorchGroupBy
    from ekuiper_tpu_torch.planner.fused import plan_fused_rule
    from ekuiper_tpu_torch.runtime.events import Trigger

    # phase 1: the card and the build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)  # the card's name and power limit, as nvidia-smi gives them
    print(f"phase 1 card: {smi}")
    kernels.build_library()
    print(f"phase 1 build: {' '.join(sorted(set(SOURCE.values())))} nvcc "
          f"{' '.join(kernels.NVCC_FLAGS)} in {kernels.build_seconds:.2f} s "
          "(one nvcc per source, run together)")

    # phase 2: each kernel against its plain version
    dev = torch.device("cuda")
    rows = kernel_checks(torch, args.seed, kernels, plan_fused_rule, dev)
    rows.update(sketch_kernel_checks(torch, args.seed, kernels, sketches,
                                     plan_fused_rule, TorchGroupBy, dev))
    print("phase 2 kernels vs plain: ok")

    mods = (plan_fused_rule, ColumnBatch, Trigger)
    # phase 3: end to end, tumbling (the main path)
    counts_t, rps, emit_ms, err, st = run_rule(torch, args.seed, TUMBLING,
                                               10_000, 1, kernels, mods)
    n_b = WINDOWS * BATCHES
    print(f"phase 3 tumbling: {WINDOWS} windows x {BATCHES} "
          f"batches x {ROWS} rows, {N_KEYS} keys: rows/s={rps:.0f} "
          f"emit_p50_ms={pct(emit_ms, 50):.3f} "
          f"emit_p99_ms={pct(emit_ms, 99):.3f} max_abs_err={err:.3g} "
          f"host_ms_per_batch encode={st['encode'] / n_b * 1e3:.3f} "
          f"fold={st['fold'] / n_b * 1e3:.3f} launches={counts_t}")
    # phase 4: end to end, hopping (2 panes)
    counts_h, rps, emit_ms, err, st = run_rule(torch, args.seed, HOPPING,
                                               5_000, 2, kernels, mods)
    print(f"phase 4 hopping: {WINDOWS} windows x {BATCHES} "
          f"batches per 5 s slide x {ROWS} rows, {N_KEYS} keys: "
          f"rows/s={rps:.0f} emit_p50_ms={pct(emit_ms, 50):.3f} "
          f"emit_p99_ms={pct(emit_ms, 99):.3f} max_abs_err={err:.3g} "
          f"host_ms_per_batch encode={st['encode'] / n_b * 1e3:.3f} "
          f"fold={st['fold'] / n_b * 1e3:.3f} launches={counts_h}")

    # phase A: heavy hitters (BASELINE config #2)
    counts_hh, a = run_hh_rule(torch, args.seed, kernels, mods)
    print(f"phase A heavy hitters: {SKETCH_WINDOWS} hop boundaries x "
          f"{SKETCH_BATCHES} batches x {ROWS} rows, {N_KEYS} keys, state "
          f"2048 -> {SLOTS} slots: {a['rows']} rows checked against the "
          f"numpy twin, 7 leads {a['led_by_7']} of {a['rows']} lists "
          f"({a['led_by_7'] / a['rows']:.4%}), rows/s={a['rows_per_s']:.0f} "
          f"emit_p50_ms={pct(a['emit_ms'], 50):.3f} "
          f"emit_p99_ms={pct(a['emit_ms'], 99):.3f} launches={counts_hh}")
    st = a["stages"]
    print(f"phase A host ms per batch: encode={st['encode']:.3f} "
          f"fold={st['fold']:.3f}; per boundary: finalize="
          f"{st['finalize']:.3f} (hh_assemble {st['assemble']:.3f}) "
          f"decode={st['decode']:.3f}; emit ms by boundary: "
          + " ".join(f"{x:.1f}" for x in a["emit_ms"])
          + f"; device busy share over the last interval "
          f"(profiled): {a['busy']:.4f}")
    # phase B: the wide finalize (percentile tumbling, hll hopping)
    b = run_wide_rules(torch, args.seed, kernels, mods)
    print(f"phase B percentile_approx: {b['pct']['rows']} rows, each in the "
          f"twin's bin ({b['pct']['edge_rows']} one bin over at a bin edge); "
          f"mean rel err vs np.quantile {b['pct']['sketch_err']:.4f}; "
          f"emit_p50_ms={pct(b['pct']['emit_ms'], 50):.3f} "
          f"launches={b['pct']['launches']}")
    print(f"phase B hll: {b['hll']['rows']} rows within ±1 of the twin; "
          f"mean rel err vs exact distinct {b['hll']['sketch_err']:.4f}; "
          f"emit_p50_ms={pct(b['hll']['emit_ms'], 50):.3f} "
          f"launches={b['hll']['launches']}")

    # phase 5: every kernel launched on each path that uses it
    paths = {"tumbling": counts_t, "hopping": counts_h, "hh": counts_hh,
             "pct": b["pct"]["launches"], "hll": b["hll"]["launches"]}
    for name, used_by in PATHS.items():
        for path in used_by:
            check(paths[path][name] > 0,
                  f"{name} was not launched on the {path} path")
    print("phase 5 kernels: " + " ".join(
        f"{n}=" + "+".join(f"{paths[p][n]}({p})" for p in PATHS[n])
        for n in PATHS))
    main_row = {"groupby_fold_wide": "groupby_fold_wide/hh",
                "groupby_finalize_wide": "groupby_finalize_wide/pct/full",
                "groupby_hh_finalize": "groupby_hh_finalize/full"}
    main_path = {"groupby_fold_wide": "hh", "groupby_finalize_wide": "pct",
                 "groupby_hh_finalize": "hh"}
    table = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE[name],
         "replaces": REPLACES[name],
         "launches": paths[main_path.get(name, "tumbling")][name],
         "launches_by_path": {p: paths[p][name] for p in PATHS[name]},
         **rows[main_row.get(name, name)]}
        for name in PATHS]}
    table["kernels"][2]["wide_state"] = rows["groupby_reset_pane/hh"]
    table["kernels"][4]["hll_hopping"] = rows["groupby_finalize_wide/hll/full"]
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except (SmokeFailure, ImportError, RuntimeError,
            subprocess.CalledProcessError, OSError) as exc:
        print(f"chip_smoke FAILED: {type(exc).__name__}: {exc}",
              file=sys.stderr)
        sys.exit(1)
