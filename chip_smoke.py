#!/usr/bin/env python3
"""Proof on one CUDA card that the PyTorch/CUDA port (ekuiper_tpu_torch)
builds, runs its main path and gives right answers.

Run from the repository root on a machine with a card:

    python3 chip_smoke.py [--seed 0]

Phases (each prints its own lines; any failure exits non-zero and prints
no result):

1. the card (nvidia-smi name and power limit) and the kernels' build time
   (csrc/groupby.cu, nvcc for sm_90a);
2. each kernel against its plain PyTorch version on the card, at the main
   path's shapes (65,536 rows, 16,384 slots): error, kernel time (CUDA
   events), the kernel body's own device time (profiler trace) and the
   host time of one wrapper call, plain time, a library yardstick and
   the bytes/operations bound;
3. end to end, tumbling: the flagship rule
   `SELECT deviceId, avg(temperature), count(*), min(temperature),
   max(temperature) FROM demo GROUP BY deviceId, TUMBLINGWINDOW(ss, 10)`
   over 10,000 device keys, temperature ~ N(20, 5), 65,536-row batches,
   every emitted row held against an independent numpy float64 group-by;
4. end to end, hopping: the same with HOPPINGWINDOW(ss, 10, 5) and
   stddev(temperature);
5. the kernels' launch counts on the main path (each must be > 0), then
   the JSON kernel table and the one-line result.
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
#: emitted windows per end-to-end phase, 65,536-row batches per trigger
#: interval, timed runs per kernel
WINDOWS, BATCHES, REPS = 16, 16, 30
#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 (non-tensor)
#: operations/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
EPS32 = float(np.finfo(np.float32).eps)
SOURCE = "ekuiper_tpu_torch/csrc/groupby.cu"
REPLACES = {
    "groupby_fold_scalar": "ekuiper_tpu/ops/groupby.py:348",
    "groupby_finalize_scalar": "ekuiper_tpu/ops/groupby.py:459",
    "groupby_reset_pane": "ekuiper_tpu/ops/groupby.py:763",
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
        b_ms, b_by = bound(SLOTS * width * 4, 0)
        print(f"kernel groupby_reset_pane P={P} C={SLOTS}: "
              f"max_abs_err={err[0]:.3g} max_rel_err={err[1]:.3g} "
              f"kernel_ms={t_k:.4f} {split_text(split)} plain_ms={t_p:.4f} "
              f"library_ms=null bound_ms={b_ms:.5f} ({b_by})")
        if P == 1:
            rows["groupby_reset_pane"] = dict(
                max_abs_err=err[0], max_rel_err=err[1], ms=t_k, **split,
                plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None)
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
    from ekuiper_tpu_torch.ops import kernels
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
    print(f"phase 1 build: {SOURCE} nvcc {' '.join(kernels.NVCC_FLAGS)} "
          f"in {kernels.build_seconds:.2f} s")

    # phase 2: each kernel against its plain version
    rows = kernel_checks(torch, args.seed, kernels, plan_fused_rule,
                         torch.device("cuda"))
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

    # phase 5: every kernel of the path launched on the path
    for name in kernels.LAUNCHES:
        check(counts_t[name] > 0 and counts_h[name] > 0,
              f"{name} was not launched on the main path")
    print("phase 5 kernels: " + " ".join(
        f"{n}={counts_t[n]}+{counts_h[n]}" for n in kernels.LAUNCHES))
    table = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": counts_t[name],
         "launches_hopping": counts_h[name], **rows[name]}
        for name in kernels.LAUNCHES]}
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
