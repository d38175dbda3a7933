#!/usr/bin/env python3
"""Routes for the scalar body of the one-launch fold (#1, csrc/fold.cuh)
on one card, at chip_smoke.py's phase-2 shapes (65,536 rows, 16,384
slots, 10,000 keys, the tumbling and hopping rules):

- `atomic`: the port's `kernels.groupby_fold` (a thread a row, global
  atomics: one a column, a slot's count columns as float4 / float2
  ones; the column maps in the launch's parameters);
- `packed`: the body as the port had it before: the column table as
  packed words in a device array, copied into shared memory by each
  block, and one atomic a column, counts too;
- `scan<NS>`: each CTA owns NS slots, reads every row's slot and keeps
  its range in shared memory, then writes each touched state word once;
- `cluster<NS>x<CL>`: the same ownership across a thread-block cluster
  of CL CTAs through distributed shared memory, each CTA scanning 1/CL
  of the rows;
- in rounds (`scan128`, `cluster...`): a round's rows of the range are
  listed in shared memory first, then their masks and values loaded
  together; `_inline`: each row's loads issued one after another by
  the warp that found it.

Each route is checked against `kernels.fold_plain` (n, act, mn, mx
bit-equal, s1 / s2 within rtol 1e-5), then timed in alternating rounds:
CUDA events around one call (`ms`) and the kernel body from a profiler
trace (`body_ms`), the median over the rounds; for the staged routes
also one more call's phases a CTA (`phases_us`). `atomic` and `packed` are
also timed on the percentile, hll and mixed rules (all three roles).

Run from the repository root on a machine with a card:

    python3 fold_routes.py [--reps 30] [--out DIR/fold_routes.json]

It prints the card's name and power limit, one line per (rule, route),
and as its last line one JSON object {"card": ..., "rows": {...}}.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

import chip_smoke as cs

ROUNDS = 3
#: the staged routes' phases, µs a CTA (mean over CTAs) from thread 0's
#: %globaltimer in one more call
PHASES = ("init_us", "scan_us", "add_us", "wait_us", "write_us", "total_us")
#: (route, kernel name, owner route code, slots a CTA, CTAs a cluster)
OWN_ROUTES = (("scan64_inline", "probe_scan_kernel", 0, 64, 1),
              ("cluster128x8_inline", "probe_cluster_kernel", 1, 128, 8),
              ("scan128", "probe_staged_scan_kernel", 2, 128, 1),
              ("cluster128x4", "probe_staged_cluster_kernel", 2, 128, 4),
              ("cluster128x8", "probe_staged_cluster_kernel", 2, 128, 8),
              ("cluster64x8", "probe_staged_cluster_kernel", 2, 64, 8))


def build(kernels) -> ctypes.CDLL:
    root = Path(__file__).resolve().parent
    out = kernels.BUILD_DIR / "libfold_routes.so"
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I",
                    str(kernels._PKG / "csrc"), "-o", str(out),
                    str(root / "fold_routes.cu")], check=True)
    return ctypes.CDLL(str(out))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    from ekuiper_tpu_torch.ops import kernels
    from ekuiper_tpu_torch.ops.groupby import TorchGroupBy
    from ekuiper_tpu_torch.planner.fused import plan_fused_rule

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    kernels._load()
    lib = build(kernels)
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    lib.probe_packed.argtypes = [P_, P_, P_, P_, I_, I_, I_, P_, I_, I_,
                                 P_, I_, I_, I_, P_, P_, P_, P_, P_, P_, P_,
                                 P_]
    lib.probe_own.argtypes = [I_, I_, I_, P_, P_, P_, P_, I_, I_, I_, I_, P_,
                              I_, P_, P_, P_, P_, P_]
    ptr, stream = kernels._ptr, kernels._stream
    hh_id = kernels.WIDE_IDS["hh"]

    def pack(cmap, wmap):
        """The packed table on the card (uploaded once) and its three
        counts: scalar, hll / hist, hh columns."""
        hh = wmap[:, 0] == hh_id
        runs = [x.astype(np.int64) for x in (cmap, wmap[~hh], wmap[hh])]
        words = np.concatenate([r[:, 0] | (r[:, 1] << 8) | (r[:, 2] << 16)
                                for r in runs]).astype(np.int32)
        return (torch.from_numpy(words).to(dev),) + tuple(map(len, runs))

    def probe_packed(state, base, V, M, slots, pane, packed):
        act = state["act"]
        P, C = act.shape
        ptrs, ks = kernels._comp_table("probe", state)
        wptrs, wks = kernels._wide_table("probe", state)
        cols, ns, nw, nh = packed
        rc = lib.probe_packed(
            ptr(base), ptr(V), ptr(M), ptr(slots),
            int(slots.dtype == torch.uint16), V.shape[1], pane, None, P, C,
            ptr(cols), ns, nw, nh, ptr(ptrs), ptr(ks), ptr(act), None,
            ptr(wptrs), ptr(wks), ptr(kernels.HIST_CONSTS), stream(dev))
        if rc:
            raise RuntimeError(f"probe_packed: {rc}")

    def probe_own(route, ns, cl, state, base, V, M, slots, pane, cmap,
                  phase=None):
        act = state["act"]
        ptrs, ks = kernels._comp_table("probe", state)
        cm = np.ascontiguousarray(cmap, dtype=np.int32)
        rc = lib.probe_own(
            route, ns, cl, ptr(base), ptr(V), ptr(M), ptr(slots),
            int(slots.dtype == torch.uint16), V.shape[1], pane,
            act.shape[1], ptr(cm), len(cm), ptr(ptrs), ptr(ks), ptr(act),
            None if phase is None else ptr(phase), stream(dev))
        if rc:
            raise RuntimeError(f"probe_own {route} {ns} {cl}: {rc}")

    cases = (("tumbling", cs.TUMBLING, np.uint16, True),
             ("tumbling_i32", cs.TUMBLING, np.int32, True),
             ("hopping", cs.HOPPING, np.uint16, True),
             ("pct", cs.PCT_RULE, np.int32, False),
             ("hll", cs.HLL_RULE, np.int32, False),
             ("mixed", cs.MIXED_RULE, np.int32, False))
    rows = {}
    ok = True
    for ci, (tag, sql, sdt, scalar) in enumerate(cases):
        node = plan_fused_rule(sql, key_slots=cs.SLOTS, micro_batch=cs.ROWS,
                               device=dev)
        gb = TorchGroupBy(node.plan, capacity=cs.SLOTS, n_panes=node.n_panes,
                          micro_batch=cs.ROWS, device=dev)
        node.on_close()
        P = gb.n_panes
        pane = P - 1
        cmap, wmap = gb._colmap, gb._widemap
        st = gb.init_state()
        seed = args.seed + 10 * ci
        if P == 2:  # both panes hold data, the fold lands in pane 1
            base, V, M, s_dev, _ = cs.sketch_inputs(torch, gb, seed + 1, dev)
            kernels.fold_plain(st, base, V, M, s_dev, 0, cmap, wmap)
        base, V, M, _, s_host = cs.sketch_inputs(torch, gb, seed + 2, dev)
        slots = torch.from_numpy(s_host.astype(sdt)).to(dev)
        routes = {
            "atomic": ("groupby_fold_kernel", functools.partial(
                kernels.groupby_fold, base=base, V=V, M=M, slots=slots,
                pane=pane, colmap=cmap, widemap=wmap)),
            "packed": ("probe_packed_kernel", functools.partial(
                probe_packed, base=base, V=V, M=M, slots=slots, pane=pane,
                packed=pack(cmap, wmap)))}
        if scalar:
            for name, kname, route, ns, cl in OWN_ROUTES:
                routes[name] = (kname, functools.partial(
                    probe_own, route, ns, cl, base=base, V=V, M=M,
                    slots=slots, pane=pane, cmap=cmap))
        ref = cs.clone_state(st)
        kernels.fold_plain(ref, base, V, M, slots, pane, cmap, wmap)
        errs = {}
        for name, (_, fn) in routes.items():
            got = cs.clone_state(st)
            fn(got)
            torch.cuda.synchronize()
            try:
                errs[name] = cs.state_err(got, ref,
                                          exact=cs.EXACT)[0]
            except cs.SmokeFailure as e:
                errs[name] = f"FAILED: {e}"
                ok = False
        times = {name: [] for name in routes}
        order = list(routes)
        for rnd in range(ROUNDS):
            for name in (order if rnd % 2 == 0 else order[::-1]):
                kname, fn = routes[name]
                scratch = cs.clone_state(st)
                call = functools.partial(fn, scratch)
                times[name].append((cs.time_ms(torch, call, args.reps),
                                    cs.body_ms(torch, call, kname,
                                               args.reps)))
                del scratch
        phases = {}
        for name, kname, route, ns, cl in OWN_ROUTES if scalar else ():
            if route != 2:
                continue
            grid = -(-cs.SLOTS // (cl * ns)) * cl
            ph = torch.zeros(grid * 6, dtype=torch.int64, device=dev)
            routes[name][1](cs.clone_state(st), phase=ph)
            ph = ph.view(grid, 6).double().cpu().numpy() / 1e3
            phases[name] = dict(zip(PHASES, ph.mean(axis=0).tolist()),
                                total_max_us=float(ph[:, 5].max()))
        for name in routes:
            t = times[name]
            bodies = [b for _, b in t if b is not None]
            rows[f"{tag}/{name}"] = row = dict(
                max_abs_err=errs[name],
                ms=statistics.median(m for m, _ in t),
                body_ms=statistics.median(bodies) if bodies else None,
                rounds_ms=[m for m, _ in t],
                rounds_body_ms=[b for _, b in t],
                **({"phases_us": phases[name]} if name in phases else {}))
            print(f"fold_routes {tag} P={P} R={cs.ROWS} C={cs.SLOTS} "
                  f"slots={np.dtype(sdt).name} cols={len(cmap)}+{len(wmap)} "
                  f"{name}: {json.dumps(row)}", flush=True)
        del st, ref, gb
        torch.cuda.empty_cache()
    result = {"card": card, "ok": ok, "rows": rows}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
