#!/usr/bin/env python3
"""Designs of the tier promote (#19) on one card, at phase 2's tiered
states (G1's plan: 1 pane, Wp 4, 1,048,576 slots; G2's: 10 panes, Wp 60,
262,144 slots; the hll and percentile plans: Wp 514 and 1,028 at 16,384
slots), with 2,000 real rows of a 2,048-row block and with one:

- `port`: the port's `kernels.tier_promote` (csrc/tierstore.cu: a thread
  a (row, packed column) of the real rows, a float atomic each);
- `flat`: the same threads, a load, merge and store each (no atomic);
- `runs`: the demote's runs over the real rows (1-32 lanes a (row,
  component, pane) run, float4 where block and state share a phase), a
  load, merge and store each;
- `runs_red`: the same runs, each element merged by a float atomic;
- `pads`: the parent's design, the port's kernel over the whole block, its
  pad rows of the identity on slots[0] included.

Each is checked against `kernels.tier_promote_plain` (the state bit for
bit), then timed in alternating rounds: CUDA events around one call
(`ms`) and the kernel body from a profiler trace (`body_ms`), the median
over the rounds.

Run from the repository root on a machine with a card:

    python3 promote_routes.py [--reps 30] [--out DIR/promote_routes.json]

It prints the card's name and power limit, one line per (plan, rows,
design), and as its last line one JSON object {"card": ..., "rows": {...}}.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

import chip_smoke as cs

ROUNDS = 3
#: each design's kernel, as a profiler trace names it
KERNEL = {"port": "tier_promote_kernel", "flat": "probe_flat_kernel",
          "runs": "probe_runs_store_kernel",
          "runs_red": "probe_runs_red_kernel", "pads": "tier_promote_kernel"}


def build(kernels) -> ctypes.CDLL:
    root = Path(__file__).resolve().parent
    out = kernels.BUILD_DIR / "libpromote_routes.so"
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I",
                    str(kernels._PKG / "csrc"), "-o", str(out),
                    str(root / "promote_routes.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.probe_promote_flat.argtypes = [P, P, P, P, I, I, I, P, I, I, P, P]
    lib.probe_promote_runs.argtypes = [P, P, P, P, I, I, I, P, I, I, P, I, P]
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    from ekuiper_tpu_torch.ops import kernels
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
    stream = kernels._stream(dev)

    def probe(fn, state, comps, *rest):
        ptrs, ws, inits, ops, P, C, _ = kernels._tier_table(
            "probe", state, comps)
        rc = fn(kernels._ptr(ptrs), kernels._ptr(ws), kernels._ptr(inits),
                kernels._ptr(ops), len(comps), P, C, *rest)
        if rc:
            raise RuntimeError(f"{fn.__name__}: CUDA error {rc}")

    rows = {}
    cases = (("g1", cs.G1_RULE, cs.G1_OPTS, cs.G_SLOTS),
             ("g2", cs.G2_RULE, {"tierHotMb": cs.G_HOT_MB}, cs.G_SLOTS),
             ("hll", cs.HLL_RULE, {"tierHotMb": 64}, cs.SLOTS),
             ("pct", cs.PCT_RULE, {"tierHotMb": 128}, cs.SLOTS))
    for i, (tag, sql, opts, cap) in enumerate(cases):
        node = plan_fused_rule(sql, key_slots=cap, micro_batch=cs.ROWS,
                               device=dev, options=opts)
        gb, ts = node.gb, node.tier.ts
        st = cs.tier_state(torch, args.seed + 700 + i, node, dev)
        r = np.random.default_rng(args.seed + 710 + i)
        D, comps = ts.demote_batch, ts.comps
        n = D - 48
        s, real = ts._slots(r.choice(gb.capacity, n, replace=False))
        block = kernels.tier_demote_plain(
            cs.clone_state(st), torch.from_numpy(s).to(dev), real, comps)
        host = block.cpu().numpy()[:real][::-1].copy()
        d = r.choice(gb.capacity, n, replace=False).astype(np.int32)
        for nn in (n, 1):
            pk = torch.from_numpy(host[:nn].copy()).to(dev)
            d_dev = torch.from_numpy(d[:nn].copy()).to(dev)
            full = np.tile(ts.init_row(), (D, 1))
            full[:nn] = host[:nn]
            pk_full = torch.from_numpy(full).to(dev)
            d_full = torch.from_numpy(np.concatenate(
                [d[:nn], np.full(D - nn, d[0], np.int32)])).to(dev)
            routes = {
                "port": lambda a: kernels.tier_promote(a, pk, d_dev, nn, D,
                                                       comps),
                "flat": lambda a: probe(
                    lib.probe_promote_flat, a, comps, kernels._ptr(d_dev),
                    nn, D, kernels._ptr(pk), stream),
                "runs": lambda a: probe(
                    lib.probe_promote_runs, a, comps, kernels._ptr(d_dev),
                    nn, D, kernels._ptr(pk), 0, stream),
                "runs_red": lambda a: probe(
                    lib.probe_promote_runs, a, comps, kernels._ptr(d_dev),
                    nn, D, kernels._ptr(pk), 1, stream),
                "pads": lambda a: kernels.tier_promote(a, pk_full, d_full, D,
                                                       D, comps),
            }
            ref = cs.clone_state(st)
            kernels.tier_promote_plain(ref, pk, d_dev, nn, D, comps)
            for design, fn in routes.items():
                got = cs.clone_state(st)
                fn(got)
                torch.cuda.synchronize()
                if not cs.same_bits(torch, got, ref):
                    sys.exit(f"{design} {tag} n={nn}: state differs")
                del got
            del ref
            work = cs.clone_state(st)
            times = {k: [] for k in routes}
            for _ in range(ROUNDS):
                for design, fn in routes.items():
                    def call(fn=fn):
                        fn(work)
                    times[design].append((
                        cs.time_ms(torch, call, args.reps),
                        cs.body_ms(torch, call, KERNEL[design], args.reps)))
            del work
            for design, t in times.items():
                bodies = [b for _, b in t if b is not None]
                row = dict(ms=statistics.median(m for m, _ in t),
                           body_ms=statistics.median(bodies) if bodies
                           else None)
                rows[f"{tag}/n{nn}/{design}"] = row
                print(f"promote_routes {tag} Wp={ts.packed_w} n={nn} "
                      f"{design}: {json.dumps(row)}", flush=True)
        del node, st
        torch.cuda.empty_cache()
    result = {"card": card, "rows": rows}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
