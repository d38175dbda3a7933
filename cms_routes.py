#!/usr/bin/env python3
"""Two designs of the count-min update (#10) on one card, at phase M's
65,536 values a batch, across the widths of the reference's tests:

- `warps`: the port's `kernels.cms_update` (csrc/countmin.cu: a thread a
  value, the lanes of a warp that hash to one cell adding their count
  with one global atomic);
- `rows`: cms_routes.cu, kept out of the port (a block per (chunk, row),
  the row's counts in shared memory, one global atomic a non-zero cell).

Each is checked against `kernels.cms_update_plain` (bit-equal: integer
counts below 2^24), then timed in alternating rounds on phase M's skewed
mix and on a uniform stream over [0, 2^20): CUDA events around one call
(`ms`) and the kernel body from a profiler trace (`body_ms`), the median
over the rounds.

Run from the repository root on a machine with a card:

    python3 cms_routes.py [--reps 30] [--out DIR/cms_routes.json]

It prints the card's name and power limit, one line per (shape, stream,
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
#: (depth, width) of the count-min sketches timed: the port's default and
#: narrower ones
SHAPES = ((4, 8192), (4, 2048), (3, 1000), (2, 128), (2, 64))
#: each design's kernel, as a profiler trace names it
KERNEL = {"warps": "cms_update_kernel", "rows": "probe_cms_rows_kernel"}


def build(kernels) -> ctypes.CDLL:
    root = Path(__file__).resolve().parent
    out = kernels.BUILD_DIR / "libcms_routes.so"
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I",
                    str(kernels._PKG / "csrc"), "-o", str(out),
                    str(root / "cms_routes.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.probe_cms_rows.argtypes = [P, I, I, P, I, P]
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    from ekuiper_tpu_torch.ops import kernels

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

    def rows_update(counts, values):
        rc = lib.probe_cms_rows(kernels._ptr(counts), *counts.shape,
                                kernels._ptr(values), len(values),
                                kernels._stream(dev))
        if rc:
            raise RuntimeError(f"probe_cms_rows: CUDA error {rc}")

    update = {"warps": kernels.cms_update, "rows": rows_update}
    rng = np.random.default_rng(args.seed + 7)
    streams = {"mix": cs.m_values(rng, cs.ROWS),
               "uniform": rng.integers(0, 1 << 20, cs.ROWS).astype(
                   np.float32)}
    rows = {}
    for d, w in SHAPES:
        for tag, v in streams.items():
            v = torch.from_numpy(v).to(dev)
            ref = torch.zeros((d, w), device=dev)
            kernels.cms_update_plain(ref, v)
            times = {k: [] for k in update}
            for design, fn in update.items():
                got = torch.zeros((d, w), device=dev)
                fn(got, v)
                torch.cuda.synchronize()
                if not torch.equal(got, ref):
                    sys.exit(f"{design} {d}x{w} {tag}: counts differ")
            for _ in range(ROUNDS):
                for design, fn in update.items():
                    c = torch.zeros((d, w), device=dev)

                    def call(fn=fn, c=c):
                        fn(c, v)

                    times[design].append((
                        cs.time_ms(torch, call, args.reps),
                        cs.body_ms(torch, call, KERNEL[design], args.reps)))
            for design, t in times.items():
                bodies = [b for _, b in t if b is not None]
                row = dict(ms=statistics.median(m for m, _ in t),
                           body_ms=statistics.median(bodies) if bodies
                           else None)
                rows[f"{d}x{w}/{tag}/{design}"] = row
                print(f"cms_routes {d}x{w} {tag} {design}: "
                      f"{json.dumps(row)}", flush=True)
    result = {"card": card, "rows": rows}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
