#!/usr/bin/env python3
"""Phase 3 of chip_smoke.py (the tumbling rule end to end on one card)
from two checkouts of the repository, alternately A B B A, each run in a
process of its own started in its checkout (so each builds and imports
its own kernels and port): rows/s, emit p50/p99 and the host's encode and
fold ms a batch. Both run the same number of windows.

Run from the repository root on a machine with a card, the parent
checkout unpacked into a directory that .gitignore lists:

    git archive HEAD~1 | (mkdir -p _archive/parent && tar -x -C _archive/parent)
    python3 ab_tumbling.py _archive/parent . --windows 6

The last line of its output is one JSON object: {"a": [...], "b": [...]},
one entry per run.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

RUN = r"""
import json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from ekuiper_tpu_torch.data.batch import ColumnBatch
from ekuiper_tpu_torch.ops import kernels
from ekuiper_tpu_torch.planner.fused import plan_fused_rule
from ekuiper_tpu_torch.runtime.events import Trigger

if not torch.cuda.is_available():
    sys.exit("no CUDA device")
kernels.build_library()
cs.WINDOWS = int(sys.argv[1])
_, rps, emit_ms, err, st = cs.run_rule(
    torch, 0, cs.TUMBLING, 10_000, 1, kernels,
    (plan_fused_rule, ColumnBatch, Trigger))
n_b = cs.WINDOWS * cs.BATCHES
print(json.dumps(dict(
    rows_per_s=rps, emit_p50_ms=cs.pct(emit_ms, 50),
    emit_p99_ms=cs.pct(emit_ms, 99), max_abs_err=err,
    encode_ms=st["encode"] / n_b * 1e3, fold_ms=st["fold"] / n_b * 1e3)))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("a", help="checkout A (the parent)")
    ap.add_argument("b", help="checkout B (the change)")
    ap.add_argument("--windows", type=int, default=6,
                    help="windows of 16 batches of 65,536 rows a run")
    args = ap.parse_args()
    out = {"a": [], "b": []}
    for tag in ("a", "b", "b", "a"):
        root = os.path.abspath(getattr(args, tag))
        res = subprocess.run([sys.executable, "-c", RUN, str(args.windows)],
                             cwd=root, capture_output=True, text=True,
                             timeout=600)
        if res.returncode:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        row = json.loads(res.stdout.strip().splitlines()[-1])
        out[tag].append(row)
        print(f"{tag} {root}: rows/s={row['rows_per_s']:.0f} "
              f"encode_ms={row['encode_ms']:.3f} fold_ms={row['fold_ms']:.3f}"
              f" emit_p50_ms={row['emit_p50_ms']:.3f} emit_p99_ms="
              f"{row['emit_p99_ms']:.3f}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
