#!/usr/bin/env python3
"""Rows of chip_smoke.py from two checkouts of the repository, alternately
A B B A, each run in a process of its own started in its checkout (so
each builds and imports its own kernels and port). Both run the same
work. `--phase` picks the rows:

- `tumbling` (the default): phase 3, the tumbling rule end to end on one
  card: rows/s, emit p50/p99 and the host's encode and fold ms a batch.
- `multirule`: the rule group's kernel rows of phase 2 (#15's fold and
  wide fold, their pane-vector forms, #16's finalizes, #17's reset, and
  in a tree that has it the folds' row order), and beside them each
  tree's #15 wrapper on E1's batch with Zipf-skewed slots and with one
  slot taking every row, timed by the same code.

Run from the repository root on a machine with a card, the parent
checkout unpacked into a directory that .gitignore lists:

    git archive HEAD~1 | (mkdir -p _archive/parent && tar -x -C _archive/parent)
    python3 ab_tumbling.py _archive/parent . --windows 6
    python3 ab_tumbling.py _archive/parent . --phase multirule --out DIR

With --out, each run's result is written to DIR/ab_<phase>_<tag><i>.json.
The last line of the output is one JSON object {"a": [...], "b": [...]},
one entry per run (for `multirule`, each row's headline numbers: ms,
body_ms, host_ms, plain_ms, library_ms, bound_ms and the like).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

PRELUDE = r"""
import functools, json, sys, time
sys.path.insert(0, ".")
import numpy as np
import torch
import chip_smoke as cs
from ekuiper_tpu_torch.ops import kernels

if not torch.cuda.is_available():
    sys.exit("no CUDA device")
kernels.build_library()
"""

TUMBLING = r"""
from ekuiper_tpu_torch.data.batch import ColumnBatch
from ekuiper_tpu_torch.planner.fused import plan_fused_rule
from ekuiper_tpu_torch.runtime.events import Trigger

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

MULTIRULE = r"""
from ekuiper_tpu_torch.ops import sketches
from ekuiper_tpu_torch.planner.rulegroup import plan_rule_group

dev = torch.device("cuda")
rows = {}
rows.update(cs.group_kernel_checks(torch, 0, kernels, plan_rule_group, dev))
rows.update(cs.wide_group_kernel_checks(torch, 0, kernels, sketches,
                                        plan_rule_group, dev))
rows.update(cs.event_group_kernel_checks(torch, 0, kernels, sketches, dev))
torch.cuda.empty_cache()
# E1's batch on skewed slots through this tree's wrapper
node = plan_rule_group(cs.rule_ids("e1_", cs.E1_RULES), cs.e1_sqls(),
                       key_slots=cs.SLOTS, micro_batch=cs.ROWS, device=dev)
gb = node.gb
r = np.random.default_rng(41)
temp = torch.from_numpy(r.normal(20, 5, cs.ROWS).astype(np.float32)).to(dev)
base, V, M = gb.rule_inputs({"temperature": temp}, cs.ROWS)
# every kernel either tree's #15 wrapper launches, the row order's memset
# among them (the parent's one kernel is multirule_fold_kernel)
names = ("Memset", "multirule_fold_kernel", "multirule_fold_keys_kernel",
         "multirule_fold_pieces_kernel", "pack_rule_bits_kernel",
         "fold_gather_kernel", "radix_hist_kernel", "radix_pass_kernel",
         "fold_order_finish_kernel")
zipf = np.minimum(r.zipf(1.3, cs.ROWS) - 1, cs.N_KEYS - 1)
for tag, sl in (("zipf", zipf), ("one_slot", np.full(cs.ROWS, 7))):
    s = torch.from_numpy(sl.astype(np.int32)).to(dev)
    st = gb.init_state()
    fn = functools.partial(kernels.multirule_fold, st, base, V, M, s, 0,
                           gb._colmap)
    rows["ab_skew/" + tag] = dict(
        ms=cs.time_ms(torch, fn, cs.REPS),
        body_ms=cs.body_ms(torch, fn, names, cs.REPS, per_call=True))
    print("ab_skew", tag, rows["ab_skew/" + tag], flush=True)
print(json.dumps(rows))
"""

PHASES = {"tumbling": (TUMBLING, 600), "multirule": (MULTIRULE, 1500)}
#: the numbers of a multirule row the summary keeps
KEYS = ("ms", "fold_only_ms", "readback_ms", "scalar_pane_ms", "body_ms",
        "host_ms", "plain_ms", "library_ms", "library_idx_ms", "bound_ms",
        "bound_inputs_ms", "kernel_rounds_ms", "library_rounds_ms")


def _fmt(v) -> str:
    return (" ".join(f"{x:.4f}" for x in v) if isinstance(v, list)
            else f"{v:.4f}")


def summary(phase: str, label: str, res: dict) -> dict:
    """Print one run's headline and return what the last line keeps."""
    if phase == "tumbling":
        print(f"{label}: rows/s={res['rows_per_s']:.0f} "
              f"encode_ms={res['encode_ms']:.3f} fold_ms={res['fold_ms']:.3f}"
              f" emit_p50_ms={res['emit_p50_ms']:.3f} emit_p99_ms="
              f"{res['emit_p99_ms']:.3f}", flush=True)
        return res
    head = {name: {k: row[k] for k in KEYS if row.get(k) is not None}
            for name, row in res.items()}
    for name in sorted(head):
        print(f"{label} {name}: " + " ".join(
            f"{k}={_fmt(v)}" for k, v in head[name].items()), flush=True)
    return head


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("a", help="checkout A (the parent)")
    ap.add_argument("b", help="checkout B (the change)")
    ap.add_argument("--phase", choices=sorted(PHASES), default="tumbling",
                    help="the rows to run (default: tumbling)")
    ap.add_argument("--windows", type=int, default=6,
                    help="tumbling: windows of 16 batches of 65,536 rows a "
                         "run")
    ap.add_argument("--out", help="directory for each run's result (JSON)")
    args = ap.parse_args()
    code, limit = PHASES[args.phase]
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    out = {"a": [], "b": []}
    for i, tag in enumerate(("a", "b", "b", "a")):
        root = os.path.abspath(getattr(args, tag))
        res = subprocess.run(
            [sys.executable, "-c", PRELUDE + code, str(args.windows)],
            cwd=root, capture_output=True, text=True, timeout=limit)
        if res.returncode:
            print(res.stdout[-8000:] + res.stderr[-8000:], file=sys.stderr)
            return res.returncode
        result = json.loads(res.stdout.strip().splitlines()[-1])
        if args.out:
            with open(os.path.join(args.out, f"ab_{args.phase}_{tag}{i}.json"),
                      "w") as f:
                json.dump(result, f)
        out[tag].append(summary(args.phase, f"{tag}{i} {root}", result))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
