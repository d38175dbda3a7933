#!/usr/bin/env python3
"""Tile sizes of the segmented scans (#21 `segscan_shift`, #22
`segscan_sort`, csrc/relational.cu) on one card: for each (radix pass,
scan) tile size a copy of the source with its RADIX_ITEMS / SCAN_ITEMS
changed is built, checked against the plain versions on chip_smoke.py's
phase-2 inputs, and timed at phase 2's shapes (CUDA events around one
call, and the summed kernel bodies of a profiler trace). RADIX_ITEMS is
csrc/radix_sort.cuh's, so each variant is a directory holding a copy of
that header beside its copy of the source.

Run from the repository root on a machine with a card:

    python3 segscan_tiles.py

It prints the card's name and power limit, one line per (tiles, shape),
and as its last line one JSON object {"card": ..., "rows": [...]}.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np

import chip_smoke as cs

#: rows a thread of a pass and of a scan takes (256 threads a block); the
#: source's own setting first
TILES = ((4, 4), (8, 8), (8, 4), (4, 8))
#: (kernel, tag, rows, slots, Zipf-skewed)
SHAPES = (("shift", "8192", cs.K_SHIFT_SMALL, cs.N_KEYS, False),
          ("shift", "131072", cs.K_SHIFT_ROWS, cs.N_KEYS, False),
          ("shift", "zipf", cs.K_SHIFT_ROWS, cs.N_KEYS, True),
          ("shift", "one_segment", cs.K_SHIFT_ROWS, 1, False),
          ("sort", "65536", cs.K_WINDOW_ROWS, cs.N_KEYS, False),
          ("sort", "one_segment", cs.K_WINDOW_ROWS, 1, False))


def with_define(text: str, name: str, value: int) -> str:
    line = next(ln for ln in text.splitlines()
                if ln.startswith(f"#define {name} "))
    return text.replace(line, f"#define {name} {value}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    import torch

    from ekuiper_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card)
    dev = torch.device("cuda")
    rng = np.random.default_rng(13)
    inputs = {}
    for kind, tag, B, slots, zipf in SHAPES:
        x = cs.seg_inputs(torch, rng, B, slots, dev, zipf=zipf)
        if kind == "sort":
            x[1] = torch.round(x[1] * 2) / 2
        inputs[tag, kind] = x
    src_path = kernels.SOURCES["relational"]
    src = src_path.read_text()
    header = (src_path.parent / "radix_sort.cuh").read_text()
    rows = []
    for radix, scan in TILES:
        out_dir = kernels.BUILD_DIR / "variants" / f"r{radix}_s{scan}"
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "radix_sort.cuh").write_text(
            with_define(header, "RADIX_ITEMS", radix))
        path = out_dir / "relational.cu"
        # the build tag hashes the source, not this header: name both
        path.write_text(f"// RADIX_ITEMS {radix}, SCAN_ITEMS {scan}\n"
                        + with_define(src, "SCAN_ITEMS", scan))
        kernels.SOURCES["relational"] = path
        kernels._lib = None
        for kind, tag, B, slots, _ in SHAPES:
            x = inputs[tag, kind]
            if kind == "shift":
                carry = (torch.zeros(cs.SLOTS, dtype=torch.int32, device=dev),
                         torch.zeros(cs.SLOTS, device=dev),
                         torch.zeros(cs.SLOTS, dtype=torch.bool, device=dev),
                         torch.zeros(cs.SLOTS, device=dev))
                want = kernels.segscan_shift_plain(
                    tuple(t.clone() for t in carry), *x)
                got = kernels.segscan_shift(tuple(t.clone() for t in carry),
                                            *x)
                cs.seg_equal(got, want, (0, 1, 2, 4), (3,), f"{tag} shift")
                names = cs.SHIFT_KERNELS

                def call(c=carry, x=x):
                    return kernels.segscan_shift(c, *x)
            else:
                cs.seg_equal(kernels.segscan_sort(*x),
                             kernels.segscan_sort_plain(*x), range(6), (),
                             f"{tag} sort")
                names = cs.SORT_KERNELS

                def call(x=x):
                    return kernels.segscan_sort(*x)
            ms = cs.time_ms(torch, call, args.reps)
            body = cs.body_ms(torch, call, names, args.reps, per_call=True)
            row = dict(radix_tile=256 * radix, scan_tile=256 * scan,
                       kernel=f"segscan_{kind}", shape=tag, rows=B,
                       slots=slots, ms=ms, body_ms=body)
            rows.append(row)
            body_text = "none" if body is None else f"{body:.4f}"
            print(f"tiles {256 * radix}/{256 * scan} segscan_{kind} {tag}: "
                  f"ms={ms:.4f} body_ms={body_text}", flush=True)
    kernels.SOURCES["relational"] = src_path
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
