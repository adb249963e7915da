#!/usr/bin/env python3
"""The control of ``correct``: the plain reference computed in TF32, one
precision below the configurations' float32 with TF32 off, put in the
program's place (``control`` of ``kinds/<kind>.py``) and driven and judged
by the same harness as a run.  Its checks set the upper reading of each
limit (cells/<cell>.json); a sound control reads ``correct`` false.

    python3 h100_bench/control.py --workload <cell> --seeds 1 2 3 --requests 8

One process takes every seed in turn; each prints its result line.  The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the control of correct")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, required=True,
                    help="requests per seed: as many as a run of the cell judges")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[0] = ROOT
    from h100_bench import harness

    chips = harness.Bench(ROOT).cell(args.workload)["chips"]
    devices = ([torch.device(f"cuda:{i}") for i in range(chips)] if args.device == "cuda"
               else [torch.device(args.device)])
    for seed in args.seeds:
        res = harness.run(ROOT, args.workload, seed, 1e9, False, devices, time.perf_counter(),
                          system="control", max_requests=args.requests)
        print(f"control {args.workload} seed {seed}: correct {res['correct']}, "
              + ", ".join(f"{k} {v['value']!r}" for k, v in res["checks"].items()),
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
