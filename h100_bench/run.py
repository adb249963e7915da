#!/usr/bin/env python3
"""The benchmark of ngt_tpu_torch on NVIDIA H100 cards.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout.  One run sets up the cell named in
BENCHMARK.json, measures it for ``--seconds`` and prints one JSON object as
the last line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` a ``breakdown``, and
last the ``checks`` that decided ``correct``, each beside its limit.  It
needs as many CUDA cards as the cell asks for and exits non-zero without a
result where they are missing.  See harness.py for the run's steps.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the checkout's root, not this folder, is where imports start
    sys.path[0] = ROOT
    import torch

    from h100_bench import harness

    chips = harness.Bench(ROOT).cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    devices = [torch.device(f"cuda:{i}") for i in range(chips)]
    torch.cuda.set_device(devices[0])
    harness.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), devices,
                T_PROCESS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
