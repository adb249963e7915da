"""Large single-card recipe (the port's copy of samples/large_single_chip.py;
NGT's large-dataset regime, NGT_LARGE_DATASET at 5M, Graph.h:287-380): a
4M x 128 uint8-valued corpus on one card, built with
``edge_size_for_creation`` 40 and searched on the quantized-graph route
at three (ef, result_expansion) settings, recall@10 against exact ground
truth.  What keeps it compact on the card:

* the narrow device mirror (an integral corpus is 1 byte a dimension);
* the u8-exact codes (the sq8 code matrix IS the mirror);
* the neighbor blocks sized by ``NGT_TPU_QG_BLOCK_GB`` (``--block-gb``);
* the edge-tail refinement and the ``ef`` rank widening for recall.

``--stage`` builds by staged bulk appends of that many rows, each through
the scan-and-merge append path.  No number of this script at its
documented size has been measured on the card; PERF.md lists the sizes
chip_smoke.py ran it at.

Run:  python samples/torch/large_single_chip.py [--device cuda] [--n 4000000]
      python samples/torch/large_single_chip.py --n 8000000 --stage 2000000 --block-gb 8
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

import ngt_tpu_torch  # noqa: E402  (path set above)
from ngt_tpu_torch.ops.bruteforce import recall_at_k  # noqa: E402

#: (ef, result_expansion) settings of the search
SETTINGS = ((48, 5.0), (72, 8.0), (96, 10.0))


def main(argv=None):
    ap = argparse.ArgumentParser(description="large single-card build and qg search")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=4_000_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--queries", type=int, default=4096)
    ap.add_argument("--stage", type=int, default=0,
                    help="rows per staged bulk append (0 = one build)")
    ap.add_argument("--block-gb", type=float, default=0,
                    help="NGT_TPU_QG_BLOCK_GB for the search (0 = leave it)")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    base = rng.integers(0, 200, size=(5000, args.dim)).astype(np.float32)
    reps = (args.n + len(base) - 1) // len(base)
    data = np.tile(base, (reps, 1))[: args.n]
    data += rng.normal(scale=12.0, size=data.shape).astype(np.float32)
    np.clip(np.rint(data), 0, 255, out=data)   # integral: the u8 mirror

    t0 = time.time()
    idx = ngt_tpu_torch.create(None, dimension=args.dim, edge_size_for_creation=40,
                               device=args.device)
    step = args.stage if args.stage > 0 else args.n
    for lo in range(0, args.n, step):
        idx.batch_insert(data[lo : lo + step], build=True)
        if args.stage:
            _ = idx.graph.degree   # bring the deferred adjacency to the host
            print(f"  staged append -> {min(lo + step, args.n)} rows "
                  f"({time.time() - t0:.1f} s)", flush=True)
    print(f"build {args.n} rows: {time.time() - t0:.1f} s")

    q = base[rng.choice(len(base), args.queries)] + rng.normal(
        scale=12.0, size=(args.queries, args.dim)).astype(np.float32)
    gt, _ = idx.batch_linear_search(q, size=10)
    idx.store.release_device()   # drop the ground truth's device corpus copy
    old = os.environ.get("NGT_TPU_QG_BLOCK_GB")
    if args.block_gb:
        os.environ["NGT_TPU_QG_BLOCK_GB"] = str(args.block_gb)
    out = []
    try:
        for ef, rexp in SETTINGS:
            idx.prop.result_expansion = rexp
            idx.batch_search(q, size=10, epsilon=0.0, ef=ef)   # warm
            t0 = time.time()
            ids, _ = idx.batch_search(q, size=10, epsilon=0.0, ef=ef)
            dt = time.time() - t0
            rec = recall_at_k(np.asarray(ids), np.asarray(gt), 10)
            print(f"ef={ef} rexp={rexp} recall@10={rec:.4f} "
                  f"queries/s={args.queries / dt:.0f}", flush=True)
            out.append({"ef": ef, "result_expansion": rexp, "recall": rec,
                        "queries_per_s": args.queries / dt})
    finally:
        if args.block_gb:
            if old is None:
                del os.environ["NGT_TPU_QG_BLOCK_GB"]
            else:
                os.environ["NGT_TPU_QG_BLOCK_GB"] = old
    assert out[-1]["recall"] >= 0.9, out
    return out


if __name__ == "__main__":
    main()
