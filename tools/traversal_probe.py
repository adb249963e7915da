#!/usr/bin/env python3
"""The graph traversal's callers outside the benchmark's cells, timed.

    python3 /path/to/tools/traversal_probe.py --label change

run from the root of a checkout on a CUDA card: it imports that checkout's
``ngt_tpu_torch`` (and its ``chip_smoke.py``), so one copy of the script
times two checkouts in turn.  On the smoke's SIFT-shaped corpus
(``chip_smoke.sift_proxy``, 1,000,000 x 128 by default) after a bulk build
it times:

* the exact route (``search_mode="exact"``): 10,000 held-out queries a
  call after a warm call (three calls), one query a call (the median of
  20), and three rounds of mixed batch sizes;
* the qg route: three rounds of batches that pad to each of its five
  buckets (32-512 rows);
* ``build_anng``: three appends of 2,048 rows (two batches of 1,024) into
  slots freed just before.

Each round of mixed sizes also counts the graphs it captured
(``traverse.captures``, 0 where the checkout has no such counter).  Prints
one JSON line.
"""

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", required=True, help="a name for the checkout, echoed")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=10_000)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import ngt_tpu_torch
    from chip_smoke import sift_proxy
    from ngt_tpu_torch import trace
    from ngt_tpu_torch.graph import build as TB
    from ngt_tpu_torch.graph import search as TS

    dev, n, nq = args.device, args.rows, args.queries
    cuda = dev.startswith("cuda")
    out = {"label": args.label, "card": torch.cuda.get_device_name(0) if cuda else dev}

    def timed(fn):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    def mixed_rounds(sizes, into):
        os.environ[trace.SEARCH] = "1"
        for rnd in range(3):
            trace.clear()
            into[f"mixed_round{rnd}_s"] = timed(
                lambda: [idx.batch_search(held[:m], size=10, epsilon=0.1) for m in sizes])
            into[f"mixed_round{rnd}_captures"] = sum(
                r.value for r in trace.records() if r.name == "traverse.captures")
        os.environ.pop(trace.SEARCH)

    base, more = sift_proxy(n, extra=max(30_000, nq + 3 * 2048), extra_seed=5)
    held = more[:nq]
    idx = ngt_tpu_torch.create(None, dimension=128, device=dev)
    out["build_s"] = timed(lambda: idx.batch_insert(base, build=True))

    idx.prop.search_mode = "exact"
    ex = {"first_s": timed(lambda: idx.batch_search(held, size=10, epsilon=0.1))}
    ex["all_queries_s"] = sorted(
        timed(lambda: idx.batch_search(held, size=10, epsilon=0.1)) for _ in range(3))
    mixed_rounds((1000, 100, 10, 1, nq, 3000), ex)
    ex["one_query_ms"] = sorted(
        1e3 * timed(lambda: idx.batch_search(held[j : j + 1], size=10, epsilon=0.1))
        for j in range(20))[10]
    out["exact"] = ex

    idx.prop.search_mode = "auto"
    qg = {"first_s": timed(lambda: idx.batch_search(held, size=10, epsilon=0.1))}
    mixed_rounds((1, 40, 100, 200, 400, 512, 3, 33), qg)
    out["qg"] = qg

    anng = []
    for rnd in range(3):
        lo = 1 + (n // 4) * rnd
        idx.batch_remove(np.arange(lo, lo + 2048))
        rows = more[nq + 2048 * rnd : nq + 2048 * (rnd + 1)]
        anng.append({"s": timed(lambda: idx.batch_insert(rows, build=True)),
                     "batches": [(b, round(t, 3), st) for b, t, st in TB.last_batches]})
    out["build_anng"] = anng
    out["reserved_gib"] = torch.cuda.memory_reserved() / 2**30 if cuda else None
    out["graphs_cached"] = len(getattr(TS, "_GRAPHS", {}))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
