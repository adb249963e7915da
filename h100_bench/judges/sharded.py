"""``correct`` for the ``sharded`` kind: the search kind's readings
(``dist_gap``, ``recall_gap``, and ``recall`` for the ``recall_at_10``
metrics) against the exact top k over the whole corpus, so that the
sharding must be invisible in the answers.  The reference scans in chunks
of ``CHUNK`` queries, whose [CHUNK, rows] float32 scores fit one card at
10M rows."""

from __future__ import annotations

import numpy as np

from h100_bench.judge import BLOCK, checks, width
from h100_bench.reference import ExactSearch, distance_gaps, hits

#: queries per chunk of the reference's scan: 128 x 10M float32 scores are
#: 5.1 GB, and the scan holds three such arrays at once
CHUNK = 128


def judge(answers, base, queries, sample, config, limits, device) -> dict:
    k = int(config["k"])
    metric = config["distance_type"]
    qidx = np.concatenate([a[0] for a in answers])
    ids = np.concatenate([width(a[1], k, -1) for a in answers]).astype(np.int64)
    dists = np.concatenate([width(a[2], k, np.inf) for a in answers]).astype(np.float64)
    uniq, inv = np.unique(qidx, return_inverse=True)
    ref = ExactSearch(base, metric, device)
    exact = ref.topk(queries[uniq], k, chunk=CHUNK)[0]
    del ref
    got = 0
    gap = 0.0
    for lo in range(0, len(qidx), BLOCK):
        sl = slice(lo, lo + BLOCK)
        got += int(hits(ids[sl], exact[inv[sl]]).sum())
        gap = max(gap, float(distance_gaps(queries[qidx[sl]], base, ids[sl], dists[sl],
                                            metric).max()))
    recall = got / (len(qidx) * k)
    readings = {"dist_gap": gap, "recall_gap": 1.0 - recall}
    return {"recall": recall, "answers": len(qidx), "readings": readings,
            "checks": checks(readings, limits)}
