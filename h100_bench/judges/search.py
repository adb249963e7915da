"""``correct`` for the ``search`` kind.

``dist_gap``: the largest gap between a distance the program reports and
the float64 distance of the id it names, as a share of that distance
(infinite for a missing, repeated or out-of-range id).  ``recall_gap``:
one less the mean recall@k of all answers against the exact top k.
``recall`` is kept for the ``recall_at_10`` metrics."""

from __future__ import annotations

import numpy as np

from h100_bench.judge import BLOCK, checks, width
from h100_bench.reference import ExactSearch, distance_gaps, hits


def judge(answers, base, queries, sample, config, limits, device) -> dict:
    k = int(config["k"])
    metric = config["distance_type"]
    qidx = np.concatenate([a[0] for a in answers])
    ids = np.concatenate([width(a[1], k, -1) for a in answers]).astype(np.int64)
    dists = np.concatenate([width(a[2], k, np.inf) for a in answers]).astype(np.float64)
    uniq, inv = np.unique(qidx, return_inverse=True)
    ref = ExactSearch(base, metric, device)
    exact = ref.topk(queries[uniq], k)[0]
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
