"""``correct`` for the ``build`` kind.

``edge_miss``: one less the share of the first ``edge_size_for_creation``
edges of the judged rows that are exact k-NN edges, over every build of the
window.  ``edge_dist_gap``: the ``dist_gap`` of those edges."""

from __future__ import annotations

from h100_bench.judge import checks
from h100_bench.reference import ExactSearch, distance_gaps, hits


def judge(answers, base, queries, sample, config, limits, device) -> dict:
    k = int(config["index"].get("edge_size_for_creation", 10))
    metric = config["distance_type"]
    exact = ExactSearch(base, metric, device).topk(base[sample], k, exclude=sample)[0]
    got = 0
    gap = 0.0
    for e_ids, e_d in answers:
        got += int(hits(e_ids, exact).sum())
        gap = max(gap, float(distance_gaps(base[sample], base, e_ids, e_d, metric).max()))
    miss = 1.0 - got / (len(answers) * len(sample) * k)
    readings = {"edge_miss": miss, "edge_dist_gap": gap}
    return {"edge_agreement": 1.0 - miss, "builds": len(answers), "readings": readings,
            "checks": checks(readings, limits)}
