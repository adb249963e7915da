"""Straggler share of the fan-out: per part-B request, the slowest shard's
`shard<s>.traverse` device seconds over the shards' mean, then the mean
over the requests (1 when the shards take equal time)."""

import numpy as np

from h100_bench.metrics._shards import per_request


def read(run):
    reqs = per_request(run, "traverse")
    if reqs is None:
        return None
    t = np.asarray(reqs)
    if (t.mean(1) <= 0).any():
        return None
    return float(np.mean(t.max(1) / t.mean(1)))
