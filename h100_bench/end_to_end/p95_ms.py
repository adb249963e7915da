"""The 95th percentile of the latency of every request of the window
(host clock, milliseconds); left out below 20 requests, where no sample
lies beyond it."""

import numpy as np


def read(run):
    lat = [(r.t1 - r.t0) * 1e3 for r in run.requests if r.error is None]
    if "queries_per_request" not in run.traffic or len(lat) < 20:
        return None
    return float(np.percentile(lat, 95))
