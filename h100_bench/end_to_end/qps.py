"""Queries answered in the window over the window's seconds (host clock):
every request counts, the window closing when the last one ends."""


def read(run):
    if "queries_per_request" not in run.traffic:
        return None
    return sum(r.units for r in run.requests if r.error is None) / run.window_s
