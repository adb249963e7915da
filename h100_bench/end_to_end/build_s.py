"""Seconds per fresh bulk build: the builds' own seconds (host clock,
each closed by a synchronize) over the builds of the window; the read-out
of the judged edges between builds is not a build's."""


def read(run):
    builds = [r for r in run.requests if r.error is None]
    if run.traffic["kind"] != "build" or not builds:
        return None
    return sum(r.t1 - r.t0 for r in builds) / len(builds)
