"""Seconds of a bulk build outside its scan phase: the build's own seconds
less the `scan` mark of graph/build.py's `last_profile` (part B, marks on);
the host store fill, rows, components, seeds, connect and mirror."""

from h100_bench.metrics._read import total


def read(run):
    builds = run.part("B")
    scan = total(run, "build.scan")
    if not builds or scan <= 0:
        return None
    return (sum(r.t1 - r.t0 for r in builds) - scan) / len(builds)
