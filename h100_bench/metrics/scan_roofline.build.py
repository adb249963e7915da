"""The bulk build's candidate scan against its roofline: the least time
the exhaustive all-pairs scan of the corpus could take on the card
(peaks.py) over the seconds of the build's `scan` mark (graph/build.py
`last_profile`, part B).  It counts the exhaustive scan, whatever kernel
does it."""

from h100_bench import peaks
from h100_bench.metrics._read import total


def read(run):
    builds = run.part("B")
    scan = total(run, "build.scan")
    if run.platform != "gpu" or not builds or scan <= 0:
        return None
    least = peaks.all_pairs_scan_s(int(run.config["rows"]), int(run.config["dimension"]))
    return 100.0 * least * len(builds) / scan
