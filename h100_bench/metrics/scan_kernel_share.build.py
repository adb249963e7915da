"""Share of the build's scan phase taken by the window-scan kernel K1:
the device seconds of the tracer's `k1` spans (ops/window_scan.py, one per
launch) over those of the build's `build.scan` mark (graph/build.py),
part B.  The rest of the phase is the torch code around the kernel."""

from h100_bench.metrics._trace import ratio


def read(run):
    return ratio(run, "k1", "build.scan", 100.0)
