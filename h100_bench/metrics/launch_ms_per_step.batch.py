"""Host milliseconds per traversal step spent issuing the step's work:
the tracer's `traverse.launch` (graph/search.py: from the end of one done
check to the start of the next) over `traverse.steps` (part B)."""

from h100_bench.metrics._trace import ratio


def read(run):
    return ratio(run, "traverse.launch", "traverse.steps", 1e3)
