"""Host milliseconds per traversal step of the one-query requests spent
issuing the step's work: the tracer's `traverse.launch` over
`traverse.steps` (graph/search.py, part B)."""

from h100_bench.metrics._trace import ratio


def read(run):
    return ratio(run, "traverse.launch", "traverse.steps", 1e3)
