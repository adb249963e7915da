"""Milliseconds per traversal step: the `traverse` stage over
`graph_search.steps` (part B)."""

from h100_bench.metrics._read import ms_per_step


def read(run):
    return ms_per_step(run)
