"""Milliseconds per traversal step of the one-query requests: the
`traverse` stage over `graph_search.steps` (part B)."""

from h100_bench.metrics._read import ms_per_step


def read(run):
    return ms_per_step(run)
