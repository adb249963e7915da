"""Traversal loop steps per one-query request (graph/search.py
`graph_search.steps`, part B)."""

from h100_bench.metrics._read import steps_per_request


def read(run):
    return steps_per_request(run)
