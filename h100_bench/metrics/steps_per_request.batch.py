"""Traversal loop steps per request (graph/search.py `graph_search.steps`,
part B): a chunk steps until its slowest query is done."""

from h100_bench.metrics._read import steps_per_request


def read(run):
    return steps_per_request(run)
