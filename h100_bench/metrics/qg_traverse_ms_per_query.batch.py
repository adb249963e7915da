"""Milliseconds of the qg traversal stage per query (quant/qgraph.py
stage timer `traverse`, part B of the traced window)."""

from h100_bench.metrics._read import ms_per_query


def read(run):
    return ms_per_query(run, ("traverse",))
