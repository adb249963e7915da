"""Milliseconds per query of the qg stages around the traversal: seeds,
exact re-rank and edge-tail refine (quant/qgraph.py stage timer, part B)."""

from h100_bench.metrics._read import ms_per_query


def read(run):
    return ms_per_query(run, ("seeds", "rerank", "refine"))
