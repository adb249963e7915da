"""Milliseconds per one-query request outside the qg stages: its wall
time less its seeds, traverse, re-rank and refine stages (part B); padding,
query preparation, the host copies and the entry points' own work."""

from h100_bench.metrics._read import call_overhead_ms


def read(run):
    return call_overhead_ms(run)
