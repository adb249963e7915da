"""Share of the traversal's query slots that still had work: the queries'
own steps (each counted while it was not yet done) over each chunk's
steps times its real rows (the tracer's `traverse.query_steps` and
`traverse.slot_steps`, quant/qgraph.py, part B).  A chunk steps until its
slowest query is done; the rest of the slots step idle."""

from h100_bench.metrics._trace import ratio


def read(run):
    return ratio(run, "traverse.query_steps", "traverse.slot_steps", 100.0)
