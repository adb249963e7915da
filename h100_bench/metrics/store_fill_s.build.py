"""Host seconds per build of the store fill: the tracer's `store.fill`
span (store.py `VectorStore.batch_insert`: the rows' preparation and their
write into the store, before the bulk build starts), over part B's
builds."""

from h100_bench.metrics._trace import total


def read(run):
    sec = total(run, "store.fill")
    return sec / len(run.part("B")) if sec is not None else None
