"""``correct`` comes out false when the timed path is broken underneath:
the harness's look for a card is skipped and the rest of a run is driven
on the CPU at a few thousand rows, once sound and once with each fault a
cell of one card can have (a traversal or build step that leaves its state
as it found it, half of a batch left out, an answer altered where it is
produced).  No cell crosses cards, so no exchange can be left out, and a
one-query request has no half to leave out.

A traversal that stops stepping keeps exact distances: the search cells
catch it by ``recall_gap``.  The test marked ``gpu`` reads it at each
search cell's own size, on three seeds, where it sets the upper reading of
the glove cells' ``recall_gap`` limits."""

import io
import time

import numpy as np
import pytest

from h100_bench import harness
from h100_bench.tests.util import ROOT, run_cpu


def _search_step_unchanged(mp):
    from ngt_tpu_torch.quant import qgraph

    orig = qgraph.graph_search
    mp.setattr(qgraph, "graph_search", lambda *a, **kw: orig(*a, **dict(kw, max_iters=1)))


def _search_half_left_out(mp):
    from ngt_tpu_torch.quant.qgraph import QuantizedGraphIndex

    orig = QuantizedGraphIndex.batch_search

    def half(self, queries, *a, **kw):
        h = max(len(queries) // 2, 1)
        ids, dists = orig(self, queries[:h], *a, **kw)
        rep = np.arange(len(queries)) % h      # the other half gets answers not its own
        return ids[rep], dists[rep]

    mp.setattr(QuantizedGraphIndex, "batch_search", half)


def _search_answer_altered(mp):
    from ngt_tpu_torch.quant.qgraph import QuantizedGraphIndex

    orig = QuantizedGraphIndex.batch_search

    def altered(self, *a, **kw):
        ids, dists = orig(self, *a, **kw)
        ids = ids.copy()
        ids[:, 0] = (ids[:, 0] + 1) % self.index.store.repository_size
        return ids, dists

    mp.setattr(QuantizedGraphIndex, "batch_search", altered)


def _build_step_unchanged(mp):
    from ngt_tpu_torch.index import Index

    orig = Index.build_index

    def unchanged(self, num_threads=0):
        orig(self)
        n = self.store.repository_size
        self.graph.nbr_ids[1:n] = -1      # every row as the build found it: empty
        self.graph.nbr_dist[1:n] = np.inf

    mp.setattr(Index, "build_index", unchanged)


def _build_half_left_out(mp):
    from ngt_tpu_torch import index

    orig = index.build_bulk
    mp.setattr(index, "build_bulk", lambda store, graph, seeder, prop, pending, mirror:
               orig(store, graph, seeder, prop, pending[: len(pending) // 2], mirror))


def _build_answer_altered(mp):
    from ngt_tpu_torch.index import Index

    orig = Index.build_index

    def altered(self, num_threads=0):
        orig(self)
        n = self.store.repository_size
        ids = self.graph.nbr_ids
        ids[1:n, 0] = ids[1:n, 0] % (n - 1) + 1

    mp.setattr(Index, "build_index", altered)


FAULTS = {
    "sift-128-euclidean.batch": [_search_step_unchanged, _search_half_left_out,
                                 _search_answer_altered],
    "glove-100-angular.online": [_search_step_unchanged, _search_answer_altered],
    "glove-100-angular.batch": [_search_step_unchanged, _search_half_left_out,
                                _search_answer_altered],
    "sift-128-euclidean.build": [_build_step_unchanged, _build_half_left_out,
                                 _build_answer_altered],
}


@pytest.mark.parametrize("workload", sorted(FAULTS))
def test_sound_run_is_correct(tiny_root, workload):
    res = run_cpu(tiny_root, workload, seconds=0.5)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1


@pytest.mark.parametrize("workload,fault", [(w, f) for w, fs in sorted(FAULTS.items())
                                            for f in fs],
                         ids=lambda x: x if isinstance(x, str) else x.__name__.strip("_"))
def test_fault_reads_incorrect(tiny_root, monkeypatch, workload, fault):
    fault(monkeypatch)
    res = run_cpu(tiny_root, workload, seconds=0.5)
    assert not res["correct"], res["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w for w, fs in sorted(FAULTS.items())
                                      if _search_step_unchanged in fs])
def test_stalled_traversal_reads_incorrect_on_the_card(cuda, monkeypatch, workload):
    """At the cell's own size and load, as many answers as a run judges: a
    one-query cell's thousand requests, a batch cell's pass over every
    query; every seed's checks print on standard error."""
    bench = harness.Bench(ROOT)
    per = bench.traffic(bench.cell(workload)["traffic"]).get("queries_per_request")
    _search_step_unchanged(monkeypatch)
    results = [harness.run(ROOT, workload, seed, 1e9, False, [cuda], time.perf_counter(),
                           out=io.StringIO(), max_requests={1: 1000}.get(per, 1))
               for seed in (2**31 + 41, 2**31 + 42, 2**31 + 43)]
    assert not any(r["correct"] for r in results), [r["checks"] for r in results]
