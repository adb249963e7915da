"""The sharded sq8 route of the BIGANN deployment (four shards, one per
card) on the CPU, against the benchmark's plain reference
(``h100_bench/reference.py``): 4,096 uint8 rows x 128 of the benchmark's
own generator as four round-robin shards.

* each shard's exact top-10, merged by ``_merge_topk``, is the exact
  top-10 over the whole corpus, and the merge breaks ties to the lower
  position;
* ``ShardedQG`` over ``ShardedIndex.build(..., object_type=UINT8)`` keeps
  the reference's distances and its recall@10;
* the fan-out over devices, one host thread a device, gives the serial
  loop's answers bit for bit;
* spans recorded from several threads keep their own parents and call ids,
  and the fan-out's shard spans sit under its ``shard.fanout`` span;
* the graph cache's caps count per card.

This file imports neither JAX nor the JAX package."""

import collections
import sys
import threading

import numpy as np
import pytest
import torch

from h100_bench.gen import bigann_proxy
from h100_bench.reference import ExactSearch, distance_gaps, hits
from ngt_tpu_torch import trace
from ngt_tpu_torch.graph import search as TS
from ngt_tpu_torch.parallel import sharding as T
from ngt_tpu_torch.properties import DistanceType, ObjectType

P, N, NQ, K = 4, 4096, 16, 10
#: the BIGANN configuration's generator (h100_bench/configs/bigann-10m.json)
GEN = dict(clusters=2048, spectrum=-0.4, zipf=1.05, center_scale=0.9, noise_scale=0.45,
           dimension=128)
#: recall@10 floor at this size: 1,024 rows a shard, every one a seed
RECALL_FLOOR = 0.99


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _tracer_off(monkeypatch):
    monkeypatch.delenv(trace.SEARCH, raising=False)
    trace.clear()
    yield
    trace.clear()


@pytest.fixture(scope="module")
def corpus():
    base, queries = bigann_proxy.make(GEN, N, NQ, 2**31 + 19, torch.device("cpu"))
    return base.astype(np.uint8), queries.astype(np.uint8)


@pytest.fixture(scope="module")
def sharded(corpus):
    base, _ = corpus
    mesh = T.make_mesh(P, device="cpu")
    sidx = T.ShardedIndex.build(base, mesh=mesh, metric=DistanceType.L2,
                                object_type=ObjectType.UINT8)
    return sidx, T.ShardedQG.from_sharded_index(sidx)


def _threads_per_shard(monkeypatch):
    """Each CPU shard in a host thread of its own, as shards on four cards
    run; returns the set the searches' thread ids land in."""
    monkeypatch.setattr(T, "_device_groups", lambda mesh: [[j] for j in
                                                           range(len(mesh.local_shards))])
    seen = set()
    search = T.graph_search

    def recorded(*a, **kw):
        seen.add(threading.get_ident())
        return search(*a, **kw)

    monkeypatch.setattr(T, "graph_search", recorded)
    return seen


def test_build_stores_uint8_rows(corpus, sharded):
    base, _ = corpus
    sidx, _ = sharded
    parts = sidx._sharded.x.parts
    assert all(p.dtype == torch.uint8 for p in parts)
    slots = np.nonzero(sidx.id_map >= 0)[0]
    np.testing.assert_array_equal(sidx._sharded.x.numpy()[slots], base[sidx.id_map[slots]])
    float_idx = T.ShardedIndex.build(base[:256].astype(np.float32),
                                     mesh=T.make_mesh(2, device="cpu"))
    assert float_idx._sharded.x.parts[0].dtype == torch.float32


def test_merged_shard_top10_is_the_exact_top10(corpus):
    base, queries = corpus
    mesh = T.make_mesh(P, device="cpu")
    n_local = N // P
    dists, gids = [], []
    for s in range(P):
        rows = base[s::P].astype(np.float64)
        d = np.sqrt(((queries[:, None, :].astype(np.float64) - rows[None]) ** 2).sum(-1))
        local = np.argsort(d, axis=1, kind="stable")[:, :K]
        dists.append(torch.from_numpy(np.take_along_axis(d, local, 1).astype(np.float32)))
        gids.append(T._global_ids(torch.from_numpy(local), s, n_local))
    got_i, got_d = T._merge_topk(mesh, dists, gids, K)
    slot = got_i.numpy()
    got_i, got_d = (slot % n_local) * P + slot // n_local, got_d.numpy()

    ref = ExactSearch(base, "L2", torch.device("cpu"))
    want_i, want_d = ref.topk(queries, K + 1)
    # the distances, as float32, are the reference's; each id is at its own
    # distance, once; where no tie crosses the 10th place, the ids are the
    # reference's, and where no two distances tie, in its order
    np.testing.assert_array_equal(got_d, want_d[:, :K].astype(np.float32))
    # (float32 rounding of the float64 distance: at most 2^-24 of it)
    assert distance_gaps(queries, base, got_i, got_d, "L2").max() <= 2.0 ** -24
    clear = want_d[:, K - 1] < want_d[:, K]
    assert clear.mean() > 0.5
    assert (hits(got_i[clear], want_i[clear, :K]) == K).all()
    distinct = clear & (np.diff(want_d[:, :K], axis=1) > 0).all(1)
    np.testing.assert_array_equal(got_i[distinct], want_i[distinct, :K])

    # ties go to the lower position of the flattened [P, k] lists
    tie_d = [torch.tensor([[1.0, 2.0]]), torch.tensor([[1.0, 2.0]])]
    tie_i = [torch.tensor([[5, 7]]), torch.tensor([[1, 3]])]
    ti, td = T._merge_topk(T.make_mesh(2, device="cpu"), tie_d, tie_i, 3)
    assert ti.tolist() == [[5, 1, 7]] and td.tolist() == [[1.0, 1.0, 2.0]]


@pytest.fixture(scope="module")
def serial(corpus, sharded):
    """The sq8 answers of the shards searched in turn."""
    _, queries = corpus
    return sharded[1].search(torch.from_numpy(queries.astype(np.float32)), k=K, epsilon=0.1)


def _bit_equal(got, want):
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(got[1].numpy().view(np.int32), want[1].numpy().view(np.int32))


def test_sharded_qg_keeps_the_references_distances_and_recall(corpus, sharded, serial):
    base, queries = corpus
    sidx, _ = sharded
    ids, dists = serial
    ids = sidx.id_map[ids.numpy()]
    exact = ExactSearch(base, "L2", torch.device("cpu")).topk(queries, K)[0]
    assert hits(ids, exact).sum() / exact.size >= RECALL_FLOOR
    assert distance_gaps(queries, base, ids, dists.numpy(), "L2").max() <= 1e-4


def test_fan_out_gives_the_serial_answers_bit_for_bit(corpus, sharded, serial, monkeypatch):
    _, queries = corpus
    seen = _threads_per_shard(monkeypatch)
    fanned = sharded[1].search(torch.from_numpy(queries.astype(np.float32)), k=K, epsilon=0.1)
    assert len(seen) == P and threading.get_ident() not in seen
    _bit_equal(fanned, serial)


def test_chunked_fan_out_and_its_spans(corpus, sharded, serial, monkeypatch):
    """Chunks of 10 queries (the last padded), fanned out and traced: the
    serial answers, and per shard one traverse and one rerank span a
    chunk and one steps counter, all under the call's ``shard.fanout``."""
    _, queries = corpus
    _, qg = sharded
    _threads_per_shard(monkeypatch)
    monkeypatch.setattr(T, "QG_QUERY_CHUNK", 10)
    monkeypatch.setenv(trace.SEARCH, "1")
    got = qg.search(torch.from_numpy(queries.astype(np.float32)), k=K, epsilon=0.1)
    _bit_equal(got, serial)
    recs = trace.records()
    fanout = [r for r in recs if r.name == "shard.fanout"]
    assert len(fanout) == 1 and fanout[0].parent is None and fanout[0].call > 0
    assert all(r.call == fanout[0].call for r in recs)
    for s in range(P):
        trav = [r for r in recs if r.name == f"shard{s}.traverse"]
        rerank = [r for r in recs if r.name == f"shard{s}.rerank"]
        steps = [r for r in recs if r.name == f"shard{s}.steps"]
        assert len(trav) == len(rerank) == 2 and len(steps) == 1
        assert {r.parent for r in trav + rerank + steps} == {"shard.fanout"}
        own = [r for r in recs if r.name == "traverse.steps"
               and r.parent == f"shard{s}.traverse" and trav[0].t0 <= r.t0 <= trav[-1].t1]
        assert len(own) == 2 and steps[0].value == sum(r.value for r in own) > 0
    merge = [r for r in recs if r.name == "shard.merge"]
    assert len(merge) == 1 and merge[0].parent is None and merge[0].t0 >= fanout[0].t1


def test_spans_from_threads_keep_their_parents_and_call_ids(monkeypatch):
    """Public calls in 16 threads at once, with a short switch interval:
    each call's records carry its own id and the spans open in its own
    thread as parents, and the buffer loses none."""
    monkeypatch.setenv(trace.SEARCH, "1")
    n_threads, rounds = 16, 20

    @trace.public
    def call(tag):
        with trace.span(f"outer{tag}", trace.SEARCH):
            for i in range(3):
                with trace.span(f"inner{tag}", trace.SEARCH):
                    trace.add(f"count{tag}", i)
        return trace.carry()[1]

    ids = collections.defaultdict(list)
    start = threading.Barrier(n_threads)

    def worker(tag):
        start.wait()
        for _ in range(rounds):
            ids[tag].append(call(tag))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    recs = trace.records()
    assert len(recs) == n_threads * rounds * 7 and trace.dropped == 0
    all_ids = [c for v in ids.values() for c in v]
    assert len(set(all_ids)) == len(all_ids) == n_threads * rounds
    for tag, calls in ids.items():
        mine = [r for r in recs if r.call in set(calls)]
        assert len(mine) == rounds * 7
        assert {(r.name, r.parent) for r in mine} == {
            (f"outer{tag}", None), (f"inner{tag}", f"outer{tag}"),
            (f"count{tag}", f"inner{tag}")}


def test_graph_cache_caps_count_per_card(monkeypatch):
    """One card's loops past its caps drop only that card's oldest."""

    class Loop:
        def __init__(self, nbytes):
            self.nbytes = nbytes

    monkeypatch.setattr(TS, "_GRAPHS", collections.OrderedDict())
    TS._keep(("cuda:1", "a"), Loop(TS.GRAPH_CACHE_BYTES // 2))
    for j in range(TS.GRAPH_CACHE + 2):
        TS._keep(("cuda:0", j), Loop(1))
    TS._keep(("cuda:0", "big"), Loop(TS.GRAPH_CACHE_BYTES))
    TS._keep(("cuda:1", "b"), Loop(TS.GRAPH_CACHE_BYTES // 2))
    assert list(TS._GRAPHS) == [("cuda:1", "a"), ("cuda:0", "big"), ("cuda:1", "b")]
    assert TS._card_lock("cuda:0") is TS._card_lock("cuda:0")
    assert TS._card_lock("cuda:0") is not TS._card_lock("cuda:1")
