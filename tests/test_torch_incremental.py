"""The port's incremental build and appends (ngt_tpu_torch/graph/build.py:
``build_anng``, the append route of ``build_bulk``) against the JAX package
on the same numpy inputs, on the CPU: adjacency ids equal on >= 99.9% of
entries, their distances to fp32 rounding (rtol 1e-5), and exact-route
search ids equal.

Covered: ``build_algorithm="anng"`` for ANNG, KNNG, BKNNG and IANNG, with
``truncation_threshold`` (drop and relink) and with ``build_mode="sq8"``;
the auto routing of a small append to ``build_anng`` and of a large one to
the bulk append; the bulk append in chunks (NGT_TPU_BULK_QBLOCK), whose
reverse edges across chunks must survive.
"""

import numpy as np
import pytest

import ngt_tpu
import ngt_tpu_torch
from ngt_tpu_torch.graph import build as TB

DIM = 16
N_BASE = 700


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(31)
    centers = rng.standard_normal((12, DIM)) * 1.5
    x = centers[rng.integers(0, 12, 1400)] + rng.standard_normal((1400, DIM))
    return x.astype(np.float32)


def assert_same_graph(t, j, queries):
    """Adjacency ids on >= 99.9% of entries, distances of equal entries to
    rtol 1e-5, and exact-route search ids equal."""
    m = j.store.repository_size
    assert t.store.repository_size == m
    ti, ji = t.graph.nbr_ids[:m], np.asarray(j.graph.nbr_ids[:m])
    same = ti == ji
    assert same.mean() >= 0.999, same.mean()
    td, jd = t.graph.nbr_dist[:m], np.asarray(j.graph.nbr_dist[:m])
    np.testing.assert_allclose(td[same], jd[same], rtol=1e-5)
    np.testing.assert_array_equal(t.graph._has_node[:m], j.graph._has_node[:m])
    assert t.verify() == []
    t.prop.search_mode = j.prop.search_mode = "exact"
    np.testing.assert_array_equal(t.batch_search(queries, size=10)[0],
                                  np.asarray(j.batch_search(queries, size=10)[0]))


@pytest.mark.parametrize("props", [
    {"graph_type": 1},                          # ANNG
    {"graph_type": 2},                          # KNNG: exact candidates, no reverse
    {"graph_type": 4},                          # BKNNG: exact candidates + reverse
    {"graph_type": 3},                          # IANNG: mutual-k pruning
    {"truncation_threshold": 6},                # drop + relink
    {"build_mode": "sq8"},                      # int8 block traversal + re-rank
], ids=["anng", "knng", "bknng", "ianng", "truncation", "sq8"])
def test_anng_build_matches_jax(data, props):
    """A fresh index built incrementally: the exact bootstrap of the first
    batch of 256, then batches that search the growing graph."""
    kw = dict(build_algorithm="anng", device_batch_size=256, **props)
    j = ngt_tpu.create(None, dimension=DIM, **kw)
    t = ngt_tpu_torch.create(None, dimension=DIM, device="cpu", **kw)
    for idx in (j, t):
        idx.batch_insert(data[:600], build=True)
    np.testing.assert_array_equal(t.seeder.rep_ids, j.seeder.rep_ids)
    assert len(TB.last_batches) == 2                # 600 = 256 bootstrap + 2 batches
    assert_same_graph(t, j, data[1300:1400])


@pytest.fixture(scope="module")
def base_dir(data, tmp_path_factory):
    """A bulk-built reference index of N_BASE rows, saved: each test opens
    it in both packages, so both start from one graph and fresh seed
    streams."""
    path = str(tmp_path_factory.mktemp("base") / "idx")
    j = ngt_tpu.create(path, dimension=DIM, device_batch_size=256)
    j.batch_insert(data[:N_BASE], build=True)
    j.save()
    return path


def _open_both(path):
    return ngt_tpu.open_index(path), ngt_tpu_torch.open_index(path, device="cpu")


def test_append_routing_matches_jax(data, base_dir, monkeypatch):
    """Auto routing: 150 rows (< bulk_append_threshold) go through
    build_anng, then 260 rows (>= a threshold of 200) through the bulk
    append; the graphs equal the reference's after each."""
    j, t = _open_both(base_dir)
    calls = []
    for name in ("build_anng", "build_bulk"):
        real = getattr(ngt_tpu_torch.index, name)
        monkeypatch.setattr(ngt_tpu_torch.index, name,
                            lambda *a, _r=real, _n=name, **k: calls.append(_n) or _r(*a, **k))
    for idx in (j, t):
        idx.batch_insert(data[N_BASE : N_BASE + 150], build=True)
    assert calls == ["build_anng"]
    assert_same_graph(t, j, data[1300:1400])
    for idx in (j, t):
        idx.prop.bulk_append_threshold = 200
        idx.batch_insert(data[N_BASE + 150 : N_BASE + 410], build=True)
    assert calls == ["build_anng", "build_bulk"]
    assert_same_graph(t, j, data[1300:1400])


def test_bulk_append_keeps_cross_chunk_reverse_edges(data, base_dir, monkeypatch):
    """NGT_TPU_BULK_QBLOCK=64 scans a 300-row append in 5 chunks: the graph
    equals the reference's in the same chunking AND the port's own
    one-chunk append, so no reverse edge between chunks was lost."""
    rows = data[N_BASE : N_BASE + 300]
    whole = ngt_tpu_torch.open_index(base_dir, device="cpu")
    whole.prop.build_algorithm = "bulk"
    whole.batch_insert(rows, build=True)
    monkeypatch.setenv("NGT_TPU_BULK_QBLOCK", "64")
    j, t = _open_both(base_dir)
    for idx in (j, t):
        idx.prop.build_algorithm = "bulk"
        idx.batch_insert(rows, build=True)
    assert_same_graph(t, j, data[1300:1400])
    m = t.store.repository_size
    np.testing.assert_array_equal(t.graph.nbr_ids[:m], whole.graph.nbr_ids[:m])
    # new rows link to each other across chunk borders (row 0 -> row 200)
    new = np.arange(N_BASE + 1, N_BASE + 301)
    nb = t.graph.nbr_ids[new]
    src_chunk = (new - N_BASE - 1) // 64
    tgt_chunk = np.where(nb > N_BASE, (nb - N_BASE - 1) // 64, -1)
    assert ((tgt_chunk >= 0) & (tgt_chunk != src_chunk[:, None])).any()
