"""Every metric and object type through the port's Index
(ngt_tpu_torch/index.py) on the CPU.

* Each of the twelve metrics (uint8 rows for Hamming and Jaccard, id sets
  for sparse Jaccard, Poincare and Lorentz rows made as
  tests/test_hyperbolic.py makes them) and an L2 index of BFLOAT16
  objects builds and searches, and the graph route finds what the exact
  linear search finds.
* Against the JAX package: create -> batch_insert(build=True) ->
  batch_search on the exact route and batch_linear_search for Cosine
  (un-normalized rows, the angular fast path), Normalized Angle, Hamming
  on uint8, sparse Jaccard and BFLOAT16 objects, each index carried into
  the other package through convert.py and through save/open; the
  quantized-graph route of Cosine and Angle (codes built from
  row-normalized rows, normalized traversal queries); and the tied last
  edges of an integral corpus pinned as they stand.  (The module-level
  functions of every metric are held against the JAX package in
  tests/test_torch_distances.py.)

Tolerances (as tests/test_torch_distances.py states them): distances to
rtol 1e-5, Angle / Normalized Angle compared as cos(d) and Poincare /
Lorentz as cosh(d); ids equal except where the two distances lie within
1e-5 relative of each other (such entries are counted).  The adjacency is
compared exactly.  The sq8 scale is held to 1e-6 relative and the codes
to >= 99.99% equal entries, never more than 1 apart: the row norms are
summed in another order than XLA's.
"""

from types import SimpleNamespace

import numpy as np
import pytest

import ngt_tpu
import ngt_tpu_torch
from ngt_tpu.properties import GraphType as JGraphType
from ngt_tpu_torch import convert
from ngt_tpu_torch.properties import DistanceType as DT
from ngt_tpu_torch.properties import GraphType as TGraphType
from ngt_tpu_torch.quant.qgraph import QuantizedGraphIndex as TQ
from test_torch_distances import assert_dist_close, assert_ids_match

N, NQ, DIM = 250, 30, 24

#: (metric name, object type): every metric, and BFLOAT16 objects under L2
CONFIGS = [
    ("L1", "Float"), ("L2", "Float"), ("Hamming", "Byte"), ("Angle", "Float"),
    ("Cosine", "Float"), ("Normalized Angle", "Float"), ("Normalized Cosine", "Float"),
    ("Jaccard", "Byte"), ("Sparse Jaccard", "Float"), ("Normalized L2", "Float"),
    ("Poincare", "Float"), ("Lorentz", "Float"), ("L2", "bfloat16"),
]
#: the configurations also built by the JAX package (its cold compiles
#: cost seconds each on the CPU)
JAX_CONFIGS = [
    ("Cosine", "Float"), ("Normalized Angle", "Float"), ("Hamming", "Byte"),
    ("Sparse Jaccard", "Float"), ("L2", "bfloat16"),
]


def _poincare_corpus(rng, n, d):
    """Clustered points in the open unit ball, members jittered toward the
    boundary and clamped at radius 0.85 (tests/test_hyperbolic.py)."""
    centers = rng.normal(size=(16, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True) * 2.0
    x = centers[rng.integers(0, 16, size=n)] + rng.normal(size=(n, d)) * 0.08
    norm = np.linalg.norm(x, axis=1, keepdims=True)
    return np.where(norm > 0.85, x * (0.85 / norm), x).astype(np.float32)


def _lorentz_corpus(rng, n, d):
    """Points on the hyperboloid x0 = sqrt(1 + |x|^2)
    (tests/test_hyperbolic.py)."""
    centers = rng.normal(size=(16, d - 1)) * 0.6
    sp = centers[rng.integers(0, 16, size=n)] + rng.normal(size=(n, d - 1)) * 0.15
    x0 = np.sqrt(1.0 + (sp**2).sum(axis=1, keepdims=True))
    return np.concatenate([x0, sp], axis=1).astype(np.float32)


def corpus(metric: str, rng, n: int) -> np.ndarray:
    if metric in ("Hamming", "Jaccard"):
        return rng.integers(0, 256, (n, DIM)).astype(np.uint8)
    if metric == "Sparse Jaccard":
        return ngt_tpu_torch.store.pad_sparse(
            [rng.choice(4 * DIM, rng.integers(1, DIM // 2), replace=False) for _ in range(n)],
            DIM)
    if metric == "Poincare":
        return _poincare_corpus(rng, n, DIM)
    if metric == "Lorentz":
        return _lorentz_corpus(rng, n, DIM)
    # un-normalized rows with log-normal norms (the Normalized* stores
    # normalize at insert)
    return (rng.normal(size=(n, DIM)) * rng.lognormal(0.0, 0.35, (n, 1))).astype(np.float32)


@pytest.mark.parametrize("metric,otype", CONFIGS, ids=[f"{m}-{o}" for m, o in CONFIGS])
def test_every_metric_builds_and_searches(metric, otype):
    """create takes the metric and the object type, builds, and its graph
    route finds the exact linear search's neighbors."""
    rng = np.random.default_rng(sum(map(ord, metric + otype)) + 1)
    x = corpus(metric, rng, N + NQ)
    t = ngt_tpu_torch.create(None, dimension=DIM, distance_type=metric, object_type=otype,
                             search_mode="exact", device="cpu")
    t.batch_insert(x[:N], build=True)
    assert t.verify() == []
    assert t.graph.degree[1 : N + 1].min() >= t.prop.edge_size_for_creation
    gi, _ = t.batch_search(x[N:], size=10, epsilon=0.1)
    li, ld = t.batch_linear_search(x[N:], size=10)
    hits = sum(len(set(a) & set(b)) for a, b in zip(gi.tolist(), li.tolist()))
    assert hits >= 0.95 * li.size, hits
    assert np.isfinite(ld).all()
    assert t.search(x[5], size=3)[0][0] == 5


@pytest.fixture(scope="module", params=JAX_CONFIGS, ids=[f"{m}-{o}" for m, o in JAX_CONFIGS])
def built(request):
    metric, otype = request.param
    rng = np.random.default_rng(sum(map(ord, metric + otype)))
    x = corpus(metric, rng, N + NQ)
    j = ngt_tpu.create(None, dimension=DIM, distance_type=metric, object_type=otype,
                       search_mode="exact")
    j.batch_insert(x[:N], build=True)
    t = ngt_tpu_torch.create(None, dimension=DIM, distance_type=metric, object_type=otype,
                             search_mode="exact", device="cpu")
    t.batch_insert(x[:N], build=True)
    return SimpleNamespace(metric=DT(int(t.prop.distance_type)), base=x[:N], q=x[N:],
                           j=j, t=t)


def _same_search(metric, t, j, q):
    ti, td = t.batch_search(q, size=10)
    ji, jd = j.batch_search(q, size=10)
    assert_dist_close(metric, td, jd)
    assert_ids_match(ti, td, ji, jd)
    return ti


def test_build_and_search_match_jax(built):
    """The same graph (exact k-NN + reverse edges + bridges), the same
    seeds, and the same exact-route and linear-search results."""
    t, j, m = built.t, built.j, built.metric
    np.testing.assert_array_equal(t.graph.nbr_ids[: N + 1], j.graph.nbr_ids[: N + 1])
    assert_dist_close(m, np.where(np.isinf(t.graph.nbr_dist[: N + 1]), 0, t.graph.nbr_dist[: N + 1]),
                      np.where(np.isinf(j.graph.nbr_dist[: N + 1]), 0, j.graph.nbr_dist[: N + 1]))
    np.testing.assert_array_equal(t.seeder.rep_ids, j.seeder.rep_ids)
    assert t.verify() == []
    assert str(t._mirror.x.dtype).split(".")[-1] == str(j._mirror.x.dtype)
    assert (t._mirror.sqnorm is None) == (j._mirror.sqnorm is None)
    _same_search(m, t, j, built.q)
    ti, td = t.batch_linear_search(built.q, size=10)
    ji, jd = j.batch_linear_search(built.q, size=10)
    assert_dist_close(m, td, jd)
    assert_ids_match(ti, td, ji, jd)
    # a stored row finds itself first on both routes
    assert t.search(built.base[17], size=3)[0][0] == 17
    assert t.linear_search(built.base[17], size=3)[0][0] == 17


def test_index_crosses_packages(built, tmp_path):
    """convert.py both ways, and save/open across packages: the store's
    dtype, the seeds' squared norms, the graph and the results carry (the
    port's save is read back by the JAX package array for array)."""
    t, j, m = built.t, built.j, built.metric
    st = j.store.state_dict()
    gs = j.graph.state_dict(j.store.repository_size)
    from_j = convert.from_ngt_tpu_arrays(
        objects=st["x"], valid=st["valid"], free=st["free"], nbr_ids=gs["nbr_ids"],
        nbr_dist=gs["nbr_dist"], degree=gs["degree"], has_node=gs["has_node"],
        rep_ids=j.seeder.rep_ids, rep_sq=np.asarray(j.seeder._rep_sq),
        prop_dict=dict(vars(j.prop)), device="cpu")
    assert from_j.store._x.dtype == st["x"].dtype
    ti = _same_search(m, from_j, j, built.q)
    back = convert.to_numpy_state(t)
    assert back["objects"].dtype == t.store._x.dtype
    np.testing.assert_allclose(back["rep_sq"], np.asarray(j.seeder._rep_sq), rtol=1e-6)
    _same_search(m, convert.from_ngt_tpu_arrays(device="cpu", **back), j, built.q)

    path = str(tmp_path / "port")
    t.save(path)
    j2 = ngt_tpu.open_index(path)
    assert int(j2.prop.object_type) == int(t.prop.object_type)
    assert int(j2.prop.distance_type) == int(t.prop.distance_type)
    np.testing.assert_array_equal(j2.store._x, t.store._x[: N + 1])
    np.testing.assert_array_equal(j2.graph.nbr_ids[: N + 1], t.graph.nbr_ids[: N + 1])
    np.testing.assert_array_equal(j2.seeder.rep_ids, t.seeder.rep_ids)
    jpath = str(tmp_path / "jax")
    j.save(jpath)
    t2 = ngt_tpu_torch.open_index(jpath, device="cpu")
    assert t2.store._x.dtype == j.store._x.dtype and t2.verify() == []
    np.testing.assert_array_equal(t2.batch_search(built.q, size=10)[0], ti)


@pytest.mark.parametrize("which", ["Cosine", "Angle"])
def test_qg_route_angular_matches_jax(which, monkeypatch):
    """search_mode="qg" on the plain angular metrics: sq8 codes of the
    row-normalized rows (the scale to 1e-6 relative, the codes on >= 99.99%
    of entries and never more than 1 apart), normalized traversal queries,
    the exact re-rank on the raw rows; 16-edge blocks below e_max = 64, so
    the tail refine engages.  Then the reference's codes carried into the
    port: equal ids."""
    rng = np.random.default_rng(sum(map(ord, which + "Float")))
    x = corpus(which, rng, N + NQ)
    # 16 columns of the 1024-row capacity's 128-byte codes
    monkeypatch.setenv("NGT_TPU_QG_BLOCK_GB", "0.002")
    j = ngt_tpu.create(None, dimension=DIM, distance_type=which, search_mode="qg")
    j.batch_insert(x[:N], build=True)
    t = ngt_tpu_torch.create(None, dimension=DIM, distance_type=which, search_mode="qg",
                             device="cpu")
    t.batch_insert(x[:N], build=True)
    ti, td = t.batch_search(x[N:], size=10)
    ji, jd = j.batch_search(x[N:], size=10)
    tq, jq = t._qg, j._qg
    assert tq.mode == jq.mode == "sq8"
    assert tq._dev_blocks()[1].shape[1] == 16 and tq._resolve_refine(64, 16) == 48
    assert abs(tq.sq_scale - jq.sq_scale) <= 1e-6 * jq.sq_scale
    tc, jc = tq._host_codes()[: N + 1], jq._host_codes()[: N + 1]
    assert tc.dtype == jc.dtype == np.int8
    assert (tc == jc).mean() >= 0.9999
    assert np.abs(tc.astype(np.int16) - jc).max() <= 1
    assert_dist_close(DT(int(t.prop.distance_type)), td, jd)
    assert_ids_match(ti, td, ji, jd)
    # one graph and one set of codes: the traversal itself is compared
    port = convert.from_ngt_tpu_arrays(device="cpu", **convert.to_numpy_state(t))
    port._qg = convert.qg_from_ngt_tpu_state(port, "sq8", jq.sq_scale, jc)
    pi, pd = port._qg.batch_search(x[N:], size=10, epsilon=0.1)
    gi, gd = jq.batch_search(x[N:], size=10, epsilon=0.1)
    assert_ids_match(pi, pd, gi, gd)
    assert isinstance(port._qg, TQ)


def _edge_d2(x: np.ndarray, nbr: np.ndarray) -> np.ndarray:
    """Exact squared distances (integers) from each row to its edges; -1
    where there is no edge.  Row r of ``nbr`` holds the edges of object id
    r + 1 (1-based ids; row 0 of ``x`` is id 1)."""
    xf = np.concatenate([np.zeros((1, x.shape[1])), x.astype(np.float64)])
    safe = np.clip(nbr, 0, len(xf) - 1)
    d2 = ((xf[safe] - xf[1:, None, :]) ** 2).sum(-1)
    return np.where(nbr >= 0, np.rint(d2), -1)


def test_tied_last_edges_pinned():
    """The open fault of the tied last edges (ROADMAP Queue 3): on an
    integral corpus two rows may lie at exactly the same distance at a
    row's last k-NN edge, and the two bulk builds keep different ones.
    Pinned on the k-NN rows themselves (graph_type KNNG: reverse edges and
    bridges would carry one choice into other rows): every row's sorted
    edge distances are equal between the packages (exact squared integers;
    the stored f32 values to rtol 1e-6, XLA's f32 sqrt may differ in the
    last bit), ids differ only among targets at the row's last distance,
    and no more rows differ than rows have such a tie."""
    n, d, k = 500, 16, 10
    data = np.random.default_rng(0).integers(0, 16, (n, d)).astype(np.float32)
    xf = data.astype(np.float64)
    sq = (xf * xf).sum(1)
    d2_all = np.sort(np.rint(sq[:, None] + sq[None, :] - 2.0 * xf @ xf.T), axis=1)
    tie_rows = int((d2_all[:, k] == d2_all[:, k + 1]).sum())   # self at column 0
    assert tie_rows > 0
    j = ngt_tpu.create(None, dimension=d, graph_type=JGraphType.KNNG)
    j.batch_insert(data, build=True)
    t = ngt_tpu_torch.create(None, dimension=d, graph_type=TGraphType.KNNG, device="cpu")
    t.batch_insert(data, build=True)
    ji, ti = j.graph.nbr_ids[1 : n + 1], t.graph.nbr_ids[1 : n + 1]
    jd2, td2 = _edge_d2(data, ji), _edge_d2(data, ti)
    np.testing.assert_array_equal(np.sort(td2, 1), np.sort(jd2, 1))
    jd, td = j.graph.nbr_dist[1 : n + 1], t.graph.nbr_dist[1 : n + 1]
    fin = np.isfinite(jd)
    np.testing.assert_array_equal(fin, np.isfinite(td))
    np.testing.assert_allclose(td[fin], jd[fin], rtol=1e-6)
    rows = np.nonzero((ji != ti).any(1))[0]
    for r in rows:
        last = jd2[r].max()
        for v in np.unique(jd2[r][jd2[r] >= 0]):
            if v != last:
                assert set(ji[r][jd2[r] == v]) == set(ti[r][td2[r] == v]), r
    assert 0 < len(rows) <= tie_rows
