"""The port's ONNG reconstruction (ngt_tpu_torch/graph/reconstruct.py and
the host library's constrained_reverse) against the JAX package's on the
same numpy inputs, on the CPU.  No float arithmetic happens in these
rewrites, so ids, degrees and distances must be equal (atol 0):

* every rewrite of an ANNG that the port's bulk build made: KNNG -> ANNG,
  the pseudo-ANNG thinning, the ONNG degree adjustment and its
  indegree-balanced variant in modes 'a' and 'c';
* ``_normalize_rows`` on both routes (``DEV_PAIRS_MIN`` lowered in both
  packages) over a graph whose two directions of an edge differ by an
  ulp, where the routes store different distances;
* shortcut detection (the packed candidate bits) and ``adjust_paths``
  under the host rule R(1), the device rule R(8) with e > 8, and one
  full-width window (NGT_TPU_ADJUST_SNAP=0), with the min_edges floor
  engaged; the window cap at a 1M-row estimate; no host replay;
* ``refine_anng`` on an index that both packages open from one save.
"""

import numpy as np
import pytest
import ref_native_build  # noqa: F401  (builds the reference's library under a lock)
import torch

import ngt_tpu
import ngt_tpu_torch
from ngt_tpu import native as JN
from ngt_tpu.graph import reconstruct as JR
from ngt_tpu.graph.storage import GraphStore as JG
from ngt_tpu_torch import native as TN
from ngt_tpu_torch.graph import reconstruct as TR
from ngt_tpu_torch.graph.storage import GraphStore as TG

N, DIM = 1200, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU search and rank loops run many small ops; beside the
    suite's other workers a multi-threaded intra-op pool only contends for
    the cores, several times slower than one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def anng():
    """(data, nbr, dist, deg, n) of an ANNG built by the port's bulk build
    (rows 0..n-1, row 0 the empty dummy slot)."""
    data = np.random.default_rng(5).normal(size=(N, DIM)).astype(np.float32)
    t = ngt_tpu_torch.create(None, dimension=DIM, edge_size_for_creation=16, device="cpu")
    t.batch_insert(data, build=True)
    n = t.store.repository_size
    return data, t.graph.nbr_ids[:n].copy(), t.graph.nbr_dist[:n].copy(), \
        t.graph.degree[:n].copy(), n


def _stores(nbr, dist, deg):
    """The same rows in a JAX-package and a port GraphStore."""
    out = []
    for cls in (JG, TG):
        g = cls(max_edges=nbr.shape[1], capacity=len(deg))
        g.nbr_ids[:] = nbr
        g.nbr_dist[:] = dist
        g.degree[:] = deg
        g._has_node[:] = deg > 0
        out.append(g)
    return out


def _equal(j, t, n):
    assert t.e_max == j.e_max
    np.testing.assert_array_equal(t.degree[:n], j.degree[:n])
    np.testing.assert_array_equal(t.nbr_ids[:n], j.nbr_ids[:n])
    np.testing.assert_array_equal(t.nbr_dist[:n], j.nbr_dist[:n])
    np.testing.assert_array_equal(t._has_node[:n], j._has_node[:n])


REWRITES = {
    "convert_to_anng": lambda R, g, n, **kw: R.convert_to_anng(g, n, e_max=96, **kw),
    "reconstruct_anng_from_anng": lambda R, g, n, **kw: R.reconstruct_anng_from_anng(
        g, n, 4, **kw),
    "reconstruct_graph": lambda R, g, n, **kw: R.reconstruct_graph(g, n, 10, 24, **kw),
    "constraint_a": lambda R, g, n, **kw: R.reconstruct_graph_with_constraint(
        g, n, 6, 12, mode="a", **kw),
    "constraint_c": lambda R, g, n, **kw: R.reconstruct_graph_with_constraint(
        g, n, 6, 12, mode="c", **kw),
}


@pytest.mark.parametrize("name", list(REWRITES))
def test_rewrites_match_jax(anng, name):
    _, nbr, dist, deg, n = anng
    jg, tg = _stores(nbr, dist, deg)
    j = REWRITES[name](JR, jg, n)
    t = REWRITES[name](TR, tg, n, device="cpu")
    _equal(j, t, n)
    assert t.degree[:n].sum() > 0


def test_constrained_reverse_matches_jax(anng):
    """The host library's serial selection: the same triples in the same
    order; a degree outside the rows is refused."""
    _, nbr, dist, deg, _ = anng
    assert JN.available(), "the reference's native library did not load"
    for out_e, in_e in ((6, 12), (2, 3)):
        for j, t in zip(JN.constrained_reverse(nbr, dist, deg, out_e, in_e),
                        TN.constrained_reverse(nbr, dist, deg, out_e, in_e)):
            np.testing.assert_array_equal(t, j)
    with pytest.raises(ValueError, match="degree"):
        TN.constrained_reverse(nbr, dist, deg + nbr.shape[1], 6, 12)


def _ulp_graph():
    """A 20-NN graph whose reverse direction of every mutual edge stores
    its distance one ulp up: rows hold u->t at d and t->u at nextafter(d)."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(300, 8)).astype(np.float32)
    d = np.linalg.norm(x[:, None] - x[None], axis=-1).astype(np.float32)
    np.fill_diagonal(d, np.inf)
    up = np.triu(np.ones_like(d, dtype=bool), 1)
    d = np.where(up, d, np.nextafter(d.T, np.float32(np.inf)))
    np.fill_diagonal(d, np.inf)
    ids = np.argsort(d, axis=1, kind="stable")[:, :20].astype(np.int32)
    return ids, np.take_along_axis(d, ids, axis=1), np.full(300, 20, np.int32)


@pytest.mark.parametrize("pairs_min", [1 << 21, 1])
def test_normalize_rows_routes_match_jax(monkeypatch, pairs_min):
    """Below DEV_PAIRS_MIN an edge stores the shortest of its pairs, from
    it on the symmetric lookup of the source rows; they differ by an ulp
    where only the reverse pair survived but the source row holds the
    forward edge.  Both packages with the threshold lowered alike."""
    assert JN.available(), "the reference's native library did not load"
    nbr, dist, deg = _ulp_graph()
    n = len(deg)
    monkeypatch.setattr(JR, "DEV_PAIRS_MIN", pairs_min)
    monkeypatch.setattr(TR, "DEV_PAIRS_MIN", pairs_min)
    jg, tg = _stores(nbr, dist, deg)
    j = JR.reconstruct_graph(jg, n, 4, 16)
    t = TR.reconstruct_graph(tg, n, 4, 16, device="cpu")
    _equal(j, t, n)
    # the other route's distances differ on some edges, its ids on none
    monkeypatch.setattr(TR, "DEV_PAIRS_MIN", (1 << 21) + 1 - pairs_min)
    other = TR.reconstruct_graph(_stores(nbr, dist, deg)[1], n, 4, 16, device="cpu")
    np.testing.assert_array_equal(other.nbr_ids[:n], t.nbr_ids[:n])
    assert (other.nbr_dist[:n] != t.nbr_dist[:n]).any()


def _padded(a, rows, fill):
    return np.concatenate([a, np.full((rows - len(a), a.shape[1]), fill, a.dtype)])


def test_detect_shortcuts_matches_jax(anng):
    """The packed candidate bits ([byte column, row, v rank]) equal the
    reference's byte columns, with the w axis padded past e."""
    import jax.numpy as jnp

    _, nbr, dist, deg, n = anng
    onng = JR.reconstruct_graph(_stores(nbr, dist, deg)[0], n, 10, 24)
    e = int(onng.degree[:n].max())
    n_pad = -(-n // 256) * 256
    cols = JR._detect_shortcuts_all(
        jnp.asarray(_padded(onng.nbr_ids[:n], n_pad, -1)),
        jnp.asarray(_padded(onng.nbr_dist[:n], n_pad, np.inf)),
        e=e, block=256, eb=((e + 7) // 8) * 8 + 8)
    want = np.stack([np.asarray(c)[:n] for c in cols])
    got = TR._detect_shortcuts_all(torch.from_numpy(onng.nbr_ids[:n]),
                                   torch.from_numpy(onng.nbr_dist[:n]), e=e,
                                   eb=want.shape[0] * 8)
    assert e > 8 and want.any()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("env,min_edges", [
    ({}, 0),                                         # R(1), the host rule
    ({}, 12),                                        # R(1), the floor engaged
    ({"NGT_TPU_ADJUST_DEVICE_MIN": "0"}, 12),        # R(8), e > 8
    ({"NGT_TPU_ADJUST_DEVICE_MIN": "0", "NGT_TPU_ADJUST_SNAP": "0"}, 3),
])
def test_adjust_paths_matches_jax(anng, monkeypatch, env, min_edges):
    # the reference's numpy stand-in of edge_dist_lookup differs from its C++
    assert JN.available(), "the reference's native library did not load"
    _, nbr, dist, deg, n = anng
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    onng = JR.reconstruct_graph(_stores(nbr, dist, deg)[0], n, 10, 24)
    pre = onng.degree[:n].copy()
    jg, tg = _stores(onng.nbr_ids[:n], onng.nbr_dist[:n], onng.degree[:n])
    j = JR.adjust_paths(jg, n, min_edges=min_edges)
    t = TR.adjust_paths(tg, n, min_edges=min_edges, device="cpu")
    _equal(j, t, n)
    assert TR._adjust_rule(n, int(pre.max()), None)[0] == bool(env)
    assert t.degree[:n].sum() < pre.sum()
    assert (t.degree[:n] >= np.minimum(min_edges, pre)).all()


def test_adjust_rule_at_1m(monkeypatch):
    """The rule and window the reference picks (reconstruct.py:560-577) at
    bench.py's 1M angular ONNG (n 1,000,001, e 136) and below its
    threshold, from the variables alone: no arrays."""
    n, e = 1_000_001, 136

    def reference_cap(snap):
        n_est = ((n + 511) // 512) * 512 + 512
        k_max = max(1, (1 << 31) // (n_est * e) - 1)
        return max(8, min(((snap + 7) // 8) * 8, 8 * k_max))

    assert TR._adjust_rule(n, e, None) == (True, 8)
    monkeypatch.setenv("NGT_TPU_ADJUST_SNAP", "0")
    assert TR._adjust_rule(n, e, None) == (True, reference_cap(e)) == (True, 112)
    monkeypatch.setenv("NGT_TPU_ADJUST_SNAP", "20")
    assert TR._adjust_rule(n, e, None) == (True, 24)
    assert TR._adjust_rule(30841, e, None) == (True, 24)       # n*e >= 2^22
    assert TR._adjust_rule(30840, e, None) == (False, 1)       # n*e < 2^22
    assert TR._adjust_rule(1000, 12, 5) == (False, 5)
    monkeypatch.setenv("NGT_TPU_ADJUST_DEVICE", "0")
    assert TR._adjust_rule(n, e, None) == (False, 1)


def test_adjust_paths_failure_propagates(anng, monkeypatch):
    """A failed phase 2 raises: nothing replays it on the host."""
    _, nbr, dist, deg, n = anng

    def boom(*a, **k):
        raise RuntimeError("phase 2 failed")

    monkeypatch.setattr(TR, "_adjust_phase2", boom)
    with pytest.raises(RuntimeError, match="phase 2 failed"):
        TR.adjust_paths(_stores(nbr, dist, deg)[1], n, device="cpu")


def test_refine_anng_matches_jax(anng, tmp_path):
    """Both packages open one save of the port's index, chop every row to
    its 2 nearest edges, and refine: equal ids and degrees, and equal
    search ids after; the distances come from each package's search, so
    they agree to the search's float tolerance."""
    data, *_ = anng
    path = str(tmp_path / "idx")
    t = ngt_tpu_torch.create(path, dimension=DIM, edge_size_for_creation=16,
                             device="cpu", search_mode="exact")
    t.batch_insert(data[:600], build=True)
    t.save()
    j = ngt_tpu.open_index(path)
    n = t.store.repository_size
    for idx in (j, t):
        idx.graph.nbr_ids[:, 2:] = -1
        idx.graph.nbr_dist[:, 2:] = np.inf
        idx.graph.degree[:] = np.minimum(idx.graph.degree, 2)
        idx._mirror = None
    JR.refine_anng(j, epsilon=0.2)
    TR.refine_anng(t, epsilon=0.2)
    np.testing.assert_array_equal(t.graph.degree[:n], j.graph.degree[:n])
    np.testing.assert_array_equal(t.graph.nbr_ids[:n], j.graph.nbr_ids[:n])
    np.testing.assert_allclose(t.graph.nbr_dist[:n], j.graph.nbr_dist[:n], rtol=1e-5)
    assert t.verify() == []
    q = data[600:664]
    np.testing.assert_array_equal(t.batch_search(q, size=10)[0],
                                  np.asarray(j.batch_search(q, size=10)[0]))


def test_deferred_rows_feed_the_rewrite(anng):
    """A fresh bulk build leaves its rows on the device; the rewrites read
    them there (the host copy is not materialized) and hand their result
    back as deferred rows, equal to the rewrite of the host copy."""
    data, nbr, dist, deg, n = anng
    t = ngt_tpu_torch.create(None, dimension=DIM, edge_size_for_creation=16, device="cpu")
    t.batch_insert(data, build=True)
    assert t.graph._deferred is not None
    out = TR.reconstruct_graph(t.graph, n, 10, 24, device="cpu")
    assert t.graph._deferred is not None and out._deferred is not None
    _equal(TR.reconstruct_graph(_stores(nbr, dist, deg)[1], n, 10, 24, device="cpu"), out, n)
