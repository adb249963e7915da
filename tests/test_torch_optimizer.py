"""The port's optimizer (ngt_tpu_torch/optimizer.py) and its ONNG index
against the JAX package's on the CPU, both packages opening one save:

* ``GraphOptimizer.execute`` with ``tune_parameters`` False and True: the
  same ONNG rows, graph type, edge counts and accuracy table (the port's
  k-means seeds draw their init on the host, so the port takes the
  reference's new seeds, as the other parity tests carry codebooks);
* ``extract_queries``, ``explore_epsilon``, ``expected_accuracy`` (the same
  ε, the same ids) and ``optimize_number_of_edges`` at a small start size;
* an ONNG saved by either package opens in the other with its properties
  and searches alike;
* the quantized-graph route after the graph swap: the blocks rebuild from
  the ONNG rows with the reference's width and refine budget.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import ngt_tpu
import ngt_tpu_torch
from ngt_tpu import optimizer as JO
from ngt_tpu_torch import optimizer as TO
from ngt_tpu_torch.properties import GraphType

N, DIM = 800, 12


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
def saved(tmp_path_factory):
    """One ANNG saved by the JAX package, its rows and some queries."""
    rng = np.random.default_rng(17)
    data = rng.normal(size=(N, DIM)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("opt") / "anng")
    j = ngt_tpu.create(path, dimension=DIM, edge_size_for_creation=16, search_mode="exact")
    j.batch_insert(data, build=True)
    j.save()
    return SimpleNamespace(path=path, data=data,
                           q=rng.normal(size=(48, DIM)).astype(np.float32))


def _pair(path):
    return ngt_tpu.open_index(path), ngt_tpu_torch.open_index(path, device="cpu")


def _onng(saved, monkeypatch, tune):
    """Both packages' indexes after GraphOptimizer(8, 24), tuned on the
    saved queries: the port's optimize_seeds takes the reference's new
    seeds."""
    j, t = _pair(saved.path)
    kw = dict(out_edges=8, in_edges=24, tune_parameters=tune, queries=saved.q)
    JO.GraphOptimizer(**kw).execute(j)
    monkeypatch.setattr(t, "optimize_seeds", lambda num_reps=0: t.seeder.set_representatives(
        np.asarray(j.seeder.rep_ids), t.store._x))
    TO.GraphOptimizer(**kw).execute(t)
    return j, t


@pytest.fixture(scope="module")
def onng(saved):
    mp = pytest.MonkeyPatch()
    try:
        yield _onng(saved, mp, tune=True)
    finally:
        mp.undo()


def _same_graph(j, t):
    n = j.store.repository_size
    assert t.prop.graph_type == j.prop.graph_type == GraphType.ONNG
    assert t.graph.e_max == j.graph.e_max == t.prop.max_edges == 32
    assert (t.prop.outgoing_edge, t.prop.incoming_edge) == (8, 24)
    np.testing.assert_array_equal(t.graph.degree[:n], j.graph.degree[:n])
    np.testing.assert_array_equal(t.graph.nbr_ids[:n], j.graph.nbr_ids[:n])
    np.testing.assert_array_equal(t.graph.nbr_dist[:n], j.graph.nbr_dist[:n])
    np.testing.assert_array_equal(t.seeder.rep_ids, np.asarray(j.seeder.rep_ids))
    assert t.verify() == []


def test_graph_optimizer_matches_jax(saved, monkeypatch):
    """tune_parameters=False (bench.py's call): the same ONNG rows and
    seeds, no table, and the same search ids after."""
    j, t = _onng(saved, monkeypatch, tune=False)
    _same_graph(j, t)
    assert t.prop.accuracy_table == j.prop.accuracy_table == ""
    np.testing.assert_array_equal(t.batch_search(saved.q, size=10, epsilon=0.05)[0],
                                  np.asarray(j.batch_search(saved.q, size=10, epsilon=0.05)[0]))


def test_graph_optimizer_tuned_matches_jax(onng):
    """tune_parameters=True: the same rows and seeds, and the same
    accuracy table.  The chosen edge size
    is the fastest and depends on timing, so it is only checked to be one
    of the candidates (0 stores e_max; the others are stored as given, as
    the reference stores them)."""
    j, t = onng
    _same_graph(j, t)
    assert t.prop.accuracy_table and t.prop.accuracy_table == j.prop.accuracy_table
    assert t.prop.edge_size_for_search in (10, 20, 40, 60, t.graph.e_max)


def test_extract_explore_expected_accuracy_match_jax(onng, saved):
    j, t = onng
    np.testing.assert_array_equal(TO.extract_queries(t, 40, seed=3),
                                  JO.extract_queries(j, 40, seed=3))
    gt = t.batch_linear_search(saved.q, size=10)[0]
    np.testing.assert_array_equal(gt, np.asarray(j.batch_linear_search(saved.q, size=10)[0]))
    eps_t = TO.explore_epsilon(t, saved.q, gt, 0.95, iters=5)
    eps_j = JO.explore_epsilon(j, saved.q, gt, 0.95, iters=5)
    assert eps_t == eps_j
    table = TO.AccuracyTable.from_string(t.prop.accuracy_table)
    eps = table.get_epsilon(0.97)
    assert eps == JO.AccuracyTable.from_string(j.prop.accuracy_table).get_epsilon(0.97)
    got = t.batch_search(saved.q, size=10, expected_accuracy=0.97)[0]
    np.testing.assert_array_equal(got, t.batch_search(saved.q, size=10, epsilon=eps)[0])
    np.testing.assert_array_equal(
        got, np.asarray(j.batch_search(saved.q, size=10, expected_accuracy=0.97)[0]))
    assert t.search(saved.data[321], size=5, expected_accuracy=0.9)[0][0] == 321


def test_optimize_number_of_edges_matches_jax(saved):
    """Prefixes of 400 and 800 rows and the validating rebuild: the port
    builds them on the index's device and finds the same edge counts."""
    j, t = _pair(saved.path)
    kw = dict(target_accuracy=0.9, start_size=400, num_queries=24,
              edge_candidates=(5, 10, 20))
    got = TO.optimize_number_of_edges(t, **kw)
    want = JO.optimize_number_of_edges(j, **kw)
    assert got["sizes"] == want["sizes"] == [400, 800]
    assert got == want


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_onng_save_open_across_packages(onng, saved, tmp_path, writer):
    """An ONNG with its table and dynamic edge sizes, saved by either
    package, opens in the other with its properties and identical ids."""
    j, t = onng
    src = j if writer == "jax" else t
    src.prop.dynamic_edge_size_base, src.prop.dynamic_edge_size_rate = 24, 14
    path = str(tmp_path / writer)
    src.save(path)
    other = (ngt_tpu_torch.open_index(path, device="cpu") if writer == "jax"
             else ngt_tpu.open_index(path))
    for key in ("graph_type", "outgoing_edge", "incoming_edge", "accuracy_table",
                "dynamic_edge_size_base", "dynamic_edge_size_rate", "max_edges",
                "edge_size_for_search"):
        assert getattr(other.prop, key) == getattr(src.prop, key), key
    assert int(other.prop.graph_type) == int(GraphType.ONNG)
    assert other.graph.e_max == 32 and other.verify() == []
    np.testing.assert_array_equal(np.asarray(other.batch_search(saved.q, size=10)[0]),
                                  np.asarray(src.batch_search(saved.q, size=10)[0]))


def test_qg_route_after_graph_swap(saved, monkeypatch):
    """bench.py runs the ONNG on an index whose qg mirror exists and keeps
    it: in both packages the next qg search rebuilds the blocks from the
    ONNG rows (keyed on the mirror's version), at the same block width and
    refine budget, and returns the same ids."""
    j, t = _pair(saved.path)
    for idx in (j, t):
        idx.prop.search_mode = "qg"
        idx.batch_search(saved.q, size=10, epsilon=0.1)
    eb0 = t._qg._dev_blocks()[1].shape[1]
    monkeypatch.setattr(t, "optimize_seeds", lambda num_reps=0: None)
    monkeypatch.setattr(j, "optimize_seeds", lambda num_reps=0: None)
    qg_t, qg_j = t._qg, j._qg
    JO.GraphOptimizer(out_edges=8, in_edges=24, tune_parameters=False).execute(j)
    TO.GraphOptimizer(out_edges=8, in_edges=24, tune_parameters=False).execute(t)
    got = t.batch_search(saved.q, size=10, epsilon=0.1)
    want = j.batch_search(saved.q, size=10, epsilon=0.1)
    assert t._qg is qg_t and j._qg is qg_j
    blocks, nbr_eb = t._qg._dev_blocks()
    eb = nbr_eb.shape[1]
    assert eb == int(j._qg._dev_blocks()[1].shape[1]) == 32 and eb0 == 64
    assert t._qg._resolve_refine(32, eb) == j._qg._resolve_refine(32, eb)
    n = t.store.repository_size
    np.testing.assert_array_equal(nbr_eb[:n].numpy(), t.graph.nbr_ids[:n, :eb])
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=1e-5)


def test_replace_graph_swaps_device_adjacency(saved, tmp_path):
    """``Index.replace_graph``, which the CLI, the adapters and the
    optimizer call after a rebuild: the device mirror keeps its object rows
    and takes the new adjacency, and a qg mirror made before the swap
    searches the new graph as an index that opened the new graph does."""
    from ngt_tpu_torch.graph.reconstruct import reconstruct_anng_from_anng

    t = ngt_tpu_torch.open_index(saved.path, device="cpu")
    t.prop.search_mode = "qg"
    t.batch_search(saved.q, size=10, epsilon=0.1)
    x, qg = t._mirror.x, t._qg
    n = t.store.repository_size
    old_nbr = t.graph.nbr_ids[:n].copy()
    t.replace_graph(reconstruct_anng_from_anng(t.graph, n, 6, device=t.device))
    assert not np.array_equal(t.graph.nbr_ids[:n, : old_nbr.shape[1]], old_nbr)
    assert t._mirror.x is x and t._qg is qg
    np.testing.assert_array_equal(t._mirror.nbr[:n].numpy(), t.graph.nbr_ids[:n])
    got = t.batch_search(saved.q, size=10, epsilon=0.1)
    t.save(str(tmp_path / "swapped"))
    fresh = ngt_tpu_torch.open_index(str(tmp_path / "swapped"), device="cpu")
    fresh.prop.search_mode = "qg"
    want = fresh.batch_search(saved.q, size=10, epsilon=0.1)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    nbr_eb = t._qg._dev_blocks()[1]
    np.testing.assert_array_equal(nbr_eb[:n].numpy(), t.graph.nbr_ids[:n, : nbr_eb.shape[1]])


@pytest.mark.parametrize("pairs", [
    [(0.0, 0.5), (0.1, 0.8), (0.3, 0.95)],
    [(0.0, 0.9), (0.2, 0.9)],
    [(0.05, 0.7)],
])
def test_accuracy_table_and_descent_match_jax(pairs):
    """The table's string form and interpolation (inside, below and past
    its range, flat segments) and the edge-size tuner's 1-D descent on a
    measured-time curve equal the reference's."""
    t, j = TO.AccuracyTable(pairs), JO.AccuracyTable(pairs)
    assert t.to_string() == j.to_string()
    assert TO.AccuracyTable.from_string(t.to_string()).pairs == t.pairs
    for acc in (0.3, 0.65, 0.8, 0.9, 0.97, 0.999):
        assert t.get_epsilon(acc) == j.get_epsilon(acc)
    a, b = pairs[0]
    curve = lambda v: (v - 40 * (1 + a)) ** 2 + 3 * b  # noqa: E731
    assert TO._descent_1d(curve, 5, 4) == JO._descent_1d(curve, 5, 4)


def test_adjust_search_edge_size_runs(onng, saved):
    """The dynamic edge-size tuner (timed, so not compared with the
    reference) stores a (base, rate) pair that edge_size=-2 searches use."""
    _, t = onng
    base, rate = TO.adjust_search_edge_size(t, saved.q)
    assert (t.prop.dynamic_edge_size_base, t.prop.dynamic_edge_size_rate) == (base, rate)
    assert base >= 4 and rate >= 2
    ids, _ = t.batch_search(saved.q, size=10, epsilon=0.1, edge_size=-2)
    assert (ids >= 0).all()


def test_convert_carries_an_onng(onng):
    """convert.py's state carries the ONNG whole: its properties (graph
    type, edge counts, accuracy table) and its rows at their width."""
    from ngt_tpu_torch import convert

    _, t = onng
    c = convert.from_ngt_tpu_arrays(device="cpu", **convert.to_numpy_state(t))
    n = t.store.repository_size
    for key in ("graph_type", "outgoing_edge", "incoming_edge", "accuracy_table",
                "max_edges", "dynamic_edge_size_base", "dynamic_edge_size_rate"):
        assert getattr(c.prop, key) == getattr(t.prop, key), key
    assert c.prop.graph_type == GraphType.ONNG and c.graph.e_max == t.graph.e_max == 32
    np.testing.assert_array_equal(c.graph.nbr_ids[:n], t.graph.nbr_ids[:n])
    np.testing.assert_array_equal(c.graph.nbr_dist[:n], t.graph.nbr_dist[:n])
