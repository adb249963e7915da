"""Removal in the port (ngt_tpu_torch/index.py ``remove``/``batch_remove``,
graph/build.py ``remove_object``/``batch_remove_objects``) against the JAX
package, on the CPU, on one graph: a reference index carried into the port
by convert.py (objects, adjacency, seeds, free slots and mutation count).
Both remove the same ids; then the adjacency, the resampled seeds, the
inspection calls (``get_edges``, ``check_graph``, ``statistics``) and the
exact-route ids are equal, no removed id comes back on either route, the
freed slots are reused smallest first by the next insert, and each
package opens the other's mutated index to the same ids.
"""

import dataclasses
import enum
import os

import numpy as np
import pytest

import ngt_tpu
import ngt_tpu_torch
from ngt_tpu_torch import convert

DIM = 24
N = 900


def carry(j, device="cpu"):
    """A port Index holding the reference index ``j``'s state."""
    n = j.store.repository_size
    ss, gs = j.store.state_dict(), j.graph.state_dict(n)
    prop = {f.name: int(v) if isinstance(v, enum.IntEnum) else v
            for f in dataclasses.fields(j.prop) for v in [getattr(j.prop, f.name)]}
    return convert.from_ngt_tpu_arrays(
        objects=ss["x"], valid=ss["valid"], free=ss["free"],
        nbr_ids=gs["nbr_ids"], nbr_dist=gs["nbr_dist"], degree=gs["degree"],
        has_node=gs["has_node"], rep_ids=j.seeder.rep_ids, prop_dict=prop,
        mutation_count=j.store.mutation_count, device=device,
    )


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(77)
    centers = rng.standard_normal((10, DIM)) * 1.5
    x = centers[rng.integers(0, 10, N + 300)] + rng.standard_normal((N + 300, DIM))
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def ref_dir(data, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "idx")
    j = ngt_tpu.create(path, dimension=DIM, search_qg_threshold=100,
                       device_batch_size=256)
    j.batch_insert(data[:N], build=True)
    j.save()
    return path


@pytest.fixture(scope="module")
def removed_pair(ref_dir):
    """The reference index opened fresh (a fresh seed stream, as the
    port's) and its carried copy, after ``batch_remove`` of 120 ids, three
    of them seed representatives, and ``remove`` of 6 more one at a time."""
    j = ngt_tpu.open_index(ref_dir)
    t = carry(j)
    reps_before = j.seeder.rep_ids.copy()
    rng = np.random.default_rng(5)
    ext_reps = np.unique(reps_before)[:3] - 1
    batch = np.unique(np.concatenate([rng.choice(N, 117, replace=False), ext_reps]))
    singles = [s for s in rng.choice(N, 20, replace=False) if s not in batch][:6]
    for idx in (j, t):
        idx.batch_remove(batch)
        for s in singles:
            idx.remove(int(s))
    return j, t, np.concatenate([batch, singles]), reps_before


def test_removal_matches_jax(removed_pair, data):
    j, t, gone, reps_before = removed_pair
    m = j.store.repository_size
    np.testing.assert_array_equal(t.graph.nbr_ids[:m], np.asarray(j.graph.nbr_ids[:m]))
    np.testing.assert_allclose(t.graph.nbr_dist[:m], np.asarray(j.graph.nbr_dist[:m]),
                               rtol=1e-5)
    np.testing.assert_array_equal(t.graph._has_node[:m], j.graph._has_node[:m])
    np.testing.assert_array_equal(t.store._valid[:m], j.store._valid[:m])
    assert sorted(t.store._free) == sorted(j.store._free)
    assert len(t) == len(j) == N - len(gone)
    # a representative went: both resampled, from the same stream
    assert not np.array_equal(t.seeder.rep_ids, reps_before)
    np.testing.assert_array_equal(t.seeder.rep_ids, j.seeder.rep_ids)
    assert not np.isin(t.seeder.rep_ids, gone + 1).any()
    assert t.verify() == [] and j.verify() == []
    q = np.concatenate([data[gone[:40]], data[N : N + 60]])
    t.prop.search_mode = j.prop.search_mode = "exact"
    ti = t.batch_search(q, size=10)[0]
    np.testing.assert_array_equal(ti, np.asarray(j.batch_search(q, size=10)[0]))


@pytest.mark.parametrize("mode", ["exact", "qg"])
def test_removed_ids_never_returned(removed_pair, data, mode):
    """The removed rows themselves as queries, and 60 others, on each
    route (the qg route re-encodes and re-gathers after the removals)."""
    _, t, gone, _ = removed_pair
    t.prop.search_mode = mode
    q = np.concatenate([data[gone], data[N : N + 60]])
    ids = t.batch_search(q, size=20, epsilon=0.2)[0]
    assert (mode == "qg") == (t._qg is not None)
    assert not np.isin(ids, gone).any()
    assert (ids[:, 0] >= 0).all()


def test_missing_ids_raise_key_error(removed_pair):
    _, t, gone, _ = removed_pair
    with pytest.raises(KeyError):
        t.remove(int(gone[0]))
    with pytest.raises(KeyError):
        t.batch_remove([int(gone[1])])
    with pytest.raises(KeyError):
        t.remove(10 ** 6)
    with pytest.raises(KeyError):
        t.get_edges(int(gone[2]))


def test_inspection_matches_jax(removed_pair):
    j, t, _, _ = removed_pair
    for ext in (0, 17, 450, N - 1):
        if j.store.contains(ext + 1):
            got, want = t.get_edges(ext), j.get_edges(ext)
            assert [i for i, _ in got] == [i for i, _ in want]
            np.testing.assert_allclose([d for _, d in got], [d for _, d in want], rtol=1e-5)
    assert t.check_graph(sample=300) == j.check_graph(sample=300)
    ts, js = t.statistics(), j.statistics()
    for key in ("nodes", "edges", "outdegree", "indegree"):
        assert ts[key] == js[key], key
    for key in ("mean", "mean_10nn"):
        assert ts["edge_length"][key] == pytest.approx(js["edge_length"][key], rel=1e-5)


def test_freed_slots_are_reused_alike(ref_dir, data):
    """After a removal the next (incremental) insert takes the freed ids,
    smallest first, in both packages, and links them alike."""
    j = ngt_tpu.open_index(ref_dir)
    t = carry(j)
    gone = np.arange(100, 160)
    for idx in (j, t):
        idx.batch_remove(gone)
    got = t.batch_insert(data[N : N + 80], build=True)
    want = np.asarray(j.batch_insert(data[N : N + 80], build=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:60], gone)
    assert got[60] == N                      # then fresh slots
    m = j.store.repository_size
    same = t.graph.nbr_ids[:m] == np.asarray(j.graph.nbr_ids[:m])
    assert same.mean() >= 0.999
    assert t.verify() == []
    # reused slots never link to themselves
    assert not (t.graph.nbr_ids[gone + 1] == (gone + 1)[:, None]).any()


def test_mutated_indexes_cross_open(removed_pair, data, tmp_path):
    j, t, gone, _ = removed_pair
    q = data[N : N + 50]
    tp, jp = str(tmp_path / "port"), str(tmp_path / "jax")
    t.prop.search_mode = j.prop.search_mode = "exact"
    t.save(tp)
    j.save(jp)
    want = t.batch_search(q, size=10)[0]
    in_jax = ngt_tpu.open_index(tp)
    in_port = ngt_tpu_torch.open_index(jp, device="cpu")
    assert in_jax.verify() == [] and in_port.verify() == []
    np.testing.assert_array_equal(np.asarray(in_jax.batch_search(q, size=10)[0]), want)
    np.testing.assert_array_equal(in_port.batch_search(q, size=10)[0], want)
    assert sorted(in_port.store._free) == sorted(np.asarray(gone) + 1)
    ngt_tpu_torch.Index.destroy(tp)
    assert not os.path.exists(tp)
