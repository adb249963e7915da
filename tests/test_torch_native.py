"""The port's host graph library (ngt_tpu_torch/native.py, built by g++
from csrc/host_graph.cpp) against the JAX package's native library on the
same numpy inputs, on the CPU: merge_edges leaves the same rows,
connected_components the same root labels, union_pairs the same min-id
labels.  And the bulk build with truncation_threshold > 0 labels its
components by those roots as the reference does, so a tie in component
size picks the same main component and the same bridges.
"""

import numpy as np
import pytest
import ref_native_build  # noqa: F401  (builds the reference's library under a lock)

import ngt_tpu
import ngt_tpu_torch
from ngt_tpu import native as JN
from ngt_tpu_torch import native as TN
from ngt_tpu_torch.graph import build as TB

INF = np.float32(np.inf)


def _graph(rng, cap, e_max, dead):
    """Sorted -1/inf padded rows of random degree, ``dead`` slots empty."""
    ids = np.full((cap, e_max), -1, np.int32)
    dist = np.full((cap, e_max), INF, np.float32)
    deg = rng.integers(0, e_max + 1, cap).astype(np.int32)
    has = np.ones(cap, bool)
    has[dead] = False
    deg[dead] = 0
    for r in range(cap):
        if deg[r]:
            ids[r, : deg[r]] = rng.choice(cap, deg[r], replace=False)
            dist[r, : deg[r]] = np.sort(rng.random(deg[r]).astype(np.float32))
    return ids, dist, deg, has


@pytest.mark.parametrize("n_adds", [5, 300, 20000])
def test_merge_edges_matches_reference(n_adds):
    """Duplicate adds, adds already in the row, full rows that drop their
    farthest edge, adds into dead slots, -1 sources; 20,000 adds spread
    over more than 64 rows per thread, so the threaded path runs."""
    assert JN.available(), "the reference's native library did not load"
    rng = np.random.default_rng(n_adds)
    cap, e_max = 700, 12
    ids, dist, deg, has = _graph(rng, cap, e_max, dead=rng.choice(cap, 40, replace=False))
    tgt = rng.integers(0, cap, n_adds).astype(np.int64)
    src = rng.integers(-1, cap, n_adds).astype(np.int32)
    d = rng.random(n_adds).astype(np.float32)
    src[: n_adds // 4] = ids[tgt[: n_adds // 4], 0]        # already present
    d[1::7] = 0.5                                          # distance ties
    out = []
    for merge in (JN.merge_edges, TN.merge_edges):
        a = [ids.copy(), dist.copy(), deg.copy(), has.copy()]
        merge(a[0], a[1], a[2], a[3].view(np.uint8), tgt, src, d)
        out.append(a)
    for j, t in zip(*out):
        np.testing.assert_array_equal(t, j)


def _two_components(rng, half, e_max, dead):
    """Two disjoint random graphs of ``half`` nodes each, interleaved ids,
    with dead slots: two components of equal size."""
    cap = 2 * half
    ids = np.full((cap, e_max), -1, np.int32)
    side = np.arange(cap) % 2
    for r in range(cap):
        pool = np.nonzero(side == side[r])[0]
        ids[r, :5] = rng.choice(pool, 5, replace=False)
    has = np.ones(cap, bool)
    has[dead] = False
    return ids, has


def test_connected_components_matches_reference():
    assert JN.available(), "the reference's native library did not load"
    ids, has = _two_components(np.random.default_rng(3), 150, 8, dead=[0, 7, 50])
    jl, jc = JN.connected_components(ids, has)
    tl, tc = TN.connected_components(ids, has)
    np.testing.assert_array_equal(tl, jl)
    assert tc == jc == 2
    assert (tl[[0, 7, 50]] == -1).all()
    # root ids, not minimum ids: the labels the bulk build's tie-break reads
    assert len(np.unique(tl[tl >= 0])) == 2


def test_union_pairs_matches_reference():
    assert JN.available(), "the reference's native library did not load"
    rng = np.random.default_rng(4)
    ids, has = _two_components(rng, 100, 8, dead=[3])
    labels, _ = JN.connected_components(ids, has)
    roots = np.unique(labels[labels >= 0])
    for a, b in ((np.zeros(0, np.int32), np.zeros(0, np.int32)),
                 (roots[:1].astype(np.int32), roots[1:].astype(np.int32)),
                 (np.array([-1, 5, 400], np.int32), np.array([2, -3, 1], np.int32))):
        jl, jc = JN.union_pairs(labels, a, b)
        tl, tc = TN.union_pairs(labels, a, b)
        np.testing.assert_array_equal(tl, jl)
        assert tc == jc


def test_truncated_bulk_build_breaks_a_size_tie_as_reference(monkeypatch):
    """Two equal clusters, truncation_threshold 5: after the cut the host
    labels give two components of 300 rows.  The main component is the one
    with the lower label; with union-find root labels (the reference's) it
    is NOT the one holding node 1, which minimum-id labels would pick, so
    the bridges differ unless the port labels by roots too."""
    assert JN.available(), "the reference's native library did not load"
    rng = np.random.default_rng(0)
    n, d = 600, 32
    centers = rng.standard_normal((2, d)) * 3.0
    x = (centers[np.arange(n) % 2] + rng.standard_normal((n, d))).astype(np.float32)
    seen = {}
    orig = TN.connected_components

    def spy(nbr, has):
        seen["labels"], seen["count"] = orig(nbr, has)
        return seen["labels"], seen["count"]

    monkeypatch.setattr(TB.native, "connected_components", spy)
    t = ngt_tpu_torch.create(None, dimension=d, device="cpu", truncation_threshold=5)
    t.batch_insert(x, build=True)
    lab = seen["labels"]
    sizes = np.bincount(lab[lab >= 0])
    assert seen["count"] == 2 and sorted(sizes[sizes > 0]) == [300, 300]
    assert sizes.argmax() != lab[1]     # the tie goes against node 1's component
    j = ngt_tpu.create(None, dimension=d, truncation_threshold=5)
    j.batch_insert(x, build=True)
    m = n + 1
    np.testing.assert_array_equal(t.graph.nbr_ids[:m], j.graph.nbr_ids[:m])
    np.testing.assert_allclose(t.graph.nbr_dist[:m], j.graph.nbr_dist[:m], rtol=1e-5)
    assert t.verify() == []


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(TN, "SOURCE", str(bad))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        TN._build(str(tmp_path / "lib.so"))
    assert not (tmp_path / "lib.so").exists()


def test_out_of_range_inputs_raise_before_the_library_runs():
    """Pointers reach C++ only for inputs that fit: a target past the last
    row, mismatched lengths, non-contiguous rows and labels past n raise."""
    ids, dist, deg, has = _graph(np.random.default_rng(2), 50, 6, dead=[])
    u8 = has.view(np.uint8)
    one = (np.array([1]), np.array([2], np.int32), np.array([0.5], np.float32))
    with pytest.raises(ValueError, match="outside"):
        TN.merge_edges(ids, dist, deg, u8, np.array([50]), *one[1:])
    with pytest.raises(ValueError, match="length"):
        TN.merge_edges(ids, dist, deg, u8, one[0], np.array([2, 3], np.int32), one[2])
    with pytest.raises(ValueError, match="contiguous"):
        TN.merge_edges(np.asfortranarray(ids), dist, deg, u8, *one)
    with pytest.raises(ValueError, match="rows"):
        TN.connected_components(ids, has[:10])
    with pytest.raises(ValueError, match="outside"):
        TN.union_pairs(np.array([0, 7], np.int32), np.zeros(0), np.zeros(0))
