"""The plain reference against brute-force loops at tiny sizes."""

import numpy as np
import pytest
import torch

from h100_bench.reference import ExactSearch, distance_gaps, exact_distances, hits, tf32_round


def _loop_topk(base, queries, metric, k, exclude=None):
    ids, dists = [], []
    for j, q in enumerate(queries.astype(np.float64)):
        row = []
        for i, x in enumerate(base.astype(np.float64)):
            if exclude is not None and i == exclude[j]:
                continue
            if metric == "L2":
                d = float(np.sqrt(((q - x) ** 2).sum()))
            else:
                d = 1.0 - float(q @ x) / float(np.linalg.norm(q) * np.linalg.norm(x))
            row.append((d, i))
        row.sort()
        ids.append([i for _, i in row[:k]])
        dists.append([d for d, _ in row[:k]])
    return np.array(ids), np.array(dists)


@pytest.mark.parametrize("metric", ["L2", "Cosine"])
@pytest.mark.parametrize("self_rows", [False, True])
def test_exact_topk_matches_loop(metric, self_rows):
    rng = np.random.default_rng(5)
    base = (rng.normal(size=(400, 8)) + 2.0).astype(np.float32)
    if self_rows:
        sel = rng.choice(400, 25, replace=False)
        queries, exclude = base[sel], sel
    else:
        queries, exclude = rng.normal(size=(25, 8)).astype(np.float32) + 2.0, None
    ids, dists = ExactSearch(base, metric, torch.device("cpu")).topk(
        queries, 7, exclude=exclude, chunk=10)
    want_i, want_d = _loop_topk(base, queries, metric, 7, exclude)
    np.testing.assert_array_equal(ids, want_i)
    np.testing.assert_allclose(dists, want_d, rtol=1e-12, atol=1e-12)


def test_tf32_round():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 2**-12, -3.0 - 2**-9, 1e-20])
    got = tf32_round(x)
    want = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-10, 1.0, -3.0 - 2**-9, 1e-20])
    assert torch.equal(got[:5], want[:5])
    assert abs(float(got[5]) / 1e-20 - 1) < 2**-10


@pytest.mark.parametrize("metric", ["L2", "Cosine"])
def test_tf32_control_is_lower_precision(metric):
    """The control keeps its TF32 scan's own distances."""
    rng = np.random.default_rng(6)
    base = (rng.normal(size=(300, 16)) + 3.0).astype(np.float32)
    queries = base[:20] + 0.05 * rng.normal(size=(20, 16)).astype(np.float32)
    ids, dists = ExactSearch(base, metric, torch.device("cpu"), control=True).topk(queries, 5)
    gaps = distance_gaps(queries, base, ids, dists, metric)
    assert ids.shape == (20, 5) and gaps.max() > 1e-4


def test_hits_counts_the_intersection():
    found = np.array([[1, 2, 3], [4, -1, -1], [7, 8, 9]])
    exact = np.array([[3, 2, 9], [4, 5, 6], [1, 2, 3]])
    want = [len(set(f[f >= 0]) & set(e)) for f, e in zip(found, exact)]
    np.testing.assert_array_equal(hits(found, exact), want)


def test_distance_gaps():
    rng = np.random.default_rng(7)
    base = rng.normal(size=(50, 4)).astype(np.float32)
    q = rng.normal(size=(3, 4)).astype(np.float32)
    ids = np.array([[0, 1, 2], [3, 4, 5], [6, 7, 8]])
    d = exact_distances(q, base[ids], "L2")
    assert distance_gaps(q, base, ids, d, "L2").max() < 1e-12
    bad = d.copy()
    bad[0, 1] *= 1.01
    np.testing.assert_allclose(distance_gaps(q, base, ids, bad, "L2")[0], 0.01, rtol=1e-6)
    for i2, d2 in ((np.array([[0, 0, 2]]), d[:1]), (np.array([[0, -1, 2]]), d[:1]),
                   (np.array([[0, 50, 2]]), d[:1]), (ids[:1], np.array([[d[0, 0], np.inf, 1]]))):
        assert np.isinf(distance_gaps(q[:1], base, i2, d2, "L2")[0])
