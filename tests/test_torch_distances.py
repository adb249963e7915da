"""The port's distances, store and brute-force search for every metric and
object type (ngt_tpu_torch/ops/distances.py, store.py, ops/bruteforce.py)
against the JAX package on the CPU, fed the same seeded numpy inputs.

Tolerances:
* distances to rtol 1e-5 (the sums run in another order);
* Angle and Normalized Angle are compared as cos(d), Poincare and Lorentz
  as cosh(d), i.e. in the argument of acos/acosh: a last-bit difference in
  a dot near 1 becomes about 3e-4 of angle, while the argument itself
  agrees to f32 rounding (rtol 1e-5, atol 1e-6);
* Hamming, Jaccard and sparse Jaccard are integer counts and agree exactly;
* ids are equal, except that an entry may differ where the two distances
  lie within 1e-5 relative of each other (a tie that the two reduction
  orders break apart); such entries are counted and reported.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngt_tpu.ops import bruteforce as JB
from ngt_tpu.ops import distances as JD
from ngt_tpu.store import VectorStore as JStore
from ngt_tpu.store import pad_sparse as j_pad_sparse
from ngt_tpu_torch.ops import bruteforce as TB
from ngt_tpu_torch.ops import distances as TD
from ngt_tpu_torch.properties import DistanceType as DT
from ngt_tpu_torch.properties import ObjectType as OT
from ngt_tpu_torch.store import VectorStore as TStore
from ngt_tpu_torch.store import pad_sparse

METRICS = [m for m in DT if m != DT.NONE]
ANGLES = (DT.ANGLE, DT.NORMALIZED_ANGLE)
HYPERBOLIC = (DT.POINCARE, DT.LORENTZ)


def metric_rows(metric, n, d, rng):
    """[n, d] rows of the metric's domain: uint8 bit patterns for Hamming
    and Jaccard, -1-padded sorted id sets for sparse Jaccard, unit rows for
    the Normalized* metrics, points in the unit ball (Poincare) or on the
    hyperboloid (Lorentz), else f32 with log-normal row norms."""
    if metric in (DT.HAMMING, DT.JACCARD):
        return rng.integers(0, 256, (n, d), dtype=np.uint8)
    if metric == DT.SPARSE_JACCARD:
        return pad_sparse(
            [rng.choice(4 * d, rng.integers(1, d // 2), replace=False) for _ in range(n)], d)
    if metric == DT.POINCARE:
        x = rng.normal(size=(n, d))
        x /= np.linalg.norm(x, axis=1, keepdims=True) * rng.uniform(1.2, 3.0, (n, 1))
        return x.astype(np.float32)
    if metric == DT.LORENTZ:
        sp = rng.normal(size=(n, d - 1)) * 0.4
        return np.concatenate([np.sqrt(1.0 + (sp**2).sum(1, keepdims=True)), sp],
                              1).astype(np.float32)
    x = rng.normal(size=(n, d)) * rng.lognormal(0.0, 0.3, (n, 1))
    if metric in TD.NORMALIZED_METRICS:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32)


def padded(metric, x, d_pad=128):
    out = np.full((x.shape[0], d_pad), -1 if metric == DT.SPARSE_JACCARD else 0, x.dtype)
    out[:, : x.shape[1]] = x
    return out


def assert_dist_close(metric, t, j):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    if metric in ANGLES:
        t, j = np.cos(t), np.cos(j)
    elif metric in HYPERBOLIC:
        t, j = np.cosh(t), np.cosh(j)
    if metric in TD.BITWISE_METRICS or metric == DT.SPARSE_JACCARD:
        np.testing.assert_array_equal(t, j)
    else:
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)


def assert_ids_match(ti, td, ji, jd, max_share=0.01):
    """Equal ids, except entries whose two distances lie within 1e-5
    relative of each other; returns how many such entries differ."""
    ti, ji = np.asarray(ti), np.asarray(ji)
    td, jd = np.asarray(td, np.float64), np.asarray(jd, np.float64)
    diff = ti != ji
    fin = np.isfinite(td) & np.isfinite(jd)
    tied = fin & (np.abs(td - jd) <= 1e-5 * np.maximum(np.abs(jd), 1e-30))
    assert not (diff & ~tied).any(), f"ids differ outside ties at {np.argwhere(diff & ~tied)[:5]}"
    assert diff.sum() <= max_share * diff.size, f"{diff.sum()} tied entries differ"
    return int(diff.sum())


@pytest.mark.parametrize("metric", METRICS, ids=[m.name for m in METRICS])
def test_pairwise_gathered_seed_scores_match_jax(metric):
    rng = np.random.default_rng(int(metric) + 7)
    d = 24
    q = padded(metric, metric_rows(metric, 9, d, rng))
    x = padded(metric, metric_rows(metric, 70, d, rng))
    xs = x[rng.integers(0, 70, (9, 12))]
    tq, tx, txs = (torch.from_numpy(a) for a in (q, x, xs))
    x_sq = np.array(JD.sq_norms(jnp.asarray(x)))
    np.testing.assert_allclose(TD.sq_norms(tx).numpy(), x_sq, rtol=1e-6)
    assert_dist_close(metric, TD.pairwise(metric, tq, tx).numpy(),
                      JD.pairwise(metric, jnp.asarray(q), jnp.asarray(x)))
    assert_dist_close(metric,
                      TD.pairwise(metric, tq, tx, x_sqnorm=torch.from_numpy(x_sq)).numpy(),
                      JD.pairwise(metric, jnp.asarray(q), jnp.asarray(x),
                                  x_sqnorm=jnp.asarray(x_sq)))
    assert_dist_close(metric, TD.gathered(metric, tq, txs).numpy(),
                      JD.gathered(metric, jnp.asarray(q), jnp.asarray(xs)))
    # seed scores: selection-only surrogates (bf16 products for the
    # normalized, angular and L2 metrics), held to their own scale
    ts = TD.seed_scores(metric, tq, tx, rep_sq=torch.from_numpy(x_sq)).numpy()
    js = np.asarray(JD.seed_scores(metric, jnp.asarray(q), jnp.asarray(x),
                                   rep_sq=jnp.asarray(x_sq)))
    if metric in TD.NORMALIZED_METRICS or metric in TD.ANGULAR_METRICS or metric == DT.L2:
        np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-5 * np.abs(js).max())
    else:
        assert_dist_close(metric, ts, js)


def test_normalize_rows_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(20, 128)).astype(np.float32) * 5.0
    x[4] = 0.0
    t = TD.normalize_rows(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(t, np.asarray(JD.normalize_rows(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)
    assert not t[4].any()
    for m in METRICS:
        assert TD.needs_normalization(m) == JD.needs_normalization(m)
    assert {int(m) for m in TD.NORMALIZED_METRICS} == {int(m) for m in JD.NORMALIZED_METRICS}
    assert {int(m) for m in TD.ANGULAR_METRICS} == {int(m) for m in JD.ANGULAR_METRICS}
    assert {int(m) for m in TD.BITWISE_METRICS} == {int(m) for m in JD.BITWISE_METRICS}


STORES = [
    (DT.L2, OT.FLOAT),
    (DT.HAMMING, OT.UINT8),
    (DT.L2, OT.BFLOAT16),
    (DT.NORMALIZED_COSINE, OT.FLOAT),
    (DT.COSINE, OT.FLOAT),
    (DT.SPARSE_JACCARD, OT.FLOAT),
]


@pytest.mark.parametrize("metric,otype", STORES, ids=[f"{m.name}-{o.name}" for m, o in STORES])
def test_store_prepare_matches_jax(metric, otype):
    rng = np.random.default_rng(5)
    d = 20
    rows = metric_rows(metric, 30, d, rng)
    if otype == OT.UINT8:
        rows = rows.astype(np.uint8)
    elif metric == DT.NORMALIZED_COSINE:
        rows = rows * 3.0     # the store normalizes
    t = TStore(d, metric=metric, object_type=otype, device="cpu")
    j = JStore(d, metric=int(metric), object_type=int(otype))
    np.testing.assert_array_equal(t._prepare(rows), j._prepare(rows))
    assert t._prepare(rows).dtype == j._prepare(rows).dtype
    assert t.sparse == j.sparse and t.normalize == j.normalize
    t.batch_insert(rows)
    j.batch_insert(rows)
    np.testing.assert_array_equal(t._x, j._x)
    if metric == DT.SPARSE_JACCARD:
        ids = [[9, 3, 5], [1], [40, 2]]
        np.testing.assert_array_equal(pad_sparse(ids, d), j_pad_sparse(ids, d))
        np.testing.assert_array_equal(
            t.prepare_queries(pad_sparse(ids, d)).numpy(),
            np.asarray(j.prepare_queries(pad_sparse(ids, d))))
    else:
        qs = rng.normal(size=(6, d)).astype(np.float32) * 40.0
        qs[2] = 0.0           # a zero query keeps norm 1
        np.testing.assert_array_equal(t.prepare_queries_host(qs), j.prepare_queries_host(qs))
        np.testing.assert_array_equal(t.prepare_queries(qs).numpy(),
                                      np.asarray(j.prepare_queries(qs)))
    tx, tv, ts = t.device_arrays()
    jx, jv, js = j.device_arrays()
    assert str(tx.dtype).split(".")[-1] == str(jx.dtype)
    np.testing.assert_array_equal(tx.to(torch.float32).numpy(), np.asarray(jx, np.float32))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert (ts is None) == (js is None)
    if ts is not None:
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    if metric == DT.NORMALIZED_COSINE:
        with pytest.raises(ValueError, match="zero vector"):
            t.batch_insert(np.zeros((1, d), np.float32))


@pytest.mark.parametrize("metric", [DT.L2, DT.HAMMING, DT.SPARSE_JACCARD],
                         ids=["L2", "HAMMING", "SPARSE_JACCARD"])
def test_store_remove_matches_jax(metric):
    rng = np.random.default_rng(6)
    d = 16
    rows = metric_rows(metric, 12, d, rng)
    otype = OT.UINT8 if metric == DT.HAMMING else OT.FLOAT
    t = TStore(d, metric=metric, object_type=otype, device="cpu")
    j = JStore(d, metric=int(metric), object_type=int(otype))
    t.batch_insert(rows)
    j.batch_insert(rows)
    before = t.mutation_count
    for oid in (3, 7):
        t.remove(oid)
        j.remove(oid)
    assert t.mutation_count == j.mutation_count == before + 2
    assert not t.contains(3) and t.contains(4) and not t.contains(0)
    np.testing.assert_array_equal(t._x, j._x)
    np.testing.assert_array_equal(t._valid, j._valid)
    with pytest.raises(KeyError):
        t.remove(3)
    with pytest.raises(KeyError):
        t.get(7)
    # freed slots are reused lowest first
    np.testing.assert_array_equal(t.batch_insert(rows[:3]), j.batch_insert(rows[:3]))
    np.testing.assert_array_equal(t._x, j._x)
    assert len(t) == len(j) == 13


@pytest.mark.parametrize("metric", METRICS, ids=[m.name for m in METRICS])
def test_linear_search_matches_jax(metric):
    """Exact top-k over 700 rows (90 dead) in blocks of 256: the block
    size does not change the result."""
    rng = np.random.default_rng(int(metric) + 40)
    n, d, k = 700, 24, 10
    x = padded(metric, metric_rows(metric, n, d, rng))
    q = padded(metric, metric_rows(metric, 25, d, rng))
    valid = rng.random(n) > 0.13
    x_sq = np.array(JD.sq_norms(jnp.asarray(x)))
    ji, jd = JB.linear_search(jnp.asarray(q), jnp.asarray(x), jnp.asarray(valid),
                              int(metric), k, x_sqnorm=jnp.asarray(x_sq))
    for block in (256, 65536):
        ti, td = TB.linear_search(torch.from_numpy(q), torch.from_numpy(x),
                                  torch.from_numpy(valid), metric, k,
                                  x_sqnorm=torch.from_numpy(x_sq), block=block)
        assert_dist_close(metric, td.numpy(), jd)
        assert_ids_match(ti.numpy(), td.numpy(), ji, jd)


def test_linear_search_blocks_are_sized_by_bytes():
    """Broadcast-heavy metrics take smaller blocks, never fewer than 128
    rows and never more than asked."""
    assert TB.block_rows(DT.L2, 8, 128) == 65536
    assert TB.block_rows(DT.L2, 4096, 128) < 65536
    assert TB.block_rows(DT.L2, 1 << 20, 128) == 128
    assert TB.block_rows(DT.HAMMING, 2048, 128) < TB.block_rows(DT.L2, 2048, 128)
    assert TB.block_rows(DT.L1, 16, 128, block=300) == 300
    assert TB.block_rows(DT.L2, 256, 128) % 128 == 0


def test_sparse_jaccard_routes_agree(monkeypatch):
    """The indicator matmul and the searchsorted lookup (taken when the
    indicator rows would pass the byte budget) give the same distances,
    equal to the reference's."""
    rng = np.random.default_rng(9)
    q = padded(DT.SPARSE_JACCARD, metric_rows(DT.SPARSE_JACCARD, 40, 24, rng))
    x = padded(DT.SPARSE_JACCARD, metric_rows(DT.SPARSE_JACCARD, 300, 24, rng))
    want = np.asarray(JD.pairwise(DT.SPARSE_JACCARD, jnp.asarray(q), jnp.asarray(x)))
    tq, tx = torch.from_numpy(q), torch.from_numpy(x)
    np.testing.assert_array_equal(TD.pairwise(DT.SPARSE_JACCARD, tq, tx).numpy(), want)
    monkeypatch.setattr(TD, "_BLOCK_BYTES", 1000)   # one query per lookup block
    np.testing.assert_array_equal(TD.pairwise(DT.SPARSE_JACCARD, tq, tx).numpy(), want)


def test_fast_knn_l2_matches_jax():
    rng = np.random.default_rng(8)
    x = padded(DT.L2, rng.normal(size=(900, 40)).astype(np.float32))
    q = padded(DT.L2, rng.normal(size=(30, 40)).astype(np.float32))
    valid = rng.random(900) > 0.1
    sq = (x * x).sum(1)
    ji, jd = JB.fast_knn_l2(jnp.asarray(q), jnp.asarray(x), jnp.asarray(valid),
                            jnp.asarray(sq), k=10, block=256)
    ti, td = TB.fast_knn_l2(torch.from_numpy(q), torch.from_numpy(x),
                            torch.from_numpy(valid), torch.from_numpy(sq), k=10, block=256)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5)
    assert_ids_match(ti.numpy(), td.numpy(), ji, jd)
    # exact over its candidates: equal to the exact linear search here
    li, _ = TB.linear_search(torch.from_numpy(q), torch.from_numpy(x),
                             torch.from_numpy(valid), DT.L2, 10)
    np.testing.assert_array_equal(ti.numpy(), li.numpy())


def test_sqrt_is_correctly_rounded_as_jax():
    """``TD.sqrt`` on the CPU equals numpy's and XLA's float32 root bit for
    bit, including the inputs torch's own CPU root rounds one ulp off
    (65.406425 = sqrt(4278), where torch gives 65.40642)."""
    v = np.random.default_rng(0).random(1 << 16).astype(np.float32) * 1e4
    v[:3] = [4278.0, 0.0, 1e-30]
    got = TD.sqrt(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, np.sqrt(v))
    np.testing.assert_array_equal(got, np.asarray(jnp.sqrt(jnp.asarray(v))))
    assert got.dtype == np.float32 and got[0] == np.float32(65.406425)
