"""The port's k-means (ngt_tpu_torch/quant/clustering.py), product
quantizer (quant/pq.py) and k-means seeds (Seeder.finalize_kmeans,
Index.optimize_seeds) against the JAX package on the CPU.

* Lloyd iterations from one init (the "head" mode, x[:k], in both
  packages; the port's ``init=`` gives the same result): centroids to 1e-5
  relative, assignments equal.  The reference draws its random inits from
  ``jax.random``, which torch cannot reproduce, so its seeded k-means is
  held by MSE: the port's within 2% of the reference's.
* With the reference's fitted codebooks carried across: codes equal,
  pack/unpack byte for byte, lookup tables and both ADC scorers to 1e-5
  relative (only the order of the M-sum differs).
* ``optimize_seeds`` on every metric: live reps, a power-of-two rep array,
  ``verify() == []``; Hamming and the Jaccard metrics keep their sampled
  reps, as the reference's do.
"""

import numpy as np
import pytest
import torch

import ngt_tpu_torch
from ngt_tpu.quant import clustering as JC
from ngt_tpu.quant import pq as JP
from ngt_tpu_torch.quant import clustering as TC
from ngt_tpu_torch.quant import pq as TP
from test_torch_metrics import CONFIGS, DIM, corpus


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("kind", ["single", "masked", "multi"])
def test_lloyd_matches_jax(kind):
    """The same init (the first k rows) gives the reference's centroids and
    assignments after 10 Lloyd iterations."""
    rng = np.random.default_rng(3)
    k = 24
    if kind == "multi":
        xs = rng.normal(size=(6, 700, 2)).astype(np.float32)
        jc, ja = JC.kmeans_multi(xs, k, iters=10, mode="head")
        tc, ta = TC.kmeans_multi(xs, k, iters=10, mode="head", device="cpu")
        ic, ia = TC.kmeans_multi(xs, k, iters=10, init=xs[:, :k], device="cpu")
    else:
        x = (rng.normal(size=(12, 8))[rng.integers(0, 12, 1500)]
             + 0.3 * rng.normal(size=(1500, 8))).astype(np.float32)
        valid = rng.random(1500) > 0.2 if kind == "masked" else None
        jc, ja = JC.kmeans(x, k, iters=10, mode="head", valid=valid)
        tc, ta = TC.kmeans(x, k, iters=10, mode="head", valid=valid, device="cpu")
        ic, ia = TC.kmeans(x, k, iters=10, valid=valid, init=x[:k], device="cpu")
    assert _rel(tc, jc) <= 1e-5
    np.testing.assert_array_equal(ta, np.asarray(ja))
    np.testing.assert_array_equal(ic, tc)
    np.testing.assert_array_equal(ia, ta)


def test_kmeans_separable_matches_jax_mse(rng):
    """tests/test_quant.py::test_kmeans_separable's data: the port's own
    seeded k-means++ reaches the reference's MSE within 2% and recovers the
    four blobs."""
    centers = np.array([[0, 0], [10, 0], [0, 10], [10, 10]], np.float32)
    x = np.concatenate(
        [c + rng.normal(scale=0.3, size=(50, 2)).astype(np.float32) for c in centers])
    jc, ja = JC.kmeans(x, 4, iters=20)
    tc, ta = TC.kmeans(x, 4, iters=20, device="cpu")
    jm = JC.mean_squared_error(x, jc, ja)
    tm = TC.mean_squared_error(x, tc, ta)
    assert tm <= 1.02 * jm, (tm, jm)
    for blob in range(4):
        assert len(set(ta[blob * 50 : (blob + 1) * 50].tolist())) == 1
    # every init mode draws on the host: a fixed seed repeats itself
    for mode in ("random", "kmeans++"):
        a = TC.kmeans(x, 4, iters=3, mode=mode, seed=5, device="cpu")[0]
        np.testing.assert_array_equal(a, TC.kmeans(x, 4, iters=3, mode=mode, seed=5,
                                                   device="cpu")[0])


@pytest.fixture(scope="module")
def fitted():
    rng = np.random.default_rng(8)
    x = (rng.normal(size=(20, 48))[rng.integers(0, 20, 1200)] * 2
         + rng.normal(size=(1200, 48))).astype(np.float32)
    q = rng.normal(size=(40, 48)).astype(np.float32) * 2
    jpq = JP.ProductQuantizer(48, dsub=2, ksub=16).fit(x)
    tpq = TP.ProductQuantizer.from_state(jpq.state_dict(), device="cpu")
    return x, q, jpq, tpq


def test_pq_codes_and_packing_match_jax(fitted):
    x, _, jpq, tpq = fitted
    jc, tc = jpq.encode(x), tpq.encode(x)
    assert tc.dtype == np.uint8 and tc.shape == (len(x), 24)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(tpq.decode(tc), jpq.decode(jc), rtol=0, atol=0)
    for m in (24, 9):
        codes = jc[:, :m]
        packed = TP.pack_codes4(codes)
        np.testing.assert_array_equal(packed, JP.pack_codes4(codes))
        np.testing.assert_array_equal(TP.unpack_codes4(packed, m), JP.unpack_codes4(packed, m))
        np.testing.assert_array_equal(TP.unpack_codes4(packed, m), codes)
    dev = TP.pack_codes4_dev(torch.from_numpy(jc.copy())).numpy()
    np.testing.assert_array_equal(dev, JP.pack_codes4(jc))


def test_pq_lut_and_adc_match_jax(fitted):
    x, q, jpq, tpq = fitted
    jl, tl = np.asarray(jpq.lut(q)), tpq.lut(q).numpy()
    assert tl.shape == (len(q), 24, 16)
    assert _rel(tl, jl) <= 1e-5
    codes = np.broadcast_to(jpq.encode(x[:300]), (len(q), 300, 24)).copy()
    lut = jl.reshape(len(q), -1).copy()   # writable, for torch.from_numpy
    ja = np.asarray(JP.adc_gathered(lut, codes))
    ta = TP.adc_gathered(torch.from_numpy(lut), torch.from_numpy(codes)).numpy()
    assert _rel(ta, ja) <= 1e-5
    packed = JP.pack_codes4(codes.reshape(-1, 24)).reshape(len(q), 300, 12)
    jp = np.asarray(JP.make_packed_scorer(24, 16)(lut, packed))
    tp = TP.make_packed_scorer(24, 16)(torch.from_numpy(lut), torch.from_numpy(packed)).numpy()
    assert _rel(tp, jp) <= 1e-5
    # ADC is the squared distance to the decoded row
    dec = tpq.decode(codes[0])
    np.testing.assert_allclose(ta[0], ((q[0] - dec) ** 2).sum(1), rtol=1e-4)


def test_pq_fit_quality_matches_jax(fitted):
    """The port's own codebooks (its k-means++ stream) reconstruct as well
    as the reference's, within 5%."""
    x, _, jpq, _ = fitted
    tpq = TP.ProductQuantizer(48, dsub=2, ksub=16, device="cpu").fit(x)
    np.testing.assert_array_equal(tpq.mean, jpq.mean)

    def err(pq):
        return float(((x - pq.decode(pq.encode(x))) ** 2).sum() / (x**2).sum())

    assert err(tpq) <= 1.05 * err(jpq), (err(tpq), err(jpq))


@pytest.mark.parametrize("metric,otype", CONFIGS, ids=[f"{m}-{o}" for m, o in CONFIGS])
def test_optimize_seeds_every_metric(metric, otype):
    rng = np.random.default_rng(sum(map(ord, metric + otype)) + 2)
    x = corpus(metric, rng, 600)
    t = ngt_tpu_torch.create(None, dimension=DIM, distance_type=metric, object_type=otype,
                             search_mode="exact", device="cpu")
    t.batch_insert(x, build=True)
    before = t.seeder.rep_ids.copy()
    t.optimize_seeds(num_reps=64)
    reps = t.seeder.rep_ids
    if metric in ("Hamming", "Jaccard", "Sparse Jaccard"):
        np.testing.assert_array_equal(reps, before)
    else:
        assert len(reps) == 64 and not np.array_equal(reps, before)
    assert t.store._valid[reps].all()
    assert t.verify() == []
    assert t.search(x[7], size=3)[0][0] == 7
