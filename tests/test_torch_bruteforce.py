"""The port's brute-force k-NN (ngt_tpu_torch/ops/bruteforce.py) against the
JAX package on the same numpy inputs, on the CPU.

``fast_knn_l2_bulk``: both routes.  The window route is forced at n = 4096
(JAX runs its Pallas scan in interpret mode there).  Tolerances: the ids of
>= 99.9% of rows equal, and distances within 1e-5 relative (a rounding flip
of a centered bf16 value is the only allowed difference; the re-rank is
exact f32 on both sides).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngt_tpu.ops import bruteforce as JBF
from ngt_tpu.properties import DistanceType as JDT
from ngt_tpu_torch.ops import bruteforce as TBF
from ngt_tpu_torch.properties import DistanceType


def _store_like(rng, n, d):
    """Rows as a store holds them: slot 0 a dummy, a few removed slots."""
    x = (rng.standard_normal((n, d)) * 20 + 50).astype(np.float32)
    valid = np.ones(n, bool)
    valid[0] = False
    valid[300:340] = False
    x[~valid] = 0
    return x, valid, (x ** 2).sum(1).astype(np.float32)


@pytest.mark.parametrize("route", ["blocked", "window"])
def test_fast_knn_l2_bulk_matches_jax(route):
    rng = np.random.default_rng(5)
    n, d, k, b = 4096, 128, 11, 256
    x, valid, sq = _store_like(rng, n, d)
    q_ids = np.arange(1, b + 1, dtype=np.int32)
    ji, jd = JBF.fast_knn_l2_bulk(
        jnp.asarray(q_ids), jnp.asarray(x), jnp.asarray(valid), jnp.asarray(sq),
        k=k, kc=2 * k, qblock=b, bf16_tile=True,
        scan_impl="pallas" if route == "window" else "xla",
    )
    ti, td = TBF.fast_knn_l2_bulk(
        torch.from_numpy(q_ids), torch.from_numpy(x), torch.from_numpy(valid),
        torch.from_numpy(sq), k=k, kc=2 * k, qblock=b, scan_impl=route,
    )
    ji, jd, ti, td = np.asarray(ji), np.asarray(jd), ti.numpy(), td.numpy()
    assert ti.shape == (b, k) and ti.dtype == np.int32
    assert (ti == ji).all(axis=1).mean() >= 0.999
    same = ti == ji
    np.testing.assert_allclose(td[same], jd[same], rtol=1e-5, atol=1e-5)
    assert (ti[:, 0] == q_ids).all()            # each row finds itself
    assert not np.isin(ti, np.arange(300, 340)).any()


def test_fast_knn_l2_bulk_blocked_gist_width_matches_jax():
    """The blocked route at a padded row width of 1,024 (960-wide rows, the
    gist-960 arm's, past the window kernel's 512), over several corpus
    blocks and query blocks, with the build's k + 1 and kc = 2(k + 1)."""
    rng = np.random.default_rng(11)
    n, d, d_pad, k, b = 384, 960, 1024, 41, 192
    x, valid, _ = _store_like(rng, n, d)
    x = np.pad(x, ((0, 0), (0, d_pad - d)))
    sq = (x ** 2).sum(1).astype(np.float32)
    q_ids = np.arange(1, b + 1, dtype=np.int32)
    kw = dict(k=k, kc=2 * k, qblock=96, block=128)
    ji, jd = JBF.fast_knn_l2_bulk(
        jnp.asarray(q_ids), jnp.asarray(x), jnp.asarray(valid), jnp.asarray(sq),
        bf16_tile=True, scan_impl="xla", **kw,
    )
    ti, td = TBF.fast_knn_l2_bulk(
        torch.from_numpy(q_ids), torch.from_numpy(x), torch.from_numpy(valid),
        torch.from_numpy(sq), scan_impl="blocked", **kw,
    )
    ji, jd, ti, td = np.asarray(ji), np.asarray(jd), ti.numpy(), td.numpy()
    assert ti.shape == (b, k)
    assert (ti == ji).all(axis=1).mean() >= 0.999
    same = ti == ji
    np.testing.assert_allclose(td[same], jd[same], rtol=1e-5, atol=1e-5)
    assert (ti[:, 0] == q_ids).all()
    assert not np.isin(ti, np.arange(300, 340)).any()


def test_linear_search_matches_jax():
    rng = np.random.default_rng(9)
    x, valid, sq = _store_like(rng, 3000, 128)
    q = (rng.standard_normal((40, 128)) * 20 + 50).astype(np.float32)
    ji, jd = JBF.linear_search(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(valid), JDT.L2, 10,
        x_sqnorm=jnp.asarray(sq), block=1024,
    )
    ti, td = TBF.linear_search(
        torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(valid),
        DistanceType.L2, 10, x_sqnorm=torch.from_numpy(sq), block=1024,
    )
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5)


def test_recall_at_k_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.integers(-1, 50, (30, 10))
    b = rng.integers(-1, 50, (30, 10))
    assert TBF.recall_at_k(a, b, 10) == JBF.recall_at_k(a, b, 10)
