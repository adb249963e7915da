"""The port's mesh-sharded IVF+PQ (ngt_tpu_torch/parallel/sharded_ivfpq.py)
against the JAX package's on the CPU, 8 shards each: one reference
``IVFPQIndex`` (4,000 x 32 rows, 32 centroids, dsub 2, ksub 16) carried
into the port by ``convert``, so both shard the same lists.  Shard loads
and ``memory_report`` equal; ids equal and distances within 1e-5
(relative: both refine exactly, with another summation order); the
distances are the exact metric distances of the returned rows (1e-4
relative against numpy), and the sharded recall is at least the
single-device search's."""

import numpy as np
import pytest
import torch

from ngt_tpu.parallel.sharded_ivfpq import ShardedIVFPQ as JShardedIVFPQ
from ngt_tpu.parallel.sharding import make_mesh as j_make_mesh
from ngt_tpu.quant.ivfpq import IVFPQIndex as JIVF
from ngt_tpu_torch import convert
from ngt_tpu_torch.parallel.sharded_ivfpq import ShardedIVFPQ
from ngt_tpu_torch.parallel.sharding import make_mesh

P = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(64, 32)).astype(np.float32) * 8
    x = centers[rng.integers(0, 64, size=4000)] + rng.normal(size=(4000, 32)).astype(np.float32)
    q = centers[rng.integers(0, 64, size=48)] + rng.normal(size=(48, 32)).astype(np.float32)
    ref = JIVF(dimension=32, n_centroids=32, dsub=2, ksub=16, raw_store="host")
    ref.batch_insert(x)
    ref.build(kmeans_iters=8)
    port = convert.ivfpq_from_state(device="cpu", **convert.ivfpq_state(ref))
    return x, q, ref, JShardedIVFPQ(j_make_mesh(P), ref), \
        ShardedIVFPQ(make_mesh(P, device="cpu"), port), port


def test_shard_layout_matches_jax(built):
    _, _, ref, jsh, tsh, _ = built
    np.testing.assert_array_equal(jsh.shard_loads, tsh.shard_loads)
    assert jsh.memory_report() == tsh.memory_report()
    rep = tsh.memory_report()
    loads = np.array(rep["shard_loads"])
    assert loads.sum() == ref.size and loads.max() <= 2 * loads.mean()
    assert (jsh.nb, jsh.bc) == (tsh.nb, tsh.bc) and jsh.scale == tsh.scale


@pytest.mark.parametrize("size,nprobe,expansion", [(10, 16, 20.0), (5, 4, 3.0)])
def test_sharded_search_matches_jax(built, size, nprobe, expansion):
    x, q, _, jsh, tsh, port = built
    ri, rd = jsh.batch_search(q, size=size, nprobe=nprobe, result_expansion=expansion)
    ti, td = tsh.batch_search(q, size=size, nprobe=nprobe, result_expansion=expansion)
    np.testing.assert_array_equal(np.asarray(ri), ti)
    np.testing.assert_allclose(np.asarray(rd), td, rtol=1e-5)
    ok = ti >= 0
    true = np.linalg.norm(q[:, None, :] - x[np.where(ok, ti, 0)], axis=-1)
    np.testing.assert_allclose(td[ok], true[ok], rtol=1e-4)
    # union-of-shards candidates >= the single-device candidates
    d = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    gt = np.argsort(d, axis=1, kind="stable")[:, :size]
    single = port.batch_search(q, size=size, nprobe=nprobe, result_expansion=expansion)[0]
    rec = lambda ids: sum(len(set(a[a >= 0].tolist()) & set(b.tolist()))
                          for a, b in zip(ids, gt)) / gt.size
    assert rec(ti) >= rec(single) - 1e-9
