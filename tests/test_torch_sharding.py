"""The port's sharded index (ngt_tpu_torch/parallel/sharding.py) against
the JAX package's, on the CPU: the port's mesh holds 8 shards on the CPU
where the reference's holds the 8 virtual devices of tests/conftest.py.

* ``shard_host_index`` and ``build_local_knng_shards``: equal arrays;
* ``_sharded_search`` on the reference test's toy graph: ids equal,
  distances within 1e-5 (relative);
* ``_merge_reverse_edges`` on the reference test's cases and on random
  proposals with repeated targets: rows equal (atol 0);
* three build steps (the reference test's batches, slot 0 of every shard
  included): every ``BuildStepOut`` field equal, the searched distances
  within 1e-6 (relative: the two packages sum a row's squares in another
  order);
* ``ShardedIndex.build`` at P = 2 over 2 x 256 rows (one build per
  package for the module): every array equal (edge distances within 1e-6
  relative), ``batch_search`` ids equal and distances within 1e-5;
* ``ShardedQG`` for L2 and Cosine: codes and blocks byte-equal, ids equal,
  distances within 1e-5;
* each package opens the other's ``save`` and ``save_distributed``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngt_tpu.parallel import sharding as J
from ngt_tpu.properties import DistanceType as JDT
from ngt_tpu_torch.parallel import multihost as TM
from ngt_tpu_torch.parallel import sharding as T
from ngt_tpu_torch.properties import DistanceType as TDT

P = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU search runs many small ops; beside the suite's other
    workers a multi-threaded intra-op pool only contends for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _toy(n, dim, e, seed=0):
    """tests/test_sharding.py's toy graph: exact e-NN rows, sorted."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    d = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    nbr = np.argsort(d, axis=1)[:, :e].astype(np.int32)
    nbr_d = np.sqrt(np.take_along_axis(d, nbr, axis=1)).astype(np.float32)
    return x, nbr, nbr_d, np.ones(n, bool)


def _layout(n, dim, e, p=P, seed=0, knng=True):
    """The same shard layout from both packages' helpers, held equal."""
    x, nbr, nbr_d, valid = _toy(n, dim, e, seed)
    ref = J.shard_host_index(x, nbr, valid, p, nbr_d)
    got = T.shard_host_index(x, nbr, valid, p, nbr_d)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)
    x_s, nbr_s, nbrd_s, val_s, n_local = got
    if knng:
        rn, rd = J.build_local_knng_shards(x_s, val_s, e, JDT.L2)
        tn, td = T.build_local_knng_shards(x_s, val_s, e, TDT.L2)
        np.testing.assert_array_equal(rn, tn)
        np.testing.assert_allclose(rd, td, rtol=1e-6)
        nbr_s, nbrd_s = rn, rd   # both packages then search the same graph
    return x, x_s, nbr_s, nbrd_s, val_s, n_local


def _both(x_s, nbr_s, val_s, seeds, nbrd_s, p=P, metric="L2"):
    ref = J.ShardedGraphIndex(J.make_mesh(p), x_s, nbr_s, val_s, seeds,
                              JDT[metric], nbr_dist_shards=nbrd_s)
    got = T.ShardedGraphIndex(T.make_mesh(p, device="cpu"), x_s, nbr_s, val_s, seeds,
                              TDT[metric], nbr_dist_shards=nbrd_s)
    return ref, got


def test_make_mesh_places_shards():
    mesh = T.make_mesh(8, device="cpu")
    assert mesh.size == 8 and mesh.local_shards == list(range(8))
    assert mesh.world_size == 1 and mesh.group is None
    assert all(d == torch.device("cpu") for d in mesh.devices)
    with pytest.raises(ValueError):
        T.make_mesh(2, device="mps")


def test_sharded_search_matches_jax():
    x, x_s, nbr_s, nbrd_s, val_s, n_local = _layout(512, 32, 12)
    ref, got = _both(x_s, nbr_s, val_s, np.arange(8, dtype=np.int32), nbrd_s)
    q = np.random.default_rng(3).normal(size=(16, 32)).astype(np.float32)
    ri, rd = ref.search(jnp.asarray(q), k=10, epsilon=0.2, width=32)
    ti, td = got.search(torch.from_numpy(q), k=10, epsilon=0.2, width=32)
    np.testing.assert_array_equal(np.asarray(ri), ti.numpy())
    np.testing.assert_allclose(np.asarray(rd), td.numpy(), rtol=1e-5)
    # the global ids are shard * n_local + slot of the round-robin layout
    gid_of = (np.arange(len(x)) % P) * n_local + np.arange(len(x)) // P
    full = np.linalg.norm(q[:, None, :] - x[None, :, :], axis=-1)
    gt = gid_of[np.argsort(full, axis=1)[:, :10]]
    hits = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(ti.numpy(), gt))
    assert hits / gt.size >= 0.9


def _merge_case(seed):
    """Random distance-sorted rows and proposals with repeated targets,
    duplicates of existing edges and invalid entries."""
    rng = np.random.default_rng(seed)
    n, e, l = 24, 6, 90
    nbr = np.full((n, e), -1, np.int32)
    nbr_d = np.full((n, e), np.inf, np.float32)
    for r in range(n):
        deg = int(rng.integers(0, e + 1))
        nbr[r, :deg] = rng.choice(40, deg, replace=False)
        nbr_d[r, :deg] = np.sort(rng.integers(1, 9, deg)).astype(np.float32)
    tgt = rng.integers(0, n, l).astype(np.int32)
    tgt[:20] = 3                                  # one crowded target
    src = rng.integers(0, 40, l).astype(np.int32)
    d = rng.integers(1, 9, l).astype(np.float32)  # integral: ties in d
    ok = rng.random(l) > 0.15
    return nbr, nbr_d, tgt, src, d, ok


@pytest.mark.parametrize("case", ["reference", 1, 2])
def test_merge_reverse_edges_matches_jax(case):
    if case == "reference":   # tests/test_sharding.py:147
        nbr = np.array([[1, 2, -1, -1], [0, 3, 5, 7], [-1, -1, -1, -1]], np.int32)
        nbr_d = np.array([[1.0, 2.0, np.inf, np.inf], [1.0, 2.0, 3.0, 4.0],
                          [np.inf] * 4], np.float32)
        tgt = np.array([0, 0, 1, 2, 2], np.int32)
        src = np.array([9, 2, 9, 4, 6], np.int32)
        d = np.array([1.5, 0.5, 2.5, 1.0, 0.5], np.float32)
        ok = np.ones(5, bool)
    else:
        nbr, nbr_d, tgt, src, d, ok = _merge_case(case)
    ri, rd = J._merge_reverse_edges(*(jnp.asarray(a) for a in (nbr, nbr_d, tgt, src, d, ok)))
    ti, td = T._merge_reverse_edges(*(torch.from_numpy(a) for a in (nbr, nbr_d, tgt, src, d, ok)))
    np.testing.assert_array_equal(np.asarray(ri), ti.numpy())
    np.testing.assert_array_equal(np.asarray(rd), td.numpy())
    if case == "reference":
        np.testing.assert_array_equal(ti.numpy()[1], [0, 3, 9, 5])


def _host(a):
    return a.numpy() if isinstance(a, T.ShardedArray) else np.asarray(a)


def test_build_steps_match_jax():
    """tests/test_sharding.py:69-145's three steps, the last onto local
    slot 0 of every shard: every output field equal."""
    _, x_s, nbr_s, nbrd_s, val_s, n_local = _layout(64 * P, 32, 8, knng=False)
    ref, got = _both(x_s, nbr_s, val_s, np.arange(4, dtype=np.int32), nbrd_s)
    rstep = J.make_sharded_build_step(J.make_mesh(P), JDT.L2, 4, n_local, width=16)
    tstep = T.make_sharded_build_step(T.make_mesh(P, device="cpu"), TDT.L2, 4, n_local, width=16)
    rng = np.random.default_rng(4)
    b = 8
    batches = []
    for off in (1, 2):
        newx = rng.normal(size=(b, x_s.shape[2])).astype(np.float32)
        gids = np.array([s * n_local + (n_local - off - i // P)
                         for i, s in enumerate(np.arange(b) % P)], np.int32)
        batches.append((newx, gids))
    batches.append((rng.normal(size=(P, x_s.shape[2])).astype(np.float32),
                    np.arange(P, dtype=np.int32) * n_local))
    rs = (ref.x, ref.nbr, ref.nbr_dist, ref.valid)
    ts = (got.x, got.nbr, got.nbr_dist, got.valid)
    for newx, gids in batches:
        rout = rstep(*rs, jnp.asarray(newx), jnp.asarray(gids), ref.seed_ids_local)
        tout = tstep(*ts, newx, gids, got.seed_ids_local)
        for name in T.BuildStepOut._fields:
            want, have = np.asarray(getattr(rout, name)), _host(getattr(tout, name))
            if want.dtype == np.float32 and name != "x":   # searched distances
                np.testing.assert_allclose(want, have, rtol=1e-6, err_msg=name)
            else:
                np.testing.assert_array_equal(want, have, err_msg=name)
        rs, ts = rout[:4], tout[:4]
    v = ts[3].numpy()
    assert v[batches[2][1]].all(), "slot-0 insert lost"


def test_shard_loading_helpers():
    mesh = TM.make_global_mesh(8, device="cpu")
    assert TM.initialize() is False
    assert TM.process_shard_slices(mesh) == {0: list(range(8))}
    local = np.stack([np.full((4, 8), i, np.float32) for i in range(8)])
    arr = TM.local_shard_array(mesh, (32, 8), local)
    np.testing.assert_array_equal(arr.numpy().reshape(8, 4, 8), local)


# ------------------------------------------------- ShardedIndex at P = 2 ----


@pytest.fixture(scope="module")
def built():
    """One ShardedIndex.build per package over the same 2 x 256 rows."""
    import ngt_tpu.parallel.sharding as JS

    rng = np.random.default_rng(13)
    data = rng.normal(size=(512, 24)).astype(np.float32)
    queries = rng.normal(size=(16, 24)).astype(np.float32)
    ref = JS.ShardedIndex.build(data, mesh=J.make_mesh(2), metric=JDT.L2)
    got = T.ShardedIndex.build(data, mesh=T.make_mesh(2, device="cpu"), metric=TDT.L2)
    return data, queries, ref, got


def _arrays(sidx, port):
    s = sidx._sharded
    conv = _host if port else np.asarray
    return {"x": conv(s.x), "nbr": conv(s.nbr), "nbr_dist": conv(s.nbr_dist),
            "valid": conv(s.valid), "seeds": conv(s.seed_ids_local).reshape(2, -1),
            "id_map": sidx.id_map}


def test_sharded_index_build_matches_jax(built):
    data, queries, ref, got = built
    ra, ta = _arrays(ref, False), _arrays(got, True)
    for key in ra:
        if key == "nbr_dist":   # the builds' distances: another summation order
            np.testing.assert_allclose(ra[key], ta[key], rtol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(ra[key], ta[key], err_msg=key)
    ri, rd = ref.batch_search(queries, size=10, epsilon=0.2)
    ti, td = got.batch_search(queries, size=10, epsilon=0.2)
    np.testing.assert_array_equal(ri, ti)
    np.testing.assert_allclose(rd, td, rtol=1e-5)
    assert (got.batch_search(data[:4], size=1, epsilon=0.2)[0][:, 0] == np.arange(4)).all()


def test_sharded_qg_from_index_matches_jax(built):
    _, queries, ref, got = built
    rq = J.ShardedQG.from_sharded_index(ref)
    tq = T.ShardedQG.from_sharded_index(got)
    _check_qg(rq, tq, queries)


@pytest.mark.parametrize("metric", ["L2", "COSINE"])
def test_sharded_qg_matches_jax(metric):
    x, x_s, nbr_s, nbrd_s, val_s, n_local = _layout(512, 32, 12)
    val_s[3, -5:] = False   # dead rows: code 0, never a block entry's source
    seeds = np.tile(np.arange(8, dtype=np.int32), (P, 1))
    rq = J.ShardedQG(J.make_mesh(P), x_s, nbr_s, val_s, seeds, JDT[metric], block_edges=8)
    tq = T.ShardedQG(T.make_mesh(P, device="cpu"), x_s, nbr_s, val_s, seeds, TDT[metric],
                     block_edges=8)
    q = np.random.default_rng(5).normal(size=(16, 32)).astype(np.float32)
    _check_qg(rq, tq, q)


def _check_qg(rq, tq, queries):
    assert rq.sq_scale == tq.sq_scale
    np.testing.assert_array_equal(np.asarray(rq.codes), tq.codes.numpy())
    np.testing.assert_array_equal(np.asarray(rq.blocks), tq.blocks.numpy())
    d_pad = tq.x.shape[1]
    qq = np.zeros((len(queries), d_pad), np.float32)
    qq[:, : queries.shape[1]] = queries
    ri, rd = rq.search(jnp.asarray(qq), k=10, epsilon=0.1)
    ti, td = tq.search(torch.from_numpy(qq), k=10, epsilon=0.1)
    np.testing.assert_array_equal(np.asarray(ri), ti.numpy())
    np.testing.assert_allclose(np.asarray(rd), td.numpy(), rtol=1e-5)


@pytest.mark.parametrize("layout", ["save", "save_distributed"])
def test_each_package_opens_the_others_save(built, tmp_path, layout):
    _, queries, ref, got = built
    opener = {"save": "open", "save_distributed": "open_distributed"}[layout]
    getattr(ref, layout)(str(tmp_path / "ref"))
    getattr(got, layout)(str(tmp_path / "port"))
    if layout == "save_distributed":
        assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "ref"))
    t_of_r = getattr(T.ShardedIndex, opener)(str(tmp_path / "ref"), T.make_mesh(2, device="cpu"))
    r_of_t = getattr(J.ShardedIndex, opener)(str(tmp_path / "port"), J.make_mesh(2))
    want_i, want_d = ref.batch_search(queries, size=5, epsilon=0.15)
    for sidx in (t_of_r, r_of_t, got):
        ids, dists = sidx.batch_search(queries, size=5, epsilon=0.15)
        np.testing.assert_array_equal(ids, want_i)
        np.testing.assert_allclose(dists, want_d, rtol=1e-5)
