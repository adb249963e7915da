"""Entry points of the port: a single-device search check and a
multi-shard dry run (the counterparts of the repository's
``__graft_entry__.py``, on ``torch`` and the port's ``parallel`` package).

    python -c "from ngt_tpu_torch.graft_entry import dryrun_multichip; \\
               dryrun_multichip(8, device='cpu')"

Both run on ``cuda`` unless the caller asks for the CPU.  On one card the
shards of ``dryrun_multichip`` share it (``make_mesh`` lays them out
round-robin over the visible devices).
"""

from __future__ import annotations

import numpy as np
import torch


def _toy_index(n=512, dim=128, e=16, seed=0):
    """(rows, exact e-NN adjacency sorted by distance, its distances,
    validity) of ``n`` normal rows."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    d = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    nbr = np.argsort(d, axis=1)[:, :e].astype(np.int32)
    nbr_d = np.sqrt(np.take_along_axis(d, nbr, axis=1)).astype(np.float32)
    valid = np.ones(n, bool)
    return x, nbr, nbr_d, valid


def _sync(t: torch.Tensor) -> None:
    """Wait for the device that holds ``t`` (the result is then computed,
    not only queued)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def entry(device="cuda"):
    """(fn, example_args): the batched k-NN graph search of the ANNG index
    on a 512-row toy graph; ``fn(*args)`` returns (ids [32, 10] int32,
    distances [32, 10] float32), the args lie on ``device``."""
    from ngt_tpu_torch.graph.search import graph_search
    from ngt_tpu_torch.properties import DistanceType

    n, dim, b, s, k = 512, 128, 32, 8, 10
    x, nbr, _, valid = _toy_index(n, dim)
    rng = np.random.default_rng(1)
    q = rng.normal(size=(b, dim)).astype(np.float32)
    seeds = rng.integers(0, n, size=(b, s)).astype(np.int32)

    def fn(x, nbr, valid, q, seeds):
        res = graph_search(
            x, nbr, valid, q, seeds,
            metric=DistanceType.L2, k=k, epsilon=0.1, width=32,
            max_iters=128, hash_bits=10, exact_hash=True,
        )
        return res.ids, res.dists

    dev = torch.device(device)
    args = tuple(torch.from_numpy(a).to(dev) for a in (x, nbr, valid, q, seeds))
    return fn, args


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run one full sharded index step over an ``n_devices``-shard mesh:
    search over the object-sharded graph with the top-k merge, the build
    step that writes owned object and adjacency rows, the sharded
    quantized-graph search and the sharded IVFPQ search; prints one
    ``dryrun_multichip ok: ...`` line of the result shapes."""
    from ngt_tpu_torch.parallel.sharded_ivfpq import ShardedIVFPQ
    from ngt_tpu_torch.parallel.sharding import (
        ShardedGraphIndex,
        ShardedQG,
        make_mesh,
        make_sharded_build_step,
        shard_host_index,
    )
    from ngt_tpu_torch.properties import DistanceType
    from ngt_tpu_torch.quant.ivfpq import IVFPQIndex

    p = n_devices
    n, dim, e, k, b = 64 * p, 128, 8, 4, 8
    x, nbr, nbr_d, valid = _toy_index(n, dim, e)
    x_s, nbr_s, nbrd_s, val_s, n_local = shard_host_index(
        x, nbr, valid, p, nbr_dist_host=nbr_d
    )

    mesh = make_mesh(p, device)
    sidx = ShardedGraphIndex(
        mesh, x_s, nbr_s, val_s,
        seed_ids_local=np.arange(4, dtype=np.int32),
        metric=DistanceType.L2,
        nbr_dist_shards=nbrd_s,
    )
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.normal(size=(b, dim)).astype(np.float32)).to(mesh.home)
    ids, dists = sidx.search(q, k=k, epsilon=0.1, width=16)
    _sync(ids)
    assert ids.shape == (b, k)

    # one build step: insert a batch of new vectors into the shards
    step = make_sharded_build_step(mesh, DistanceType.L2, k, n_local, width=16)
    newx = torch.from_numpy(rng.normal(size=(b, x_s.shape[2])).astype(np.float32))
    # host id allocator: new ids round-robin in the shards' tail slots
    new_gids = torch.from_numpy(
        np.array([s * n_local + (n_local - 1 - i // p) for i, s in
                  enumerate(np.arange(b) % p)], dtype=np.int32)
    )
    out = step(sidx.x, sidx.nbr, sidx.nbr_dist, sidx.valid, newx, new_gids,
               sidx.seed_ids_local)
    _sync(out.new_neighbor_ids)
    assert out.x.shape == (p * n_local, x_s.shape[2])

    # the sharded quantized graph: sq8 codes and neighbor blocks sharded
    # object-wise, local traversal and exact re-rank, one top-k merge
    qg = ShardedQG(
        mesh, x_s, nbr_s, val_s,
        seed_ids_local=np.arange(4, dtype=np.int32),
        metric=DistanceType.L2,
    )
    qg_ids, qg_d = qg.search(q, k=k, epsilon=0.1, result_expansion=3.0)
    _sync(qg_ids)
    assert qg_ids.shape == (b, k)

    # the sharded IVF+PQ index: buckets and raw rows over the same mesh
    qidx = IVFPQIndex(dimension=dim, n_centroids=16, dsub=2, ksub=16,
                      raw_store="host", device=mesh.home)
    qidx.batch_insert(x)
    qidx.build(kmeans_iters=4)
    sq = ShardedIVFPQ(mesh, qidx)
    qids, qdists = sq.batch_search(q.cpu().numpy(), size=k, nprobe=4)
    assert qids.shape == (b, k)
    print(f"dryrun_multichip ok: {p} devices, search {tuple(ids.shape)}, "
          f"build-step neighbors {tuple(out.new_neighbor_ids.shape)}, "
          f"sharded-qg {tuple(qg_ids.shape)}, sharded-ivfpq {qids.shape}")
