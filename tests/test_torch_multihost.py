"""Two real ranks of the port's sharded index on the CPU: two worker
processes (tests/torch_multihost_worker.py) join one gloo group through a
file store, each owns 4 of 8 shards of a layout the JAX package saved with
``save_distributed``, reads only its own shard files, and must return the
reference's single-process ``batch_search`` ids (equal) and distances
(within 1e-5 relative) with the merge crossing the process boundary.  The
layout the two ranks write back opens in one process with the same ids.
``initialize()`` without arguments or environment does nothing."""

import os
import subprocess
import sys

import numpy as np
import pytest

from ngt_tpu.parallel import sharding as J
from ngt_tpu.properties import DistanceType as JDT
from ngt_tpu_torch.parallel import multihost as TM
from ngt_tpu_torch.parallel.sharding import ShardedIndex, make_mesh

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_multihost_worker.py")


def _reference_layout(path):
    """A reference ShardedIndex over 800 x 16 rows at 8 shards (exact
    per-shard KNNGs, round-robin), saved with save_distributed."""
    rng = np.random.default_rng(29)
    data = rng.normal(size=(800, 16)).astype(np.float32)
    queries = rng.normal(size=(8, 16)).astype(np.float32)
    xp = np.zeros((800, 128), np.float32)
    xp[:, :16] = data
    nbr = np.full((800, 1), -1, np.int32)
    x_s, _, _, val_s, n_local = J.shard_host_index(xp, nbr, np.ones(800, bool), 8)
    nbr_s, nbrd_s = J.build_local_knng_shards(x_s, val_s, 10, JDT.L2)
    mesh = J.make_mesh(8)
    sgi = J.ShardedGraphIndex(mesh, x_s, nbr_s, val_s, np.arange(8, dtype=np.int32),
                              JDT.L2, nbr_dist_shards=nbrd_s)
    id_map = np.full(8 * n_local, -1, np.int64)
    rows = np.arange(800)
    id_map[(rows % 8) * n_local + rows // 8] = rows
    ref = J.ShardedIndex(mesh, sgi, id_map)
    ref.save_distributed(path)
    return ref, queries


def test_two_ranks_open_the_references_layout(tmp_path):
    ipath = str(tmp_path / "dist_idx")
    ref, queries = _reference_layout(ipath)
    ids, dists = ref.batch_search(queries, size=5, epsilon=0.15)
    epath = str(tmp_path / "expected.npz")
    np.savez(epath, queries=queries, ids=ids, dists=dists, size=5, epsilon=0.15)
    out = str(tmp_path / "written")
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen([sys.executable, WORKER, str(tmp_path / "store"), "2", str(r),
                          ipath, epath, out],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for r in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0].decode())
    finally:
        for p in procs:   # a hung rendezvous must not leak workers
            if p.poll() is None:
                p.kill()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{text[-3000:]}"
        assert f"TORCH_MULTIHOST_OK rank={r} world=2 shards=8" in text, text[-1000:]
    assert sorted(os.listdir(out)) == sorted(os.listdir(ipath))
    again = ShardedIndex.open_distributed(out, make_mesh(8, device="cpu"))
    ids2, dists2 = again.batch_search(queries, size=5, epsilon=0.15)
    np.testing.assert_array_equal(ids2, ids)
    np.testing.assert_allclose(dists2, dists, rtol=1e-5)


def test_initialize_without_environment_is_a_no_op(monkeypatch):
    import torch.distributed as dist

    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert TM.initialize(device="cpu") is False
    assert not dist.is_initialized()
    mesh = TM.make_global_mesh(4, device="cpu")
    assert mesh.world_size == 1 and TM.process_shard_slices(mesh) == {0: [0, 1, 2, 3]}
    with pytest.raises(ValueError):
        TM.initialize("127.0.0.1:1", None, 0, device="cpu")
