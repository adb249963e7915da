"""Distributed (mesh-sharded) index sample (the port's copy of
samples/sharded_search.py): the vald deployment (objects sharded across
agents, per-shard graphs, a top-k merge; NGT's README.md:30,97) over a mesh
of devices.

In one process the shards share the visible devices: on one card
``make_mesh(2)`` puts both shards on cuda:0, and ``--device cpu`` puts
them on the CPU.  Across processes (torchrun sets MASTER_ADDR, MASTER_PORT,
WORLD_SIZE and RANK) ``multihost.initialize`` joins the group, each rank
builds only its own shards, and the merge is an all_gather over NCCL (CUDA)
or gloo (CPU); nothing else changes.

Run:  python samples/torch/sharded_search.py [--device cuda] [--shards 2]
      torchrun --nproc-per-node 2 samples/torch/sharded_search.py --device cpu --shards 8
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

from ngt_tpu_torch.ops.bruteforce import recall_at_k  # noqa: E402
from ngt_tpu_torch.parallel import multihost  # noqa: E402
from ngt_tpu_torch.parallel.sharding import ShardedIndex  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description="sharded build and search")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--n", type=int, default=8000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--queries", type=int, default=256)
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    data = rng.normal(size=(args.n, args.dim)).astype(np.float32)
    queries = data[rng.choice(args.n, args.queries, replace=False)] + rng.normal(
        size=(args.queries, args.dim)).astype(np.float32) * 0.05

    multihost.initialize(device=args.device)   # one process: nothing to do
    mesh = multihost.make_global_mesh(args.shards, device=args.device)
    print(f"mesh: {mesh.size} shards over {mesh.world_size} process(es)")
    t0 = time.time()
    idx = ShardedIndex.build(data, mesh=mesh, edge_size_for_creation=12)
    ids, _ = idx.batch_search(queries, size=10, epsilon=0.1)
    secs = time.time() - t0
    d = ((queries[:, None, :] - data[None, :, :]) ** 2).sum(-1)
    gt = np.argsort(d, axis=1)[:, :10]
    rec = recall_at_k(ids, gt, 10)
    print(f"sharded recall@10 = {rec:.4f} over {mesh.size} shards ({secs:.1f} s)")
    assert rec > 0.9, rec
    print("OK")
    return {"recall": rec, "shards": mesh.size, "seconds": secs}


if __name__ == "__main__":
    main()
