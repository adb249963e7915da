"""Worker of tests/test_torch_multihost.py: one rank of a 2-process gloo
group that opens a ``save_distributed`` layout over the rank-major global
mesh, reading only its own shard files, and searches it.

Run:  python torch_multihost_worker.py <store file> <world> <rank>
      <index dir> <expected.npz> <output dir>

It checks its shard slice, asserts the search's ids equal the expected
ones and its distances within 1e-5 (relative), writes the index again with
``save_distributed`` into <output dir> (each rank its own shards) and
prints ``TORCH_MULTIHOST_OK rank=<r> world=<w> shards=<P>``.  It imports
neither JAX nor the JAX package.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402


def main() -> None:
    store, world, rank, index_dir, expected, out_dir = sys.argv[1:7]
    world, rank = int(world), int(rank)
    torch.set_num_threads(1)
    from ngt_tpu_torch.parallel import multihost as MH
    from ngt_tpu_torch.parallel.sharding import ShardedIndex

    assert MH.initialize(f"file://{store}", world, rank, device="cpu")
    mesh = MH.make_global_mesh(8, device="cpu")
    mine = MH.process_shard_slices(mesh)[rank]
    assert mine == list(range(rank * 4, rank * 4 + 4)), mine
    sidx = ShardedIndex.open_distributed(index_dir, mesh)
    assert len(sidx._sharded.x.parts) == 4
    exp = np.load(expected)
    ids, dists = sidx.batch_search(exp["queries"], size=int(exp["size"]),
                                   epsilon=float(exp["epsilon"]))
    assert (ids == exp["ids"]).all(), (ids[:2], exp["ids"][:2])
    np.testing.assert_allclose(dists, exp["dists"], rtol=1e-5)
    sidx.save_distributed(out_dir)
    dist.barrier()
    dist.destroy_process_group()
    print(f"TORCH_MULTIHOST_OK rank={rank} world={world} shards={mesh.size}", flush=True)


if __name__ == "__main__":
    main()
