"""Multi-process bootstrap for the sharded index (the port's counterpart of
``ngt_tpu/parallel/multihost.py``).

Once ``torch.distributed`` is initialized, a mesh over every rank's shards
makes the sharded programs' merges run as ``all_gather`` over the process
group (NCCL between CUDA devices, gloo on the CPU), and the single-process
``ShardedGraphIndex`` code runs unchanged:

* ``initialize()``: idempotent ``init_process_group`` that resolves
  explicit arguments first, then torch's own ``MASTER_ADDR`` /
  ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``; with neither it does
  nothing (one process), so library code can call it unconditionally.  The
  rendezvous is a ``FileStore`` (``file://...``) or a TCP store at the
  given address (127.0.0.1 on one machine);
* ``make_global_mesh()``: a mesh over every rank's shards, rank-major, so
  each rank's shard range is contiguous;
* ``process_shard_slices()``: which shards each rank owns, for loading
  only the local slice of a corpus;
* ``local_shard_array()``: this rank's shard blocks placed on its devices.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ngt_tpu_torch.parallel.sharding import Mesh, ShardedArray, make_mesh, visible_devices


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device="cuda",
) -> bool:
    """Join (once) the process group of ``num_processes`` ranks as rank
    ``process_id``: NCCL for a CUDA ``device``, gloo for the CPU; a failure
    raises (no other backend is tried).  ``coordinator_address`` is a
    ``file://`` or ``tcp://`` init method, or ``host:port``.  Returns True
    when more than one rank is (already) running."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator_address is not None:
        init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        world, rank = num_processes, process_id
    elif "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        init = "env://"
        world = num_processes or int(os.environ.get("WORLD_SIZE", "0")) or None
        rank = process_id if process_id is not None else (
            int(os.environ["RANK"]) if "RANK" in os.environ else None)
    else:
        return False   # one process; nothing to do
    if world is None or rank is None:
        raise ValueError("initialize needs the number of processes and this process's rank")
    dev = torch.device(device)
    if dev.type == "cuda":
        local = visible_devices(dev)
        torch.cuda.set_device(local[rank % len(local)])
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device type: {dev.type!r}")
    dist.init_process_group(backend, init_method=init, world_size=int(world), rank=int(rank))
    return int(world) > 1


def make_global_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """A mesh over every rank's shards, rank-major: rank r owns shards
    ``r * per`` to ``(r + 1) * per - 1`` with ``per = n_devices /
    world_size`` (default: one per visible device), laid out round-robin on
    its visible devices.  A process that never called ``initialize`` gets
    ``make_mesh``'s single-process mesh.  Entries of other ranks name the
    device as that rank sees it."""
    if not dist.is_initialized():
        return make_mesh(n_devices, device)
    world, rank = dist.get_world_size(), dist.get_rank()
    devs = visible_devices(device)
    if n_devices and n_devices % world:
        raise ValueError(f"{n_devices} shards over {world} ranks")
    per = n_devices // world if n_devices else len(devs)
    if torch.device(device).type == "cuda" and world > 1:
        devs = [devs[rank % len(devs)]]   # NCCL: one device per rank
    return Mesh([devs[j % len(devs)] for _ in range(world) for j in range(per)],
                owners=[r for r in range(world) for _ in range(per)],
                rank=rank, group=dist.group.WORLD)


def process_shard_slices(mesh: Mesh) -> dict[int, list[int]]:
    """rank -> the shard ids it owns.  Load only the local slice of a
    corpus with ``process_shard_slices(mesh)[mesh.rank]``."""
    owners: dict[int, list[int]] = {}
    for i, r in enumerate(mesh.owners):
        owners.setdefault(r, []).append(i)
    return owners


def local_shard_array(mesh: Mesh, global_shape: tuple[int, ...],
                      local_shards: np.ndarray) -> ShardedArray:
    """This rank's shard blocks ``[n_local_shards, rows, ...]`` placed on
    its shards' devices as the ``ShardedArray`` of ``global_shape``; no
    block of another rank is read or held."""
    return ShardedArray.from_local(mesh, list(local_shards), global_shape)
