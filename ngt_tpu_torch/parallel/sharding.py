"""Object-sharded index over a mesh of devices (the port's counterpart of
``ngt_tpu/parallel/sharding.py``).

The reference shards its object matrix and adjacency over a 1-D
``jax.sharding.Mesh`` and runs each program as one ``shard_map``.  Here a
``Mesh`` is an ordered list of shard devices (a device may hold several
shards) with the rank that owns each shard; a ``ShardedArray`` holds this
process's row blocks, one tensor per local shard on that shard's device.
Every shard runs the port's ``graph_search`` on its own subgraph in local
ids (the vald layout: objects round-robin over the shards, per-shard
graphs), and the per-shard top-k lists merge by one gather and a
(distance, position) top-k: within one process a concatenation in shard
order, across ranks a ``torch.distributed.all_gather`` (NCCL on CUDA
devices, gloo on the CPU).  Ties pick the lower flattened ``[P, k]``
position, as ``jax.lax.top_k`` does.  The shards' work fans out over the
devices (``_fan_out``): each device runs its shards in a host thread of its
own, so shards on different cards search and build at once, and shards on
one device take turns; the answers are those of a loop over the shards.

The build step (``make_sharded_build_step``) is the reference's SPMD
growth step: a batch of new vectors is searched on every shard, the
candidates merge across shards, and each shard writes the rows it owns and
inserts reverse edges into its distance-sorted rows
(``_merge_reverse_edges``, the reference's ``addEdge``).  The high-level
``ShardedIndex`` builds each shard with the port's own ``create`` +
``build_index`` (the window-scan kernel at 2^19 rows and more on CUDA);
``ShardedQG`` is the sharded sq8 quantized graph.  Saves use the
reference's files and keys, so each package opens the other's.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import math
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ngt_tpu_torch import trace
from ngt_tpu_torch.graph.search import graph_search
from ngt_tpu_torch.ops.select import sort_lex, topk_pos
from ngt_tpu_torch.properties import DistanceType, ObjectType

AXIS = "shard"
INF = float("inf")
_F32 = torch.float32

#: rows per step of the on-device sq8 encode and block gather
_QG_CHUNK = 1 << 16
#: queries a shard's sq8 traversal takes at once: a larger batch is cut
#: into chunks of this many, the last one padded with copies of its first
#: query, so that a batch of any size past it replays one captured loop.
#: At 2^22 visited bits (2.5M rows a shard) a chunk's loop holds 1 GiB.
QG_QUERY_CHUNK = 2048


def visible_devices(device="cuda") -> list[torch.device]:
    """The devices of ``device``'s type this process sees: every CUDA
    device (or the one named), or the CPU.  Raises without a CUDA device."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")]
    if dev.type != "cuda":
        raise ValueError(f"unsupported device type: {dev.type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' for a CPU mesh")
    if dev.index is not None:
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """The port's 1-D mesh over ``AXIS``: ``devices[s]`` holds shard ``s``
    (entries may repeat a device), ``owners[s]`` is the rank that owns it;
    ``rank`` is this process's rank and ``group`` the process group the
    merges run over (None: one process owns every shard)."""

    def __init__(self, devices, owners=None, rank: int = 0, group=None):
        self.devices = [torch.device(d) for d in devices]
        self.owners = [int(r) for r in owners] if owners is not None else [rank] * len(self.devices)
        if len(self.owners) != len(self.devices):
            raise ValueError(f"{len(self.owners)} owners for {len(self.devices)} shards")
        self.rank = int(rank)
        self.group = group
        self.world_size = dist.get_world_size(group) if group is not None else 1
        if group is None and any(o != self.rank for o in self.owners):
            raise ValueError("a mesh whose shards other ranks own needs a process group")
        self.local_shards = [s for s, o in enumerate(self.owners) if o == self.rank]
        if not self.local_shards:
            raise ValueError(f"rank {self.rank} owns no shard of the mesh")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        """The device the merged results land on: this rank's first shard's."""
        return self.devices[self.local_shards[0]]

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.devices]}, owners={self.owners}, "
                f"rank={self.rank}, world_size={self.world_size})")


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """This process's mesh of ``n_devices`` shards (default: one per
    visible device) laid out round-robin over the visible devices of
    ``device``'s type: ``make_mesh(2)`` on one card puts both shards on
    ``cuda:0``, ``make_mesh(8, device="cpu")`` eight on the CPU."""
    devs = visible_devices(device)
    n = n_devices or len(devs)
    return Mesh([devs[i % len(devs)] for i in range(n)])


class ShardedArray:
    """A ``[P * rows, ...]`` array split into P equal row blocks over a
    mesh (the port's form of an array sharded ``P(AXIS, ...)``): ``parts[j]``
    is the block of shard ``mesh.local_shards[j]`` on that shard's device.
    No process holds another rank's blocks."""

    def __init__(self, mesh: Mesh, parts, global_shape):
        if len(parts) != len(mesh.local_shards):
            raise ValueError(f"{len(parts)} parts for {len(mesh.local_shards)} local shards")
        self.mesh = mesh
        self.parts = list(parts)
        self.shape = tuple(int(v) for v in global_shape)

    @classmethod
    def from_blocks(cls, mesh: Mesh, blocks) -> "ShardedArray":
        """From host blocks ``[P, rows, ...]`` of every shard: the local
        shards' blocks are copied to their devices."""
        blocks = np.asarray(blocks)
        if blocks.shape[0] != mesh.size:
            raise ValueError(f"{blocks.shape[0]} blocks for a mesh of {mesh.size} shards")
        return cls.from_local(mesh, [blocks[s] for s in mesh.local_shards],
                              (blocks.shape[0] * blocks.shape[1], *blocks.shape[2:]))

    @classmethod
    def from_local(cls, mesh: Mesh, blocks, global_shape) -> "ShardedArray":
        """From this rank's host blocks, one per local shard in
        ``mesh.local_shards`` order, of the array of ``global_shape``."""
        if len(blocks) != len(mesh.local_shards):
            raise ValueError(
                f"{len(blocks)} local blocks for {len(mesh.local_shards)} local shards")
        per = global_shape[0] // mesh.size
        # a copy (also on the CPU, where the caller's array would be shared)
        parts = [torch.from_numpy(_writable(np.asarray(b)[:per])).to(mesh.devices[s], copy=True)
                 for b, s in zip(blocks, mesh.local_shards)]
        return cls(mesh, parts, global_shape)

    def numpy(self) -> np.ndarray:
        """The whole ``[P * rows, ...]`` array on the host (one process must
        own every shard)."""
        if len(self.parts) != self.mesh.size:
            raise ValueError("numpy() needs every shard in this process")
        return np.concatenate([p.cpu().numpy() for p in self.parts])


def _writable(a: np.ndarray) -> np.ndarray:
    """A contiguous array torch may wrap (a broadcast view is copied)."""
    a = np.ascontiguousarray(a)
    return a if a.flags.writeable else a.copy()


def _hash_bits(n_local: int) -> int:
    return max(int(math.ceil(math.log2(max(n_local, 2)))), 10)


def _all_gather(mesh: Mesh, parts) -> torch.Tensor:
    """Per-local-shard tensors [B, ...] -> [B, P, ...] on ``mesh.home`` in
    shard order (a stack within the process; an all_gather over the mesh's
    group across ranks, every rank owning the same number of shards)."""
    local = torch.stack([p.to(mesh.home) for p in parts], 1)
    if mesh.group is None:
        return local
    counts = {r: mesh.owners.count(r) for r in range(mesh.world_size)}
    if len(set(counts.values())) != 1:
        raise ValueError(f"ranks own unequal shard counts {counts}")
    outs = [torch.empty_like(local) for _ in range(mesh.world_size)]
    dist.all_gather(outs, local.contiguous(), group=mesh.group)
    got = torch.cat(outs, 1)
    order = [s for r in range(mesh.world_size) for s, o in enumerate(mesh.owners) if o == r]
    inv = torch.from_numpy(np.argsort(np.asarray(order), kind="stable")).to(mesh.home)
    return got.index_select(1, inv)


def _device_groups(mesh: Mesh) -> list[list[int]]:
    """The positions in ``mesh.local_shards`` grouped by device, each group
    in shard order."""
    groups: dict = {}
    for j, s in enumerate(mesh.local_shards):
        groups.setdefault(mesh.devices[s], []).append(j)
    return list(groups.values())


def _fan_out(mesh: Mesh, work) -> list:
    """``work(j, s)`` for each local shard ``s = mesh.local_shards[j]`` on
    its device, the results in ``local_shards`` order.  One host thread a
    device group (``_device_groups``) runs its shards in turn; the groups
    run at once, and on a CUDA device each shard's work has finished on
    the card when this returns.  The tracer's place (the call, the open
    span) carries into the threads."""
    out = [None] * len(mesh.local_shards)

    def run(group):
        for j in group:
            s = mesh.local_shards[j]
            dev = mesh.devices[s]
            with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                out[j] = work(j, s)
                if dev.type == "cuda":
                    torch.cuda.current_stream(dev).synchronize()

    groups = _device_groups(mesh)
    if len(groups) == 1:
        run(groups[0])
        return out
    place = trace.carry()

    def thread(group):
        with trace.adopt(place):
            run(group)

    with concurrent.futures.ThreadPoolExecutor(len(groups)) as pool:
        for f in [pool.submit(thread, g) for g in groups]:
            f.result()
    return out


def _global_max(mesh: Mesh, values) -> float:
    """Max of per-local-shard float32 scalars over every shard."""
    t = torch.stack([v.to(mesh.home, _F32).reshape(()) for v in values]).max().reshape(1)
    if mesh.group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return float(t.item())


def _merge_topk(mesh: Mesh, dists, gids, k: int):
    """all_gather + top-k of per-shard (dists [B, k'], global ids [B, k'])
    lists: the k smallest of the flattened [B, P * k'], ties to the lower
    position (``jax.lax.top_k(-d)``'s order)."""
    all_d = _all_gather(mesh, dists)
    all_i = _all_gather(mesh, gids)
    b = all_d.shape[0]
    dd, sel = topk_pos(all_d.reshape(b, -1), k)
    return all_i.reshape(b, -1).gather(1, sel), dd


def _seed_rows(seeds: torch.Tensor, b: int) -> torch.Tensor:
    """A shard's seed slots [1, S] (or [S]) as every query's [B, S]."""
    flat = seeds.reshape(-1)
    return flat[None, :].expand(b, flat.shape[0])


def _global_ids(ids: torch.Tensor, shard: int, n_local: int) -> torch.Tensor:
    ids = ids.to(torch.int64)
    return torch.where(ids >= 0, ids + shard * n_local, -1)


class ShardedGraphIndex:
    """A proximity-graph index whose objects and adjacency are sharded.

    Each shard's subgraph is built independently over its local objects
    (the vald layout); global ids are ``shard * n_local + local``.  The
    arrays are ``ShardedArray``s: x ``[P*n_local, D_pad]``, nbr and
    nbr_dist ``[P*n_local, E]``, valid ``[P*n_local]``, seed_ids_local
    ``[P, S]``."""

    def __init__(
        self,
        mesh: Mesh,
        x_shards: np.ndarray,        # [P, n_local, D_pad]
        nbr_shards: np.ndarray,      # [P, n_local, E] local ids, -1 padded
        valid_shards: np.ndarray,    # [P, n_local]
        seed_ids_local: np.ndarray,  # [S] or [P, S] local seed slots
        metric: DistanceType,
        nbr_dist_shards: np.ndarray | None = None,  # [P, n_local, E] f32;
        # required for build steps (sorted bounded edge insert), optional
        # for a search-only index
    ):
        p, n_local = x_shards.shape[:2]
        if p != mesh.size:
            raise ValueError(f"{p} shards for a mesh of {mesh.size}")
        seeds = np.asarray(seed_ids_local, np.int32)
        if seeds.ndim == 1:   # the same local seed slots on every shard
            seeds = np.broadcast_to(seeds[None, :], (p, seeds.shape[0]))
        self._set(
            mesh, metric, n_local,
            ShardedArray.from_blocks(mesh, np.asarray(x_shards)),
            ShardedArray.from_blocks(mesh, np.asarray(nbr_shards, np.int32)),
            ShardedArray.from_blocks(mesh, np.asarray(valid_shards, bool)),
            ShardedArray.from_blocks(mesh, seeds[:, None, :]),
            None if nbr_dist_shards is None else ShardedArray.from_blocks(
                mesh, np.asarray(nbr_dist_shards, np.float32)),
        )

    def _set(self, mesh, metric, n_local, x, nbr, valid, seeds, nbr_dist):
        self.mesh = mesh
        self.metric = DistanceType(metric)
        self.n_local = int(n_local)
        self.x, self.nbr, self.valid, self.nbr_dist = x, nbr, valid, nbr_dist
        #: [P, S]: one row block of one row per shard
        self.seed_ids_local = seeds

    @classmethod
    def from_arrays(
        cls,
        mesh: Mesh,
        x: ShardedArray,               # [P*n_local, D_pad]
        nbr: ShardedArray,             # [P*n_local, E]
        valid: ShardedArray,           # [P*n_local]
        seed_ids_local: ShardedArray,  # [P, S]
        metric: DistanceType,
        n_local: int,
        nbr_dist: ShardedArray | None = None,
    ) -> "ShardedGraphIndex":
        """Wrap arrays already placed per shard (a multi-rank open places
        each rank's own blocks with ``multihost.local_shard_array``; no
        process holds the whole index)."""
        self = cls.__new__(cls)
        self._set(mesh, metric, n_local, x, nbr, valid, seed_ids_local, nbr_dist)
        return self

    def search(self, queries, k: int = 10, epsilon: float = 0.1,
               width: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
        """Queries [B, D_pad] (every rank passes the same) -> global ids
        [B, k] int64 and distances, on ``mesh.home``."""
        return _sharded_search(
            self.mesh, self.x, self.nbr, self.valid, torch.as_tensor(queries),
            self.seed_ids_local, metric=self.metric, k=k, epsilon=epsilon,
            width=width, n_local=self.n_local,
        )


def _sharded_search(mesh, x, nbr, valid, q, seeds, *, metric, k, epsilon, width, n_local):
    """Per shard: row-mode ``graph_search`` over the local subgraph from
    the shard's own seed slots (exact visited table), local ids to global;
    then the all_gather top-k merge."""
    b = q.shape[0]

    def shard(j, s):
        res = graph_search(
            x.parts[j], nbr.parts[j], valid.parts[j], q.to(mesh.devices[s], _F32),
            _seed_rows(seeds.parts[j], b), metric=metric, k=k, epsilon=epsilon, width=width,
            hash_bits=_hash_bits(n_local), exact_hash=True,
        )
        return res.dists, _global_ids(res.ids, s, n_local)

    dists, gids = zip(*_fan_out(mesh, shard))
    return _merge_topk(mesh, list(dists), list(gids), k)


# ----------------------------------------------------------------------------
# distributed build step
# ----------------------------------------------------------------------------


class BuildStepOut(NamedTuple):
    x: ShardedArray
    nbr: ShardedArray
    nbr_dist: ShardedArray
    valid: ShardedArray
    new_neighbor_ids: torch.Tensor    # [B, K] global ids chosen for the new nodes
    new_neighbor_dists: torch.Tensor


def _f32_order(d: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 in [0, 2^32) preserving the total order (-0.0 just
    below +0.0), the order ``jax.lax.sort`` compares floats in."""
    bits = d.to(_F32).contiguous().view(torch.int32)
    bits = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    return bits.to(torch.int64) + (1 << 31)


def _merge_reverse_edges(nbr, nbr_d, tgt, src, d, ok):
    """Deterministic batched addEdge: insert edges (tgt[i] -> src[i], d[i])
    into fixed-width DISTANCE-SORTED rows, skipping duplicates and dropping
    the farthest edge of a full row (the reference's sorted bounded insert,
    addEdgeDeletingExcessEdges, Graph.h:888-934).

    Proposals are grouped by target with one stable sort on (target, dist);
    every proposal of a group computes the SAME merged row from the group's
    leading window and writes it, so repeated write indices all carry equal
    values and the result does not depend on the write order.  Invalid
    proposals route to a pad row past the last one."""
    e_width = nbr.shape[1]
    n_rows = nbr.shape[0]
    l = tgt.shape[0]
    dev = nbr.device
    big = 1 << 30
    key_t = torch.where(ok, tgt.to(torch.int64), big)     # invalid proposals sort last
    order = torch.sort((key_t << 32) + _f32_order(d), stable=True).indices
    sort_t, sort_d, sort_s = key_t[order], d.to(_F32)[order], src.to(torch.int32)[order]
    idx = torch.arange(l, device=dev)
    is_start = torch.ones(l, dtype=torch.bool, device=dev)
    is_start[1:] = sort_t[1:] != sort_t[:-1]
    group_start = torch.cummax(torch.where(is_start, idx, 0), 0).values
    # candidate window: the E nearest proposals of this position's group
    win_raw = group_start[:, None] + torch.arange(e_width, device=dev)
    inb = win_raw < l
    win = win_raw.clamp(0, l - 1)
    same = (sort_t[win] == sort_t[:, None]) & inb
    cd = torch.where(same, sort_d[win], INF)
    cs = torch.where(same, sort_s[win], -1)
    # existing rows + duplicate check: a proposed src already present keeps
    # its existing edge and the proposal is dropped
    nbr_p = torch.cat([nbr, nbr.new_full((1, e_width), -1)])
    nbr_d_p = torch.cat([nbr_d, nbr_d.new_full((1, e_width), INF)])
    t_safe = torch.where(sort_t < big, sort_t, n_rows)
    rows_i = nbr_p[t_safe]
    rows_d = nbr_d_p[t_safe]
    dup = (cs[:, :, None] == rows_i[:, None, :]).any(2)
    cd = torch.where(dup, INF, cd)
    cs = torch.where(dup, -1, cs)
    md, mi = sort_lex(torch.cat([rows_d, cd], 1), torch.cat([rows_i, cs], 1))
    nbr_p[t_safe] = mi[:, :e_width].to(nbr.dtype)
    nbr_d_p[t_safe] = md[:, :e_width].to(nbr_d.dtype)
    return nbr_p[:n_rows], nbr_d_p[:n_rows]


def make_sharded_build_step(
    mesh: Mesh,
    metric: DistanceType,
    k: int,
    n_local: int,
    epsilon: float = 0.1,
    width: int = 32,
):
    """One index-growth step over the mesh: search the sharded graph for a
    batch of new vectors, merge candidates across shards, then each shard
    writes (a) the object rows it owns, (b) the new nodes' own
    distance-sorted adjacency rows and (c) reverse edges whose target it
    owns, by the sorted bounded insert with duplicate check (reference
    addEdge semantics, Graph.h:845-934).  ``new_gids`` [B] are global slots
    chosen on the host.  Rows another shard owns are masked out of every
    write (the reference drops them out of bounds; a clamp to slot 0 would
    collide with a real insert there).  Like the reference's donated
    buffers, the x and valid blocks passed in are updated in place."""
    metric = DistanceType(metric)

    def step(x, nbr, nbr_d, valid, newx, new_gids, seeds) -> BuildStepOut:
        newx = torch.as_tensor(newx)
        new_gids = torch.as_tensor(new_gids)
        b = newx.shape[0]
        nn_i, nn_d = _sharded_search(mesh, x, nbr, valid, newx, seeds, metric=metric, k=k,
                                     epsilon=epsilon, width=width, n_local=n_local)

        xs, nbrs, nbr_ds, valids = [], [], [], []
        for j, s in enumerate(mesh.local_shards):
            dev = mesh.devices[s]
            xj, vj = x.parts[j], valid.parts[j]
            nbj, ndj = nbr.parts[j], nbr_d.parts[j]
            g = new_gids.to(dev, torch.int64)
            ni, nd = nn_i.to(dev), nn_d.to(dev)
            # -- object rows owned by this shard
            mine = torch.div(g, n_local, rounding_mode="floor") == s
            own = torch.nonzero(mine).squeeze(1)
            slot = (g % n_local)[own]
            xj[slot] = newx.to(dev, xj.dtype)[own]
            vj[slot] = True
            # -- the new nodes' own rows, in local ids: cross-shard edges
            # are dropped (each subgraph is self-contained), the survivors
            # compacted to the front in (distance, id) order
            keep = (ni >= 0) & (torch.div(ni, n_local, rounding_mode="floor") == s)
            nn_local = torch.where(keep, ni % n_local, -1).to(torch.int32)
            nn_ld = torch.where(keep, nd, INF)
            nn_ld, nn_local = sort_lex(nn_ld, nn_local)
            e_width = nbj.shape[1]
            nn_row = torch.full((b, e_width), -1, dtype=nbj.dtype, device=dev)
            nn_row[:, : nn_local.shape[1]] = nn_local.to(nbj.dtype)
            nn_row_d = torch.full((b, e_width), INF, dtype=ndj.dtype, device=dev)
            nn_row_d[:, : nn_ld.shape[1]] = nn_ld.to(ndj.dtype)
            nbj = nbj.clone()
            ndj = ndj.clone()
            nbj[slot] = nn_row[own]
            ndj[slot] = nn_row_d[own]
            # -- reverse edges: sorted bounded insert into owned target rows
            flat_ok = (keep & mine[:, None]).reshape(-1)
            flat_t = torch.where(keep, ni % n_local, 0).reshape(-1)
            flat_s = (g % n_local)[:, None].expand(b, ni.shape[1]).reshape(-1)
            nbj, ndj = _merge_reverse_edges(nbj, ndj, flat_t, flat_s, nd.reshape(-1), flat_ok)
            xs.append(xj)
            valids.append(vj)
            nbrs.append(nbj)
            nbr_ds.append(ndj)
        return BuildStepOut(
            ShardedArray(mesh, xs, x.shape), ShardedArray(mesh, nbrs, nbr.shape),
            ShardedArray(mesh, nbr_ds, nbr_d.shape), ShardedArray(mesh, valids, valid.shape),
            nn_i, nn_d,
        )

    return step


# ----------------------------------------------------------------------------
# the high-level sharded index
# ----------------------------------------------------------------------------


def _pad_queries(q: np.ndarray, d_pad: int) -> np.ndarray:
    q = np.asarray(q, np.float32)
    if q.shape[1] == d_pad:
        return q
    qq = np.zeros((len(q), d_pad), np.float32)
    qq[:, : q.shape[1]] = q
    return qq


def _check_meta(p: int, mesh: Mesh) -> None:
    if mesh.size != p:
        raise ValueError(f"index has {p} shards; mesh has {mesh.size}")


class ShardedIndex:
    """High-level distributed index: objects round-robin over the mesh,
    each shard a self-contained ANNG built by the port's own engine,
    queries fanned out and merged (the vald deployment: objects sharded
    across NGT agents, per-agent graphs, top-k merge; reference
    README.md:30,97)."""

    def __init__(self, mesh: Mesh, shard_index: ShardedGraphIndex, id_map: np.ndarray):
        self.mesh = mesh
        self._sharded = shard_index
        self.id_map = id_map  # global slot -> original row index (-1 unused)

    @classmethod
    @trace.public
    def build(
        cls,
        data: np.ndarray,
        mesh: Mesh | None = None,
        metric: DistanceType = DistanceType.L2,
        edge_size_for_creation: int = 10,
        max_edges: int = 48,
        seed_size: int = 12,
        object_type: ObjectType = ObjectType.FLOAT,
    ) -> "ShardedIndex":
        """Build per-shard ANNGs with ``create`` + ``build_index`` on each
        shard's device (the devices at once, ``_fan_out``) and lay them out
        over the mesh; each shard stores its rows as ``object_type`` does
        (uint8 rows for ``UINT8``).  Every rank passes the same ``data``
        and builds only the shards it owns; the seed count is agreed over
        the mesh's group."""
        import ngt_tpu_torch
        from ngt_tpu_torch.ops.bruteforce import pad_dim

        mesh = mesh or make_mesh()
        p = mesh.size
        data = np.asarray(data)
        n, dim = data.shape
        d_pad = pad_dim(dim)
        n_local = (n + p - 1) // p
        owner = np.arange(n) % p
        id_map = np.full((p * n_local,), -1, np.int64)
        for s in range(p):
            rows = np.nonzero(owner == s)[0]
            id_map[s * n_local : s * n_local + len(rows)] = rows

        def shard(j, s):
            rows = np.nonzero(owner == s)[0]
            sub = ngt_tpu_torch.create(
                None, dimension=dim, distance_type=metric, object_type=object_type,
                edge_size_for_creation=edge_size_for_creation,
                max_edges=max_edges, device=mesh.devices[s],
            )
            ids = sub.store.batch_insert(data[rows])
            sub.build_index()
            # local layout: slot j holds internal id ids[j]
            x_b = np.zeros((n_local, d_pad), sub.store._x.dtype)
            x_b[: len(rows)] = sub.store._x[ids]
            remap = np.full(sub.store._x.shape[0], -1, np.int32)
            remap[ids] = np.arange(len(rows), dtype=np.int32)
            adj = sub.graph.nbr_ids[ids][:, :max_edges]
            ok = adj >= 0
            nbr_b = np.full((n_local, max_edges), -1, np.int32)
            nbr_b[: len(rows)][ok] = remap[adj[ok]]
            dd = sub.graph.nbr_dist[ids][:, :max_edges].astype(np.float32)
            dd[~ok] = np.inf
            nbrd_b = np.full((n_local, max_edges), np.inf, np.float32)
            nbrd_b[: len(rows)] = dd
            val_b = np.zeros(n_local, bool)
            val_b[: len(rows)] = True
            # per-shard seeds = the sub-index's representatives (k-means
            # coverage beats an arbitrary first-S slice), in local slots
            reps = remap[sub.seeder.rep_ids]
            reps = reps[reps >= 0]
            if len(reps) == 0:
                reps = np.arange(min(seed_size * 4, len(rows)), dtype=np.int32)
            sub.close()
            return (x_b, nbr_b, nbrd_b, val_b), reps.astype(np.int32)

        built = _fan_out(mesh, shard)
        parts = dict(zip(("x", "nbr", "nbr_dist", "valid"), zip(*(b[0] for b in built))))
        shard_seeds = [b[1] for b in built]
        s_max = int(_global_max(mesh, [torch.tensor(float(len(r))) for r in shard_seeds]))
        seeds = np.zeros((len(shard_seeds), 1, s_max), np.int32)
        for j, reps in enumerate(shard_seeds):
            seeds[j, 0, : len(reps)] = reps
            if len(reps) < s_max:  # pad by repeating (dedup'd in search)
                seeds[j, 0, len(reps):] = reps[0] if len(reps) else 0
        arr = lambda key, *tail: ShardedArray.from_local(
            mesh, list(parts[key]), (p * n_local, *tail))
        sharded = ShardedGraphIndex.from_arrays(
            mesh, arr("x", d_pad), arr("nbr", max_edges), arr("valid"),
            ShardedArray.from_local(mesh, list(seeds), (p, s_max)), metric, n_local,
            nbr_dist=arr("nbr_dist", max_edges),
        )
        return cls(mesh, sharded, id_map)

    # ------------------------------------------------------- persistence ----
    def save(self, path: str) -> None:
        """Persist the sharded layout as one ``shards.npz`` (the reference's
        keys and dtypes); reopening lays the same shards out over a mesh of
        the same size.  One process must own every shard."""
        os.makedirs(path, exist_ok=True)
        s = self._sharded
        p = self.mesh.size
        unflat = lambda a: a.numpy().reshape(p, s.n_local, *a.shape[1:])
        np.savez(
            os.path.join(path, "shards.npz"),
            x=unflat(s.x),
            nbr=unflat(s.nbr),
            nbr_dist=(unflat(s.nbr_dist) if s.nbr_dist is not None
                      else np.zeros((0,), np.float32)),
            valid=unflat(s.valid),
            seed_ids_local=s.seed_ids_local.numpy().reshape(p, -1),
            metric=int(s.metric),
            id_map=self.id_map,
        )

    def save_distributed(self, path: str) -> None:
        """Persist as ONE FILE PER SHARD (``shard_{i:05d}.npz``) + a small
        ``meta.npz`` that rank 0 writes: every rank writes only the shards
        it owns, so the corpus never gathers on one host."""
        os.makedirs(path, exist_ok=True)
        s = self._sharded
        for j, i in enumerate(self.mesh.local_shards):
            np.savez(
                os.path.join(path, f"shard_{i:05d}.npz"),
                x=s.x.parts[j].cpu().numpy(), nbr=s.nbr.parts[j].cpu().numpy(),
                valid=s.valid.parts[j].cpu().numpy(),
                seeds=s.seed_ids_local.parts[j].cpu().numpy().reshape(-1),
                nbr_dist=(np.zeros((0,), np.float32) if s.nbr_dist is None
                          else s.nbr_dist.parts[j].cpu().numpy()),
            )
        if self.mesh.rank == 0:
            np.savez(
                os.path.join(path, "meta.npz"),
                p=self.mesh.size, n_local=s.n_local,
                d_pad=s.x.shape[1], e=s.nbr.shape[1],
                s_max=s.seed_ids_local.shape[1],
                has_nbr_dist=s.nbr_dist is not None,
                metric=int(s.metric), id_map=self.id_map,
            )

    @classmethod
    def open_distributed(cls, path: str, mesh: Mesh | None = None) -> "ShardedIndex":
        """Open a ``save_distributed`` layout: each rank reads ONLY its own
        shard files and places them on its shards' devices."""
        from ngt_tpu_torch.parallel import multihost as MH

        meta = np.load(os.path.join(path, "meta.npz"))
        p, n_local = int(meta["p"]), int(meta["n_local"])
        mesh = mesh or make_mesh(p)
        _check_meta(p, mesh)
        has_d = bool(meta["has_nbr_dist"])
        parts = [np.load(os.path.join(path, f"shard_{i:05d}.npz")) for i in mesh.local_shards]
        stack = lambda key: np.stack([np.asarray(f[key]) for f in parts])
        glob = lambda a: MH.local_shard_array(mesh, (p * n_local, *a.shape[2:]), a)
        sharded = ShardedGraphIndex.from_arrays(
            mesh,
            glob(stack("x")),
            glob(stack("nbr")),
            glob(stack("valid")),
            MH.local_shard_array(mesh, (p, int(meta["s_max"])), stack("seeds")[:, None, :]),
            DistanceType(int(meta["metric"])), n_local,
            nbr_dist=glob(stack("nbr_dist")) if has_d else None,
        )
        return cls(mesh, sharded, meta["id_map"])

    @classmethod
    def open(cls, path: str, mesh: Mesh | None = None) -> "ShardedIndex":
        st = np.load(os.path.join(path, "shards.npz"))
        p = st["x"].shape[0]
        mesh = mesh or make_mesh(p)
        _check_meta(p, mesh)
        nbrd = st["nbr_dist"] if st["nbr_dist"].size else None
        sharded = ShardedGraphIndex(
            mesh, st["x"], st["nbr"], st["valid"],
            seed_ids_local=st["seed_ids_local"],
            metric=DistanceType(int(st["metric"])),
            nbr_dist_shards=nbrd,
        )
        return cls(mesh, sharded, st["id_map"])

    def batch_search(self, queries: np.ndarray, size: int = 10,
                     epsilon: float = 0.1, width: int = 64):
        """Queries [B, dim] -> (original row ids [B, size] int64, -1 where
        empty; distances), the same on every rank."""
        q = _pad_queries(queries, self._sharded.x.shape[1])
        ids, dists = self._sharded.search(
            torch.from_numpy(q), k=size, epsilon=epsilon, width=width)
        ids = ids.cpu().numpy()
        out = np.where(ids >= 0, self.id_map[np.clip(ids, 0, None)], -1)
        return out.astype(np.int64), dists.cpu().numpy()


class ShardedQG:
    """Quantized-graph (sq8) search sharded over the mesh: NGTQG
    (QuantizedGraph.h:192-320) past one device's block budget.  Per shard,
    in local ids: int8 codes ``[n_local, D_pad]`` with ONE global scale
    (per-shard scales would re-weight distances at the merge), neighbor
    blocks ``[n_local, eb * D_pad]``, the f32 rows for the exact re-rank,
    and the seed slots.  Codes and blocks are built on each shard's device
    and are byte-equal to the reference's host build; the search is a local
    block traversal + exact re-rank per shard, then the merge."""

    def __init__(
        self,
        mesh: Mesh,
        x_shards: np.ndarray,        # [P, n_local, D_pad] f32
        nbr_shards: np.ndarray,      # [P, n_local, E] local ids
        valid_shards: np.ndarray,    # [P, n_local]
        seed_ids_local: np.ndarray,  # [P, S] local seed slots
        metric: DistanceType,
        block_edges: int = 0,        # 0 = all E columns
    ):
        seeds = np.asarray(seed_ids_local, np.int32)
        p, n_local = x_shards.shape[:2]
        if seeds.ndim == 1:
            seeds = np.broadcast_to(seeds[None, :], (p, seeds.shape[0]))
        self._build(
            mesh, ShardedArray.from_blocks(mesh, np.asarray(x_shards, np.float32)),
            ShardedArray.from_blocks(mesh, np.asarray(nbr_shards, np.int32)),
            ShardedArray.from_blocks(mesh, np.asarray(valid_shards, bool)),
            ShardedArray.from_blocks(mesh, seeds[:, None, :]),
            metric, n_local, block_edges,
        )

    @classmethod
    def from_sharded_index(cls, sharded: ShardedIndex, block_edges: int = 0) -> "ShardedQG":
        """Quantize a ShardedIndex where its shards lie (no host copy of
        the rows; the plain angular metrics read the row norms on the
        host, as the reference computes them)."""
        s = sharded._sharded
        self = cls.__new__(cls)
        self._build(s.mesh, s.x, s.nbr, s.valid, s.seed_ids_local, s.metric,
                    s.n_local, block_edges)
        return self

    def _build(self, mesh, x, nbr, valid, seeds, metric, n_local, block_edges):
        self.mesh = mesh
        self.metric = DistanceType(metric)
        self.n_local = int(n_local)
        e = nbr.shape[1]
        self.eb = eb = min(block_edges, e) if block_edges > 0 else e
        angular = self.metric in (DistanceType.COSINE, DistanceType.ANGLE)

        def encoded(xj):
            xj = xj.to(_F32)
            if angular:   # np.linalg.norm's float32 sum, as the reference
                nrm = np.linalg.norm(xj.cpu().numpy(), axis=1, keepdims=True)
                xj = xj / torch.from_numpy(np.maximum(nrm, np.float32(1e-30))).to(xj.device)
            return xj

        rows = [encoded(p) for p in x.parts]   # the rows the codes encode
        amax = _global_max(mesh, [
            r[live].abs().max() if bool(live.any()) else torch.zeros((), dtype=_F32)
            for r, live in zip(rows, valid.parts)])
        # one global scale: the largest live |component| over 127, a float64
        scale = amax / 127.0 if amax > 0 else 0.0
        self.sq_scale = scale or 1.0
        codes, blocks = [], []
        for j, (xj, live) in enumerate(zip(rows, valid.parts)):
            dev = xj.device
            div = torch.full((1,), np.float32(self.sq_scale), dtype=_F32, device=dev)
            cj = torch.zeros(xj.shape, dtype=torch.int8, device=dev)
            for i in range(0, n_local, _QG_CHUNK):
                q8 = torch.clamp(torch.round(xj[i : i + _QG_CHUNK] / div), -127, 127)
                cj[i : i + _QG_CHUNK] = torch.where(
                    live[i : i + _QG_CHUNK, None], q8, 0).to(torch.int8)
            d_pad = cj.shape[1]
            bj = torch.empty((n_local, eb * d_pad), dtype=torch.int8, device=dev)
            for i in range(0, n_local, _QG_CHUNK):
                nb = nbr.parts[j][i : i + _QG_CHUNK, :eb].to(torch.int64)
                blk = cj[nb.clamp(0, n_local - 1)]
                blk[nb < 0] = 0
                bj[i : i + _QG_CHUNK] = blk.reshape(nb.shape[0], -1)
            codes.append(cj)
            blocks.append(bj)
        self.x = x
        self.codes = ShardedArray(mesh, codes, (x.shape[0], x.shape[1]))
        self.blocks = ShardedArray(mesh, blocks, (x.shape[0], eb * x.shape[1]))
        self.nbr = nbr if eb == e else ShardedArray(
            mesh, [p[:, :eb].contiguous() for p in nbr.parts], (nbr.shape[0], eb))
        self.valid = valid
        self.seed_ids_local = seeds

    @trace.public
    def search(self, queries, k: int = 10, epsilon: float = 0.0,
               result_expansion: float = 3.0, width: int = 0):
        """Padded queries [B, D_pad] -> global ids [B, k] int64 (-1 where
        the distance is not finite) and distances, on ``mesh.home``.  With
        the tracer's search family on it records the host span
        ``shard.fanout`` (the shards' work, first issued to last finished),
        per shard s the device spans ``shard<s>.traverse`` (seeds and
        traversal) and ``shard<s>.rerank`` on its device and the counter
        ``shard<s>.steps`` (its traversal steps), and the device span
        ``shard.merge`` on ``mesh.home`` (the copies there and the top-k)."""
        k_exp = max(int(np.ceil(k * max(result_expansion, 1.0))), k)
        return _sharded_qg_search(
            self, torch.as_tensor(queries), k=k, k_exp=k_exp, epsilon=float(epsilon),
            width=width if width > 0 else max(64, 2 * k_exp),
        )


def _query_chunks(b: int) -> list[tuple[int, int, int]]:
    """(first, end, rows) of each chunk of a batch of ``b`` queries: the
    batch whole up to ``QG_QUERY_CHUNK``, else chunks of that many rows."""
    if b <= QG_QUERY_CHUNK:
        return [(0, b, b)]
    return [(lo, min(lo + QG_QUERY_CHUNK, b), QG_QUERY_CHUNK)
            for lo in range(0, b, QG_QUERY_CHUNK)]


def _padded(q: torch.Tensor, rows: int) -> torch.Tensor:
    """``q`` with copies of its first row appended up to ``rows`` rows."""
    if q.shape[0] == rows:
        return q
    return torch.cat([q, q[:1].expand(rows - q.shape[0], -1)])


def _sharded_qg_search(qg: ShardedQG, q, *, k, k_exp, epsilon, width):
    """Per shard, in chunks of queries (``_query_chunks``): the block
    traversal over the sq8 codes (queries normalized for the plain angular
    metrics, then divided by the scale), the exact re-rank of its k_exp
    candidates with the true metric, local ids to global; then the merge.
    A query's answer does not depend on its chunk."""
    from ngt_tpu_torch.ops import distances as D
    from ngt_tpu_torch.quant.qgraph import _rerank_body

    mesh = qg.mesh
    chunks = _query_chunks(q.shape[0])
    angular = qg.metric in (DistanceType.COSINE, DistanceType.ANGLE)

    def shard(j, s):
        dev = mesh.devices[s]
        qd = q.to(dev, _F32)
        qdv = D.normalize_rows(qd) if angular else qd
        div = torch.full((1,), np.float32(qg.sq_scale), dtype=_F32, device=dev)
        qs = qdv / div
        ids, dists, steps = [], [], 0
        for lo, hi, rows in chunks:
            with trace.span(f"shard{s}.traverse", trace.SEARCH, dev):
                res = graph_search(
                    qg.blocks.parts[j], qg.nbr.parts[j], qg.valid.parts[j],
                    _padded(qs[lo:hi], rows), _seed_rows(qg.seed_ids_local.parts[j], rows),
                    metric=DistanceType.L2, k=k_exp, k_radius=k, epsilon=epsilon, width=width,
                    hash_bits=_hash_bits(qg.n_local), exact_hash=True, block_mode=True,
                    seed_x=qg.codes.parts[j],
                )
            cand = res.ids[: hi - lo]
            with trace.span(f"shard{s}.rerank", trace.SEARCH, dev):
                ids1, d1 = _rerank_body(qg.x.parts[j], qd[lo:hi], cand, cand >= 0, qg.metric, k)
            ids.append(ids1)
            dists.append(d1)
            steps += res.iters
        if trace.on(trace.SEARCH):
            trace.add(f"shard{s}.steps", steps)
        return torch.cat(dists), _global_ids(torch.cat(ids), s, qg.n_local)

    with trace.span("shard.fanout", trace.SEARCH):
        dists, gids = zip(*_fan_out(mesh, shard))
    with trace.span("shard.merge", trace.SEARCH, mesh.home):
        out_i, out_d = _merge_topk(mesh, list(dists), list(gids), k)
    return torch.where(torch.isfinite(out_d), out_i, -1), out_d


def build_local_knng_shards(
    x_s: np.ndarray, val_s: np.ndarray, e: int, metric: DistanceType
):
    """Exact per-shard KNNG over each shard's local vectors (each agent
    builds its own graph): one argsort over the port's ``pairwise`` per
    shard, on the host.  Returns (nbr [P, n_local, e] int32, dists
    [P, n_local, e] f32)."""
    from ngt_tpu_torch.ops import distances as D

    p, n_local, _ = x_s.shape
    nbr_s = np.full((p, n_local, e), -1, np.int32)
    nbrd_s = np.full((p, n_local, e), np.inf, np.float32)
    for s in range(p):
        rows = torch.from_numpy(np.ascontiguousarray(x_s[s]))
        d = D.pairwise(DistanceType(metric), rows, rows).cpu().numpy()
        d[:, ~val_s[s]] = np.inf
        d[~val_s[s], :] = np.inf
        np.fill_diagonal(d, np.inf)
        nn = np.argsort(d, axis=1)[:, :e].astype(np.int32)
        nd = np.take_along_axis(d, nn, axis=1)
        nn[~np.isfinite(nd)] = -1
        nbr_s[s] = nn
        nbrd_s[s] = nd.astype(np.float32)
    return nbr_s, nbrd_s


def shard_host_index(
    x_host: np.ndarray,
    nbr_host: np.ndarray,
    valid_host: np.ndarray,
    p: int,
    nbr_dist_host: np.ndarray | None = None,
):
    """Split a host-built index into P self-contained shards (round-robin,
    adjacency remapped to local ids, cross-shard edges dropped).  Pass
    ``nbr_dist_host`` to carry edge distances (the build step's sorted
    insert needs them); surviving edges stay distance-sorted."""
    n = x_host.shape[0]
    n_local = (n + p - 1) // p
    x_s = np.zeros((p, n_local, x_host.shape[1]), x_host.dtype)
    nbr_s = np.full((p, n_local, nbr_host.shape[1]), -1, np.int32)
    nbrd_s = np.full((p, n_local, nbr_host.shape[1]), np.inf, np.float32)
    val_s = np.zeros((p, n_local), bool)
    owner = np.arange(n) % p
    local = np.arange(n) // p
    g2l = np.stack([owner, local], axis=1)
    for s in range(p):
        ids = np.nonzero(owner == s)[0]
        x_s[s, : len(ids)] = x_host[ids]
        val_s[s, : len(ids)] = valid_host[ids]
        adj = nbr_host[ids]
        ok = adj >= 0
        same = np.zeros_like(adj, dtype=bool)
        same[ok] = g2l[adj[ok], 0] == s
        remapped = np.full_like(adj, -1)
        dd = np.full(adj.shape, np.inf, np.float32)
        remapped[same] = g2l[adj[same], 1]
        if nbr_dist_host is not None:
            dd[same] = nbr_dist_host[ids][same]
        # compact: dropped (cross-shard) edges move to the tail, surviving
        # edges keep their distance order (input rows are distance-sorted)
        key = np.where(remapped >= 0, np.arange(adj.shape[1])[None, :],
                       np.iinfo(np.int32).max)
        order = np.argsort(key, axis=1, kind="stable")
        nbr_s[s, : len(ids)] = np.take_along_axis(remapped, order, axis=1)
        nbrd_s[s, : len(ids)] = np.take_along_axis(dd, order, axis=1)
    return x_s, nbr_s, nbrd_s, val_s, n_local
