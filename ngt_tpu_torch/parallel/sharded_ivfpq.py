"""Mesh-sharded IVF+PQ search (the port's counterpart of
``ngt_tpu/parallel/sharded_ivfpq.py``).

* the coarse centroids are replicated (C x D floats) and every shard
  computes the same global top-``nprobe`` probe list;
* each centroid's inverted lists (bucketed int8 decoded-residual rows,
  ``IVFPQIndex.host_blocks``) live on exactly ONE shard, assigned by a
  greedy balance of record counts, so the devices' memory together, not
  one device's, bounds the index;
* every shard scores the probed centroids it owns (probes it does not own
  see empty chains), refines its own top candidates exactly against its
  shard of the raw rows, and the per-shard exact top-k lists merge as in
  ``parallel.sharding``;
* because refinement happens before the merge, the result is the exact
  re-rank of the UNION of per-shard candidate lists, a superset of the
  single-device list at equal expansion.
"""

from __future__ import annotations

import numpy as np
import torch

from ngt_tpu_torch.ops import distances as D
from ngt_tpu_torch.ops.select import topk_pos
from ngt_tpu_torch.parallel.sharding import Mesh, _merge_topk
from ngt_tpu_torch.properties import DistanceType
from ngt_tpu_torch.quant.ivfpq import BUCKET_LEN, SEARCH_BYTES, IVFPQIndex, _probe_lists

INF = float("inf")


class ShardedIVFPQ:
    """Distributed quantized search over a built :class:`IVFPQIndex`.

    Construction moves the bucketed lists and raw rows of this process's
    shards to their devices; persistence stays with the underlying
    ``IVFPQIndex`` (save and open it, then shard it again: the layout is
    derived state)."""

    def __init__(self, mesh: Mesh, idx: IVFPQIndex):
        if not idx.built:
            raise ValueError("shard a BUILT IVFPQIndex")
        if idx._raw is None:
            raise ValueError("sharded refine needs raw vectors")
        idx._flush_pending()
        self.mesh = mesh
        self.metric = idx.metric
        self.dimension = idx.dimension
        nshard = mesh.size
        c = len(idx.centroids)
        assign = idx._assign
        valid = idx._valid if idx._valid.size else np.ones(len(assign), bool)
        self._ids = idx._ids.copy()   # internal row -> external object id
        counts = np.bincount(assign[valid], minlength=c)

        # greedy balance: heaviest centroid to the lightest shard
        shard_of = np.zeros(c, np.int32)
        loads = np.zeros(nshard, np.int64)
        for ci in np.argsort(-counts, kind="stable"):
            s = int(np.argmin(loads))
            shard_of[ci] = s
            loads[s] += counts[ci]
        self.shard_loads = loads

        blocks = [
            idx.host_blocks(np.nonzero((shard_of[assign] == s) & valid)[0])
            for s in range(nshard)
        ]
        nb = max(b["bucket_ids"].shape[0] for b in blocks)
        bc = max(b["cent_buckets"].shape[1] for b in blocks)
        d = idx.dimension
        self.scale = blocks[0]["scale"]
        self.nb, self.bc = nb, bc
        raw = idx._raw
        self._parts = []
        for s in mesh.local_shards:
            b = blocks[s]
            dev = mesh.devices[s]
            nbs = b["bucket_ids"].shape[0]
            cent_buckets = np.full((c, bc), -1, np.int32)
            cent_buckets[:, : b["cent_buckets"].shape[1]] = b["cent_buckets"]
            ids = b["bucket_ids"]                      # [nbs, L] record rows
            # local bucket positions stand in for the record ids: a chain
            # entry points at its row of this shard's raw_flat
            bucket_pos = np.full((nb, BUCKET_LEN), -1, np.int32)
            bucket_pos[:nbs] = np.where(
                ids >= 0, np.arange(nbs * BUCKET_LEN, dtype=np.int32).reshape(nbs, BUCKET_LEN), -1)
            bucket_vals = np.zeros((nb, BUCKET_LEN, d), np.int8)
            bucket_vals[:nbs] = b["bucket_vals"]
            bucket_norm = np.zeros((nb, BUCKET_LEN), np.float32)
            bucket_norm[:nbs] = b["bucket_norm"]
            flat_ids = ids.reshape(-1)
            sel = flat_ids >= 0
            gid_flat = np.full(nb * BUCKET_LEN, -1, np.int32)
            gid_flat[: nbs * BUCKET_LEN] = flat_ids
            raw_flat = np.zeros((nb * BUCKET_LEN, d), np.float32)
            raw_flat[: nbs * BUCKET_LEN][sel] = np.asarray(raw[flat_ids[sel]], np.float32)
            up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            self._parts.append({
                "centroids": up(np.asarray(idx.centroids, np.float32)),
                "cent_buckets": up(cent_buckets), "bucket_pos": up(bucket_pos),
                "bucket_vals": up(bucket_vals), "bucket_norm": up(bucket_norm),
                "gid_flat": up(gid_flat), "raw_flat": up(raw_flat),
            })

    def memory_report(self) -> dict:
        """Device bytes of the sharded arrays over every shard (the
        devices' memory together is the capacity bound)."""
        rows = self.nb * BUCKET_LEN
        per = rows * self.dimension + rows * 4 + rows * 4 + rows * self.dimension * 4
        n = self.mesh.size
        return {
            "n_shards": n,
            "total_bytes": int(per * n),
            "per_shard_bytes": int(per),
            "shard_loads": [int(v) for v in self.shard_loads],
        }

    def _query_chunk(self, kloc: int) -> int:
        """Queries per chunk: SEARCH_BYTES over one query's temporaries (a
        probe's int8 gather and its f32 widening, the refine's rows)."""
        d = self.dimension
        per = max(self.bc * BUCKET_LEN * (5 * d + 32), kloc * (8 * d + 32))
        return max(1, SEARCH_BYTES // per)

    def batch_search(self, queries: np.ndarray, size: int = 10, nprobe: int = 8,
                     result_expansion: float = 3.0):
        """Exact-refined quantized search over all shards: queries [B, dim]
        (the same on every rank) -> (external ids [B, size], -1 where
        empty; distances)."""
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None]
        nprobe = min(nprobe, self._parts[0]["centroids"].shape[0])
        kloc = max(int(np.ceil(size * max(result_expansion, 1.0))), size)
        step = self._query_chunk(kloc)
        outs = []
        for i in range(0, len(q), step):
            outs.append(_sharded_ivfpq_search(
                self, torch.from_numpy(np.ascontiguousarray(q[i : i + step])),
                nprobe=nprobe, size=size, kloc=kloc))
        rows = torch.cat([o[0] for o in outs]).cpu().numpy()
        dists = torch.cat([o[1] for o in outs]).cpu().numpy()
        if len(self._ids):   # internal rows -> stable external ids
            safe = np.clip(rows, 0, len(self._ids) - 1)
            rows = np.where(rows >= 0, self._ids[safe], -1)
        return rows, dists


def _sharded_ivfpq_search(sh: ShardedIVFPQ, q, *, nprobe, size, kloc):
    """Per shard: the replicated global probe, this shard's bucket chains
    scored (local positions), the exact refine of its candidates; then the
    merge of the per-shard exact lists."""
    dists, gids = [], []
    for j, s in enumerate(sh.mesh.local_shards):
        part = sh._parts[j]
        qd = q.to(sh.mesh.devices[s])
        _, probe = topk_pos(D.pairwise(DistanceType.L2, qd, part["centroids"]), nprobe)
        qr = qd[:, None, :] - part["centroids"][probe]
        pos, _ = _probe_lists(part["cent_buckets"], part["bucket_pos"], part["bucket_vals"],
                              part["bucket_norm"], sh.scale, qr, probe, kloc)
        raw_flat = part["raw_flat"]
        safe = pos.to(torch.int64).clamp(0, raw_flat.shape[0] - 1)
        g = torch.where(pos >= 0, part["gid_flat"][safe].to(torch.int64), -1)
        dd = D.gathered(sh.metric, qd, raw_flat[safe])
        dists.append(torch.where(g >= 0, dd, INF))
        gids.append(g)
    out_i, out_d = _merge_topk(sh.mesh, dists, gids, size)
    return torch.where(torch.isfinite(out_d), out_i, -1), out_d
