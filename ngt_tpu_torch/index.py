"""Index facade (the port's counterpart of ``ngt_tpu/index.py``) — create /
insert / build / search / save / open.

The API mirrors the reference's Python surface (``ngtpy``,
python/src/ngtpy.cpp:28-639): zero-based external ids by default,
``insert`` + ``build_index`` resume semantics, ε / edge-size search knobs,
and an index directory with an NGT-compatible ``prf`` file.  The directory
layout is the JAX package's (``prf``, ``objects.npy``, the graph ``.npy``
files, ``seeds.npz``, ``meta.json``), so each package opens the other's
indexes.

Every entry point runs on ``device`` (default ``"cuda"``).  The port
covers every metric and object type of the reference; the bulk build of a
fresh index and of large appends, the incremental ANNG build of smaller
appends (``build_algorithm``, ``bulk_append_threshold``), removal
(``remove``, ``batch_remove``), graph inspection (``get_edges``,
``check_graph``, ``statistics``), k-means seeds (``optimize_seeds``) and
every search route of the reference: the exact-graph route, and for the
metrics the quantized codes serve, at ``search_qg_threshold`` (5,000)
nodes or more with default properties, the quantized-graph route
(``quant/qgraph.py``: sq8 codes, or pq4 codes once the block budget
``NGT_TPU_QG_BLOCK_GB`` holds fewer than 8 sq8 columns), and past the
size ceiling ``NGT_TPU_QG_MAX_GB`` an auto-built IVFPQ mirror
(``quant/ivfpq.py``; ``search_fallback="exact"`` takes the exact route
instead).  ``ngt_tpu_torch.optimizer.GraphOptimizer`` rebuilds the graph
as an ONNG (``graph/reconstruct.py``) and tunes it; ``expected_accuracy``
maps to ε through the accuracy table it stores.  ``batch_insert_dedup`` is
the reference's range-gated insert; ``export_index`` / ``import_index``
carry an index through the lossless v2 text stream (formatted and parsed
by the host library, byte for byte as the JAX package writes it, so an
export of either package imports into the other), and
``open_index(memory_mapped=True)`` opens the arrays as copy-on-write maps.
"""

from __future__ import annotations

import io
import json
import math
import os
import shutil
import tempfile
from typing import Optional

import numpy as np
import torch

from ngt_tpu_torch.graph.build import (
    _SQ8_METRICS,
    DeviceMirror,
    batch_remove_objects,
    build_anng,
    build_bulk,
    remove_object,
)
from ngt_tpu_torch import native, trace
from ngt_tpu_torch.graph.search import seeded_search, wrap_hash_bits
from ngt_tpu_torch.graph.storage import GraphStore
from ngt_tpu_torch.ops import bruteforce as BF
from ngt_tpu_torch.quant.ivfpq import IVFPQIndex
from ngt_tpu_torch.properties import (
    IndexType,
    ObjectType,
    Property,
    resolve_distance_type,
    resolve_object_type,
)
from ngt_tpu_torch.seeds import Seeder, default_reps
from ngt_tpu_torch.store import VectorStore, pad_sparse
from ngt_tpu_torch.utils import logger

FORMAT_VERSION = 1


class Index:
    def __init__(
        self,
        path: Optional[str] = None,
        prop: Optional[Property] = None,
        zero_based_numbering: bool = True,
        memory_mapped: bool = False,
        device="cuda",
    ):
        self.path = path
        self.zero_based = zero_based_numbering
        self.device = torch.device(device)
        #: the quantized-graph mirror of the auto route (``_maybe_qg``)
        self._qg = None
        #: set by ``_maybe_qg`` when the index outgrew the qg size ceiling
        self._qg_size_blocked = self._qg_size_warned = False
        #: the IVFPQ mirror past that ceiling (``_maybe_ivfpq``), the store
        #: key it was built at, and its rows' internal ids
        self._ivfpq_mirror = self._ivfpq_key = self._ivfpq_ids = None
        if path is not None and os.path.exists(os.path.join(path, "prf")):
            self._load(path, memory_mapped=memory_mapped)
            return
        if prop is None:
            raise ValueError("need an existing index path or a Property")
        self.prop = prop.copy()
        self.store = VectorStore(
            dimension=prop.dimension,
            metric=prop.distance_type,
            object_type=prop.object_type,
            device=self.device,
        )
        self.graph = GraphStore(max_edges=prop.max_edges)
        self.seeder = Seeder(prop.distance_type, seed_size=prop.seed_size,
                             device=self.device)
        self._mirror: Optional[DeviceMirror] = None

    # ------------------------------------------------------------- ids -----
    def _ext(self, internal):
        if isinstance(internal, (int, np.integer)):
            return int(internal) - 1 if self.zero_based else int(internal)
        out = np.asarray(internal)
        if self.zero_based:
            out = np.where(out >= 0, out - 1, out)
        return out

    def _int(self, external) -> int:
        return int(external) + 1 if self.zero_based else int(external)

    # --------------------------------------------------------- mutation ----
    def insert(self, v) -> int:
        """Insert one vector (no graph node yet — call build_index)."""
        return self._ext(self.store.insert(np.asarray(v)))

    @trace.public
    def batch_insert(self, vs, build: bool = True) -> np.ndarray:
        """Insert many vectors and (by default) index them."""
        ids = self.store.batch_insert(np.asarray(vs))
        if build:
            self.build_index()
        return self._ext(ids)

    def batch_insert_dedup(self, vs, radius: float, build: bool = True
                           ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Range-gated deduplicating insert, the reference's
        ``createIndex(objects, ids, range, threadSize)`` (Index.cpp:1303-1352;
        ngt_tpu/index.py:101-221): a row whose nearest stored object, or
        nearest EARLIER batch row that was itself inserted, lies within
        ``radius`` is not inserted; it reports that object instead.

        Returns ``(ids, identical, dist)`` per input row: the external id
        (the surviving object's for a deduplicated row), the identical flag
        and the matched distance (0 for an inserted row).

        The store check is one exact ``batch_linear_search``; the
        intra-batch check is a pairwise top-m (m = 16) of the earlier rows
        in 4,096-row blocks, ties to the lower row as ``jax.lax.top_k``
        orders them; the rows with an earlier neighbor within the radius
        are then resolved in order, with an exact re-check against every
        earlier inserted row where all m were within-radius rows that were
        not inserted."""
        from ngt_tpu_torch.ops import distances as D
        from ngt_tpu_torch.ops.select import topk_pos

        vs = np.asarray(vs, dtype=self._qdtype())
        if vs.ndim == 1:
            vs = vs[None]
        prepared = self.store._prepare(vs)
        b = len(prepared)
        radius = float(radius)
        metric = self.store.metric

        # the nearest stored object (one exact scan)
        store_id = np.full(b, -1, np.int64)
        store_d = np.full(b, np.inf, np.float32)
        if len(self.store) > 0:
            sid, sd = self.batch_linear_search(vs, size=1)
            store_id = np.asarray(sid)[:, 0].astype(np.int64)
            store_d = np.asarray(sd)[:, 0].astype(np.float32)
            store_id[~np.isfinite(store_d)] = -1

        # the top-m EARLIER batch rows of each row (blocked pairwise, j < i)
        m = int(min(16, max(b - 1, 1)))
        inb_j = np.full((b, m), -1, np.int64)
        inb_d = np.full((b, m), np.inf, np.float32)
        if b > 1:
            xb = torch.from_numpy(prepared).to(self.device)
            cols = torch.arange(b, device=self.device)
            step = 4096
            for s in range(0, b, step):
                dd = D.pairwise(metric, xb[s : s + step], xb)
                rows = torch.arange(s, min(s + step, b), device=self.device)[:, None]
                dd = torch.where(cols[None, :] < rows, dd, float("inf"))
                d_top, j_top = topk_pos(dd, m)
                inb_d[s : s + step] = d_top.cpu().numpy()
                inb_j[s : s + step] = j_top.cpu().numpy()
            inb_j[~np.isfinite(inb_d)] = -1

        identical = np.zeros(b, bool)
        match_store = np.full(b, -1, np.int64)   # external id when matched
        match_batch = np.full(b, -1, np.int64)   # batch row when matched
        match_d = np.zeros(b, np.float32)
        inserted = np.zeros(b, bool)
        cand = (store_d <= radius) | (inb_d[:, 0] <= radius)
        inserted[~cand] = True
        for i in np.nonzero(cand)[0]:
            best_d = store_d[i] if store_d[i] <= radius else np.inf
            best_b = -1
            saturated = True
            for j, dj in zip(inb_j[i], inb_d[i]):
                if dj > radius or not np.isfinite(dj):
                    saturated = False
                    break
                if inserted[j]:
                    # the list is ascending: its first inserted row is the
                    # nearest inserted one
                    if dj < best_d:
                        best_d, best_b = float(dj), int(j)
                    saturated = False
                    break
            if saturated and m < b - 1:
                # all m were within-radius rows that were not inserted: a
                # farther inserted row may hide past the window, so check
                # every earlier inserted row exactly
                prev = np.nonzero(inserted[:i])[0]
                if len(prev):
                    dall = D.pairwise(
                        metric, torch.from_numpy(prepared[i][None]).to(self.device),
                        torch.from_numpy(prepared[prev]).to(self.device),
                    )[0].cpu().numpy()
                    jj = int(np.argmin(dall))
                    if dall[jj] <= radius and dall[jj] < best_d:
                        best_d, best_b = float(dall[jj]), int(prev[jj])
            if np.isfinite(best_d):
                identical[i] = True
                match_d[i] = best_d
                if best_b >= 0:
                    match_batch[i] = best_b
                else:
                    match_store[i] = store_id[i]
            else:
                inserted[i] = True

        new_ids = np.full(b, -1, np.int64)
        rows = np.nonzero(inserted)[0]
        if len(rows):
            ids_int = self.store.batch_insert(vs[rows])
            new_ids[rows] = np.asarray(self._ext(ids_int))
            if build:
                self.build_index()
        out_ids = new_ids.copy()
        mb = match_batch >= 0
        out_ids[mb] = new_ids[match_batch[mb]]
        ms = match_store >= 0
        out_ids[ms] = match_store[ms]
        dist = np.where(inserted, np.float32(0), match_d).astype(np.float32)
        return out_ids, identical, dist

    @trace.public
    def build_index(self, num_threads: int = 0) -> None:
        """Create graph nodes for all unindexed objects (Index::createIndex,
        Index.cpp:609-629).  ``build_algorithm`` "bulk" always takes the
        bulk build, "auto" takes it for a fresh index and for appends of at
        least ``bulk_append_threshold`` objects, and everything else takes
        the incremental ANNG build (ngt_tpu/index.py:223-244)."""
        del num_threads
        n = self.store.repository_size
        self.graph.ensure_capacity(self.store._x.shape[0])
        pending = np.nonzero(
            self.store._valid[:n] & ~self.graph._has_node[:n]
        )[0].astype(np.int32)
        if len(pending) == 0:
            return
        algo = self.prop.build_algorithm
        fresh = self.graph.node_count() == 0
        big_append = len(pending) >= self.prop.bulk_append_threshold
        build = build_bulk if algo == "bulk" or (
            algo == "auto" and (fresh or big_append)) else build_anng
        self._mirror = build(
            self.store, self.graph, self.seeder, self.prop, pending, self._mirror,
        )

    def _resample_seeds(self, gone: np.ndarray) -> None:
        """Resample the representatives when a removed object was one (the
        reference replaces the removed tree slot, Index.h:1423-1453)."""
        if self.seeder.num_reps and np.isin(self.seeder.rep_ids, gone).any():
            live = np.nonzero(self.store._valid[: self.store.repository_size])[0]
            self.seeder.refresh(live.astype(np.int32), self.store._x,
                                self.seeder.num_reps)

    def remove(self, external_id: int) -> None:
        """Delete one object (ngt_tpu/index.py:248-271): its slot goes to
        the free list, its graph neighborhood is repaired, and the changed
        rows are scattered into the device mirror."""
        oid = self._int(external_id)
        if not self.store.contains(oid):
            raise KeyError(f"no such object id: {external_id}")
        touched = remove_object(self.store, self.graph, oid, self.store.metric)
        if self._mirror is not None:
            self._mirror.update_rows(touched, touched)
        self._resample_seeds(np.asarray([oid]))

    def batch_remove(self, external_ids) -> None:
        """Delete a set of objects with batch-wide passes: one reverse scan,
        one repair, one mirror scatter (ngt_tpu/index.py:273-298)."""
        oids = np.unique([self._int(e) for e in np.asarray(external_ids).ravel()])
        for oid in oids:
            if not self.store.contains(int(oid)):
                raise KeyError(f"no such object id: {oid}")
        touched = batch_remove_objects(self.store, self.graph, oids, self.store.metric)
        if self._mirror is not None:
            self._mirror.update_rows(touched, touched)
        self._resample_seeds(oids)

    def get_edges(self, external_id: int) -> list[tuple[int, float]]:
        """Sorted (neighbor id, distance) edges of one graph node (the
        analogue of ngt_get_edges), ids in this index's id base."""
        oid = self._int(external_id)
        if not self.graph.has_node(oid):
            raise KeyError(f"no graph node for id {external_id}")
        ids, dists = self.graph.get_node(oid)
        return [(int(self._ext(int(i))), float(d)) for i, d in zip(ids, dists) if i >= 0]

    def make_sparse_object(self, ids) -> np.ndarray:
        """Pack a feature-id set for a Sparse-Jaccard index (the analogue of
        Index::makeSparseObject, Index.cpp:303-320)."""
        return pad_sparse([ids], self.store.dimension)[0]

    def insert_sparse(self, ids) -> int:
        return self.insert(self.make_sparse_object(ids))

    def optimize_seeds(self, num_reps: int = 0) -> None:
        """Replace the sampled seed representatives with k-means centroids'
        nearest live rows (``Seeder.finalize_kmeans``); ``num_reps`` 0
        scales with the index (``default_reps``)."""
        n = self.store.repository_size
        live = np.nonzero(self.store._valid[:n] & self.graph._has_node[:n])[0].astype(np.int32)
        reps = num_reps if num_reps > 0 else default_reps(len(live))
        self.seeder.finalize_kmeans(live, self.store._x, num_reps=reps)

    def _qdtype(self):
        """Query dtype on the host: id sets for a sparse store."""
        return np.int64 if self.store.sparse else np.float32

    def get_object(self, external_id: int) -> np.ndarray:
        return self.store.get(self._int(external_id))

    def __len__(self) -> int:
        return len(self.store)

    # ------------------------------------------------------------ search ----
    def _ensure_mirror(self) -> DeviceMirror:
        # also re-sync a mirror whose arrays a failed build dropped
        if self._mirror is None:
            self._mirror = DeviceMirror(self.store, self.graph)
        if self._mirror.x is None:
            self._mirror.sync_full()
        return self._mirror

    def _auto_width(self, k: int, epsilon: float) -> int:
        if self.prop.search_width > 0:
            return max(self.prop.search_width, k)
        w = max(64, 2 * k, int(k * (1.0 + 8.0 * max(epsilon, 0.0))))
        return 1 << int(math.ceil(math.log2(w)))

    def _resolve_edge_size(self, edge_size: int, epsilon: float) -> int:
        """Per-search edge count (NeighborhoodGraph::getEdgeSize,
        Graph.h:675-692): -1 = property default, 0 = unlimited, >0 =
        explicit, -2 = dynamic ``base + 10^(ε·rate)``."""
        if edge_size == -1:
            return min(self.prop.edge_size_for_search, self.graph.e_max)
        if edge_size == 0:
            return self.graph.e_max
        if edge_size == -2:
            add = 10.0 ** (epsilon * float(self.prop.dynamic_edge_size_rate))
            e = self.prop.dynamic_edge_size_base + int(min(add, 2**31 - 1))
            return min(e, self.graph.e_max)
        if edge_size > 0:
            return min(int(edge_size), self.graph.e_max)
        raise ValueError(f"invalid edge size: {edge_size}")

    def _maybe_qg(self):
        """The quantized-graph mirror that plain ``batch_search`` calls
        take (ngt_tpu/index.py:362-428), or None where the exact route
        serves: search_mode "exact", a sparse store, a metric outside
        ``_SQ8_METRICS``, fewer than search_qg_threshold nodes (unless
        search_mode is "qg"), an empty graph, or, on the auto route, an
        index whose floor-width blocks and codes exceed NGT_TPU_QG_MAX_GB
        (9 GiB; sets ``_qg_size_blocked``).  The mirror refreshes itself
        on inserts and graph changes."""
        from ngt_tpu_torch.quant.qgraph import QuantizedGraphIndex

        self._qg_size_blocked = False
        mode = self.prop.search_mode
        if mode == "exact" or self.store.sparse:
            return None
        if self.store.metric not in _SQ8_METRICS:
            return None
        n = self.graph.node_count()
        if mode != "qg" and n < self.prop.search_qg_threshold:
            return None
        if n == 0:
            return None
        if mode != "qg" and self._qg is None:
            cap = self.store._x.shape[0]
            d_pad = self.store.d_pad
            fmt = QuantizedGraphIndex.pick_mode(cap, d_pad)
            bpd = d_pad if fmt == "sq8" else -(-d_pad // 4)   # bytes/row-edge
            floor_bytes = cap * 8 * bpd + cap * bpd   # floor blocks + codes
            max_gb = float(os.environ.get("NGT_TPU_QG_MAX_GB", "9"))
            if floor_bytes > max_gb * (1 << 30):
                self._qg_size_blocked = True
                if not self._qg_size_warned:
                    self._qg_size_warned = True
                    logger.warning(
                        "%s mirror skipped: %d-row blocks need %.1f GiB even at "
                        "the width floor (> NGT_TPU_QG_MAX_GB=%g); auto-routing "
                        "falls through to %s", fmt, cap, floor_bytes / (1 << 30), max_gb,
                        "an IVFPQ mirror" if self.prop.search_fallback == "ivfpq"
                        else "the exact route",
                    )
                return None
        if self._qg is None:
            self._qg = QuantizedGraphIndex.quantize(self, mode="auto")
        return self._qg

    def _maybe_ivfpq(self):
        """The IVFPQ mirror past the qg size ceiling (ngt_tpu/index.py:
        430-503), or None where it does not apply (search_fallback other
        than "ivfpq", an object type other than float, bfloat16 or uint8,
        no live rows).  Built from the live rows with min(2^14, max(256,
        live / 2048)) centroids and rebuilt whenever the store's
        (mutation_count, repository_size) changes; raw rows stay on the
        device up to NGT_TPU_AUTO_IVFPQ_RAW_GB (4 GiB), else in an mmap
        file (``auto_ivfpq_raw.f32`` in the index directory, or the
        temporary directory)."""
        if self.prop.search_fallback != "ivfpq":
            return None
        if self.store.object_type not in (ObjectType.FLOAT, ObjectType.BFLOAT16,
                                          ObjectType.UINT8):
            return None
        key = (self.store.mutation_count, self.store.repository_size)
        if self._ivfpq_mirror is not None and self._ivfpq_key == key:
            return self._ivfpq_mirror
        n = self.store.repository_size
        live = np.nonzero(self.store._valid[:n])[0]
        if len(live) == 0:
            return None
        self._ivfpq_mirror = None   # free the stale mirror first
        raw_gb = float(os.environ.get("NGT_TPU_AUTO_IVFPQ_RAW_GB", "4"))
        raw_store, raw_path = "device", None
        if len(live) * self.store.dimension * 4 > raw_gb * (1 << 30):
            raw_store = "mmap"
            raw_path = os.path.join(self.path or tempfile.gettempdir(), "auto_ivfpq_raw.f32")
        n_centroids = int(min(1 << 14, max(256, len(live) // 2048)))
        logger.warning(
            "building the auto IVFPQ mirror for %d rows (%d centroids, raw=%s); "
            "search_fallback='exact' opts out", len(live), n_centroids, raw_store,
        )
        ivf = IVFPQIndex(dimension=self.store.dimension, n_centroids=n_centroids,
                         metric=self.store.metric, raw_store=raw_store,
                         raw_path=raw_path, device=self.device)
        step = 1 << 20
        for s in range(0, len(live), step):
            ivf.batch_insert(np.asarray(
                self.store._x[live[s : s + step], : self.store.dimension], np.float32))
        ivf.build()
        self._ivfpq_mirror, self._ivfpq_ids, self._ivfpq_key = ivf, live.astype(np.int64), key
        return ivf

    @trace.public
    def batch_search(
        self,
        queries,
        size: int = 10,
        epsilon: float = 0.1,
        radius: float = float("inf"),
        edge_size: int = -1,
        width: int = 0,
        expand: int = 0,
        expected_accuracy: float = -1.0,
        with_stats: bool = False,
        ef: int = 0,
    ):
        """Batched k-NN over the graph. queries: [B, dim].  Returns
        (ids [B, k] external, dists [B, k]); -1 id = empty slot.
        ``expected_accuracy`` > 0 maps to ε through the accuracy table
        (Index.h:1156-1158; ngt_tpu/index.py:541-551)."""
        if expected_accuracy > 0:
            from ngt_tpu_torch.optimizer import AccuracyTable

            if not self.prop.accuracy_table:
                raise ValueError(
                    "expected_accuracy needs an accuracy table; run "
                    "ngt_tpu_torch.optimizer.generate_accuracy_table first"
                )
            epsilon = AccuracyTable.from_string(
                self.prop.accuracy_table).get_epsilon(expected_accuracy)
        if (not with_stats and edge_size == -1 and not np.isfinite(radius)
                and expand == 0 and width == 0):
            qg = self._maybe_qg()
            if qg is not None:
                return qg.batch_search(
                    queries, size=size, epsilon=epsilon,
                    result_expansion=self.prop.result_expansion, ef=ef,
                )
            ivf = self._maybe_ivfpq() if self._qg_size_blocked else None
            if ivf is not None:
                # past the block ceiling: the qg -> IVFPQ crossover
                nprobe = int(os.environ.get("NGT_TPU_AUTO_IVFPQ_NPROBE", "32"))
                exp = float(os.environ.get("NGT_TPU_AUTO_IVFPQ_EXP", "16"))
                q = self.store.prepare_queries_host(
                    np.asarray(queries, np.float32))[:, : self.store.dimension]
                rows, dists = ivf.batch_search(q, size=size, nprobe=nprobe,
                                               result_expansion=exp, mode="refine")
                n_ids = len(self._ivfpq_ids)
                ok = (rows >= 0) & (rows < n_ids)
                ids = np.where(ok, self._ivfpq_ids[np.clip(rows, 0, n_ids - 1)], -1)
                return self._ext(ids), dists
        mirror = self._ensure_mirror()
        q = self.store.prepare_queries(np.asarray(queries, dtype=self._qdtype()))
        b = q.shape[0]
        if self.seeder.num_reps == 0 and self.graph.node_count() > 0:
            live = np.nonzero(self.graph._has_node)[0].astype(np.int32)
            self.seeder.refresh(live, self.store._x, default_reps(len(live)))
        e = self._resolve_edge_size(edge_size, epsilon)
        bits, exact = wrap_hash_bits(mirror.capacity, self.prop.visited_bits_log2)
        # exploration rank: a pool of kk = ef keeps the frontier alive until
        # the ef-th best stops improving; the first `size` are returned
        if ef <= 0:
            ef = max(int(self.prop.search_ef), 0)
        kk = min(max(int(size), ef), 4 * int(size) + 64) if ef > 0 else int(size)
        if self.seeder.num_reps == 0:
            res_ids = np.full((b, kk), -1, np.int64)
            res_d = np.full((b, kk), np.inf, np.float32)
            stats = {"visit_count": np.zeros(b, np.int32),
                     "distance_count": np.zeros(b, np.int32), "iters": 0}
        else:
            res = seeded_search(
                mirror.x, mirror.nbr, mirror.valid,
                self.seeder._rep_rows, self.seeder._rep_ids_dev, q,
                x_sqnorm=mirror.sqnorm,
                rep_sq=self.seeder._rep_sq if mirror.sqnorm is not None else None,
                metric=self.store.metric, k=kk, s=int(self.prop.seed_size),
                epsilon=epsilon, radius=radius, edge_size=e,
                width=width if width > 0 else self._auto_width(kk, epsilon),
                hash_bits=bits, exact_hash=exact,
                expand=expand if expand > 0 else max(self.prop.search_expand, 1),
            )
            res_ids, res_d = res.ids.cpu().numpy(), res.dists.cpu().numpy()
            stats = {"visit_count": res.visit_count.cpu().numpy(),
                     "distance_count": res.dist_count.cpu().numpy(),
                     "iters": int(res.iters)}
        ids = self._ext(res_ids[:, : int(size)])
        dists = res_d[:, : int(size)]
        if with_stats:
            return ids, dists, stats
        return ids, dists

    def search(self, query, size: int = 10, epsilon: float = 0.1,
               radius: float = float("inf"), edge_size: int = -1,
               expected_accuracy: float = -1.0, with_distance: bool = True):
        """Single-query search returning [(id, dist)] like ngtpy
        (ngtpy.cpp:172-240)."""
        ids, dists = self.batch_search(
            np.asarray(query, dtype=self._qdtype())[None, :], size=size,
            epsilon=epsilon, radius=radius, edge_size=edge_size,
            expected_accuracy=expected_accuracy,
        )
        out = [
            (int(i), float(d))
            for i, d in zip(ids[0], dists[0])
            if i >= (0 if self.zero_based else 1) and np.isfinite(d)
        ]
        return out if with_distance else [i for i, _ in out]

    def batch_linear_search(self, queries, size: int = 10):
        """Exact batched top-k — also the ground-truth generator of the
        recall harness (the reference generates GT with `ngt search -i s`)."""
        x, valid, sqn = self.store.device_arrays()
        q = self.store.prepare_queries(np.asarray(queries, dtype=self._qdtype()))
        ids, dists = BF.linear_search(
            q, x, valid, self.store.metric, int(size), x_sqnorm=sqn
        )
        return self._ext(ids.cpu().numpy()), dists.cpu().numpy()

    def linear_search(self, query, size: int = 10):
        """Exact search (ngtpy linear_search; ObjectSpaceRepository.h:466)."""
        ids, dists = self.batch_linear_search(
            np.asarray(query, dtype=self._qdtype())[None, :], size)
        return [
            (int(i), float(d))
            for i, d in zip(ids[0], dists[0])
            if i >= (0 if self.zero_based else 1) and np.isfinite(d)
        ]

    # ------------------------------------------------------------ verify ----
    def verify(self) -> list[str]:
        """Structural invariant check (GraphIndex::verify, Index.h:940-1053).
        Returns a list of problems (empty = ok)."""
        errs: list[str] = []
        n = self.store.repository_size
        live = self.store._valid[:n]
        has = self.graph._has_node[:n]
        if (live & ~has).any():
            errs.append(f"{int((live & ~has).sum())} objects lack graph nodes")
        if (~live & has).any():
            errs.append(f"{int((~live & has).sum())} graph nodes lack objects")
        nbr = self.graph.nbr_ids[:n]
        deg = self.graph.degree[:n]
        in_deg = np.arange(nbr.shape[1])[None, :] < deg[:, None]
        edges = nbr[in_deg]
        if len(edges):
            if (edges < 0).any():
                errs.append("negative edge inside degree range")
            bad = ~live[np.clip(edges, 0, n - 1)] | (edges >= n)
            if bad.any():
                errs.append(f"{int(bad.sum())} edges point to dead/out-of-range ids")
        rows = np.nonzero((nbr == np.arange(n)[:, None]) & in_deg)[0]
        if len(rows):
            errs.append(f"{len(rows)} self-edges")
        d = np.where(
            np.isfinite(self.graph.nbr_dist[:n]),
            self.graph.nbr_dist[:n],
            np.float32(3.0e38),
        )
        if not (np.diff(d, axis=1)[in_deg[:, 1:]] >= -1e-6).all():
            errs.append("edge lists not sorted by distance")
        errs.extend(self.seeder.verify(live, self.store._x[:n]))
        return errs

    def check_graph(self, sample: int = 1024, seed: int = 0) -> dict:
        """Re-derive sampled nodes' edges by exact search on the store's
        device and compare them with the stored rows (the reference's
        checkGraph, Index.h:886-938; ngt_tpu/index.py:774-822).  Returns
        {'checked', 'mean_overlap', 'min_overlap', 'divergent'}: the
        overlap is the share of a node's stored edges found among its
        exact top-(degree) neighbors; 'divergent' counts nodes below 1."""
        n = self.store.repository_size
        live = np.nonzero(self.store._valid[:n] & self.graph._has_node[:n])[0]
        if len(live) == 0:
            return {"checked": 0, "mean_overlap": 1.0, "min_overlap": 1.0,
                    "divergent": 0}
        rng = np.random.default_rng(seed)
        pick = live if len(live) <= sample else np.sort(
            rng.choice(live, sample, replace=False))
        deg = self.graph.degree[pick].astype(np.int64)
        kmax = int(max(deg.max(), 1))
        x, valid, sqn = self.store.device_arrays()
        q = torch.from_numpy(self.store._x[pick]).to(self.device)
        # k+1: the exact list holds the node itself at distance 0
        ids, _ = BF.linear_search(q, x, valid, self.store.metric, kmax + 1, x_sqnorm=sqn)
        ids = ids.cpu().numpy()
        ids = np.where(ids == pick[:, None], -1, ids)
        stored = self.graph.nbr_ids[pick]
        overlaps = np.empty(len(pick), np.float64)
        for i in range(len(pick)):
            d = int(deg[i])
            if d == 0:
                overlaps[i] = 1.0
                continue
            exact = set(ids[i][ids[i] >= 0][:d].tolist())
            overlaps[i] = sum(1 for e in stored[i, :d] if int(e) in exact) / d
        return {
            "checked": int(len(pick)),
            "mean_overlap": float(overlaps.mean()),
            "min_overlap": float(overlaps.min()),
            "divergent": int((overlaps < 1.0).sum()),
        }

    def statistics(self) -> dict:
        """Graph statistics (the analogue of showStatisticsOfGraph,
        Index.cpp:800-1154; ngt_tpu/index.py:824-866): out- and in-degree,
        edge lengths and the mean length of the first 10 edges."""
        n = self.store.repository_size
        has = self.graph._has_node[:n]
        deg = self.graph.degree[:n][has]
        nbr = self.graph.nbr_ids[:n]
        dist = self.graph.nbr_dist[:n]
        in_rng = np.arange(nbr.shape[1])[None, :] < self.graph.degree[:n][:, None]
        edges = nbr[in_rng]
        indeg = (np.bincount(edges[edges >= 0], minlength=n)[has]
                 if len(edges) else np.zeros(0, int))
        lens = dist[in_rng]
        lens = lens[np.isfinite(lens)]
        d10 = dist[:, : min(10, dist.shape[1])]
        d10 = d10[np.isfinite(d10)]

        def stat(a, f, empty):
            return f(a) if len(a) else empty

        return {
            "nodes": int(has.sum()),
            "edges": int(deg.sum()),
            "outdegree": {
                "min": stat(deg, lambda a: int(a.min()), 0),
                "mean": stat(deg, lambda a: float(a.mean()), 0.0),
                "max": stat(deg, lambda a: int(a.max()), 0),
                "histogram": stat(deg, lambda a: np.bincount(a).tolist(), []),
            },
            "indegree": {
                "min": stat(indeg, lambda a: int(a.min()), 0),
                "mean": stat(indeg, lambda a: float(a.mean()), 0.0),
                "max": stat(indeg, lambda a: int(a.max()), 0),
                "zero": stat(indeg, lambda a: int((a == 0).sum()), 0),
            },
            "edge_length": {
                "mean": stat(lens, lambda a: float(a.mean()), 0.0),
                "mean_10nn": stat(d10, lambda a: float(a.mean()), 0.0),
            },
        }

    # ------------------------------------------------------- persistence ----
    def save(self, path: Optional[str] = None) -> None:
        path = path or self.path
        if path is None:
            raise ValueError("no path")
        os.makedirs(path, exist_ok=True)
        self.prop.dimension = self.store.dimension
        self.prop.save(os.path.join(path, "prf"))
        n = self.store.repository_size
        np.save(os.path.join(path, "objects.npy"), self.store._x[:n])
        gs = self.graph.state_dict(n)
        ss = self.store.state_dict()
        for name, arr in (
            ("nbr_ids", gs["nbr_ids"]),
            ("nbr_dist", gs["nbr_dist"]),
            ("degree", gs["degree"]),
            ("has_node", gs["has_node"]),
            ("valid", ss["valid"]),
            ("free", ss["free"]),
        ):
            np.save(os.path.join(path, name + ".npy"), arr)
        legacy = os.path.join(path, "graph.npz")   # round-1 layout, now stale
        if os.path.exists(legacy):
            os.remove(legacy)
        np.savez(os.path.join(path, "seeds.npz"), rep_ids=self.seeder.rep_ids)
        with open(os.path.join(path, "meta.json"), "w") as fh:
            json.dump(
                {
                    "format_version": FORMAT_VERSION,
                    "size": n,
                    "e_max": int(self.graph.e_max),
                    "framework": "ngt_tpu_torch",
                },
                fh,
            )
        self.path = path

    def _load(self, path: str, memory_mapped: bool = False) -> None:
        self.prop = Property.load_dir(path)
        # copy-on-write maps: reader processes share the page cache, and
        # this process's writes stay private (ngt_tpu/index.py:907-947)
        mm = "c" if memory_mapped else None
        if os.path.exists(os.path.join(path, "graph.npz")):   # round-1 layout
            g = dict(np.load(os.path.join(path, "graph.npz")))
        else:
            g = {
                name: np.load(os.path.join(path, name + ".npy"), mmap_mode=mm)
                for name in ("nbr_ids", "nbr_dist", "degree", "has_node",
                             "valid", "free")
            }
            with open(os.path.join(path, "meta.json")) as fh:
                g["e_max"] = json.load(fh)["e_max"]
        self.store = VectorStore.from_state(
            {
                "x": np.load(os.path.join(path, "objects.npy"), mmap_mode=mm),
                "valid": g["valid"],
                "free": g["free"],
                "dimension": self.prop.dimension,
                "metric": int(self.prop.distance_type),
                "object_type": int(self.prop.object_type),
            },
            device=self.device,
            copy=not memory_mapped,
        )
        self.graph = GraphStore.from_state(
            {k: g[k] for k in ("nbr_ids", "nbr_dist", "degree", "has_node", "e_max")},
            copy=not memory_mapped,
        )
        self.graph.ensure_capacity(self.store._x.shape[0])
        self.seeder = Seeder(self.prop.distance_type, seed_size=self.prop.seed_size,
                             device=self.device)
        rep = np.load(os.path.join(path, "seeds.npz"))["rep_ids"]
        if len(rep):
            self.seeder.set_representatives(rep, self.store._x)
        self._mirror = None
        self._qg = self._ivfpq_mirror = None
        self.path = path

    def replace_graph(self, graph: GraphStore) -> None:
        """Take ``graph`` as the index's adjacency (a rebuilt graph, or the
        current one rewritten in place) and drop the device adjacency of the
        old one.  Object rows already on the device are kept under the new
        adjacency; the quantized-graph mirror is kept too: its codes are the
        objects', and its neighbor blocks key on the device mirror's
        version, which a new mirror never repeats."""
        from ngt_tpu_torch.graph.reconstruct import _rows_dev

        old, self._mirror = self._mirror, None
        self.graph = graph
        cap = self.store._x.shape[0]
        if old is not None and old.x is not None and old.capacity == cap:
            n = self.store.repository_size
            nbr = torch.full((cap, graph.e_max), -1, dtype=torch.int32, device=old.x.device)
            nbr[:n] = _rows_dev(graph, n, old.x.device)[0]
            self._mirror = DeviceMirror(self.store, graph)
            self._mirror.adopt(old.x, nbr, old.sqnorm)

    def close(self) -> None:
        """Drop every device array the index holds."""
        self._mirror = None
        self._qg = self._ivfpq_mirror = None
        self.store.release_device()

    @staticmethod
    def destroy(path: str) -> None:
        """Delete an index directory (NGT::Index::destroy, Index.h:496)."""
        shutil.rmtree(path)

    # -------------------------------------------------------- text export ---
    def export_index(self, fh) -> None:
        """The lossless v2 text stream: properties, objects, the adjacency
        and the seed representatives (the reference's exportIndex, Index.h:
        703-715; ngt_tpu/index.py:959-1028), into a text or a binary stream
        (prefer binary: a 1M export is gigabytes of text).  The host library
        formats 65,536 rows at a time."""
        n = self.store.repository_size
        dim = self.store.dimension
        binary = not isinstance(fh, io.TextIOBase)
        ws = (lambda s: fh.write(s.encode("ascii"))) if binary else fh.write
        wb = fh.write if binary else (lambda b: fh.write(b.decode("ascii")))
        ws("# ngt_tpu export v2\n")
        ws(json.dumps(self.prop.to_prf()) + "\n")
        ws(f"# objects {n - 1}\n")
        chunk = 65536
        for off in range(1, n, chunk):
            hi = min(off + chunk, n)
            wb(native.format_obj_rows(self.store._x[off:hi, :dim], self.store._valid[off:hi]))
        ws(f"# graph {n - 1} {self.graph.e_max}\n")
        nbr, dist, deg = self.graph.nbr_ids, self.graph.nbr_dist, self.graph.degree
        for off in range(1, n, chunk):
            hi = min(off + chunk, n)
            wb(native.format_graph_rows(nbr[off:hi], dist[off:hi], deg[off:hi],
                                        self.graph._has_node[off:hi]))
        ws("# seeds\n")
        ws(" ".join(str(int(r)) for r in self.seeder.rep_ids) + "\n")

    @classmethod
    def import_index(cls, fh, path: Optional[str] = None, device="cuda") -> "Index":
        """An index on ``device`` from an export stream, text or binary
        (ngt_tpu/index.py:1029-1153): a v2 stream restores the objects
        (holes freed, so line i stays internal id i + 1), the adjacency and
        the seeds; a legacy v1 stream holds vectors only and the graph is
        rebuilt (``_import_v1``).  Saved to ``path`` when given."""
        binary = isinstance(fh.read(0), bytes)
        rl = (lambda: fh.readline().decode("ascii")) if binary else fh.readline
        header = rl()
        if not header.startswith("# ngt_tpu export"):
            raise ValueError("not an ngt_tpu export stream")
        v2 = header.strip().endswith("v2")
        prop = Property.from_prf(json.loads(rl()))
        idx = cls(prop=prop, device=device)
        if not v2:
            if binary:
                fh = io.TextIOWrapper(fh, encoding="ascii")
            return cls._import_v1(idx, fh, path)
        line = rl()
        if not line.startswith("# objects"):
            raise ValueError("malformed export: objects")
        n_obj = int(line.split()[2])
        data = fh.read()
        if not binary:
            data = data.encode("ascii")
        xs, vm, off = native.parse_obj_rows(data, n_obj, idx.store.dimension)
        if vm.any():
            # occupy every slot so that line i is internal id i + 1, then
            # free the holes (they have no graph rows)
            idx.store.batch_insert(xs)
            for h in np.nonzero(~vm)[0]:
                idx.store.remove(int(h) + 1)
        nl = data.index(b"\n", off)
        gline = data[off:nl].decode("ascii")
        if not gline.startswith("# graph"):
            raise ValueError("malformed export: graph")
        e_max = int(gline.split()[3])
        nb, dd, dg, hs, gused = native.parse_graph_rows(data[nl + 1 :], n_obj, e_max)
        g = GraphStore(max_edges=e_max, capacity=max(n_obj + 1, 16))
        g.nbr_ids[1 : n_obj + 1] = nb
        g.nbr_dist[1 : n_obj + 1] = dd
        g.degree[1 : n_obj + 1] = dg
        g._has_node[1 : n_obj + 1] = hs
        idx.graph = g
        idx.graph.ensure_capacity(idx.store._x.shape[0])
        tail = data[nl + 1 + gused :].decode("ascii").splitlines()
        if tail and tail[0].startswith("# seeds") and len(tail) > 1:
            toks = tail[1].split()
            if toks:
                idx.seeder.set_representatives(
                    np.array([int(t) for t in toks], np.int32), idx.store._x)
        if path:
            idx.save(path)
        return idx

    @staticmethod
    def _import_v1(idx: "Index", fh, path: Optional[str]) -> "Index":
        """The legacy vectors-only stream (``+v\tv...`` per object, any other
        line a hole): insert, rebuild the graph, remove the holes
        (ngt_tpu/index.py:1154-1218)."""
        vecs, holes = [], []
        for i, line in enumerate(fh):
            line = line.rstrip("\n")
            if line.startswith("+"):
                vecs.append((i, np.array([float(t) for t in line[1:].split("\t")])))
            else:
                holes.append(i)
        if vecs:
            mat = np.zeros((len(vecs) + len(holes), len(vecs[0][1])), np.float32)
            mat[:] = vecs[0][1]
            for i, v in vecs:
                mat[i] = v
            idx.store.batch_insert(mat)
            idx.build_index()
            for h in holes:
                idx.remove(h if idx.zero_based else h + 1)
        if path:
            idx.save(path)
        return idx


# ---------------------------------------------------------------- factory ---


def create(
    path: Optional[str],
    dimension: int,
    edge_size_for_creation: int = 10,
    edge_size_for_search: int = 40,
    distance_type="L2",
    object_type="Float",
    max_edges: int = 0,
    device="cuda",
    **kwargs,
) -> Index:
    """Create a new index (ngtpy.create, ngtpy.cpp:505-529) on ``device``."""
    prop = Property(
        dimension=dimension,
        edge_size_for_creation=edge_size_for_creation,
        edge_size_for_search=edge_size_for_search,
        distance_type=resolve_distance_type(distance_type),
        object_type=resolve_object_type(object_type),
        index_type=IndexType.GRAPH_AND_TREE,
    )
    prop.max_edges = max_edges if max_edges > 0 else max(
        64, 2 * edge_size_for_creation
    )
    for key, val in kwargs.items():
        if not hasattr(prop, key):
            raise TypeError(f"unknown property: {key}")
        setattr(prop, key, val)
    idx = Index(prop=prop, device=device)
    idx.path = path
    if path:
        os.makedirs(path, exist_ok=True)
        idx.save(path)
    return idx


def open_index(path: str, zero_based_numbering: bool = True, memory_mapped: bool = False,
               device="cuda") -> Index:
    """Open an existing index (ngtpy.Index ctor, ngtpy.cpp:58-75) on
    ``device``.  ``memory_mapped=True`` opens the object and adjacency files
    as copy-on-write maps: reader processes share one page-cache copy (the
    reference's shared-memory read, README.md:85), this process's changes
    stay private, and the device copy uploads the mapped rows as usual."""
    return Index(path=path, zero_based_numbering=zero_based_numbering,
                 memory_mapped=memory_mapped, device=device)

