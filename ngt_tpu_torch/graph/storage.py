"""GraphStore — fixed-width adjacency (the port's counterpart of
``ngt_tpu/graph/storage.py``), replacing the reference's per-node
variable-length sorted edge lists (``GraphRepository`` of ``GraphNode``;
reference lib/NGT/Graph.h:62-183).

Host numpy is authoritative; the device holds a mirror used by the batched
search.  Layout: ``nbr_ids[N_cap, E_max]`` int32 (-1 padded), ``nbr_dist``
f32 (+inf padded), rows sorted ascending by distance; a full row drops its
farthest edge (``addEdgeDeletingExcessEdges``, Graph.h:888-934).

A fresh bulk build leaves its adjacency on the device as torch tensors
(``defer_rows``), and a graph rewrite hands its result back the same way
(``from_device_rows``, host arrays not even allocated yet); the host copy
materializes on first host access.  The
mutators follow the reference's: ``set_nodes`` replaces rows,
``add_edges`` merges edges through the host graph library's
``merge_edges`` (``ngt_tpu_torch/native.py``), and ``remove_node`` /
``remove_edges_to`` / ``remove_edges_to_many`` unlink removed objects.
"""

from __future__ import annotations

import numpy as np

from ngt_tpu_torch import native

INF = np.float32(np.inf)


class GraphStore:
    def __init__(self, max_edges: int = 64, capacity: int = 1024):
        self.e_max = int(max_edges)
        cap = max(int(capacity), 16)
        self._h_ids = np.full((cap, self.e_max), -1, dtype=np.int32)
        self._h_dist = np.full((cap, self.e_max), INF, dtype=np.float32)
        self._h_deg = np.zeros((cap,), dtype=np.int32)
        self._has_node = np.zeros((cap,), dtype=bool)
        #: (dev_ids, dev_dist, dev_deg, n_used) torch tensors when the
        #: freshly-built adjacency still lives only on the device (the bulk
        #: build defers the download until something needs the host copy —
        #: persistence, mutation, stats; search runs off the device mirror)
        self._deferred = None

    # Host arrays are exposed through materializing properties: ANY host
    # read or mutation first completes the deferred device->host download,
    # so every existing consumer stays correct without knowing about
    # deferral.  Assignment (e.g. ensure_capacity realloc) bypasses it.
    @property
    def nbr_ids(self) -> np.ndarray:
        self._materialize()
        return self._h_ids

    @nbr_ids.setter
    def nbr_ids(self, v: np.ndarray) -> None:
        self._h_ids = v

    @property
    def nbr_dist(self) -> np.ndarray:
        self._materialize()
        return self._h_dist

    @nbr_dist.setter
    def nbr_dist(self, v: np.ndarray) -> None:
        self._h_dist = v

    @property
    def degree(self) -> np.ndarray:
        self._materialize()
        return self._h_deg

    @degree.setter
    def degree(self, v: np.ndarray) -> None:
        self._h_deg = v

    @classmethod
    def from_device_rows(cls, dev_ids, dev_dist, dev_deg, n_used: int, capacity: int,
                         has_node: np.ndarray) -> "GraphStore":
        """A store of ``capacity`` rows whose rows [0, n_used) are the given
        device tensors and whose node set starts with ``has_node``; its host
        arrays are allocated at the first host access (a graph rewrite's
        intermediate result never has one)."""
        g = cls.__new__(cls)
        g.e_max = int(dev_ids.shape[1])
        g._h_ids = g._h_dist = g._h_deg = None
        g._has_node = np.zeros((max(int(capacity), 16),), dtype=bool)
        g._has_node[: len(has_node)] = has_node
        g._deferred = None
        g.defer_rows(dev_ids, dev_dist, dev_deg, n_used)
        return g

    def defer_rows(self, dev_ids, dev_dist, dev_deg, n_used: int) -> None:
        """Adopt device-resident adjacency as the pending source of truth
        for rows [0, n_used); the host copy materializes lazily on first
        host access."""
        if n_used > self.capacity:
            raise ValueError("defer_rows: host capacity too small")
        self._deferred = (dev_ids, dev_dist, dev_deg, int(n_used))

    def _materialize(self) -> None:
        if self._deferred is None:
            return
        dev_ids, dev_dist, dev_deg, n = self._deferred
        self._deferred = None
        if self._h_ids is None:   # a store made by from_device_rows
            cap = self.capacity
            self._h_ids = np.empty((cap, self.e_max), dtype=np.int32)
            self._h_dist = np.empty((cap, self.e_max), dtype=np.float32)
            self._h_deg = np.zeros((cap,), dtype=np.int32)
            self._h_ids[n:] = -1
            self._h_dist[n:] = INF
        self._h_ids[:n] = dev_ids[:n].cpu().numpy()
        self._h_dist[:n] = dev_dist[:n].cpu().numpy()
        self._h_deg[:n] = dev_deg[:n].cpu().numpy()

    @property
    def capacity(self) -> int:
        return self._has_node.shape[0]

    def ensure_capacity(self, n: int) -> bool:
        """Grow to hold node id n-1; returns True if a realloc happened."""
        if n <= self.capacity:
            return False
        cap = self.capacity
        while cap < n:
            cap *= 2
        ids = np.full((cap, self.e_max), -1, dtype=np.int32)
        ids[: self.nbr_ids.shape[0]] = self.nbr_ids
        dist = np.full((cap, self.e_max), INF, dtype=np.float32)
        dist[: self.nbr_dist.shape[0]] = self.nbr_dist
        deg = np.zeros((cap,), dtype=np.int32)
        deg[: self.degree.shape[0]] = self.degree
        has = np.zeros((cap,), dtype=bool)
        has[: self._has_node.shape[0]] = self._has_node
        self.nbr_ids, self.nbr_dist, self.degree, self._has_node = ids, dist, deg, has
        return True

    def has_node(self, oid: int) -> bool:
        return 0 <= oid < self.capacity and bool(self._has_node[oid])

    def node_count(self) -> int:
        return int(self._has_node.sum())

    def get_node(self, oid: int) -> tuple[np.ndarray, np.ndarray]:
        """(neighbor ids, distances) of one node's row, nearest first."""
        d = int(self.degree[oid])
        return self.nbr_ids[oid, :d].copy(), self.nbr_dist[oid, :d].copy()

    # ------------------------------------------------------------ mutation --
    def add_edges(self, targets: np.ndarray, srcs: np.ndarray, dists: np.ndarray):
        """Bulk sorted-insert of edges target->src (the reverse-edge step of
        ANNG insertion; reference ``addEdge`` calls in insertANNGNode,
        Graph.h:611-626) through the host graph library's ``merge_edges``.
        Full rows drop the farthest edge.  Duplicate (target, src) pairs
        are skipped like the reference's ``addEdgeDeletingExcessEdges``
        duplicate check (Graph.h:896-907)."""
        if len(targets) == 0:
            return
        targets = np.asarray(targets, dtype=np.int64)
        self.ensure_capacity(int(targets.max()) + 1)
        native.merge_edges(
            self.nbr_ids, self.nbr_dist, self.degree,
            self._has_node.view(np.uint8), targets, srcs, dists,
        )

    def set_nodes(self, oids: np.ndarray, ids: np.ndarray, dists: np.ndarray):
        """Replace whole rows (ids/dists [T, <=E_max], -1/inf padded)."""
        oids = np.asarray(oids, dtype=np.int64)
        self.ensure_capacity(int(oids.max()) + 1 if len(oids) else 0)
        t, k = ids.shape
        if k > self.e_max:
            ids, dists = ids[:, : self.e_max], dists[:, : self.e_max]
            k = self.e_max
        row_i = np.full((t, self.e_max), -1, dtype=np.int32)
        row_d = np.full((t, self.e_max), INF, dtype=np.float32)
        row_i[:, :k] = ids
        row_d[:, :k] = np.where(ids >= 0, dists, INF)
        row_i[row_d == INF] = -1
        order = np.argsort(row_d, axis=1, kind="stable")
        row_d = np.take_along_axis(row_d, order, axis=1)
        row_i = np.take_along_axis(row_i, order, axis=1)
        self.nbr_ids[oids] = row_i
        self.nbr_dist[oids] = row_d
        self.degree[oids] = (row_i >= 0).sum(axis=1)
        self._has_node[oids] = True

    def truncate_rows(self, oids: np.ndarray, threshold: int) -> None:
        """Cap the given rows to their `threshold` nearest edges (rows are
        kept distance-sorted, so this is a tail drop)."""
        oids = np.asarray(oids, np.int64)
        oids = oids[(oids >= 0) & (oids < self.capacity)]
        over = oids[self.degree[oids] > threshold]
        if len(over) == 0:
            return
        self.nbr_ids[over, threshold:] = -1
        self.nbr_dist[over, threshold:] = INF
        self.degree[over] = threshold

    def remove_node(self, oid: int) -> np.ndarray:
        """Tombstone a node; returns its former neighbor ids.  The caller
        unlinks the incoming edges (``build.remove_object``, the batched
        analogue of removeEdgesReliably, Graph.cpp:641-864)."""
        former = self.nbr_ids[oid, : self.degree[oid]].copy()
        self.nbr_ids[oid] = -1
        self.nbr_dist[oid] = INF
        self.degree[oid] = 0
        self._has_node[oid] = False
        return former

    def _drop_hits(self, targets: np.ndarray, hit_of) -> None:
        """Blank the entries ``hit_of(rows_i)`` flags in the given rows and
        re-sort them by distance (stable, so the survivors keep their
        order)."""
        targets = np.asarray(targets, dtype=np.int64)
        targets = targets[(targets >= 0) & (targets < self.capacity)]
        rows_i = self.nbr_ids[targets]
        rows_d = self.nbr_dist[targets]
        hit = hit_of(rows_i)
        rows_d[hit] = INF
        rows_i[hit] = -1
        order = np.argsort(rows_d, axis=1, kind="stable")
        self.nbr_dist[targets] = np.take_along_axis(rows_d, order, axis=1)
        self.nbr_ids[targets] = np.take_along_axis(rows_i, order, axis=1)
        self.degree[targets] = (self.nbr_ids[targets] >= 0).sum(axis=1)

    def remove_edges_to(self, targets: np.ndarray, gone: int) -> None:
        """Drop edges target->gone from the given rows."""
        if len(targets):
            self._drop_hits(targets, lambda r: r == gone)

    def remove_edges_to_many(self, targets: np.ndarray, gone_mask: np.ndarray) -> None:
        """Drop every edge target->g with ``gone_mask[g]`` from the given
        rows in one vectorized pass (the batched unlink behind
        ``Index.batch_remove``)."""
        if len(targets):
            self._drop_hits(targets, lambda r: gone_mask[
                np.clip(r, 0, len(gone_mask) - 1)] & (r >= 0))

    # --------------------------------------------------------- persistence --
    def state_dict(self, n: int) -> dict:
        return {
            "nbr_ids": self.nbr_ids[:n],
            "nbr_dist": self.nbr_dist[:n],
            "degree": self.degree[:n],
            "has_node": self._has_node[:n],
            "e_max": self.e_max,
        }

    @classmethod
    def from_state(cls, state: dict, copy: bool = True) -> "GraphStore":
        """A store holding ``state`` (``state_dict``'s keys).  ``copy=False``
        adopts the caller's adjacency arrays as they are, e.g. copy-on-write
        memmaps that reader processes share; ``ensure_capacity`` moves them
        into private arrays on growth (ngt_tpu/graph/storage.py:296-316)."""
        n = len(state["degree"])
        if not copy:
            g = cls(max_edges=int(state["e_max"]), capacity=16)
            g.nbr_ids = state["nbr_ids"]
            g.nbr_dist = state["nbr_dist"]
            g.degree = np.array(state["degree"])
            g._has_node = np.array(state["has_node"])
            return g
        g = cls(max_edges=int(state["e_max"]), capacity=max(n, 16))
        g.nbr_ids[:n] = state["nbr_ids"]
        g.nbr_dist[:n] = state["nbr_dist"]
        g.degree[:n] = state["degree"]
        g._has_node[:n] = state["has_node"]
        return g
