"""IVF+PQ index (the port's counterpart of ``ngt_tpu/quant/ivfpq.py``) — the
NGTQ analogue (NGTQ/Quantizer.h): coarse centroids, per-centroid inverted
lists of (object id, PQ code) records, PQ codebooks over the residuals from
the centroids, the raw objects for an exact refine, and the reference's
five aggregation modes (Quantizer.h:2266-2549).

* The coarse codebook is a dense centroid matrix: a query batch scores all
  C centroids with one matmul and takes the ``nprobe`` nearest.
* Inverted lists are bucketed: chains of ``BUCKET_LEN`` records per
  centroid (``cent_buckets [C, Bc] -> bucket_ids [NB, L]``), so memory is
  O(N + C * L) on skewed clusters and every probe is a fixed-shape gather.
* Records are packed 4-bit codes (two per byte when ksub <= 16).  For the
  search each record's PQ-decoded residual is stored as an int8 row
  (``host_blocks``): the LUT sum equals |qr|^2 - 2 qr.recon + |recon|^2, so
  scoring a bucket chain is a contiguous row gather and a matvec.  As in
  the reference, the query residual is rounded to bfloat16 and each
  product is summed in f32 (an int8 times a bf16 value is exact in f32;
  only the order of the sum may differ).
* The probes merge into a running top-k one probe at a time, selecting on
  (distance, position) keys, the order of the reference's ``top_k``.  The
  queries run in chunks whose temporaries (the ``[B, Bc, L, d]`` int8
  gather and its f32 widening, the exact mode's row gather) stay under
  ``SEARCH_BYTES``; a query's result does not depend on its chunk.
* Raw objects live on the device, in host memory, in an on-disk memmap
  (``raw_store``, the ArrayFile analogue, ArrayFile.h:32-219), or nowhere.
* Inserts after ``build`` are assigned to the existing centroids and
  encoded with the existing codebooks; with ``centroid_mode="dynamic"`` a
  row farther than ``global_range`` from every centroid creates one
  (Quantizer.h:174-205, 1895-1959).  ``rebuild`` retrains.

Its k-means draws its init on the host (``quant/clustering.py``), so a
port build and a reference build of the same rows train different
centroids; ``convert.py`` carries a built index across.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ngt_tpu_torch.ops import distances as D
from ngt_tpu_torch.ops.select import topk_pos
from ngt_tpu_torch.properties import DistanceType
from ngt_tpu_torch.quant.clustering import kmeans
from ngt_tpu_torch.quant.pq import ProductQuantizer, encode_dev, pack_codes4, unpack_codes4

_F32 = torch.float32
INF = float("inf")

#: records per inverted-list bucket
BUCKET_LEN = 128
#: bytes a query chunk's search temporaries may hold
SEARCH_BYTES = 1 << 30


def _probe_lists(cent_buckets, bucket_ids, bucket_vals, bucket_norm, scale, qr, probe, k):
    """Score the probed centroids' bucket chains: qr [B, P, d] query
    residuals, probe [B, P]; per probe the squared distance of every record
    |qr|^2 - 2 scale qr_bf16.vals + norm, merged into a running top-k
    (each record lies in one list, so the merge is exact).  Returns (ids
    [B, k'] record rows, -1 where empty; dists [B, k'] squared)."""
    b, p = probe.shape
    bc = cent_buckets.shape[1]
    nb, ll = bucket_ids.shape
    d = qr.shape[2]
    kcap = min(k, p * bc * ll)
    two_s = torch.tensor(np.float32(2.0) * np.float32(scale))
    best_d = torch.full((b, kcap), INF, dtype=_F32, device=qr.device)
    best_i = torch.full((b, kcap), -1, dtype=torch.int32, device=qr.device)
    for pi in range(p):
        qrp = qr[:, pi]
        qsq = (qrp * qrp).sum(1)
        bsel = cent_buckets[probe[:, pi]]                              # [B, Bc]
        bsafe = bsel.to(torch.int64).clamp(0, nb - 1)
        ids = bucket_ids[bsafe]                                        # [B, Bc, L]
        vals = bucket_vals[bsafe].view(b, bc * ll, d).to(_F32)         # [B, Bc*L, d]
        q16 = qrp.to(torch.bfloat16).to(_F32)[:, :, None]
        dot = torch.bmm(vals, q16).view(b, bc, ll)
        d2 = qsq[:, None, None] - two_s * dot + bucket_norm[bsafe]
        ok = (ids >= 0) & (bsel >= 0)[:, :, None]
        d2 = torch.where(ok, d2, INF)
        best_d, sel = topk_pos(torch.cat([best_d, d2.view(b, -1)], 1), kcap)
        best_i = torch.cat([best_i, ids.view(b, -1)], 1).gather(1, sel)
    return torch.where(torch.isfinite(best_d), best_i, -1), best_d


def _search_approx(centroids, cent_buckets, bucket_ids, bucket_vals, bucket_norm, scale,
                   qd, *, nprobe, k):
    """Coarse probe (the nprobe nearest centroids by L2), query residuals
    and bucket scoring.  Returns (probe [B, P], ids, squared dists)."""
    _, probe = topk_pos(D.pairwise(DistanceType.L2, qd, centroids), nprobe)
    qr = qd[:, None, :] - centroids[probe]
    ids, dists = _probe_lists(cent_buckets, bucket_ids, bucket_vals, bucket_norm, scale,
                              qr, probe, k)
    return probe, ids, dists


def _rerank_rows(qd, rows, ids, *, size, metric):
    """Exact re-rank of gathered candidate rows [B, C, d]."""
    dd = D.gathered(metric, qd, rows)
    dd = torch.where(ids >= 0, dd, INF)
    out_d, sel = topk_pos(dd, min(size, ids.shape[1]))
    out_i = ids.gather(1, sel)
    return torch.where(torch.isfinite(out_d), out_i, -1), out_d


def _assign_chunk(xc, cents):
    """Nearest centroid (L2, the first on ties) and its distance."""
    d = D.pairwise(DistanceType.L2, xc, cents)
    dist, a = torch.min(d, dim=1)
    return a, dist


def _encode_chunk_dev(xc, cents, assign, codebooks, pq_mean):
    """PQ codes of the residuals x - centroid - mean."""
    return encode_dev(xc.to(_F32) - cents[assign] - pq_mean, codebooks)


class IVFPQIndex:
    """NGTQ-style quantized index (API after NGTQ::Index,
    Quantizer.h:2720-2939: insert, search, save, open, validate, plus
    rebuild at capacity) on ``device``."""

    def __init__(
        self,
        dimension: int,
        n_centroids: int = 256,
        dsub: int = 2,
        ksub: int = 16,
        metric: DistanceType = DistanceType.L2,
        keep_raw: bool = True,
        raw_store: str = "device",   # "device" | "host" | "mmap" | "none"
        raw_path: str | None = None,  # backing file for raw_store="mmap"
        rebuild_factor: float = 2.0,
        train_sample: int = 262_144,
        device_refine_max_bytes: int = 4 << 30,
        centroid_mode: str = "dynamic",   # "dynamic" | "static"
        device="cuda",
    ):
        self.dimension = dimension
        self.metric = DistanceType(metric)
        self.n_centroids = int(n_centroids)
        self.device = torch.device(device)
        self.pq = ProductQuantizer(dimension, dsub=dsub, ksub=ksub, device=self.device)
        self.packed = self.pq.ksub <= 16
        if not keep_raw:
            raw_store = "none"
        self.raw_store = raw_store
        self.raw_path = raw_path
        self.rebuild_factor = float(rebuild_factor)
        self.train_sample = int(train_sample)
        self.device_refine_max_bytes = int(device_refine_max_bytes)
        self.centroids: np.ndarray | None = None
        #: "dynamic": an insert farther than ``global_range`` from every
        #: centroid creates centroids (the reference's default
        #: CentroidCreationModeDynamic); "static" freezes the trained set
        self.centroid_mode = centroid_mode
        #: the 99.9th percentile of the training rows' own distances to
        #: their centroids, learned at build()
        self.global_range = 0.0
        self._raw = None                       # ndarray | memmap | None
        self._pending: list[np.ndarray] = []   # inserted, not yet encoded
        self._assign = np.zeros((0,), np.int32)
        self._codes = np.zeros((0, 0), np.uint8)  # packed when self.packed
        #: stable external ids and liveness (remove() tombstones, compress()
        #: reclaims)
        self._ids = np.zeros((0,), np.int64)
        self._valid = np.zeros((0,), bool)
        self._next_id = 0
        self._trained_size = 0
        self._dev = None
        #: host seconds of the last build's and device upload's stages
        #: (kmeans, pq_fit, assign_encode, host_blocks, upload); each stage
        #: ends in a host copy, which waits for the device
        self.timings: dict[str, float] = {}

    # ------------------------------------------------------------- sizing --
    @property
    def size(self) -> int:
        n = len(self._assign) + sum(len(a) for a in self._pending)
        if self.raw_store == "mmap" and self._raw is not None:
            n = max(n, self._raw.shape[0])   # mmap spills pending to the file
        return n

    @property
    def live_size(self) -> int:
        """Records remove() has not tombstoned (+ the unencoded tail)."""
        return int(self._valid.sum()) + (self.size - len(self._assign))

    @property
    def built(self) -> bool:
        return self.centroids is not None

    def needs_rebuild(self) -> bool:
        """True once the index grew past rebuild_factor x its trained size
        (a local codebook at capacity, Quantizer.h:1846-1893)."""
        return self.built and self.size > self.rebuild_factor * max(self._trained_size, 1)

    def memory_report(self) -> dict:
        """Bytes per component (getSharedMemorySize, Quantizer.h:2672-2684)."""
        n = len(self._assign)
        mp = self._codes.shape[1] if self._codes.size else (
            (self.pq.m + 1) // 2 if self.packed else self.pq.m)
        raw = 0 if self._raw is None or self.raw_store == "mmap" else self._raw.nbytes
        return {
            "objects": int(n),
            "live": int(self._valid.sum()),
            "removed": int(n - self._valid.sum()),
            "codes_bytes": int(n * mp),
            "ids_bytes": int(n * self._ids.itemsize),
            "centroid_bytes": int(0 if self.centroids is None else self.centroids.nbytes),
            "raw_bytes_resident": int(raw),
            "raw_store": self.raw_store,
        }

    # ------------------------------------------------------------ mutation --
    def batch_insert(self, x: np.ndarray) -> None:
        """Queue vectors, encoded lazily; after ``build`` they are assigned
        to the existing centroids and encoded with the existing codebooks
        at once (Quantizer.h:1895-1959)."""
        x = np.asarray(x, np.float32)
        if x.ndim == 1:
            x = x[None]
        if x.shape[1] != self.dimension:
            raise ValueError(f"dimension mismatch: got {x.shape[1]}, want {self.dimension}")
        if len(x) == 0:
            return
        if self.raw_store == "mmap":
            # spill straight to the raw file; build/flush stream it back
            self._append_raw(x)
        else:
            self._pending.append(x)
        if self.built:
            self._flush_pending()

    def _append_raw(self, x: np.ndarray) -> None:
        if self.raw_store == "none":
            return
        if self.raw_store == "mmap":
            if self.raw_path is None:
                raise ValueError("raw_store='mmap' needs raw_path")
            old = 0 if self._raw is None else self._raw.shape[0]
            new = np.memmap(self.raw_path, dtype=np.float32, mode="r+" if old else "w+",
                            shape=(old + len(x), self.dimension))
            new[old:] = x
            new.flush()
            self._raw = new
        else:
            self._raw = x.copy() if self._raw is None else np.concatenate([self._raw, x])

    def _encode_assigned(self, x: np.ndarray, assign: np.ndarray) -> np.ndarray:
        """Codes of ``x - centroids[assign]`` in 2^20-row device chunks."""
        mp = (self.pq.m + 1) // 2 if self.packed else self.pq.m
        out = np.empty((len(x), mp), np.uint8)
        cents = torch.from_numpy(self.centroids).to(self.device)
        cb = self.pq._cb()
        mean = torch.from_numpy(self.pq.mean).to(self.device)
        step = 1 << 20
        for s in range(0, len(x), step):
            xc = torch.from_numpy(np.ascontiguousarray(x[s : s + step], np.float32)).to(self.device)
            a = torch.from_numpy(np.asarray(assign[s : s + step], np.int64)).to(self.device)
            codes = _encode_chunk_dev(xc, cents, a, cb, mean).cpu().numpy()
            out[s : s + step] = pack_codes4(codes) if self.packed else codes
        return out

    def _unflushed(self):
        """Rows inserted but not yet encoded (a memmap view of the raw
        file's tail for raw_store='mmap')."""
        if self.raw_store == "mmap":
            if self._raw is None:
                return np.zeros((0, self.dimension), np.float32)
            return self._raw[len(self._assign):]
        if not self._pending:
            return np.zeros((0, self.dimension), np.float32)
        if len(self._pending) == 1:
            return self._pending[0]
        return np.concatenate(self._pending, axis=0)

    def _grow_centroids(self, x, dist: np.ndarray) -> bool:
        """Insert-time centroid creation: rows beyond global_range seed new
        centroids farthest-first, each seed more than 1.5 global_range from
        the others (one seed per new cluster), at most max(C, 1024) of them
        per flush; then three Lloyd steps over those rows (a subsample of
        2^26 / seeds rows, ``default_rng(0)``, when larger).  Codebooks stay
        as they are.  Returns True when centroids were added."""
        out_mask = dist > self.global_range
        if not out_mask.any():
            return False
        xo_all = np.asarray(x[out_mask], np.float32)
        xo = xo_all
        d_rem = dist[out_mask].copy()
        new: list[np.ndarray] = []
        cap = max(len(self.centroids), 1024)
        dedup = 1.5 * self.global_range
        while len(xo) and len(new) < cap:
            j = int(np.argmax(d_rem))
            c0 = xo[j]
            new.append(c0)
            dd = np.linalg.norm(xo - c0[None, :], axis=1)
            keep = dd > dedup
            xo, d_rem = xo[keep], np.minimum(d_rem[keep], dd[keep])
        cents = np.stack(new).astype(np.float32)
        if len(xo_all) * len(cents) > (1 << 26):
            sel = np.random.default_rng(0).choice(
                len(xo_all), (1 << 26) // max(len(cents), 1), replace=False)
            xo_all = xo_all[np.sort(sel)]
        for _ in range(3):
            dd = np.linalg.norm(xo_all[:, None, :] - cents[None, :, :], axis=2)
            a = np.argmin(dd, axis=1)
            for j in range(len(cents)):
                m = a == j
                if m.any():
                    cents[j] = xo_all[m].mean(axis=0)
        self.centroids = np.concatenate([self.centroids, cents], axis=0)
        self._dev = None
        return True

    def _flush_pending(self) -> None:
        """Assign and encode the unflushed rows against the current
        codebooks and grow the inverted lists."""
        x = self._unflushed()
        if len(x) == 0:
            self._pending = []
            return
        if self.centroid_mode == "dynamic" and self.global_range > 0.0:
            assign, dist = self._assign_to_centroids(x, return_dist=True)
            if self._grow_centroids(x, dist):
                assign = self._assign_to_centroids(x)
        else:
            assign = self._assign_to_centroids(x)
        codes = self._encode_assigned(x, assign)
        self._assign = np.concatenate([self._assign, assign])
        self._codes = codes if self._codes.size == 0 else np.concatenate([self._codes, codes])
        new_ids = np.arange(self._next_id, self._next_id + len(assign), dtype=np.int64)
        self._ids = np.concatenate([self._ids, new_ids])
        self._valid = np.concatenate([self._valid, np.ones(len(assign), bool)])
        self._next_id += len(assign)
        if self.raw_store != "mmap":
            self._append_raw(np.asarray(x))
        self._pending = []
        self._dev = None

    def _assign_to_centroids(self, x: np.ndarray, return_dist: bool = False):
        """Nearest centroid of each row (and its L2 distance), in chunks
        of 65,536 rows."""
        cd = torch.from_numpy(np.asarray(self.centroids, np.float32)).to(self.device)
        out = np.empty(len(x), np.int32)
        dist = np.empty(len(x), np.float32) if return_dist else None
        step = 65536
        for s in range(0, len(x), step):
            xc = torch.from_numpy(np.ascontiguousarray(x[s : s + step], np.float32))
            a, d = _assign_chunk(xc.to(self.device), cd)
            out[s : s + step] = a.cpu().numpy()
            if return_dist:
                dist[s : s + step] = d.cpu().numpy()
        return (out, dist) if return_dist else out

    def build(self, kmeans_iters: int = 15, seed: int = 0) -> None:
        """Train the coarse centroids and the PQ codebooks on (a sample of)
        the unflushed rows, then encode them all (Quantizer.h:1846-1959).
        The stages' seconds land in ``timings``."""
        if self.built:
            self._flush_pending()
            return
        x = self._unflushed()
        if len(x) == 0:
            raise ValueError("nothing to build")
        self.timings = {}
        t0 = time.perf_counter()
        rng = np.random.default_rng(seed)
        train = x
        if len(x) > self.train_sample:
            train = x[np.sort(rng.choice(len(x), self.train_sample, replace=False))]
        c = min(self.n_centroids, len(train))
        self.centroids, _ = kmeans(train, c, iters=kmeans_iters, seed=seed, device=self.device)
        t1 = time.perf_counter()
        assign, adist = self._assign_to_centroids(x, return_dist=True)
        self.global_range = float(np.quantile(adist, 0.999)) if len(adist) else 0.0
        t2 = time.perf_counter()
        if len(x) > self.train_sample:
            pick = np.sort(rng.choice(len(x), self.train_sample, replace=False))
            rs = x[pick] - self.centroids[assign[pick]]
        else:
            rs = np.asarray(x) - self.centroids[assign]
        self.pq.fit(rs, center=False)
        t3 = time.perf_counter()
        codes = self._encode_assigned(x, assign)
        t4 = time.perf_counter()
        self.timings.update(kmeans=t1 - t0, pq_fit=t3 - t2, assign_encode=(t2 - t1) + (t4 - t3))
        self._assign = assign
        self._codes = codes
        if len(self._ids) != len(assign):   # a fresh build (rebuild restores)
            self._ids = np.arange(len(assign), dtype=np.int64)
            self._next_id = len(assign)
        self._valid = np.ones(len(assign), bool)
        if self.raw_store != "mmap":   # mmap: the rows are already in the file
            self._raw = None
            self._append_raw(np.asarray(x))
        self._pending = []
        self._trained_size = len(x)
        self._dev = None

    def rebuild(self, kmeans_iters: int = 15, seed: int = 0) -> None:
        """Retrain on the current population and re-encode (Quantizer.h:
        1846-1893).  Needs raw vectors; tombstones are reclaimed first and
        external ids kept."""
        self._flush_pending()
        if self._raw is None:
            raise ValueError("rebuild needs raw vectors (raw_store != 'none')")
        if self._valid.size and not self._valid.all():
            self.compress()
        keep_ids, keep_next = self._ids.copy(), self._next_id
        if self.raw_store == "mmap":
            self._pending = []   # the whole raw file becomes the unflushed set
        else:
            self._pending = [np.asarray(self._raw, np.float32)]
            self._raw = None
        self.centroids = None
        self._assign = np.zeros((0,), np.int32)
        self._codes = np.zeros((0, 0), np.uint8)
        self._ids = np.zeros((0,), np.int64)
        self._valid = np.zeros((0,), bool)
        self.build(kmeans_iters=kmeans_iters, seed=seed)
        self._ids, self._next_id = keep_ids, keep_next
        self._valid = np.ones(len(keep_ids), bool)

    def remove(self, ids, force: bool = False) -> int:
        """Tombstone objects by external id (ngtq remove,
        NGTQCommand.h:430-496); unknown or removed ids raise unless
        ``force``.  Returns the count removed."""
        if not self.built:
            raise ValueError("build the index before removing")
        self._flush_pending()
        req = np.unique(np.atleast_1d(np.asarray(ids, np.int64)))
        n = len(self._ids)
        pos = np.searchsorted(self._ids, req)   # _ids is strictly increasing
        safe = np.clip(pos, 0, max(n - 1, 0))
        ok = (pos < n) & (self._ids[safe] == req) if n else np.zeros(len(req), bool)
        ok &= self._valid[safe] if n else False
        if not ok.all() and not force:
            raise ValueError(f"unknown or already-removed ids: {req[~ok][:8].tolist()}")
        self._valid[safe[ok]] = False
        self._dev = None
        return int(ok.sum())

    def compress(self) -> int:
        """Drop tombstoned records, keeping external ids (NGTQ::Index::
        compress, Quantizer.h:2747-2760: the mmap file is rewritten to a
        temporary and renamed over).  Returns the records reclaimed."""
        self._flush_pending()
        if not self._valid.size or bool(self._valid.all()):
            return 0
        keep = np.nonzero(self._valid)[0]
        dropped = len(self._valid) - len(keep)
        self._assign = self._assign[keep]
        if self._codes.size:
            self._codes = np.ascontiguousarray(self._codes[keep])
        self._ids = self._ids[keep]
        self._valid = np.ones(len(keep), bool)
        if self._raw is not None:
            if self.raw_store == "mmap":
                tmp = self.raw_path + ".tmp"
                new = np.memmap(tmp, dtype=np.float32, mode="w+",
                                shape=(max(len(keep), 1), self.dimension))
                step = 1 << 20
                for s in range(0, len(keep), step):
                    new[s : s + step] = self._raw[keep[s : s + step]]
                new.flush()
                del new
                self._raw = None
                os.replace(tmp, self.raw_path)
                if len(keep):
                    self._raw = np.memmap(self.raw_path, dtype=np.float32, mode="r+",
                                          shape=(len(keep), self.dimension))
            else:
                self._raw = np.ascontiguousarray(np.asarray(self._raw)[keep])
        self._dev = None
        return dropped

    def _ext_ids(self, rows: np.ndarray) -> np.ndarray:
        """Internal record rows (-1 padded) -> external object ids."""
        if not len(self._ids):
            return rows
        safe = np.clip(rows, 0, len(self._ids) - 1)
        return np.where(rows >= 0, self._ids[safe], -1)

    # -------------------------------------------------------------- device --
    def host_blocks(self, record_sel: np.ndarray | None = None) -> dict:
        """Bucketed inverted lists over ``record_sel`` (record rows; None =
        every live record), built on the host: each record's PQ-decoded
        residual as an int8 row at one scale (the largest |codebook entry +
        mean| over 127) and its squared norm at that scale."""
        self._flush_pending()
        c = len(self.centroids)
        if record_sel is None:
            record_sel = np.nonzero(self._valid)[0].astype(np.int64)
        else:
            record_sel = np.asarray(record_sel, np.int64)
            if self._valid.size:   # tombstoned records never enter buckets
                record_sel = record_sel[self._valid[record_sel]]
        assign = self._assign[record_sel]
        counts = np.bincount(assign, minlength=c)
        nbuckets = np.maximum((counts + BUCKET_LEN - 1) // BUCKET_LEN, 0)
        b_cap = max(int(nbuckets.max()), 1)
        nb = max(int(nbuckets.sum()), 1)
        cent_buckets = np.full((c, b_cap), -1, np.int32)
        bucket_start = np.concatenate([[0], np.cumsum(nbuckets)[:-1]])
        for ci in np.nonzero(nbuckets)[0]:
            cent_buckets[ci, : nbuckets[ci]] = np.arange(
                bucket_start[ci], bucket_start[ci] + nbuckets[ci])
        bucket_ids = np.full((nb, BUCKET_LEN), -1, np.int32)
        d = self.dimension
        bucket_vals = np.zeros((nb, BUCKET_LEN, d), np.int8)
        bucket_norm = np.zeros((nb, BUCKET_LEN), np.float32)
        order = record_sel[np.argsort(assign, kind="stable")]
        sorted_assign = self._assign[order]
        starts = np.searchsorted(sorted_assign, np.arange(c))
        slot = np.arange(len(order)) - starts[sorted_assign]
        brow = bucket_start[sorted_assign] + slot // BUCKET_LEN
        bcol = slot % BUCKET_LEN
        bucket_ids[brow, bcol] = order.astype(np.int32)
        shift = self.pq.mean.reshape(self.pq.m, self.pq.dsub)
        entry_max = float(np.abs(self.pq.codebooks + shift[:, None, :]).max())
        scale = max(entry_max, 1e-12) / 127.0
        step = 1 << 19
        for s in range(0, len(order), step):
            sel = order[s : s + step]
            codes = self._codes[sel]
            if self.packed:
                codes = unpack_codes4(codes, self.pq.m)
            recon = self.pq.decode(codes)
            v8 = np.clip(np.rint(recon / scale), -127, 127).astype(np.int8)
            bucket_vals[brow[s : s + step], bcol[s : s + step]] = v8
            bucket_norm[brow[s : s + step], bcol[s : s + step]] = (
                scale * scale) * np.sum(v8.astype(np.float32) ** 2, axis=1)
        return {
            "cent_buckets": cent_buckets,
            "bucket_ids": bucket_ids,
            "bucket_vals": bucket_vals,
            "bucket_norm": bucket_norm,
            "scale": np.float32(scale),
        }

    def _raw_as_u8(self) -> np.ndarray | None:
        """A lossless uint8 copy of the raw store (an integral corpus in
        0..255 within ``device_refine_max_bytes``), else None."""
        if self._raw is None:
            return None
        n = self._raw.shape[0]
        if n * self.dimension > self.device_refine_max_bytes:
            return None
        out = np.empty((n, self.dimension), np.uint8)
        step = 1 << 20
        for s in range(0, n, step):
            c = np.asarray(self._raw[s : s + step])
            r = np.rint(c)
            if not ((c == r).all() and r.min() >= 0.0 and r.max() <= 255.0):
                return None
            out[s : s + step] = r.astype(np.uint8)
        return out

    def _device(self):
        """The bucketed inverted lists (and the raw rows, where they live
        on the device or have a lossless uint8 copy) on the device."""
        if self._dev is not None:
            return self._dev
        t0 = time.perf_counter()
        hb = self.host_blocks()
        t1 = time.perf_counter()
        if self.raw_store == "device" and self._raw is not None:
            x_host = np.asarray(self._raw)
        else:
            x_host = self._raw_as_u8()

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        self._dev = {
            "centroids": up(np.asarray(self.centroids, np.float32)),
            "cent_buckets": up(hb["cent_buckets"]),
            "bucket_ids": up(hb["bucket_ids"]),
            "bucket_vals": up(hb["bucket_vals"]),
            "bucket_norm": up(hb["bucket_norm"]),
            "scale": hb["scale"],
            "x": None if x_host is None else up(x_host),
        }
        self.timings.update(host_blocks=t1 - t0, upload=time.perf_counter() - t1)
        return self._dev

    def _raw_rows(self, ids: torch.Tensor) -> torch.Tensor:
        """Raw rows [B, C, d] f32 of record rows ``ids`` [B, C], from
        wherever raw lives (a host gather for "host" and "mmap" without a
        device copy)."""
        dev = self._device()
        if dev["x"] is not None:
            return dev["x"][ids.to(torch.int64).clamp(0, dev["x"].shape[0] - 1)].to(_F32)
        if self._raw is None:
            raise ValueError("refinement needs raw vectors")
        safe = np.clip(ids.cpu().numpy(), 0, self._raw.shape[0] - 1)
        return torch.from_numpy(np.asarray(self._raw[safe], np.float32)).to(self.device)

    # -------------------------------------------------------------- search --
    def _query_chunk(self, dev, nprobe: int, k_exp: int, mode: str) -> int:
        """Queries per chunk: SEARCH_BYTES over the bytes one query's
        temporaries hold (a probe's int8 gather, its f32 widening and the
        ids, norms and scores beside it; the exact mode's gathered f32
        rows and their distances; the refine's candidate rows)."""
        bc = dev["cent_buckets"].shape[1]
        d = self.dimension
        per = bc * BUCKET_LEN * (5 * d + 32)
        if mode == "exact":
            per = max(per, nprobe * bc * BUCKET_LEN * (8 * d + 32))
        per = max(per, k_exp * (8 * d + 32))
        return max(1, SEARCH_BYTES // per)

    def batch_search(self, queries: np.ndarray, size: int = 10, nprobe: int = 8,
                     result_expansion: float = 3.0, mode: str = "refine"):
        """IVFADC search.  ``mode`` is one of the reference's aggregation
        modes (Quantizer.h:2266-2549, CLI letters NGTQCommand.h:299-312):
        ``"approx"``, ``"lut"``, ``"cached-lut"`` (a/l/c: the LUT sums, one
        computation here, returning L2 distances), ``"refine"`` (r: the
        approximate top-(size x expansion) re-ranked exactly; the default)
        or ``"exact"`` (e: exact distances of every probed record).
        Returns (external ids [B, size], -1 where empty; dists)."""
        if not self.built:
            self.build()
        dev = self._device()
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None]
        nprobe = min(nprobe, len(self.centroids))
        mode = {"a": "approx", "l": "lut", "c": "cached-lut", "r": "refine",
                "e": "exact"}.get(mode, mode)
        if mode not in ("approx", "lut", "cached-lut", "refine", "exact"):
            raise ValueError(f"unknown aggregation mode: {mode}")
        refine = mode == "refine"
        k_exp = max(int(np.ceil(size * max(result_expansion, 1.0))), size) if refine else size
        step = self._query_chunk(dev, nprobe, k_exp, mode)
        outs = []
        for s in range(0, len(q), step):
            qd = torch.from_numpy(np.ascontiguousarray(q[s : s + step])).to(self.device)
            if mode == "exact":
                _, probe = topk_pos(D.pairwise(DistanceType.L2, qd, dev["centroids"]), nprobe)
                outs.append(self._search_exact(qd, probe, size))
                continue
            _, ids, dists = _search_approx(
                dev["centroids"], dev["cent_buckets"], dev["bucket_ids"], dev["bucket_vals"],
                dev["bucket_norm"], dev["scale"], qd, nprobe=nprobe, k=k_exp)
            if not refine:
                outs.append((ids[:, :size], D.sqrt(torch.clamp(dists[:, :size], min=0))))
            else:
                outs.append(_rerank_rows(qd, self._raw_rows(ids), ids, size=size,
                                         metric=self.metric))
        ids = torch.cat([o[0] for o in outs]).cpu().numpy()
        dists = torch.cat([o[1] for o in outs]).cpu().numpy()
        return self._ext_ids(ids), dists

    def _search_exact(self, qd, probe, size):
        """Exact distances of every probed record (AggregationMode
        ExactDistance, Quantizer.h:2266-2304)."""
        dev = self._device()
        bsel = dev["cent_buckets"][probe]
        bsafe = bsel.to(torch.int64).clamp(0, dev["bucket_ids"].shape[0] - 1)
        ids = torch.where((bsel >= 0)[..., None], dev["bucket_ids"][bsafe], -1)
        flat = ids.reshape(ids.shape[0], -1)
        rows = self._raw_rows(flat)
        dd = torch.where(flat >= 0, D.gathered(self.metric, qd, rows), INF)
        out_d, sel = topk_pos(dd, min(size, flat.shape[1]))
        out_i = flat.gather(1, sel)
        return torch.where(torch.isfinite(out_d), out_i, -1), out_d

    def search(self, query, size=10, nprobe=8, result_expansion=3.0, mode: str = "refine"):
        ids, dists = self.batch_search(
            np.asarray(query, np.float32)[None, :], size=size, nprobe=nprobe,
            result_expansion=result_expansion, mode=mode,
        )
        return [(int(i), float(d)) for i, d in zip(ids[0], dists[0])
                if i >= 0 and np.isfinite(d)]

    # ------------------------------------------------------------- audits --
    def verify(self) -> list[str]:
        """Inverted-index consistency (NGTQ validate/verify,
        Quantizer.h:2140-2246, 2612-2668)."""
        errs = []
        if not self.built:
            return ["index not built"]
        self._flush_pending()
        n = self.size
        if self._assign.shape[0] != n or self._codes.shape[0] != n:
            errs.append("assignment/code count mismatch")
        if len(self._assign) and (
            (self._assign < 0).any() or (self._assign >= len(self.centroids)).any()
        ):
            errs.append("assignment out of range")
        codes = self._codes
        if self.packed and codes.size:
            codes = unpack_codes4(codes, self.pq.m)
        if codes.size and (codes >= self.pq.ksub).any():
            errs.append("code out of range")
        if self._raw is not None and self._raw.shape[0] != n:
            errs.append("raw object count mismatch")
        if (self._ids.shape[0] != len(self._assign)
                or self._valid.shape[0] != len(self._assign)):
            errs.append("id/validity count mismatch")
        elif len(self._ids) > 1 and not bool((np.diff(self._ids) > 0).all()):
            errs.append("external ids not strictly increasing")
        return errs

    def quantization_error(self, sample: int = 1024, seed: int = 0) -> dict:
        """Mean |reconstruction - row| over a sample of live records
        (Quantizer.h:2552-2584)."""
        self._flush_pending()
        if self._raw is None:
            raise ValueError("audit needs raw vectors")
        rng = np.random.default_rng(seed)
        live = np.nonzero(self._valid)[0]
        pick = live[rng.choice(len(live), size=min(sample, len(live)), replace=False)]
        x = np.asarray(self._raw)[pick]
        codes = self._codes[pick]
        if self.packed:
            codes = unpack_codes4(codes, self.pq.m)
        recon = self.pq.decode(codes) + self.centroids[self._assign[pick]]
        err = np.linalg.norm(x - recon, axis=1)
        scale = np.linalg.norm(x - x.mean(0), axis=1).mean() or 1.0
        return {
            "mean_reconstruction_error": float(err.mean()),
            "relative_error": float(err.mean() / scale),
            "max_reconstruction_error": float(err.max()),
        }

    # -------------------------------------------------------- persistence --
    def save(self, path: str) -> None:
        """``<path>/ivfpq.npz`` and ``ivfpq.json`` in the reference's
        format, so each package opens the other's."""
        self._flush_pending()
        os.makedirs(path, exist_ok=True)
        raw = (np.zeros((0, self.dimension), np.float32)
               if self._raw is None or self.raw_store == "mmap" else np.asarray(self._raw))
        np.savez(
            os.path.join(path, "ivfpq.npz"),
            centroids=self.centroids,
            assign=self._assign,
            codes=self._codes,
            ids=self._ids,
            valid=self._valid,
            x=raw,
            **{f"pq_{k}": v for k, v in self.pq.state_dict().items()},
        )
        with open(os.path.join(path, "ivfpq.json"), "w") as fh:
            json.dump({
                "dimension": self.dimension,
                "metric": int(self.metric),
                "n_centroids": self.n_centroids,
                "raw_store": self.raw_store,
                "raw_path": self.raw_path,
                "packed": self.packed,
                "trained_size": self._trained_size,
                "rebuild_factor": self.rebuild_factor,
                "next_id": self._next_id,
                "centroid_mode": self.centroid_mode,
                "global_range": self.global_range,
            }, fh)

    @classmethod
    def open(cls, path: str, device="cuda") -> "IVFPQIndex":
        with open(os.path.join(path, "ivfpq.json")) as fh:
            meta = json.load(fh)
        st = np.load(os.path.join(path, "ivfpq.npz"))
        idx = cls(
            meta["dimension"],
            n_centroids=meta["n_centroids"],
            dsub=int(st["pq_dsub"]),
            ksub=int(st["pq_ksub"]),
            metric=DistanceType(meta["metric"]),
            raw_store=meta.get("raw_store", "device"),
            raw_path=meta.get("raw_path"),
            rebuild_factor=meta.get("rebuild_factor", 2.0),
            centroid_mode=meta.get("centroid_mode", "static"),
            device=device,
        )
        idx.global_range = float(meta.get("global_range", 0.0))
        idx.centroids = st["centroids"]
        idx._assign = st["assign"]
        codes = st["codes"]
        if not meta.get("packed", False) and idx.packed:
            codes = pack_codes4(codes)   # the round-1 unpacked format
        idx._codes = codes
        if idx.raw_store == "mmap":
            idx._raw = np.memmap(idx.raw_path, dtype=np.float32, mode="r",
                                 shape=(len(idx._assign), idx.dimension))
        elif idx.raw_store != "none" and st["x"].size:
            idx._raw = st["x"].astype(np.float32)
        idx.pq = ProductQuantizer.from_state(
            {k: st[f"pq_{k}"] for k in ("codebooks", "mean", "dsub", "ksub", "dimension")},
            device=device)
        n = len(idx._assign)
        idx._ids = st["ids"] if "ids" in st.files else np.arange(n, dtype=np.int64)
        idx._valid = (st["valid"].astype(bool) if "valid" in st.files
                      else np.ones(n, bool))
        idx._next_id = int(meta.get("next_id", int(idx._ids.max()) + 1 if n else 0))
        idx._trained_size = int(meta.get("trained_size", len(idx._assign)))
        return idx
