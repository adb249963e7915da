"""Seed selection (the port's counterpart of ``ngt_tpu/seeds.py``) — the
replacement for the reference's DVPTree descent
(``GraphAndTreeIndex::getSeedsFromTree``, Index.h:1524-1567): score the
query against a sample of representative rows with one matmul and take the
top ``seed_size`` as graph-search entry points.

Representatives are a uniform sample of live ids drawn from the same
``numpy.random.default_rng(0x5EED)`` stream as the reference, so both
packages pick the same ids; ``finalize_kmeans`` replaces them with the
live rows nearest to k-means centroids (``Index.optimize_seeds``).  Its
k-means draws its init on the host (``quant/clustering.py``), not from the
reference's ``jax.random`` stream, so the two packages' k-means reps
differ.
"""

from __future__ import annotations

import numpy as np
import torch

from ngt_tpu_torch.ops import distances as D
from ngt_tpu_torch.ops.select import topk_lex
from ngt_tpu_torch.properties import DistanceType


def _nearest_row(cents: torch.Tensor, rows: torch.Tensor, metric) -> torch.Tensor:
    """The row nearest to each centroid under ``metric`` (the first on
    ties), computed on the device."""
    return torch.argmin(D.pairwise(metric, cents, rows), dim=1)


def default_reps(n_live: int) -> int:
    """Representative count: n/32, at least 1024, at most 65536 (with R
    reps a cluster of m members lacks a rep with prob ~exp(-R*m/n))."""
    return int(min(max(1024, n_live // 32), 65536))


class Seeder:
    """Holds representative object ids and their rows on the device."""

    def __init__(self, metric: DistanceType, seed_size: int = 10, device="cuda"):
        self.metric = DistanceType(metric)
        self.seed_size = int(seed_size)
        self.device = torch.device(device)
        self.rep_ids: np.ndarray = np.zeros((0,), np.int32)
        self._rep_rows: torch.Tensor | None = None
        #: the rep rows' squared norms: the angular seed scores divide by
        #: them, the exotic metrics' exact scores read them
        self._rep_sq: torch.Tensor | None = None
        self._rep_ids_dev: torch.Tensor | None = None
        self._rng = np.random.default_rng(0x5EED)

    @property
    def num_reps(self) -> int:
        return len(self.rep_ids)

    def refresh(self, live_ids: np.ndarray, x_host: np.ndarray, num_reps: int):
        """Resample representatives from the live id set."""
        live_ids = np.asarray(live_ids)
        if len(live_ids) == 0:
            self.rep_ids = np.zeros((0,), np.int32)
            self._rep_rows = self._rep_sq = self._rep_ids_dev = None
            return
        num = int(min(max(num_reps, 1), len(live_ids)))
        sel = (
            live_ids
            if num >= len(live_ids)
            else self._rng.choice(live_ids, size=num, replace=False)
        )
        sel = np.sort(sel).astype(np.int32)
        # pad to a power of two by repeating the first id, as the reference
        # does to bound its recompiles; kept so both packages hold the same
        # rep arrays (duplicate seeds are deduped inside graph_search)
        bucket = 1 << max(int(np.ceil(np.log2(max(len(sel), 1)))), 4)
        if len(sel) < bucket:
            sel = np.concatenate(
                [sel, np.full(bucket - len(sel), sel[0], np.int32)]
            )
        self.set_representatives(sel, x_host)

    def set_representatives(self, rep_ids: np.ndarray, x_host: np.ndarray):
        self.rep_ids = np.asarray(rep_ids, dtype=np.int32)
        self._rep_rows = torch.from_numpy(
            np.ascontiguousarray(x_host[self.rep_ids])
        ).to(self.device)
        self._rep_sq = D.sq_norms(self._rep_rows)
        self._rep_ids_dev = torch.from_numpy(self.rep_ids).to(self.device, copy=True)

    def finalize_kmeans(self, live_ids: np.ndarray, x_host: np.ndarray,
                        num_reps: int = 1024, sample: int = 65536, iters: int = 10):
        """Replace the sampled representatives with the live rows nearest to
        k-means centroids of a sample of live rows (locality comparable to
        the reference's tree leaves, Node.cpp:145-227;
        ngt_tpu/seeds.py:139-200).  Hamming and the Jaccard metrics keep
        their sampled reps (no meaningful mean); past 4,096 reps the
        uniform sample is kept (coverage matters more than placement); k is
        rounded up to a power of two, at most the sample size; random init
        (centroids snap to rows anyway)."""
        from ngt_tpu_torch.quant.clustering import kmeans

        if self.metric in (DistanceType.HAMMING, DistanceType.JACCARD,
                           DistanceType.SPARSE_JACCARD):
            return
        live_ids = np.asarray(live_ids)
        if len(live_ids) == 0:
            return
        if num_reps > 4096:
            self.refresh(live_ids, x_host, num_reps)
            return
        pool = (live_ids if len(live_ids) <= sample
                else self._rng.choice(live_ids, size=sample, replace=False))
        k = int(min(num_reps, len(pool)))
        k = min(1 << max(int(np.ceil(np.log2(max(k, 1)))), 0), len(pool))
        rows = x_host[pool].astype(np.float32)
        cents, _ = kmeans(rows, k, iters=iters, mode="random", device=self.device)
        near = _nearest_row(torch.from_numpy(cents).to(self.device),
                            torch.from_numpy(rows).to(self.device), self.metric)
        sel = np.unique(pool[near.cpu().numpy()]).astype(np.int32)
        bucket = 1 << max(int(np.ceil(np.log2(max(len(sel), 1)))), 4)
        if len(sel) < bucket:
            sel = np.concatenate([sel, np.full(bucket - len(sel), sel[0], np.int32)])
        self.set_representatives(sel, x_host)

    def verify(self, live_mask: np.ndarray, x_host: np.ndarray) -> list:
        """Seed-structure invariants (the role of DVPTree::verify,
        Tree.h:380-403): every representative is a live object and its
        cached device row equals the host row."""
        errs: list = []
        if self.num_reps == 0:
            return errs
        ids = self.rep_ids
        n = len(live_mask)
        if (ids < 0).any() or (ids >= n).any():
            errs.append("representative id out of range")
            return errs
        dead = ~np.asarray(live_mask)[ids]
        if dead.any():
            errs.append(f"{int(dead.sum())} representatives are dead objects")
        if self._rep_rows is not None:
            cached = self._rep_rows.cpu().numpy()
            if cached.shape != x_host[ids].shape or not np.array_equal(
                cached, x_host[ids]
            ):
                errs.append("representative rows stale vs object store")
        return errs

    def seeds_for(self, queries: torch.Tensor, seed_size: int | None = None) -> torch.Tensor:
        """queries [B, D_pad] -> seed ids [B, S] int32, -1 padded."""
        s = int(seed_size or self.seed_size)
        b = queries.shape[0]
        if self._rep_rows is None or self.num_reps == 0:
            return torch.full((b, s), -1, dtype=torch.int32, device=queries.device)
        idx = top_seeds(
            D.seed_scores(self.metric, queries, self._rep_rows, rep_sq=self._rep_sq), s
        )
        ids = self._rep_ids_dev[idx]
        if ids.shape[1] < s:
            ids = torch.cat([ids, ids.new_full((b, s - ids.shape[1]), -1)], 1)
        return ids


def top_seeds(scores: torch.Tensor, s: int) -> torch.Tensor:
    """Positions of the min(s, reps) lowest seed scores per row, ascending,
    ties to the lower position: the order the reference's top-k gives
    (``approx_max_k`` lowers to an exact top-k on the CPU).  ``torch.topk``
    leaves the order of ties open, so the selection runs on (score,
    position) keys."""
    pos = torch.arange(scores.shape[1], dtype=torch.int32, device=scores.device)
    _, idx = topk_lex(scores, pos.expand_as(scores), min(s, scores.shape[1]))
    return idx.to(torch.int64)
