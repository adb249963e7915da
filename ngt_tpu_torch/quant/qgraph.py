"""Quantized-graph search (the port's counterpart of
``ngt_tpu/quant/qgraph.py``) — the NGTQG analogue, the route that
``Index.batch_search`` takes with default properties at 5,000+ nodes.

The reference's NGTQG (NGTQ/QuantizedGraph.h) stores, per graph node, the
quantized codes of its neighbors and scores all neighbors of a popped node
at once, then re-ranks the expanded candidates exactly
(``searchQuantizedGraph``, QuantizedGraph.h:192-320).  Here:

* codes are ``sq8``: int8 with ONE global scale, so scaled L2 over the
  codes ranks exactly like L2 over the quantized vectors, or, past the
  block budget (``pick_mode``), ``pq4``: the reference's 4-bit product
  codes, two to a byte (``quant/pq.py``), scored by a per-query lookup
  table (ADC) computed per chunk from the codebooks.  An integral
  corpus (u8 narrow mirror) skips quantization: its codes ARE the mirror
  tensor, scale 1.0, and the traversal scores exact distances.  Plain
  Cosine and Angle (rows stored un-normalized) encode the row-normalized
  vectors and traverse with normalized queries: on unit rows L2 ranks
  like the angle; the exact re-rank then scores the raw mirror with the
  true metric;
* each node owns one block row ``[eb * M]``: the codes of its first ``eb``
  neighbors, so one row read per expanded node scores every neighbor
  (block-mode ``graph.search.graph_search``);
* the traversal keeps ``result_expansion * k`` candidates, which are
  re-ranked exactly over the mirror; when the block width cut the
  adjacency (``eb < e_max``), the tails of the top-k rows are scored too
  (``_tail_refine_body``).

Block sizing keeps the reference's constants
(``NGT_TPU_QG_BLOCK_GB``, ``SQ8_MIN_EB``, the width floor 16), so both
packages pick the same format, width and refine budget at every size.
The reference's recovery paths for a shared TPU (shrinking blocks after an
out-of-memory error, a cool-down onto the exact route, the eager redo) are
not ported: a ``torch.cuda.OutOfMemoryError`` propagates.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from ngt_tpu_torch import trace
from ngt_tpu_torch.graph.search import _repeats, graph_search, wrap_hash_bits
from ngt_tpu_torch.ops import distances as D
from ngt_tpu_torch.ops.select import topk_pos
from ngt_tpu_torch.properties import DistanceType
from ngt_tpu_torch.quant.clustering import kmeans_dev
from ngt_tpu_torch.quant.pq import (
    ProductQuantizer,
    encode_dev,
    lut_dev,
    make_packed_scorer,
    pack_codes4,
    pack_codes4_dev,
)
from ngt_tpu_torch.seeds import default_reps, top_seeds

INF = float("inf")
_F32 = torch.float32

#: seconds per stage of the quantized-graph calls made with
#: NGT_TPU_QG_PROFILE=1 since it was last cleared (on a card the device
#: timeline between the stage's two events, filled when the call ends):
#: quantize (with its pq4 parts fit and encode), blocks (the first call's
#: code encode and block gather), seeds, traverse, rerank, refine
last_profile: dict[str, float] = {}


def _stage(label: str, dev: torch.device):
    """The tracer's span ``qg.<label>`` of the search family, its seconds
    added to ``last_profile[label]``."""
    return trace.span("qg." + label, trace.SEARCH, dev, into=(last_profile, label))


def _bucket(n: int) -> int:
    """Batch padding: the next power of two, at least 32."""
    return 1 << max(int(math.ceil(math.log2(max(n, 1)))), 5)


def _normalizes(metric) -> bool:
    """Plain angular metrics: their sq8 codes are built from unit rows."""
    return metric in D.ANGULAR_METRICS


def _sq8_rows(metric, x_rows: np.ndarray) -> np.ndarray:
    """Host rows the sq8 codes are built from: row-normalized for the plain
    angular metrics."""
    if _normalizes(metric):
        nrm = np.linalg.norm(x_rows, axis=1, keepdims=True)
        return x_rows / np.maximum(nrm, 1e-30)
    return x_rows


def _rerank_body(x, queries, cand_ids, cand_ok, metric, k):
    """Re-rank candidate ids exactly (the reference's resultExpansion
    re-rank, QuantizedGraph.h:270-299)."""
    safe = cand_ids.to(torch.int64).clamp(0, x.shape[0] - 1)
    d = D.gathered(metric, queries, x[safe])
    d = torch.where(cand_ok, d, INF)
    dd, sel = topk_pos(d, k)
    ids = cand_ids.gather(1, sel)
    return torch.where(torch.isfinite(dd), ids, -1), dd


def _tail_refine_body(x, codes, nbr_full, valid, q, qdv, pool_ids, ids1, *,
                      metric, k, eb, r_sel, scorer=None):
    """Edge-tail refinement: the traversal never scores adjacency columns
    >= eb, and the true neighbors it misses sit mostly in those tails of
    the top-k rows.  Score the k*(e_max-eb) tail ids over the codes (sq8:
    L2 against the scaled queries ``qdv``; pq4: ``scorer`` over the
    per-query tables ``qdv``), keep
    the best ``r_sel``, and re-rank them exactly with the pool (duplicates
    dropped, the first occurrence kept)."""
    n = x.shape[0]
    b, kk = ids1.shape
    tails = nbr_full[ids1.to(torch.int64).clamp(0, n - 1)][:, :, eb:]   # [B, k, T]
    t = tails.shape[2]
    cand = tails.reshape(b, kk * t)
    safe_c = cand.to(torch.int64).clamp(0, n - 1)
    ok = (cand >= 0) & valid[safe_c]
    rows = codes[safe_c]
    dd = D.gathered(DistanceType.L2, qdv, rows) if scorer is None else scorer(qdv, rows)
    dd = torch.where(ok, dd, INF)
    dsel, sel = topk_pos(dd, min(r_sel, kk * t))
    tid = torch.where(torch.isfinite(dsel), cand.gather(1, sel), -1)
    merged = torch.cat([pool_ids, tid], 1)
    ok = (merged >= 0) & ~_repeats(merged, skip_negative=True)
    return _rerank_body(x, q, merged, ok, metric, k)


def _qg_fused_search(
    blocks, nbr_eb, valid, codes, x, rep_rows, rep_sq, rep_ids, q, sq_scale,
    epsilon, edge_limit, nbr_full, codebooks=None, pq_mean=None, *, metric, k,
    k_exp, s, width, hash_bits, exact_hash, expand, normalize_q, refine=0,
    eb=0, kr=0, mode="sq8", m=0, ksub=16,
):
    """Seed selection, the block traversal, the exact re-rank over the
    mirror and the edge-tail refine, for one chunk of prepared queries
    ``q`` [B, D_pad] f32: (ids, dists, the traversal's ``SearchResult``).
    The traversal queries are normalized when
    ``normalize_q``; then sq8 scales them by 1/scale and scores L2 over the
    int8 block rows, pq4 computes each query's lookup table [M * ksub] from
    the codebooks [M, ksub, dsub] and the mean and scores the packed block
    rows by ``make_packed_scorer(m, ksub)``."""
    dev = q.device
    with _stage("seeds", dev):
        sd = D.seed_scores(metric, q, rep_rows, rep_sq=rep_sq)
        seeds = rep_ids[top_seeds(sd, s)]
    with _stage("traverse", dev):
        qn = D.normalize_rows(q) if normalize_q else q
        if mode == "sq8":
            qt = qn / torch.tensor(sq_scale, dtype=_F32)
            scorer = None
        else:
            qt = lut_dev(qn - pq_mean[None, :], codebooks).reshape(q.shape[0], -1)
            scorer = make_packed_scorer(m, ksub)
        res = graph_search(
            blocks, nbr_eb, valid, qt, seeds,
            metric=DistanceType.L2, k=k_exp, k_radius=kr if kr > 0 else k,
            epsilon=epsilon, width=width, edge_size=edge_limit,
            hash_bits=hash_bits, exact_hash=exact_hash, expand=expand,
            scorer=scorer, block_mode=True, seed_x=codes,
        )
    with _stage("rerank", dev):
        ids1, d1 = _rerank_body(x, q, res.ids, res.ids >= 0, metric, k)
    if refine <= 0 or nbr_full.shape[1] <= eb:
        return ids1, d1, res
    with _stage("refine", dev):
        ids1, d1 = _tail_refine_body(
            x, codes, nbr_full, valid, q, qt, res.ids, ids1,
            metric=metric, k=k, eb=eb, r_sel=refine, scorer=scorer,
        )
    return ids1, d1, res


class QuantizedGraphIndex:
    """NGTQG-style index over a built ``Index``: its graph, its device
    mirror (exact vectors) and codes, either sq8 ``[cap, d_pad]`` (int8, or
    uint8 for the u8-exact codes of an integral corpus) or pq4
    ``[cap, ceil(M/2)]`` packed uint8 with the ``ProductQuantizer`` ``pq``.
    Build one with ``quantize`` (the analogue of ``ngtqg quantize``,
    QuantizedGraph.h:456-475)."""

    #: narrowest block width the auto format keeps sq8 down to
    SQ8_MIN_EB = 8
    #: rows the pq4 codebooks train on (a deterministic sample of live rows)
    PQ_FIT_SAMPLE = 1 << 18
    #: rows per step of the host pq4 encode
    PQ_ENCODE_CHUNK = 1 << 19
    #: rows per step of the device encode (bounds the f32 widening and the
    #: [chunk, M, ksub] pq distance tile)
    DEV_ENCODE_CHUNK = 1 << 18

    def __init__(self, index, codes: np.ndarray, mode: str = "sq8",
                 sq_scale: float = 1.0, block_edges: int = 0,
                 pq: ProductQuantizer | None = None):
        if mode not in ("sq8", "pq4") or (mode == "pq4") != (pq is not None):
            raise ValueError(f"mode {mode!r} with pq {pq!r}")
        self.index = index
        self.pq = pq
        self.codes = codes
        self.mode = mode
        self.sq_scale = float(sq_scale)
        #: neighbors per block row (0 = sized by the block budget)
        self.block_edges = int(block_edges)
        self._codes_dev = None
        #: the store's mutation_count at the last encode: an insert after
        #: quantize() triggers a re-encode
        self._codes_mut = index.store.mutation_count
        #: the host codes are a placeholder for the device codes until
        #: something on the host needs them (save)
        self._codes_host_stale = False
        self._blocks_dev = self._nbr_eb = self._blocks_for = None
        self._cb_dev = self._mean_dev = None

    # ------------------------------------------------------------------
    @classmethod
    def pick_mode(cls, cap: int, d_pad: int) -> str:
        """Block format by memory budget: sq8 while the budget admits
        >= SQ8_MIN_EB block columns, else pq4."""
        if d_pad % 4:
            return "sq8"
        gb = float(os.environ.get("NGT_TPU_QG_BLOCK_GB", "6"))
        eb_sq8 = int(gb * (1 << 30)) // max(cap * d_pad, 1)
        return "sq8" if eb_sq8 >= cls.SQ8_MIN_EB else "pq4"

    @classmethod
    def _quantize_device(cls, index, dsub: int, ksub: int, iters: int,
                         mode: str) -> "QuantizedGraphIndex":
        """Encode straight from the device mirror.  sq8: the scale is the
        largest |component| of the live rows over 127 (a Python double);
        codes are round(x * float32(1/scale)) clipped to +-127, dead rows
        0; the plain angular metrics encode the row-normalized rows, so
        their codes are never the u8 mirror.  pq4: k-means++ codebooks
        (seed 0) over the residuals of PQ_FIT_SAMPLE live rows drawn by
        ``default_rng(12345)`` (all when fewer) from their mean, all
        subspaces in one batch; dead rows take the code of a zero
        residual."""
        store = index.store
        d_pad = store.d_pad
        mirror = index._ensure_mirror()
        cap = store._x.shape[0]
        dev = mirror.x.device
        normalize = _normalizes(store.metric)
        if mode == "sq8" and not normalize and mirror.x.dtype == torch.uint8:
            # integral corpus, narrow mirror: the codes ARE the corpus
            self = cls(index, np.zeros((cap, d_pad), np.uint8), sq_scale=1.0)
            self._codes_dev = mirror.x
            self._codes_host_stale = True
            return self
        if mode == "pq4":
            with _stage("fit", dev):
                live_idx = np.nonzero(store._valid[: store.repository_size])[0]
                fit_ids = live_idx[cls._fit_positions(len(live_idx))]
                fit = mirror.x[torch.from_numpy(fit_ids).to(dev)].to(_F32)
                fit = D.normalize_rows(fit) if normalize else fit
                pq = ProductQuantizer(d_pad, dsub=dsub, ksub=ksub, device=dev)
                if pq.m % 2:
                    raise ValueError("device pq4 needs an even subspace count")
                mean = fit.mean(0)
                xs = (fit - mean).view(len(fit_ids), pq.m, dsub).transpose(0, 1)
                cents = kmeans_dev(xs, ksub, iters, "kmeans++", 0)[0]
                pq.codebooks, pq.mean = cents.cpu().numpy(), mean.cpu().numpy()
            return cls.encode_pq4(index, pq)
        valid = torch.from_numpy(store._valid[:cap]).to(dev)
        step = cls.DEV_ENCODE_CHUNK

        def rows(i):
            xr = mirror.x[i : i + step].to(_F32)
            return torch.where(valid[i : i + step, None],
                               D.normalize_rows(xr) if normalize else xr, 0.0)

        scale = max(float(rows(i).abs().max()) for i in range(0, cap, step)) / 127.0
        scale = max(scale, 1e-30)
        inv = torch.tensor(np.float32(1.0 / scale))
        codes = torch.cat([
            torch.clamp(torch.round(rows(i) * inv), -127, 127).to(torch.int8)
            for i in range(0, cap, step)
        ])
        self = cls(index, np.zeros((cap, d_pad), np.int8), sq_scale=scale)
        self._codes_dev = codes
        self._codes_host_stale = True
        return self

    @classmethod
    def encode_pq4(cls, index, pq: ProductQuantizer) -> "QuantizedGraphIndex":
        """pq4 codes of every row of ``index``'s device mirror under
        ``pq`` (an even subspace count), packed two to a byte, in
        DEV_ENCODE_CHUNK row chunks on the device; rows of the plain angular
        metrics are normalized first, dead rows take the code of a zero
        residual."""
        store = index.store
        mirror = index._ensure_mirror()
        cap = store._x.shape[0]
        dev = mirror.x.device
        normalize = _normalizes(store.metric)
        valid = torch.from_numpy(store._valid[:cap]).to(dev)
        step = cls.DEV_ENCODE_CHUNK
        self = cls(index, np.zeros((cap, pq.m // 2), np.uint8), mode="pq4", pq=pq)
        with _stage("encode", dev):
            cb, mean = self._dev_pq()

            def resid(i):
                xr = mirror.x[i : i + step].to(_F32)
                xr = D.normalize_rows(xr) if normalize else xr
                return torch.where(valid[i : i + step, None], xr, mean) - mean

            self._codes_dev = torch.cat([
                pack_codes4_dev(encode_dev(resid(i), cb)) for i in range(0, cap, step)
            ])
        self._codes_host_stale = True
        return self

    @classmethod
    @trace.public
    def quantize(cls, index, dsub: int = 2, ksub: int = 16, iters: int = 20,
                 mode: str = "sq8") -> "QuantizedGraphIndex":
        """Codes for ``index``: sq8, or pq4 with ``dsub``-wide subspaces of
        ``ksub`` centroids fitted in ``iters`` Lloyd iterations;
        ``mode="auto"`` picks the format by the block budget
        (``pick_mode``).  NGT_TPU_QG_HOST_QUANTIZE=1, or pq4 with an odd
        subspace count, encodes on the host instead (sq8: rows divided by
        the scale, int8 codes even for an integral corpus; pq4: fit on the
        sample drawn as above, seed 0, dead rows code 0; unit rows for the
        plain angular metrics)."""
        store = index.store
        if mode == "auto":
            mode = cls.pick_mode(store._x.shape[0], store.d_pad)
        if mode not in ("sq8", "pq4"):
            raise ValueError(f"unknown quantization mode: {mode}")
        with _stage("quantize", store.device):
            if (os.environ.get("NGT_TPU_QG_HOST_QUANTIZE", "") != "1"
                    and not (mode == "pq4" and (store.d_pad // dsub) % 2)):
                return cls._quantize_device(index, dsub, ksub, iters, mode)
            n = store.repository_size
            live = store._valid[:n]
            rows = _sq8_rows(store.metric, store._x[:n][live].astype(np.float32))
            if mode == "sq8":
                scale = float(np.abs(rows).max()) / 127.0 if live.any() else 1.0
                scale = scale or 1.0
                codes = np.zeros((store._x.shape[0], store.d_pad), np.int8)
                codes[:n][live] = np.clip(np.round(rows / scale), -127, 127).astype(np.int8)
                return cls(index, codes, sq_scale=scale)
            pq = ProductQuantizer(store.d_pad, dsub=dsub, ksub=ksub, device=store.device)
            pq.fit(rows[cls._fit_positions(len(rows))], iters=iters)
            codes = np.zeros((store._x.shape[0], (pq.m + 1) // 2), np.uint8)
            codes[:n][live] = cls._pq4_encode_chunked(pq, rows)
            return cls(index, codes, mode="pq4", pq=pq)

    @classmethod
    def _fit_positions(cls, n: int) -> np.ndarray:
        """Which of n live rows the pq4 codebooks train on: all, or
        PQ_FIT_SAMPLE of them drawn by ``default_rng(12345)``, sorted."""
        if n <= cls.PQ_FIT_SAMPLE:
            return np.arange(n)
        return np.sort(np.random.default_rng(12345).choice(n, cls.PQ_FIT_SAMPLE, replace=False))

    @classmethod
    def _pq4_encode_chunked(cls, pq: ProductQuantizer, rows: np.ndarray) -> np.ndarray:
        out = np.empty((len(rows), (pq.m + 1) // 2), np.uint8)
        step = cls.PQ_ENCODE_CHUNK
        for i in range(0, len(rows), step):
            out[i : i + step] = pack_codes4(pq.encode(rows[i : i + step]))
        return out

    # ------------------------------------------------------------------
    def _encode_rows(self, x_live: np.ndarray) -> np.ndarray:
        if self.mode == "pq4":
            return self._pq4_encode_chunked(
                self.pq, _sq8_rows(self.index.store.metric, x_live))
        if self.codes.dtype == np.uint8:
            # u8-exact codes stay exact while the data allows; otherwise
            # switch to scaled int8 codes
            if len(x_live) == 0 or (
                np.all((x_live >= 0) & (x_live <= 255))
                and np.array_equal(np.rint(x_live), x_live)
            ):
                return np.rint(x_live).astype(np.uint8)
            self.codes = self.codes.astype(np.int8)
        x_live = _sq8_rows(self.index.store.metric, x_live)
        peak = float(np.abs(x_live).max()) if len(x_live) else 1.0
        if peak > 127.0 * self.sq_scale:
            self.sq_scale = peak / 127.0
        return np.clip(np.round(x_live / self.sq_scale), -127, 127).astype(np.int8)

    def _dev_codes(self) -> torch.Tensor:
        """The codes on the index's device, re-encoded on the host from
        every live row when the store changed since the last encode."""
        store = self.index.store
        cap = store._x.shape[0]
        stale = store.mutation_count != self._codes_mut
        if self.codes.shape[0] < cap:
            grown = np.zeros((cap, self.codes.shape[1]), self.codes.dtype)
            grown[: self.codes.shape[0]] = self.codes
            self.codes = grown
            stale = True
        if stale or self._codes_dev is None:
            with _stage("quantize", store.device):
                if stale:
                    n = store.repository_size
                    live = store._valid[:n]
                    self.codes[:] = 0
                    if live.any():
                        self.codes[:n][live] = self._encode_rows(
                            store._x[:n][live].astype(np.float32)
                        )
                    self._codes_mut = store.mutation_count
                    self._codes_host_stale = False
                self._codes_dev = torch.from_numpy(self.codes).to(store.device, copy=True)
        return self._codes_dev

    def _host_codes(self) -> np.ndarray:
        """Host copy of the codes (downloaded after a device encode)."""
        if self._codes_host_stale:
            self.codes = np.array(self._codes_dev.cpu().numpy())
            self._codes_host_stale = False
        return self.codes

    def _dev_pq(self):
        """The pq4 codebooks and mean on the index's device."""
        if self._cb_dev is None:
            dev = self.index.store.device
            self._cb_dev = torch.tensor(self.pq.codebooks, dtype=_F32, device=dev)
            self._mean_dev = torch.tensor(self.pq.mean, dtype=_F32, device=dev)
        return self._cb_dev, self._mean_dev

    def _resolve_refine(self, e_max: int, eb: int) -> int:
        """search_refine: >= 0 as given; -1 = auto, min(64, e_max - eb),
        the tail that the block width cut."""
        r = int(self.index.prop.search_refine)
        if r >= 0:
            return r
        return min(64, max(0, int(e_max) - int(eb)))

    def _effective_block_edges(self) -> int:
        """Block width: ``block_edges`` when set, else what the budget of
        NGT_TPU_QG_BLOCK_GB (6 GiB) admits, at least 16 edges while the
        budget holds 16 and at least 8 under pressure, at most e_max."""
        if self.block_edges > 0:
            return min(self.block_edges, self.index.graph.e_max)
        cap = self.index.store._x.shape[0]
        m = self.codes.shape[1]
        gb = float(os.environ.get("NGT_TPU_QG_BLOCK_GB", "6"))
        budget = int(gb * (1 << 30)) // max(cap * m, 1)
        floor = max(8, min(16, budget))
        return int(min(self.index.graph.e_max, max(floor, budget)))

    def _dev_blocks(self):
        """Per-node neighbor code blocks [rows, eb*M] and the matching
        adjacency slice [rows, eb], one row per row of the mirror's
        adjacency (the codes may hold more rows after an insert that no
        build followed); cached on the mirror's version, the codes'
        mutation count, eb and the capacity.  Filled in slabs of about
        1 GiB, so the gather's index tensor stays small."""
        codes = self._dev_codes()
        cap = codes.shape[0]
        mirror = self.index._ensure_mirror()
        eb = self._effective_block_edges()
        key = (mirror.version, self._codes_mut, eb, cap)
        if self._blocks_dev is not None and self._blocks_for == key:
            return self._blocks_dev, self._nbr_eb
        self._blocks_dev = self._nbr_eb = None   # free the stale blocks first
        with _stage("blocks", codes.device):
            nbr = mirror.nbr[:, :eb]
            m = codes.shape[1]
            rows = nbr.shape[0]
            blocks = torch.empty((rows, eb * m), dtype=codes.dtype, device=codes.device)
            step = max(1 << 14, (1 << 30) // max(eb * m, 1))
            step = min(1 << 19, 1 << (int(step).bit_length() - 1))
            for s in range(0, rows, step):
                idx = nbr[s : s + step].to(torch.int64).clamp_(0, cap - 1).reshape(-1)
                torch.index_select(codes, 0, idx, out=blocks[s : s + step].view(-1, m))
        self._blocks_dev, self._nbr_eb, self._blocks_for = blocks, nbr, key
        return blocks, nbr

    # ------------------------------------------------------------------
    @trace.public
    def batch_search(
        self,
        queries,
        size: int = 10,
        epsilon: float = 0.02,
        result_expansion: float = 3.0,
        edge_size: int = -1,
        width: int = 0,
        expand: int = 0,
        ef: int = 0,
    ):
        """Quantized traversal + exact re-rank.  ``expand``/``ef`` 0 take
        the index's search_expand/search_ef.  Defaults follow the reference
        (epsilon 0.02, expansion 3.0; bin/ngtqg/README.md:62-69).  Returns
        (ids [B, size] external, dists [B, size])."""
        idx = self.index
        k_exp = max(int(math.ceil(size * max(result_expansion, 1.0))), size)
        if ef <= 0:
            ef = max(int(idx.prop.search_ef), 0)
        kr = min(max(int(size), ef), k_exp) if ef > 0 else int(size)
        if idx.seeder.num_reps == 0 and idx.graph.node_count() > 0:
            live = np.nonzero(idx.graph._has_node)[0].astype(np.int32)
            idx.seeder.refresh(live, idx.store._x, default_reps(len(live)))
        qh = np.asarray(queries, dtype=np.float32)
        if qh.ndim == 1:
            qh = qh[None, :]
        if idx.seeder.num_reps == 0:   # no graph: nothing to reach
            return (np.full((qh.shape[0], size), -1, np.int32),
                    np.full((qh.shape[0], size), np.inf, np.float32))
        return self._batch_search_fused(
            qh, size, k_exp, epsilon, edge_size, width, expand, kr
        )

    def _batch_search_fused(self, qh, size, k_exp, epsilon, edge_size, width,
                            expand, kr=0):
        """The batch in chunks of NGT_TPU_QG_CHUNK (512) queries; a batch
        within one chunk is padded to ``_bucket`` rows, a larger one to
        whole chunks (copies of its first row).  A query's result does not
        depend on its chunk.  With the tracer's search family on, the call
        records ``traverse.query_steps`` (the queries' own traversal steps,
        the padding rows left out) and ``traverse.slot_steps`` (each
        chunk's steps times its real rows)."""
        idx = self.index
        mirror = idx._ensure_mirror()
        bits, exact = wrap_hash_bits(mirror.capacity, idx.prop.visited_bits_log2)
        blocks, nbr_eb = self._dev_blocks()
        codes = self._dev_codes()
        eb = nbr_eb.shape[1]
        # score every resident block column unless asked for fewer
        e = eb if edge_size in (-1, 0) else min(int(edge_size), eb)
        seeder = idx.seeder
        kw = dict(
            metric=idx.store.metric, k=int(size), k_exp=int(k_exp),
            s=int(idx.prop.seed_size),
            width=width if width > 0 else max(64, 2 * k_exp),
            hash_bits=bits, exact_hash=exact,
            expand=expand if expand > 0 else max(idx.prop.search_expand, 1),
            normalize_q=_normalizes(idx.store.metric),
            refine=self._resolve_refine(mirror.nbr.shape[1], eb),
            eb=int(eb), kr=int(kr),
        )
        cb = mean = None
        if self.mode == "pq4":
            cb, mean = self._dev_pq()
            kw.update(mode="pq4", m=int(self.pq.m), ksub=int(self.pq.ksub))
        b0 = qh.shape[0]
        chunk = int(os.environ.get("NGT_TPU_QG_CHUNK", "512"))
        if b0 <= chunk:
            bounds = [(0, b0, _bucket(b0))]
        else:
            bounds = [(i, min(i + chunk, b0), chunk) for i in range(0, b0, chunk)]
        outs = []
        query_steps, slot_steps = [], 0
        for lo, hi, pad in bounds:
            qc = qh[lo:hi]
            if hi - lo < pad:
                qc = np.concatenate([qc, np.repeat(qc[:1], pad - (hi - lo), axis=0)])
            qd = torch.from_numpy(idx.store.prepare_queries_host(qc)).to(idx.store.device)
            ids_c, dists_c, res = _qg_fused_search(
                blocks, nbr_eb, mirror.valid, codes, mirror.x,
                seeder._rep_rows, seeder._rep_sq, seeder._rep_ids_dev, qd, self.sq_scale,
                epsilon, e, mirror.nbr, cb, mean, **kw,
            )
            outs.append((ids_c, dists_c))
            if res.own_steps is not None:
                query_steps.append(res.own_steps[: hi - lo].sum())
                slot_steps += res.iters * (hi - lo)
        ids = torch.cat([o[0] for o in outs])[:b0].cpu().numpy()
        dists = torch.cat([o[1] for o in outs])[:b0].cpu().numpy()
        if query_steps:
            trace.add("traverse.query_steps", int(torch.stack(query_steps).sum()))
            trace.add("traverse.slot_steps", slot_steps)
        return idx._ext(ids), dists

    def search(self, query, size: int = 10, epsilon: float = 0.02,
               result_expansion: float = 3.0):
        ids, dists = self.batch_search(
            np.asarray(query, np.float32)[None, :],
            size=size, epsilon=epsilon, result_expansion=result_expansion,
        )
        lo = 0 if self.index.zero_based else 1
        return [
            (int(i), float(d))
            for i, d in zip(ids[0], dists[0])
            if i >= lo and np.isfinite(d)
        ]

    # ------------------------------------------------------------------
    def save(self, path: str | None = None) -> None:
        """Save the index and ``<path>/qg/quantized.npz`` in the reference's
        format (QuantizedGraph.h:152-162), so each package opens the
        other's."""
        base = path or self.index.path
        if base is None:
            raise ValueError("no path")
        self.index.save(base)
        qg = os.path.join(base, "qg")
        os.makedirs(qg, exist_ok=True)
        n = self.index.store.repository_size
        np.savez(
            os.path.join(qg, "quantized.npz"),
            codes=self._host_codes()[:n],
            mode=self.mode,
            sq_scale=self.sq_scale,
            packed=self.mode == "pq4",
            **(self.pq.state_dict() if self.pq is not None else {}),
        )

    @classmethod
    def open(cls, path: str, device="cuda") -> "QuantizedGraphIndex":
        from ngt_tpu_torch.index import open_index

        idx = open_index(path, device=device)
        st = np.load(os.path.join(path, "qg", "quantized.npz"))
        mode = str(st["mode"]) if "mode" in st else "pq4"
        saved = st["codes"]   # int8, uint8 for u8-exact codes, or pq4 codes
        pq = None
        if mode == "pq4":
            pq = ProductQuantizer.from_state(
                {k: st[k] for k in ("codebooks", "mean", "dsub", "ksub", "dimension")},
                device=idx.device)
            if "packed" not in st or not bool(st["packed"]):
                saved = pack_codes4(saved)   # the round-1 unpacked format
        codes = np.zeros((idx.store._x.shape[0], saved.shape[1]), saved.dtype)
        codes[: saved.shape[0]] = saved
        return cls(idx, codes, mode=mode, sq_scale=float(st["sq_scale"]), pq=pq)
