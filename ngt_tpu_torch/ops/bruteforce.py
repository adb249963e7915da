"""Exact brute-force k-NN (the port's counterpart of
``ngt_tpu/ops/bruteforce.py``) — the analogue of the reference's
``ObjectSpaceRepository::linearSearch`` (ObjectSpaceRepository.h:466-502)
and the ground-truth generator of the recall harness.

Selections order ties by id (``ops/select.py``), which is the order the
reference's ``top_k`` gives through its candidate layout.
"""

from __future__ import annotations

import torch

from ngt_tpu_torch.ops import distances as D
from ngt_tpu_torch.ops.select import topk_lex
from ngt_tpu_torch.ops.window_scan import BIG, window_scan
from ngt_tpu_torch.properties import DistanceType

_F32 = torch.float32
INF = float("inf")


def pad_dim(d: int, multiple: int = 128) -> int:
    """Round the feature dim up to a multiple of 128 (the analogue of
    ObjectSpace::getPaddedDimension's x16 rounding, ObjectSpace.h:249)."""
    return max(((d + multiple - 1) // multiple) * multiple, multiple)


def _pad_rows(t: torch.Tensor, n_pad: int, value=0) -> torch.Tensor:
    if t.shape[0] == n_pad:
        return t
    pad = t.new_full((n_pad - t.shape[0],) + tuple(t.shape[1:]), value)
    return torch.cat([t, pad])


#: bytes the per-block temporaries of ``linear_search`` may hold
BLOCK_BYTES = 1 << 30


def block_rows(metric, b: int, d: int, block: int = 65536) -> int:
    """Corpus rows per ``linear_search`` block: ``block`` at most, fewer
    where the [B, rows] tile and its temporaries would pass BLOCK_BYTES
    (a multiple of 128 rows, at least 128).  The distance functions hold
    per (query, row) about 32 bytes of f32 tiles and selection keys; the
    bit unpack of Hamming and Jaccard holds 32 bytes per row byte (sparse
    Jaccard bounds its own lookups, ``distances._BLOCK_BYTES``)."""
    metric = DistanceType(metric)
    per_pair = 32
    per_row = 4 * d + (32 * d if metric in D.BITWISE_METRICS else 0)
    rows = BLOCK_BYTES // max(b * per_pair + per_row, 1)
    return int(min(block, max(128, rows // 128 * 128)))


def linear_search(queries, x, valid, metric, k: int, x_sqnorm=None,
                  block: int = 65536):
    """Exact top-k. Returns (ids [B,k] int32, dists [B,k] f32), ascending;
    empty slots are (-1, +inf).  Blocked over N (``block`` rows at most,
    fewer where ``block_rows`` bounds the bytes) with a running merge; the
    block size does not change the result."""
    n, b = x.shape[0], queries.shape[0]
    block = block_rows(metric, b, x.shape[1], block)
    best_d = torch.full((b, k), INF, dtype=_F32, device=x.device)
    best_i = torch.full((b, k), -1, dtype=torch.int32, device=x.device)
    for s in range(0, n, block):
        e = min(s + block, n)
        d = D.pairwise(
            metric, queries, x[s:e],
            x_sqnorm=None if x_sqnorm is None else x_sqnorm[s:e],
        )
        d = torch.where(valid[None, s:e], d, INF)
        ids = torch.arange(s, e, dtype=torch.int32, device=x.device)
        best_d, best_i = topk_lex(
            torch.cat([best_d, d], 1),
            torch.cat([best_i, ids[None, :].expand(b, -1)], 1), k,
        )
    best_i = torch.where(torch.isinf(best_d), -1, best_i)
    return best_i.to(torch.int32), best_d


def fast_knn_l2(queries, x, valid, x_sqnorm, k: int, kc: int = 0,
                block: int = 65536):
    """Exact L2 top-k of arbitrary queries by a bf16 scan and an f32
    re-rank: per corpus block a bf16 score tile (f32 products and sums)
    merged into the running top-kc, then the kc candidates re-ranked
    exactly.  bf16's relative error never pushes a true neighbor out of
    a 4x-wide candidate set.  Returns (ids [B,k] int32, dists [B,k] f32)."""
    b, n = queries.shape[0], x.shape[0]
    kc = kc if kc > 0 else 4 * k
    q16 = queries.to(torch.bfloat16).to(_F32)
    q_sq = (queries.to(_F32) ** 2).sum(-1)
    cd = torch.full((b, kc), INF, dtype=_F32, device=x.device)
    ci = torch.full((b, kc), -1, dtype=torch.int32, device=x.device)
    for s in range(0, n, block):
        e = min(s + block, n)
        dot = q16 @ x[s:e].to(torch.bfloat16).to(_F32).T
        d2 = q_sq[:, None] + x_sqnorm[None, s:e] - 2.0 * dot
        d2 = torch.where(valid[None, s:e], d2, INF)
        ids = torch.arange(s, e, dtype=torch.int32, device=x.device)
        cd, ci = topk_lex(torch.cat([cd, d2], 1),
                          torch.cat([ci, ids[None, :].expand(b, -1)], 1), kc)
    ci = torch.where(torch.isinf(cd), -1, ci)
    rows = x[ci.to(torch.int64).clamp(0, n - 1)].to(_F32)
    diff = rows - queries.to(_F32)[:, None, :]
    dd = torch.where(ci >= 0, (diff * diff).sum(-1), INF)
    sd, si = topk_lex(dd, ci, k)
    return (torch.where(torch.isinf(sd), -1, si).to(torch.int32),
            D.sqrt(torch.clamp(sd, min=0.0)))


def center_rows(x, valid, x_sqnorm):
    """(mu, centered rows in bf16, centered sqnorms) of the valid-row mean:
    ||x-mu||^2 = ||x||^2 - 2 x.mu + ||mu||^2.  Centering comes BEFORE the
    bf16 cast, so the cast rounds covariance-scale values."""
    cnt = torch.clamp(valid.to(_F32).sum(), min=1.0)
    mu = torch.where(valid[:, None], x, 0.0).sum(0) / cnt
    sp = x_sqnorm - 2.0 * (x @ mu) + (mu * mu).sum()
    return mu, (x - mu[None, :]).to(torch.bfloat16), sp


def fast_knn_l2_bulk(q_ids, x, valid, x_sqnorm, *, k: int, kc: int = 0,
                     qblock: int = 4096, block: int = 32768,
                     scan_impl: str = "blocked"):
    """Exact k-NN of many stored rows (``q_ids`` into ``x``) against the
    whole store: a bf16 candidate scan, then an exact f32 re-rank.

    Rows and queries are centered on the valid-row mean BEFORE the bf16
    cast (translation leaves every L2 distance unchanged and shrinks the
    dot products to covariance scale; the reference's ``bf16_tile`` path,
    which its build always takes).

    ``scan_impl="blocked"``: per corpus block of ``block`` rows, a bf16
    score tile and its top-kc; then the top-kc across blocks.
    ``scan_impl="window"``: the window-min scan (``ops/window_scan.py``;
    the hand kernel on CUDA), one candidate per 128-row window, then the
    top-kc windows.  Either way the returned top-k is exact over the
    candidates, re-ranked from the original f32 rows."""
    n = x.shape[0]
    kc = kc if kc > 0 else 4 * k
    if scan_impl not in ("blocked", "window"):
        raise ValueError(f"unknown scan_impl {scan_impl!r}")
    use_window = scan_impl == "window"
    xp, vp, sp = x, valid, x_sqnorm
    if use_window:
        # the reference pads the corpus to whole 8192-multiple blocks; the
        # padding rows are invalid and keep the window layout identical
        block = max(((block + 8191) // 8192) * 8192, 8192)
        n_pad = max((n + block - 1) // block, 1) * block
        xp, vp, sp = _pad_rows(x, n_pad), _pad_rows(valid, n_pad, False), \
            _pad_rows(x_sqnorm, n_pad)
    mu, x16, sp = center_rows(xp, vp, sp)
    if use_window:
        sp_masked = torch.where(vp, sp, float(BIG))
    col = torch.arange(n, dtype=torch.int32, device=x.device)

    out_i, out_d = [], []
    for t in range(0, q_ids.shape[0], qblock):
        idq = q_ids[t : t + qblock].to(torch.int64)
        q = x[torch.clamp(idq, 0, n - 1)]
        qc = q.to(_F32) - mu[None, :]
        q16 = qc.to(torch.bfloat16)
        b = q.shape[0]
        if use_window:
            wd, wi = window_scan(q16, x16, sp_masked)
            cd, ci = topk_lex(wd, wi, min(kc, wd.shape[1]))
            ci = torch.where(cd >= float(BIG) * 0.5, -1, ci)
        else:
            q_sq = (qc * qc).sum(-1)
            cds, cis = [], []
            for s in range(0, n, block):
                e = min(s + block, n)
                dot = q16 @ x16[s:e].T                    # bf16 score tile
                d2 = q_sq[:, None] + sp[None, s:e] - 2.0 * dot.to(_F32)
                d2 = torch.where(vp[None, s:e], d2, INF)
                d2 = d2.to(torch.bfloat16).to(_F32)
                bd, bi = topk_lex(d2, col[None, s:e].expand(b, -1), min(kc, e - s))
                cds.append(bd)
                cis.append(torch.where(torch.isinf(bd), -1, bi))
            cd, ci = torch.cat(cds, 1), torch.cat(cis, 1)
            if cd.shape[1] > kc:
                cd, ci = topk_lex(cd, ci, kc)
        if cd.shape[1] < k:  # fewer rows than k: pad with empty slots
            cd = torch.cat([cd, cd.new_full((b, k - cd.shape[1]), INF)], 1)
            ci = torch.cat([ci, ci.new_full((b, k - ci.shape[1]), -1)], 1)
        # exact f32 re-rank of the candidate set, from the original rows
        rows = x[torch.clamp(ci.to(torch.int64), 0, n - 1)].to(_F32)
        diff = rows - q.to(_F32)[:, None, :]
        dd = torch.where(ci >= 0, (diff * diff).sum(-1), INF)
        sd, si = topk_lex(dd, ci, k)
        out_i.append(torch.where(torch.isinf(sd), -1, si).to(torch.int32))
        out_d.append(D.sqrt(torch.clamp(sd, min=0.0)))
    return torch.cat(out_i), torch.cat(out_d)


def recall_at_k(found_ids, gt_ids, k: int) -> float:
    """recall@k as computed by the reference's evaluator
    (Optimizer::evaluate, Optimizer.h:130-226): |found ∩ gt| / k averaged."""
    found = found_ids[:, :k]
    gt = gt_ids[:, :k]
    hits = 0
    for f, g in zip(found, gt):
        hits += len(set(int(i) for i in f if i >= 0) & set(int(i) for i in g if i >= 0))
    return hits / (len(found) * k)
