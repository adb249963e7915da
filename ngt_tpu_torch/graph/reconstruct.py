"""ONNG construction: bulk graph rewrites and shortcut (path) reduction —
the port's counterpart of ``ngt_tpu/graph/reconstruct.py`` (the reference's
``GraphReconstructor``, lib/NGT/GraphReconstructor.h).

Every pass is a whole-graph torch program on an explicit device (the
index's; ``"cuda"`` unless the caller asks for the CPU):

* ``convert_to_anng`` — add all reverse edges, sort, dedupe (:389-423);
* ``reconstruct_graph`` — keep the best ``out_edges`` per row, add the
  reverses of each row's first ``in_edges`` original edges, sort, dedupe
  (:425-561); ``reconstruct_graph_with_constraint`` selects the reversed
  edges serially in the host graph library (``native.constrained_reverse``)
  and ``reconstruct_anng_from_anng`` thins a graph to a pseudo-ANNG;
* ``adjust_paths`` — shortcut reduction (``adjustPathsEffectively``,
  :197-386): an edge u->w is a candidate when some neighbor v of u holds w
  with both legs shorter (d_uv < d_uw, d_vw < d_uw); ``_detect_shortcuts_all``
  marks every candidate, bit-packed along the w axis, and
  ``_adjust_phase2`` re-inserts edges rank by rank, dropping those whose
  two-hop detour survives under the R(C) visibility rule;
* ``refine_anng`` — re-search every object and merge the results as new
  out/in edges (:803-924).

Rows come from the device where a bulk build left them there
(``GraphStore.defer_rows``), else from one upload of the host arrays; the
rewritten graph is handed back as deferred device rows, so the host copy
materializes only when something reads it.  Every pair list is sorted on
int64 keys (row, distance bits, target), so the card and the CPU order
ties alike.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ngt_tpu_torch import native
from ngt_tpu_torch.graph.build import _Marks
from ngt_tpu_torch.graph.storage import GraphStore

INF = float("inf")

#: pair count from which ``_normalize_rows`` stores the distances that the
#: reference's device route stores (the symmetric lookup of ``dist_from``)
#: instead of the shortest of each duplicated pair (``ngt_tpu/graph/
#: reconstruct.py:43,112``); module-level so tests can lower it
DEV_PAIRS_MIN = 1 << 21

#: elements of one chunk's [rows, e, e] temporaries in shortcut detection
#: (about 2-3 GiB of working memory per chunk at this size)
CHUNK_ELEMS = 1 << 26

#: phase times of the last ``GraphOptimizer.execute`` or ``adjust_paths``
#: with NGT_TPU_BUILD_PROFILE=1: [(phase, seconds)], the tracer's
#: ``reconstruct.<phase>`` marks (``graph/build.py::_Marks``)
last_profile: list[tuple[str, float]] = []

_LOW32 = 0xFFFFFFFF


def _ceil8(x: int) -> int:
    return ((int(x) + 7) // 8) * 8


def _dist_key(d: torch.Tensor) -> torch.Tensor:
    """int64 keys in [0, 2^32) ordered as the finite float32 values ``d``
    are, with -0.0 equal to 0.0."""
    i = (d + 0.0).view(torch.int32).to(torch.int64)
    return torch.where(i < 0, ~i, i + (1 << 31))


def _rows_dev(graph: GraphStore, n: int, device: torch.device):
    """(ids [n, e_max] int32, dists f32, degrees int32) of rows [0, n) on
    ``device``: the bulk build's deferred device rows where they are still
    pending there (no download), else one upload of the host arrays."""
    dfr = graph._deferred
    device = torch.empty(0, device=device).device   # "cuda" -> "cuda:0"
    if dfr is not None and dfr[0].device == device and dfr[3] >= n:
        ids, dist, deg, _ = dfr
        return ids[:n].to(torch.int32), dist[:n], deg[:n].to(torch.int32)
    return (torch.from_numpy(graph.nbr_ids[:n]).to(device),
            torch.from_numpy(graph.nbr_dist[:n]).to(device),
            torch.from_numpy(graph.degree[:n]).to(device))


def _out_graph(graph: GraphStore, n: int, nbr, dist, deg) -> GraphStore:
    """A GraphStore holding the rewritten rows [0, n) as deferred device
    rows, with the input's node set and at least its capacity."""
    return GraphStore.from_device_rows(nbr, dist, deg, n, max(n, graph.capacity),
                                       graph._has_node[:n])


def _rows_to_lists(nbr, dist, deg):
    """(src int64, dst int32, dist) of every edge inside its row's degree,
    row-major."""
    col = torch.arange(nbr.shape[1], device=nbr.device)
    keep = col[None, :] < deg[:, None]
    src = keep.nonzero(as_tuple=True)[0]
    return src, nbr[keep], dist[keep]


def _edge_dist_lookup(nbr, dist, deg, q_nbr, q_deg):
    """dist[u, j] of the edge u -> q_nbr[u, j] in u's source row, else of
    the mirror edge q_nbr[u, j] -> u, else +inf, over the first q_deg[u]
    entries of each query row (the reference's native ``edge_dist_lookup``
    with ``symmetric=True``, ngt_tpu/native/src/ngt_tpu_native.cpp:592-644).
    Source keys (row << 32 | id) sorted once and searched."""
    n = nbr.shape[0]
    dev = nbr.device
    src, ids, ds = _rows_to_lists(nbr, dist, deg.clamp(max=nbr.shape[1]))
    ok = ids >= 0
    keys = (src[ok] << 32) | ids[ok].to(torch.int64)
    keys, order = torch.sort(keys, stable=True)
    vals = ds[ok][order]
    out = torch.full(q_nbr.shape, INF, dtype=torch.float32, device=dev)
    if keys.numel() == 0:
        return out
    u, j = (torch.arange(q_nbr.shape[1], device=dev)[None, :]
            < q_deg[:, None]).nonzero(as_tuple=True)
    t = q_nbr[u, j].to(torch.int64)

    def find(a, b):
        q = (a << 32) | (b & _LOW32)
        p = torch.searchsorted(keys, q).clamp_(max=keys.numel() - 1)
        return keys[p] == q, vals[p]

    hit1, v1 = find(u, t)
    hit2, v2 = find(t, u)
    hit2 &= (t >= 0) & (t < n)
    out[u, j] = torch.where(hit1, v1, torch.where(hit2, v2, torch.full_like(v1, INF)))
    return out


def _normalize_rows(pairs_src, pairs_dst, pairs_d, n: int, e_max: int,
                    dist_from=None):
    """Group (src -> dst, d) pairs into sorted, deduplicated fixed-width rows
    (reference GraphReconstructor.h:516-553; ngt_tpu/graph/reconstruct.py:
    96-190): invalid pairs (negative ids, non-finite d) dropped, each
    (src, dst) kept once at its shortest d, each row ranked by (d, dst) and
    cut at ``e_max``.  Returns (nbr [n, e_max] int32, dist f32, deg int32)
    on the pairs' device.

    The stored distance follows the reference's route: from
    ``DEV_PAIRS_MIN`` pairs on, with ``dist_from`` = (nbr, dist, deg) of the
    source graph, each edge stores what ``_edge_dist_lookup`` finds there
    (the forward edge if its row holds it, else the mirror edge); otherwise
    the shortest d of its pair.  Ids and ranks agree on both routes."""
    dev = pairs_src.device
    big = pairs_src.numel() >= DEV_PAIRS_MIN
    s = pairs_src.to(torch.int64)
    t = pairs_dst.to(torch.int64)
    d = pairs_d.to(torch.float32)
    ok = (t >= 0) & (s >= 0) & torch.isfinite(d)
    s, t, d = s[ok], t[ok], d[ok]
    # order by (src, d, dst): a stable sort by dst, then by (src, d)
    o = torch.sort(t, stable=True)[1]
    o = o[torch.sort((s[o] << 32) | _dist_key(d[o]), stable=True)[1]]
    s, t, d = s[o], t[o], d[o]
    # dedupe (src, dst): the first of each run in that order is the shortest
    o = torch.sort((s << 32) | t, stable=True)[1]
    ks = ((s << 32) | t)[o]
    first = torch.ones_like(ks, dtype=torch.bool)
    first[1:] = ks[1:] != ks[:-1]
    keep = torch.zeros_like(first)
    keep[o] = first
    s, t, d = s[keep], t[keep], d[keep]   # still in (src, d, dst) order
    counts = torch.bincount(s, minlength=n)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(s.numel(), device=dev) - starts[s]
    sel = rank < e_max
    flat = s[sel] * e_max + rank[sel]
    nbr = torch.full((n, e_max), -1, dtype=torch.int32, device=dev)
    dist = torch.full((n, e_max), INF, dtype=torch.float32, device=dev)
    nbr.view(-1)[flat] = t[sel].to(torch.int32)
    dist.view(-1)[flat] = d[sel]
    deg = (nbr >= 0).sum(1, dtype=torch.int32)
    if big and dist_from is not None:
        dist = _edge_dist_lookup(*dist_from, nbr, deg)
    return nbr, dist, deg


def convert_to_anng(graph: GraphStore, n: int, e_max: int | None = None,
                    device="cuda") -> GraphStore:
    """KNNG -> ANNG: add all reverse edges (reference :389-423)."""
    dev = torch.device(device)
    e_max = e_max or graph.e_max
    nbr, dist, deg = _rows_dev(graph, n, dev)
    src, dst, d = _rows_to_lists(nbr, dist, deg)
    dst = dst.to(torch.int64)
    rows = _normalize_rows(torch.cat([src, dst]), torch.cat([dst, src]),
                           torch.cat([d, d]), n, e_max, dist_from=(nbr, dist, deg))
    return _out_graph(graph, n, *rows)


def reconstruct_anng_from_anng(graph: GraphStore, n: int, edge_size: int,
                               e_max: int | None = None, device="cuda") -> GraphStore:
    """Thin an ANNG: per node keep the first ``edge_size`` edges whose
    target id is smaller than the node id, added in both directions, then
    sort and dedupe (reconstructANNGFromANNG, GraphReconstructor.h:717-801)."""
    dev = torch.device(device)
    e_max = e_max or graph.e_max
    nbr, dist, deg = _rows_dev(graph, n, dev)
    rowid = torch.arange(n, device=dev)[:, None]
    ok = (nbr >= 0) & (nbr < rowid)
    keep = ok & (torch.cumsum(ok, 1) - 1 < edge_size)
    src = keep.nonzero(as_tuple=True)[0]
    dst = nbr[keep].to(torch.int64)
    dd = dist[keep]
    rows = _normalize_rows(torch.cat([src, dst]), torch.cat([dst, src]),
                           torch.cat([dd, dd]), n, e_max, dist_from=(nbr, dist, deg))
    return _out_graph(graph, n, *rows)


def reconstruct_graph(graph: GraphStore, n: int, out_edges: int, in_edges: int,
                      e_max: int | None = None, device="cuda") -> GraphStore:
    """ONNG degree adjustment (reference reconstructGraph, :425-561): each
    row keeps its best ``out_edges`` edges (all, if it has fewer) and gains
    the reverses of the first ``in_edges`` original edges of every row;
    ``e_max`` defaults to out_edges + in_edges rounded up to 8."""
    dev = torch.device(device)
    if e_max is None:
        e_max = _ceil8(out_edges + in_edges)
    nbr, dist, deg = _rows_dev(graph, n, dev)
    col = torch.arange(nbr.shape[1], device=dev)[None, :]
    fw = col < deg.clamp(max=out_edges)[:, None]
    rv = col < deg.clamp(max=in_edges)[:, None]
    src_f = fw.nonzero(as_tuple=True)[0]
    dst_r = rv.nonzero(as_tuple=True)[0]
    rows = _normalize_rows(
        torch.cat([src_f, nbr[rv].to(torch.int64)]),
        torch.cat([nbr[fw].to(torch.int64), dst_r]),
        torch.cat([dist[fw], dist[rv]]), n, e_max, dist_from=(nbr, dist, deg),
    )
    return _out_graph(graph, n, *rows)


def reconstruct_graph_with_constraint(graph: GraphStore, n: int, out_edges: int,
                                      in_edges: int, mode: str = "a",
                                      e_max: int | None = None,
                                      device="cuda") -> GraphStore:
    """Indegree-balanced ONNG variant (reconstructGraphWithConstraint,
    GraphReconstructor.h:565-715): the reversed edges are selected serially
    in the host graph library (``native.constrained_reverse``); forward
    edges then fill each row up to ``out_edges`` (mode 'a'), or the first
    ``out_edges`` originals are always added (mode 'c'); rows are sorted and
    deduplicated on the device."""
    dev = torch.device(device)
    if e_max is None:
        e_max = _ceil8(out_edges + in_edges)
    nbr, dist, deg = _rows_dev(graph, n, dev)
    rid, src, rd = native.constrained_reverse(
        graph.nbr_ids[:n], graph.nbr_dist[:n], graph.degree[:n], out_edges, in_edges)
    rid = torch.from_numpy(rid.astype(np.int64)).to(dev)
    if mode == "a":
        room = (out_edges - torch.bincount(rid, minlength=n)).clamp(min=0)
        lim = torch.minimum(deg.to(torch.int64), room)
    else:
        lim = deg.clamp(max=out_edges)
    fw = torch.arange(nbr.shape[1], device=dev)[None, :] < lim[:, None]
    rows = _normalize_rows(
        torch.cat([rid, fw.nonzero(as_tuple=True)[0]]),
        torch.cat([torch.from_numpy(src.astype(np.int64)).to(dev),
                   nbr[fw].to(torch.int64)]),
        torch.cat([torch.from_numpy(rd).to(dev), dist[fw]]), n, e_max,
        dist_from=(nbr, dist, deg),
    )
    return _out_graph(graph, n, *rows)


# --------------------------------------------------------------------------
# shortcut reduction (path adjustment)
# --------------------------------------------------------------------------


def _id_sorted_rows(nbr_e, dist_e):
    """Each row sorted by (id, dist) with the padding (-1) last as
    int32 max: (ids int32 [n, e], dists f32, original ranks int64)."""
    ids = torch.where(nbr_e >= 0, nbr_e, torch.iinfo(torch.int32).max)
    o = torch.sort(dist_e, dim=1, stable=True)[1]
    o = o.gather(1, torch.sort(ids.gather(1, o), dim=1, stable=True)[1])
    return ids.gather(1, o), dist_e.gather(1, o), o


def _shortcut_hits(nbr_blk, dist_blk, sid, sdist, e: int):
    """For a block of rows u: hit[u, v_rank, w_rank] where u's rank-w edge
    has a two-hop path u->v->w through its rank-v edge with d_uv < d_uw and
    d_vw < d_uw, v != w (reference ``_shortcut_hits``, reconstruct.py:
    336-358).  ``sid``/``sdist`` are every row's first e entries sorted by
    (id, dist) (``_id_sorted_rows``): w is looked up in v's row by binary
    search, and the shortest of duplicated ids is the one compared, as the
    reference's any-over-positions does.  Returns [blk, e, e] bool."""
    b = nbr_blk.shape[0]
    v = nbr_blk[:, :e]
    safe_v = v.clamp(0, sid.shape[0] - 1).to(torch.int64)
    rows_i, rows_d = sid[safe_v], sdist[safe_v]                       # [b, e, e]
    wq = v[:, None, :].expand(b, e, e).contiguous()                   # w per (u, v)
    p = torch.searchsorted(rows_i, wq).clamp_(max=e - 1)
    found = rows_i.gather(2, p) == wq
    d_uw = dist_blk[:, None, :e]
    hit = found & (rows_d.gather(2, p) < d_uw)
    hit &= dist_blk[:, :e, None] < d_uw
    hit &= v[:, :, None] != v[:, None, :]
    return hit


def _detect_shortcuts_all(nbr, dist, *, e: int, eb: int | None = None) -> torch.Tensor:
    """Whole-graph shortcut detection in row chunks of at most CHUNK_ELEMS
    [rows, e, e] elements, each chunk's hits bit-packed along the w axis
    (np.packbits layout: big-endian per byte).  ``eb`` (a multiple of 8,
    >= e) pads the packed w axis.  Returns [eb // 8, n, e] uint8: byte
    column k (the reference's k-th array, reconstruct.py:361-398) holds w
    ranks 8k..8k+7."""
    n = nbr.shape[0]
    eb = _ceil8(e) if eb is None else eb
    sid, sdist, _ = _id_sorted_rows(nbr[:, :e], dist[:, :e])
    cand = torch.empty((eb // 8, n, e), dtype=torch.uint8, device=nbr.device)
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=nbr.device)
    step = max(1, CHUNK_ELEMS // (e * e))
    for s in range(0, n, step):
        hit = _shortcut_hits(nbr[s : s + step], dist[s : s + step], sid, sdist, e)
        hit = torch.nn.functional.pad(hit, (0, eb - e)).view(hit.shape[0], e, eb // 8, 8)
        packed = (hit.to(torch.uint8) << shifts).sum(3, dtype=torch.uint8)
        cand[:, s : s + step] = packed.permute(2, 0, 1)
    return cand


def _adjust_phase2(nbr_e, deg, cand, *, e: int, min_edges: int, snap: int) -> torch.Tensor:
    """Rank-ordered re-insertion, phase 2 of path adjustment, under the
    R(C) visibility rule with C = ``snap`` (the reference's native
    ``adjust_paths_phase2`` and device ``_adjust_phase2_chunk``,
    reconstruct.py:401-497): edges of rank r are decided for all rows at
    once; u's rank-r edge to w drops when some kept earlier edge u->v is a
    candidate detour and v's edge to w is visible: the snapshot taken at
    the window start [r0, r0+C) for v-ranks below r0, presence for ranks in
    [r0, r), never for ranks >= r; and only while more than ``min_edges``
    edges could remain.  At C = 1 the window is empty and the rule is the
    rank-synchronous one.  Within a window the rows are independent, so
    each rank is one pass over all rows; v's edge to w is found by binary
    search of (v << 32 | w) in every row's (row << 32 | id) keys, sorted
    once.  Returns kept [n, e] bool; ``_adjust_phase2.lookups`` counts the
    searches of the last call."""
    n = nbr_e.shape[0]
    dev = nbr_e.device
    sid, _, srank = _id_sorted_rows(nbr_e, torch.zeros(nbr_e.shape, device=dev))
    keys = ((torch.arange(n, device=dev, dtype=torch.int64)[:, None] << 32)
            | sid.to(torch.int64)).view(-1)
    srank = srank.view(-1)
    kept = torch.zeros((n, e), dtype=torch.bool, device=dev)
    cnt = torch.zeros(n, dtype=torch.int32, device=dev)
    snapshot, r0 = kept, 0
    _adjust_phase2.lookups = 0
    for r in range(e):
        if r % snap == 0:
            r0 = r
            snapshot = kept if snap == 1 else kept.clone()
        has_edge = r < deg
        can_drop = cnt + (deg - r) > min_edges
        bit = ((cand[r >> 3] >> (7 - (r & 7))) & 1).bool()
        act = bit & kept & (has_edge & can_drop)[:, None]
        us, vr = act.nonzero(as_tuple=True)
        drop = torch.zeros(n, dtype=torch.bool, device=dev)
        _adjust_phase2.lookups += us.numel()
        if us.numel():
            v = nbr_e[us, vr].to(torch.int64)
            q = (v << 32) | nbr_e[us, r].to(torch.int64)
            p = torch.searchsorted(keys, q).clamp_(max=keys.numel() - 1)
            pos = srank[p]
            vis = torch.where(pos < r0, snapshot.view(-1)[v.clamp(max=n - 1) * e + pos],
                              pos < r)
            drop[us[(keys[p] == q) & vis & (v < n)]] = True
        keep_now = has_edge & ~drop
        kept[:, r] = keep_now
        cnt += keep_now.to(torch.int32)
    return kept


_adjust_phase2.lookups = 0


def _kept_to_rows(nbr_e, dist_e, kept, e_max: int):
    """Compact the kept edges into fixed-width rows in rank order (rows are
    distance-ascending and duplicate-free, so this is what a re-sort would
    give; reference ``_kept_to_rows_dev``, reconstruct.py:500-519, with
    each edge's own distance, which its native ``edge_dist_lookup`` finds
    in the same row)."""
    n = nbr_e.shape[0]
    valid = kept & (nbr_e >= 0)
    rank = torch.cumsum(valid, 1) - 1
    u, j = valid.nonzero(as_tuple=True)
    nbr = torch.full((n, e_max), -1, dtype=torch.int32, device=nbr_e.device)
    dist = torch.full((n, e_max), INF, dtype=torch.float32, device=nbr_e.device)
    nbr[u, rank[u, j]] = nbr_e[u, j]
    dist[u, rank[u, j]] = dist_e[u, j]
    return nbr, dist, valid.sum(1, dtype=torch.int32)


def _adjust_rule(n: int, e: int, snap: int | None, block: int = 512):
    """(use_dev, C): the reference's choice of phase-2 rule
    (reconstruct.py:560-577).  Its device rule is taken when
    NGT_TPU_ADJUST_DEVICE is not "0" and n*e >= NGT_TPU_ADJUST_DEVICE_MIN
    (2^22); C is then NGT_TPU_ADJUST_SNAP (8; 0 = one full-width window)
    rounded up to a multiple of 8 and capped so that one window's
    [n_est, e, C/8] candidate slice stays under 2^31 elements.  Otherwise
    the host rule, C = ``snap`` or 1."""
    env = os.environ
    use_dev = env.get("NGT_TPU_ADJUST_DEVICE", "1") != "0"
    use_dev = use_dev and n * e >= int(env.get("NGT_TPU_ADJUST_DEVICE_MIN", str(1 << 22)))
    if snap is None:
        snap = int(env.get("NGT_TPU_ADJUST_SNAP", "8")) if use_dev else 1
    if snap <= 0 or snap > e:
        snap = e
    if not use_dev:
        return False, snap
    n_est = ((n + block - 1) // block) * block + block
    k_max = max(1, (1 << 31) // max(n_est * e, 1) - 1)
    return True, max(8, min(_ceil8(snap), 8 * k_max))


def adjust_paths(graph: GraphStore, n: int, min_edges: int = 0, block: int = 512,
                 snap: int | None = None, device="cuda", marks=None) -> GraphStore:
    """Shortcut reduction (reference adjustPathsEffectively, :197-386;
    ngt_tpu/graph/reconstruct.py:522-717).  Both phases run on ``device``.
    The visibility rule R(C) and the row rule are the reference's
    (``_adjust_rule``): under its device rule the kept edges are compacted
    in rank order, under its host rule they are re-sorted through
    ``_normalize_rows``.  ``block`` enters only the window cap, as the
    reference's tile size does.  A failure propagates: nothing is replayed
    on the host.  ``marks``: the caller's phase marks (GraphOptimizer's),
    else its own into ``last_profile``."""
    dev = torch.device(device)
    own = marks is None
    marks = marks or _Marks(dev, last_profile, "reconstruct.")
    nbr, dist, deg = _rows_dev(graph, n, dev)
    e = int(deg.max()) if n else 0
    if e == 0:
        return graph
    use_dev, c = _adjust_rule(n, e, snap, block)
    cand = _detect_shortcuts_all(nbr, dist, e=e)
    marks("detect")
    kept = _adjust_phase2(nbr[:, :e], deg, cand, e=e, min_edges=min_edges, snap=c)
    del cand
    marks("phase2")
    if use_dev:
        rows = _kept_to_rows(nbr[:, :e], dist[:, :e], kept, graph.e_max)
    else:
        src, col = kept.nonzero(as_tuple=True)
        rows = _normalize_rows(src, nbr[src, col], dist[src, col], n, graph.e_max,
                               dist_from=(nbr, dist, deg))
    out = _out_graph(graph, n, *rows)
    marks("rows")
    if own:
        marks.finish()
    return out


def refine_anng(index, epsilon: float = 0.1, num_edges: int = 0) -> None:
    """Re-search every object and rebuild its neighborhood (reference
    refineANNG, GraphReconstructor.h:803-924): each live row's
    ``num_edges`` (edge_size_for_creation) nearest results other than
    itself become its out-edges and their reverses in-edges, normalized on
    the index's device into the index's graph."""
    store, graph = index.store, index.graph
    n = store.repository_size
    live = np.nonzero(store._valid[:n])[0].astype(np.int32)
    k = num_edges if num_edges > 0 else index.prop.edge_size_for_creation
    batch = index.prop.device_batch_size
    index._ensure_mirror()
    new_i = np.full((n, k), -1, np.int32)
    new_d = np.full((n, k), np.inf, np.float32)
    cols = np.arange(k)[None, :]
    for s in range(0, len(live), batch):
        chunk = live[s : s + batch]
        ids, dists = index.batch_search(store._x[chunk][:, : store.dimension],
                                        size=k + 1, epsilon=epsilon)
        ids = np.where(ids >= 0, ids + (1 if index.zero_based else 0), -1)
        # the object itself comes back first: move the others to the front
        keep = (ids != chunk[:, None]) & (ids >= 0)
        order = np.argsort(~keep, axis=1, kind="stable")[:, :k]
        cnt = keep.sum(axis=1, keepdims=True)
        new_i[chunk] = np.where(cols < cnt, np.take_along_axis(ids, order, axis=1), -1)
        new_d[chunk] = np.where(cols < cnt, np.take_along_axis(dists, order, axis=1), np.inf)
    dev = index.device
    src, col = np.nonzero(new_i >= 0)
    ps = torch.from_numpy(src.astype(np.int64)).to(dev)
    pt = torch.from_numpy(new_i[src, col].astype(np.int64)).to(dev)
    pd = torch.from_numpy(new_d[src, col]).to(dev)
    nbr, dist, deg = _normalize_rows(torch.cat([ps, pt]), torch.cat([pt, ps]),
                                     torch.cat([pd, pd]), n, graph.e_max)
    graph.ensure_capacity(n)
    graph.nbr_ids[:n] = nbr.cpu().numpy()
    graph.nbr_dist[:n] = dist.cpu().numpy()
    graph.degree[:n] = deg.cpu().numpy()
    graph._has_node[:n] = store._valid[:n]
    index.replace_graph(graph)
