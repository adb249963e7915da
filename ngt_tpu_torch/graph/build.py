"""Bulk graph construction (the port's counterpart of the bulk half of
``ngt_tpu/graph/build.py``).

A fresh index is built from EXACT k-NN edges plus reverse edges: one bulk
k-NN scan, every adjacency row assembled in one device sort-and-scatter,
connected components by device min-label propagation, and bridges from
each secondary component to its nearest representative in another
component.
An exact k-NN graph with reverse edges is the ideal the reference's
refineANNG approaches (GraphReconstructor.h:803-924).

The scan: L2 and the normalized and angular metrics take the bf16 scan
with an exact re-rank (``ops/bruteforce.fast_knn_l2_bulk``; at >= 2^19
rows on a CUDA device its candidate scan is the hand kernel of
``ops/window_scan.py``).  Plain Cosine and Angle scan a row-normalized
copy, where both are monotone in L2, and convert the distances exactly
(cosine = d^2/2, angle = acos(1 - d^2/2)).  Every other metric takes the
exact ``linear_search`` in chunks of 4,096 queries.

Appends: one of at least ``bulk_append_threshold`` rows takes the bulk
route too (``build_bulk``): the same scan over the new rows, applied on the
host in two phases (every new row, then every reverse edge), connected with
the host union-find labels (``native.connected_components``).  Smaller
appends, and every build with ``build_algorithm="anng"``, take the
incremental ANNG build (``build_anng``): batches of ``device_batch_size``
new rows search the current graph (``graph_search``), merge the intra-batch
pairwise candidates, and update the host graph and the device mirror's
changed rows (``DeviceMirror.update_rows``).  Removal (``remove_object``,
``batch_remove_objects``) tombstones, unlinks, and relinks each removed
node's surviving former neighbors to their nearest former co-neighbor.
"""

from __future__ import annotations

import math
import os
import sys
import time

import numpy as np
import torch

from ngt_tpu_torch import native, trace
from ngt_tpu_torch.graph.search import graph_search, wrap_hash_bits
from ngt_tpu_torch.graph.storage import GraphStore
from ngt_tpu_torch.ops import bruteforce as BF
from ngt_tpu_torch.ops import distances as D
from ngt_tpu_torch.ops import window_scan as WS
from ngt_tpu_torch.properties import DistanceType, GraphType, Property
from ngt_tpu_torch.ops.select import topk_lex
from ngt_tpu_torch.seeds import Seeder, default_reps, top_seeds
from ngt_tpu_torch.store import SQNORM_METRICS, VectorStore
from ngt_tpu_torch.utils import narrow_host

INF = float("inf")

#: corpus rows (store capacity) from which the build's candidate scan takes
#: the window route: it keeps ONE candidate per 128-row window, so its
#: expected edge loss is C(k+1,2)*128/n per row — negligible at >= 2^19
#: rows, structurally wrong for small corpora
WINDOW_SCAN_MIN_ROWS = 1 << 19


#: phase times of the last ``build_bulk`` run with NGT_TPU_BUILD_PROFILE=1
#: (the reference's switch): [(phase, seconds)], in order
last_profile: list[tuple[str, float]] = []


class _Marks:
    """``mark(label)`` closes a phase when the tracer's build family is on
    (NGT_TPU_BUILD_PROFILE=1, the reference's switch): the tracer's record
    ``<prefix><label>`` spans from the previous mark (or the marks' start)
    to now, on a card the device timeline between two events.  ``profile``
    (``last_profile`` unless given) is emptied at the start; ``finish``
    waits for the last mark and writes every phase's seconds to it, in
    order.  A no-op with the family off."""

    def __init__(self, dev: torch.device, profile: list | None = None,
                 prefix: str = "build."):
        self.on = trace.on(trace.BUILD)
        self.dev, self.prefix = dev, prefix
        self.profile = last_profile if profile is None else profile
        if self.on:
            self.profile.clear()
            self.recs = []
            self.last = trace.stamp(dev)

    def __call__(self, label: str) -> None:
        if self.on:
            rec, self.last = trace.interval(self.prefix + label, self.last, self.dev)
            self.recs.append(rec)

    def finish(self, line: str = "") -> None:
        """Fills ``profile``; ``line`` names the phases' line on standard
        error (``# <line> profile: ...``)."""
        if not self.on:
            return
        trace.resolve()
        self.profile[:] = [(r.name[len(self.prefix):], r.value) for r in self.recs]
        if line:
            print(f"# {line} profile: " + " ".join(
                f"{label}={sec:.2f}s" for label, sec in self.profile), file=sys.stderr)


#: metrics whose scaled-L2 ranking over the stored vectors is monotone with
#: the metric (normalized metrics store unit vectors: L2^2 = 2 - 2cos; the
#: plain angular ones qualify because the sq8 codes are built from
#: row-normalized vectors); the quantized-graph route serves only these
_SQ8_METRICS = (
    DistanceType.L2,
    DistanceType.NORMALIZED_L2,
    DistanceType.NORMALIZED_COSINE,
    DistanceType.NORMALIZED_ANGLE,
    DistanceType.COSINE,
    DistanceType.ANGLE,
)


def _narrow_enabled() -> bool:
    """The reference's NGT_TPU_MIRROR_NARROW switch: "0" keeps the search
    mirror in f32."""
    return os.environ.get("NGT_TPU_MIRROR_NARROW", "1") != "0"


def _upload(xh: np.ndarray, dev: torch.device, narrow: bool) -> torch.Tensor:
    """A device copy of the object matrix, in the narrowest lossless dtype
    when ``narrow`` (u8 for an integral corpus: 4x less memory and gather
    traffic per hop; every distance casts to f32, so results are equal)."""
    return torch.from_numpy(narrow_host(xh) if narrow else xh).to(dev, copy=True)


def _widen(x_narrow: torch.Tensor, xh: np.ndarray) -> torch.Tensor:
    """The f32 working copy of a narrow upload of a float store; the rows
    of a uint8 or sparse store keep their dtype (xor, popcount and id
    lookups need integers)."""
    if xh.dtype == np.float32 and x_narrow.dtype != torch.float32:
        return x_narrow.to(torch.float32)
    return x_narrow


#: plain and normalized angular metrics: the scan runs on unit rows
_ANGULAR_SCAN = (
    DistanceType.COSINE, DistanceType.ANGLE,
    DistanceType.NORMALIZED_COSINE, DistanceType.NORMALIZED_ANGLE,
)
#: metrics the bf16 scan serves: L2 ranking equals the metric's ranking
_FAST_SCAN = (DistanceType.L2, DistanceType.NORMALIZED_L2) + _ANGULAR_SCAN
#: queries per linear_search chunk of the other metrics' build scan
LINEAR_QBLOCK = 4096


def _l2_to_metric(d: torch.Tensor, metric) -> torch.Tensor:
    """Unit-row L2 distances to the angular metric (exact); others as is."""
    if metric in (DistanceType.COSINE, DistanceType.NORMALIZED_COSINE):
        return 0.5 * d * d
    if metric in (DistanceType.ANGLE, DistanceType.NORMALIZED_ANGLE):
        return torch.acos(torch.clamp(1.0 - 0.5 * d * d, -1.0, 1.0))
    return d


class DeviceMirror:
    """Device copies of the object matrix and adjacency that the search
    reads (x [cap, d_pad] in the narrowest lossless dtype, valid [cap]
    bool, nbr [cap, e_max] int32, and sqnorm [cap] f32 for the metrics
    that read the row norms, else None)."""

    #: process-wide: a replaced mirror never repeats a version that an old
    #: mirror handed out
    _version_seed = 0

    def __init__(self, store: VectorStore, graph: GraphStore):
        self.store = store
        self.graph = graph
        self.x = self.valid = self.nbr = self.sqnorm = None
        self.capacity = 0
        #: bumped on every array replacement; derived caches (the quantized
        #: graph's neighbor blocks) key on it, not on id(self.nbr), which
        #: CPython may reuse once the old tensor is freed
        DeviceMirror._version_seed += 1_000_000
        self.version = DeviceMirror._version_seed

    def _wants_sqnorm(self) -> bool:
        return self.store.metric in SQNORM_METRICS

    def _search_valid(self, idx: np.ndarray | None = None) -> np.ndarray:
        # a search may only return indexed objects: live AND graph node
        cap = self.store._x.shape[0]
        v = self.store._valid[:cap] & self.graph._has_node[:cap]
        return v if idx is None else v[idx]

    def drop(self) -> None:
        """Forget the device arrays (stale once the graph changes)."""
        self.x = self.valid = self.nbr = self.sqnorm = None
        self.capacity = 0
        self.version += 1

    def sync_full(self) -> None:
        cap = self.store._x.shape[0]
        dev = self.store.device
        self.graph.ensure_capacity(cap)
        self.x = _upload(self.store._x, dev, _narrow_enabled())
        self.valid = torch.from_numpy(self._search_valid()).to(dev)
        self.nbr = torch.from_numpy(self.graph.nbr_ids[:cap]).to(dev, copy=True)
        self.sqnorm = D.sq_norms(self.x) if self._wants_sqnorm() else None
        self.capacity = cap
        self.version += 1

    def adopt(self, x: torch.Tensor, nbr: torch.Tensor, sqnorm: torch.Tensor | None,
              x_narrow: torch.Tensor | None = None) -> None:
        """Take the bulk build's device-resident arrays instead of
        uploading them again; the build's narrow copy ``x_narrow`` when it
        kept one, else its working copy ``x``."""
        self.graph.ensure_capacity(self.store._x.shape[0])
        self.x = x_narrow if x_narrow is not None and _narrow_enabled() else x
        self.nbr = nbr
        self.sqnorm = sqnorm if self._wants_sqnorm() else None
        self.valid = torch.from_numpy(self._search_valid()).to(self.store.device)
        self.capacity = self.store._x.shape[0]
        self.version += 1

    def update_rows(self, obj_ids: np.ndarray | None, nbr_ids: np.ndarray | None) -> None:
        """Scatter changed rows into the resident tensors: the object rows,
        valid bits and squared norms of ``obj_ids`` and the adjacency rows
        of ``nbr_ids`` (``obj_ids`` when None or empty), by int64 index.  A
        float row the narrow mirror cannot hold exactly widens the mirror to
        f32 once; a changed capacity (or a dropped mirror) re-uploads
        everything (ngt_tpu/graph/build.py:285-324)."""
        if self.x is None or self.capacity != self.store._x.shape[0]:
            self.sync_full()
            return
        dev = self.x.device
        has_obj = obj_ids is not None and len(obj_ids) > 0
        if nbr_ids is None or len(nbr_ids) == 0:
            if not has_obj:
                return
            nbr_ids = obj_ids
        if has_obj:
            oid = np.asarray(obj_ids, np.int64)
            rows = self.store._x[oid]
            oi = torch.from_numpy(oid).to(dev)
            if self.sqnorm is not None:
                sq = (rows.astype(np.float32) ** 2).sum(-1)
                self.sqnorm.index_copy_(0, oi, torch.from_numpy(sq).to(dev))
            if self.x.dtype != torch.float32 and rows.dtype == np.float32:
                with np.errstate(invalid="ignore", over="ignore"):
                    cast = rows.astype(_NUMPY_DTYPE[self.x.dtype])
                if np.array_equal(cast.astype(np.float32), rows):
                    rows = cast
                else:
                    self.x = self.x.to(torch.float32)
            self.x.index_copy_(0, oi, torch.from_numpy(rows).to(dev, self.x.dtype))
            self.valid.index_copy_(0, oi, torch.from_numpy(self._search_valid(oid)).to(dev))
        nid = np.asarray(nbr_ids, np.int64)
        self.nbr.index_copy_(0, torch.from_numpy(nid).to(dev),
                             torch.from_numpy(self.graph.nbr_ids[nid]).to(dev))
        self.version += 1


#: numpy dtype of each narrow mirror dtype (``utils.narrow_host``)
_NUMPY_DTYPE = {torch.uint8: np.uint8, torch.int16: np.int16, torch.float16: np.float16}


def _dist_bits(d: torch.Tensor) -> torch.Tensor:
    """Order-preserving int64 of non-negative f32 (+inf included)."""
    return d.contiguous().view(torch.int32).to(torch.int64)


def _bulk_graph_rows(src_ids, f_ids, f_d, *, e_max: int, cap: int, reverse: bool):
    """All adjacency rows from the bulk scan's forward edges: forward ∪
    reversed edge triples, dedupe on (row, target), rank within each row by
    (dist, target), scatter into fixed-width rows.  Returns
    (nbr [cap, e_max] int32, nbr_dist [cap, e_max] f32, degree [cap] int32).

    ``torch.sort`` takes one key, so the reference's three-key sort
    becomes a stable sort on dist followed by a stable sort on the packed
    (row, target) key, and its (row, dist) sort a stable sort on the
    packed (row, dist bits) key."""
    npq, kk = f_ids.shape
    src = src_ids.to(torch.int64)[:, None].expand(npq, kk)
    f = f_ids.to(torch.int64)
    ok = (f >= 0) & (f != src)
    d = torch.where(ok, f_d.to(torch.float32), INF)
    t = torch.where(ok, f, -1)
    if reverse:
        s = torch.cat([src.reshape(-1), t.reshape(-1)])
        tt = torch.cat([t.reshape(-1), src.reshape(-1)])
        dd = torch.cat([d.reshape(-1), d.reshape(-1)])
    else:
        s, tt, dd = src.reshape(-1), t.reshape(-1), d.reshape(-1)
    s = torch.where((tt < 0) | (s < 0) | torch.isinf(dd), cap, s)
    # dedupe (row, target), keeping the smallest distance
    o = torch.sort(dd, stable=True).indices
    s, tt, dd = s[o], tt[o], dd[o]
    o = torch.sort(s * (cap + 2) + (tt + 1), stable=True).indices
    s1, t1, d1 = s[o], tt[o], dd[o]
    same = torch.zeros_like(s1, dtype=torch.bool)
    same[1:] = (s1[1:] == s1[:-1]) & (t1[1:] == t1[:-1])
    d1 = torch.where(same, INF, d1)
    s1 = torch.where(same, cap, s1)
    # rank within row by (dist, target)
    o = torch.sort((s1 << 32) | _dist_bits(d1), stable=True).indices
    s2, d2, t2 = s1[o], d1[o], t1[o]
    idxv = torch.arange(s2.shape[0], device=s2.device)
    is_start = torch.ones_like(s2, dtype=torch.bool)
    is_start[1:] = s2[1:] != s2[:-1]
    rank = idxv - torch.cummax(torch.where(is_start, idxv, 0), 0).values
    keep = (rank < e_max) & (s2 < cap) & torch.isfinite(d2)
    row = torch.where(keep, s2, cap)
    col = torch.where(keep, rank, 0)
    nbr = torch.full((cap + 1, e_max), -1, dtype=torch.int32, device=s2.device)
    nbrd = torch.full((cap + 1, e_max), INF, dtype=torch.float32, device=s2.device)
    # masked entries all write the constant (-1, inf) at the pad row
    nbr[row, col] = torch.where(keep, t2, -1).to(torch.int32)
    nbrd[row, col] = torch.where(keep, d2, INF)
    nbr, nbrd = nbr[:cap], nbrd[:cap]
    return nbr, nbrd, (nbr >= 0).sum(1, dtype=torch.int32)


def _cc_labels_device(nbr: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Connected-component labels: the minimum node id of each component
    for valid nodes, ``len(nbr)`` for the rest.  Min-label propagation: pull
    the neighbors' minimum and follow label chains to a fixpoint, then one
    push round (scatter-min along the edges) checks convergence of the
    symmetric operator; a changed push re-enters the pull.  Labels only
    decrease, so every loop ends."""
    n = nbr.shape[0]
    safe = nbr.to(torch.int64).clamp(0, n - 1)
    edge_ok = nbr >= 0

    def jump(l):
        while True:
            l2 = torch.where(l < n, torch.minimum(l, l[l.clamp(0, n - 1)]), n)
            if torch.equal(l2, l):
                return l
            l = l2

    labels = torch.where(valid, torch.arange(n, device=nbr.device), n)
    while True:
        while True:
            pulled = torch.where(edge_ok, labels[safe], n).amin(1)
            new = torch.where(valid, jump(torch.minimum(labels, pulled)), n)
            if torch.equal(new, labels):
                break
            labels = new
        push = torch.where(edge_ok, labels[:, None], n)
        new = labels.scatter_reduce(0, safe.reshape(-1), push.reshape(-1), "amin")
        new = torch.where(valid, jump(new), n)
        if torch.equal(new, labels):
            return labels
        labels = new


def _bridge_deferred(graph: GraphStore, piv, tgt, td) -> torch.Tensor:
    """Apply bidirectional bridge edges to adjacency that still lives on the
    device (``GraphStore.defer_rows``): pull the touched rows, merge them on
    the host through the host graph library's ``merge_edges`` (sorted
    bounded insert, duplicates skipped; Graph.h:888-934), write them back
    IN PLACE into the deferred tensors (the build owns them)."""
    dev_i, dev_d, dev_g, _ = graph._deferred
    targets = np.concatenate([piv, tgt]).astype(np.int64)
    uniq = np.unique(targets)
    idx = torch.from_numpy(uniq).to(dev_i.device)
    rows_i = np.ascontiguousarray(dev_i[idx].cpu().numpy(), np.int32)
    rows_d = np.ascontiguousarray(dev_d[idx].cpu().numpy(), np.float32)
    deg = np.ascontiguousarray(dev_g[idx].cpu().numpy(), np.int32)
    native.merge_edges(
        rows_i, rows_d, deg, np.ones(len(uniq), np.uint8),
        np.searchsorted(uniq, targets), np.concatenate([tgt, piv]), np.concatenate([td, td]),
    )
    dev_i[idx] = torch.from_numpy(rows_i).to(dev_i.device)
    dev_d[idx] = torch.from_numpy(rows_d).to(dev_i.device)
    dev_g[idx] = torch.from_numpy(deg).to(dev_i.device, dev_g.dtype)
    return dev_i


def ensure_connected(
    store: VectorStore,
    graph: GraphStore,
    seeder: Seeder,
    metric,
    max_passes: int = 4,
    nbr_dev: torch.Tensor | None = None,
    first_labels: np.ndarray | None = None,
) -> tuple[int, torch.Tensor | None]:
    """Link disconnected components into the main graph.

    Labels come from ``first_labels`` when given (the fresh bulk build's
    device min-label propagation), else from the host graph library's
    union-find over the host adjacency (root ids, as the reference's, so a
    tie in component size picks the same main component).  Each pass takes
    one pivot per
    secondary component (its lowest node id) and links it both ways to its
    nearest representative in another component; the bridged labels are
    then merged in place (the bridges are the only new edges).  The main
    component is the largest, ties going to the lowest label as
    ``np.bincount(...).argmax()`` gives.  Returns the final component count
    and the (bridge-updated) device adjacency when one was passed in."""
    n = store.repository_size
    if first_labels is not None:
        labels = np.asarray(first_labels)[:n].astype(np.int64)
        labels[labels >= n] = -1
    else:
        m = max(n, 1)
        labels = native.connected_components(
            graph.nbr_ids[:m], graph._has_node[:m])[0][:n].astype(np.int64)
    comps = len(np.unique(labels[labels >= 0]))
    rrow = None  # rep rows upload once, reused across passes
    for _ in range(max_passes):
        if comps <= 1:
            break
        live_labels = labels[labels >= 0]
        main = np.bincount(live_labels).argmax()
        # one pivot per secondary component: its first (lowest) node
        live_idx = np.nonzero(labels >= 0)[0]
        order = np.argsort(labels[live_idx], kind="stable")
        ll = labels[live_idx][order]
        first_mask = np.concatenate([[True], ll[1:] != ll[:-1]])
        firsts = live_idx[order][first_mask]
        pivots = firsts[ll[first_mask] != main].astype(np.int64)
        reps = seeder.rep_ids
        if len(reps) == 0:
            break
        rep_labels = labels[np.clip(reps, 0, n - 1)]
        if rrow is None:
            rrow = torch.from_numpy(store._x[reps]).to(store.device)
        tgt_idx, td = _bridge_select(
            torch.from_numpy(store._x[pivots]).to(store.device), rrow,
            torch.from_numpy(rep_labels).to(store.device),
            torch.from_numpy(labels[pivots]).to(store.device), metric,
        )
        okm = np.isfinite(td)
        if not okm.any():
            break
        tgt = reps[tgt_idx[okm]].astype(np.int32)
        piv = pivots[okm].astype(np.int32)
        td = td[okm].astype(np.float32)
        if graph._deferred is not None:
            nbr_dev = _bridge_deferred(graph, piv, tgt, td)
        else:
            graph.add_edges(piv.astype(np.int64), tgt, td)
            graph.add_edges(tgt.astype(np.int64), piv, td)
            if nbr_dev is not None:
                touched = np.unique(np.concatenate([piv, tgt])).astype(np.int64)
                nbr_dev[torch.from_numpy(touched).to(nbr_dev.device)] = (
                    torch.from_numpy(graph.nbr_ids[touched]).to(nbr_dev.device)
                )
        # merge bridged components in the label array (a tiny union-find
        # over label values)
        parent: dict[int, int] = {}

        def find(a: int) -> int:
            r = a
            while parent.get(r, r) != r:
                r = parent[r]
            while parent.get(a, a) != a:
                parent[a], a = r, parent[a]
            return r

        for a, b in zip(labels[piv], labels[tgt]):
            ra, rb = find(int(a)), find(int(b))
            if ra != rb:
                parent[max(ra, rb)] = min(ra, rb)
        uniq = np.unique(live_labels)
        roots = np.array([find(int(u)) for u in uniq], np.int64)
        lut = np.arange(labels.max() + 1, dtype=np.int64)
        lut[uniq] = roots
        labels = np.where(labels >= 0, lut[np.clip(labels, 0, None)], -1)
        comps = len(np.unique(roots))
    return comps, nbr_dev


def _bridge_select(prow, rrow, rep_labels, piv_labels, metric):
    """Per pivot: the nearest representative holding another component
    label (argmin, first on ties) and its distance, as numpy."""
    dd = D.pairwise(metric, prow, rrow)
    bad = (rep_labels[None, :] == piv_labels[:, None]) | (rep_labels < 0)[None, :]
    dd = torch.where(bad, INF, dd)
    arg = dd.argmin(1)
    return arg.cpu().numpy(), dd.gather(1, arg[:, None])[:, 0].cpu().numpy()


def build_bulk(
    store: VectorStore,
    graph: GraphStore,
    seeder: Seeder,
    prop: Property,
    pending: np.ndarray,
    mirror: DeviceMirror | None = None,
) -> DeviceMirror:
    """Bulk construction: EXACT k-NN edges + reverse edges, for a fresh
    index or an append of many rows to a built one.

    The reference grows its graph incrementally because exact k-NN is
    quadratic on a CPU; on a matrix engine the full distance scan is the
    cheap path, and an exact k-NN graph with reverse edges dominates an
    incrementally grown ANNG in quality.

    A fresh index assembles every adjacency row on the device
    (``_bulk_graph_rows``).  An append scans the new rows against the whole
    store in chunks of NGT_TPU_BULK_QBLOCK rows (131,072 on the fast scan,
    4,096 on ``linear_search``), brings each chunk's k nearest other rows to
    the host, and applies them in two phases, every new row first and every
    reverse edge second: interleaved per chunk, a later chunk's row would
    wipe the reverse edges an earlier chunk added into it
    (ngt_tpu/graph/build.py:1010-1026)."""
    k = int(prop.edge_size_for_creation)
    pending = np.asarray(pending, dtype=np.int32)
    cap = store._x.shape[0]
    graph.ensure_capacity(cap)
    fresh = graph.node_count() == 0
    if mirror is None:
        mirror = DeviceMirror(store, graph)
    # free the old mirror and any adjacency a fresh build left deferred on
    # the device before the new upload, so neither sits through the scan
    # (the "upload" phase holds the download)
    mirror.drop()
    mark = _Marks(store.device)
    graph._materialize()
    if len(pending) == 0:
        return mirror
    dev = store.device
    metric = store.metric
    # the narrow upload is what the search mirror adopts; the scan holds a
    # widened f32 working copy of a float store
    x_narrow = _upload(store._x, dev, narrow=True)
    x = _widen(x_narrow, store._x)
    valid = torch.from_numpy(store._valid).to(dev, copy=True)
    sqn = D.sq_norms(x) if mirror._wants_sqnorm() else None
    mark("upload")
    x_fast = sqn_fast = None
    if metric in _FAST_SCAN:
        x_fast = x.to(torch.float32)
        ang = metric in _ANGULAR_SCAN
        if ang and not store.normalize:
            # unit rows; the dummy slot, padding and freed rows stay zero
            x_fast = D.normalize_rows(x_fast)
        sqn_fast = sqn if sqn is not None and not ang else D.sq_norms(x_fast)
        scan_impl = (
            "window"
            if cap >= WINDOW_SCAN_MIN_ROWS and x.is_cuda and store.d_pad <= WS.D_MAX
            else "blocked"
        )

        def scan(rows: np.ndarray):
            # kc = 2(k+1): any true top-(k+1) neighbor ranks <= k+1 within
            # its own block, so a 2x window never loses it to bf16 noise
            ids, dists = BF.fast_knn_l2_bulk(
                torch.from_numpy(rows).to(dev), x_fast, valid, sqn_fast, k=k + 1,
                kc=2 * (k + 1), qblock=4096, scan_impl=scan_impl,
            )
            return ids, _l2_to_metric(dists, metric)
    else:

        def scan(rows: np.ndarray):
            parts = [
                BF.linear_search(
                    torch.from_numpy(store._x[rows[i : i + LINEAR_QBLOCK]]).to(dev),
                    x, valid, metric, k + 1, x_sqnorm=sqn,
                )
                for i in range(0, len(rows), LINEAR_QBLOCK)
            ]
            return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

    reverse = prop.graph_type != GraphType.KNNG
    if fresh:
        ids, dists = scan(pending)
        x_fast = sqn_fast = None
        mark("scan")
        nbr_dev, nbrd_dev, deg_dev = _bulk_graph_rows(
            torch.from_numpy(pending).to(dev), ids, dists, e_max=graph.e_max,
            cap=cap, reverse=reverse,
        )
        del ids, dists
        mark("rows")
        # fresh build: graph membership == store validity
        first_labels = _cc_labels_device(nbr_dev, valid).cpu().numpy() if reverse else None
        mark("cc")
        graph._has_node[:] = False
        graph._has_node[pending] = True
        graph.defer_rows(nbr_dev, nbrd_dev, deg_dev, int(pending.max()) + 1)
        mark("defer")
    else:
        qblock = int(os.environ.get("NGT_TPU_BULK_QBLOCK", "0")) or (
            32 * 4096 if metric in _FAST_SCAN else LINEAR_QBLOCK
        )
        chunks = []
        for off in range(0, len(pending), qblock):
            chunk = pending[off : off + qblock]
            ids, dists = scan(chunk)
            ids, dists = ids.cpu().numpy(), dists.cpu().numpy()
            # drop self-matches, keep k
            dists = np.where(ids == chunk[:, None], np.inf, dists)
            order = np.argsort(dists, axis=1, kind="stable")[:, :k]
            sel_i = np.take_along_axis(ids, order, axis=1)
            sel_d = np.take_along_axis(dists, order, axis=1)
            sel_i[~np.isfinite(sel_d)] = -1
            chunks.append((chunk, sel_i, sel_d))
        del ids, dists
        x_fast = sqn_fast = None
        mark("scan")
        for chunk, sel_i, sel_d in chunks:
            graph.set_nodes(chunk, sel_i, sel_d)
        if reverse:
            for chunk, sel_i, sel_d in chunks:
                ok = sel_i >= 0
                graph.add_edges(sel_i[ok].astype(np.int64),
                                np.repeat(chunk, ok.sum(axis=1)).astype(np.int32),
                                sel_d[ok].astype(np.float32))
        del chunks
        mark("apply")
        nbr_dev = first_labels = None
    if prop.truncation_threshold > 0:
        # exact rows: the tail IS the farthest edges; ensure_connected
        # keeps the cut-off targets reachable
        live = np.nonzero(graph._has_node)[0]
        graph.truncate_rows(live.astype(np.int64), int(prop.truncation_threshold))
        nbr_dev = first_labels = None
    live = np.nonzero(graph._has_node)[0].astype(np.int32)
    seeder.refresh(live, store._x, num_reps=default_reps(len(live)))
    mark("seeds")
    if reverse:
        _, nbr_dev = ensure_connected(
            store, graph, seeder, metric, nbr_dev=nbr_dev,
            first_labels=first_labels,
        )
    mark("connect")
    if nbr_dev is not None:
        mirror.adopt(x, nbr_dev, sqn, x_narrow=x_narrow)
    else:
        mirror.sync_full()
    mark("mirror")
    mark.finish("build_bulk")
    return mirror


# ------------------------------------------------------------------------
# incremental ANNG build
# ------------------------------------------------------------------------


def _bucket(n: int) -> int:
    """The reference's batch padding: the next power of two, at least 32.
    The port pads nothing, but the intra-batch top-kb width derives from
    it, so small batches link as the reference's do."""
    return 1 << max(int(math.ceil(math.log2(max(n, 1)))), 5)


def _batch_topk(metric, queries: torch.Tensor, kb: int):
    """The kb nearest other members of each batch row (positions, dists),
    ascending, ties to the lower position (``lax.top_k`` order).  kb may
    exceed the batch: the missing columns are empty (+inf)."""
    pb = D.pairwise(metric, queries, queries)
    b = pb.shape[0]
    eye = torch.eye(b, dtype=torch.bool, device=pb.device)
    pb = torch.where(eye, INF, pb)
    if kb > b:
        pb = torch.cat([pb, pb.new_full((b, kb - b), INF)], 1)
    pos = torch.arange(pb.shape[1], dtype=torch.int32, device=pb.device)
    bd, bi = topk_lex(pb, pos.expand_as(pb), kb)
    return bi, bd


def _seeds(metric, queries, rep_rows, rep_sq, rep_ids, s: int) -> torch.Tensor:
    """Seed ids: the s best representatives by ``seed_scores``."""
    return rep_ids[top_seeds(D.seed_scores(metric, queries, rep_rows, rep_sq=rep_sq), s)]


def _fused_insert_search(mirror: DeviceMirror, rep_rows, rep_sq, rep_ids, queries, eps,
                         *, metric, k, kb, s, width, hash_bits, exact_hash, expand=1):
    """Seed scoring, the insertion search over the current graph and the
    intra-batch pairwise top-kb (kb = 0 skips it): the device side of a
    build batch (ngt_tpu/graph/build.py:64-96).  Returns (ids, dists) of
    the search and (positions, dists) of the batch top-kb, or None."""
    seeds = _seeds(metric, queries, rep_rows, rep_sq, rep_ids, s)
    res = graph_search(
        mirror.x, mirror.nbr, mirror.valid, queries, seeds, metric=metric, k=k,
        epsilon=eps, width=width, hash_bits=hash_bits, exact_hash=exact_hash,
        expand=expand, x_sqnorm=mirror.sqnorm,
    )
    return res.ids, res.dists, (_batch_topk(metric, queries, kb) if kb else None), res.iters


def _fused_insert_search_sq8(mirror: DeviceMirror, blocks, codes, rep_rows, rep_sq, rep_ids,
                             queries, eps, inv_scale, *, metric, k, kb, s, width,
                             hash_bits, exact_hash):
    """The sq8 insertion search: the traversal scores int8 neighbor blocks
    (``[cap, E, D]``, one row read per hop) for 2k candidates with the
    radius rule on the k-th, then the candidates are re-ranked exactly
    against the mirror, so the stored edges carry true distances
    (ngt_tpu/graph/build.py:99-137)."""
    seeds = _seeds(metric, queries, rep_rows, rep_sq, rep_ids, s)
    res = graph_search(
        blocks, mirror.nbr, mirror.valid, queries.to(torch.float32) * inv_scale, seeds,
        metric=DistanceType.L2, k=2 * k, k_radius=k, epsilon=eps, width=width,
        hash_bits=hash_bits, exact_hash=exact_hash, block_mode=True, seed_x=codes,
    )
    safe = res.ids.to(torch.int64).clamp(0, mirror.x.shape[0] - 1)
    rsq = mirror.sqnorm[safe] if mirror.sqnorm is not None else None
    dd = D.gathered(metric, queries, mirror.x[safe], xs_sqnorm=rsq)
    dd = torch.where(res.ids >= 0, dd, INF)
    pos = torch.arange(dd.shape[1], dtype=torch.int32, device=dd.device)
    f_d, sel = topk_lex(dd, pos.expand_as(dd), k)
    f_ids = res.ids.gather(1, sel.to(torch.int64))
    f_ids = torch.where(torch.isfinite(f_d), f_ids, -1)
    return f_ids, f_d, _batch_topk(metric, queries, kb), res.iters


def _sq8_codes(x: torch.Tensor, inv_scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x.to(torch.float32) * inv_scale), -127, 127).to(torch.int8)


def _make_codes_blocks(x: torch.Tensor, nbr: torch.Tensor, inv_scale: torch.Tensor):
    """int8 codes of every mirror row and the neighbor blocks
    ``blocks[u] = codes[nbr[u]]`` ([cap, E, D]; 8 GiB at 1M x 64 x 128, so
    this opt-in route suits small indexes)."""
    codes = _sq8_codes(x, inv_scale)
    return codes, codes[nbr.to(torch.int64).clamp(0, x.shape[0] - 1)]


def _update_codes_blocks(codes, blocks, obj_idx, obj_codes, blk_idx, nbr_rows) -> None:
    """Write the new objects' codes and re-gather the blocks of every row
    whose adjacency changed, in place."""
    codes.index_copy_(0, obj_idx, obj_codes)
    safe = nbr_rows.to(torch.int64).clamp(0, codes.shape[0] - 1)
    blocks.index_copy_(0, blk_idx, codes[safe])


def truncate_drop(graph: GraphStore, rows: np.ndarray, threshold: int):
    """Phase 1 of optimal truncation (truncateEdgesOptimally,
    Graph.cpp:947-1008): cap each over-threshold row at its ``threshold``
    nearest edges and erase the reverse direction of every dropped edge.
    Returns ``(dropped_targets, touched_rows)``."""
    rows = np.unique(np.asarray(rows, np.int64))
    rows = rows[(rows >= 0) & (rows < graph.capacity)]
    over = rows[graph.degree[rows] > threshold]
    if len(over) == 0:
        return np.zeros((0,), np.int64), np.zeros((0,), np.int64)
    tail_i = graph.nbr_ids[over, threshold:]
    src = np.repeat(over, tail_i.shape[1])
    tgt = tail_i.ravel().astype(np.int64)
    keep = tgt >= 0
    src, tgt = src[keep], tgt[keep]
    graph.truncate_rows(over, threshold)
    # reverse unlink: membership test on (tgt, src) pair keys
    cap = graph.capacity
    pair_keys = np.unique(tgt * cap + src)
    utgt = np.unique(tgt)
    utgt = utgt[graph._has_node[utgt]]
    rows_i = graph.nbr_ids[utgt]
    rows_d = graph.nbr_dist[utgt]
    qkeys = utgt[:, None] * cap + np.where(rows_i >= 0, rows_i, 0)
    hit = (rows_i >= 0) & np.isin(qkeys, pair_keys)
    if hit.any():
        rows_d[hit] = INF
        rows_i[hit] = -1
        order = np.argsort(rows_d, axis=1, kind="stable")
        graph.nbr_dist[utgt] = np.take_along_axis(rows_d, order, axis=1)
        graph.nbr_ids[utgt] = np.take_along_axis(rows_i, order, axis=1)
        graph.degree[utgt] = (graph.nbr_ids[utgt] >= 0).sum(axis=1)
    return utgt, np.unique(np.concatenate([over, utgt]))


def truncate_relink(store: VectorStore, graph: GraphStore, prop: Property,
                    mirror: DeviceMirror, utgt: np.ndarray, rep_rows, rep_sq,
                    rep_ids_dev, metric) -> np.ndarray:
    """Phase 2 of optimal truncation (Graph.cpp:1015-1103): search the
    truncated graph for each dropped target (epsilon 0.1, s 10, width
    max(32, 2k)) and link it both ways to its nearest node other than
    itself, unless it finds itself first.  Returns the touched row ids."""
    if len(utgt) == 0:
        return np.zeros((0,), np.int64)
    k = int(prop.edge_size_for_creation)
    bits, exact = wrap_hash_bits(mirror.capacity, prop.visited_bits_log2)
    q = torch.from_numpy(store._x[utgt]).to(store.device)
    f_ids, f_d, _, _ = _fused_insert_search(
        mirror, rep_rows, rep_sq, rep_ids_dev, q, 0.1, metric=metric, k=k, kb=0,
        s=10, width=max(32, 2 * k), hash_bits=bits, exact_hash=exact,
    )
    f_ids, f_d = f_ids.cpu().numpy(), f_d.cpu().numpy()
    self_hit = f_ids == utgt[:, None]
    first_other = np.argmax((f_ids >= 0) & ~self_hit, axis=1)
    near_i = np.take_along_axis(f_ids, first_other[:, None], axis=1)[:, 0]
    near_d = np.take_along_axis(f_d, first_other[:, None], axis=1)[:, 0]
    ok = (near_i >= 0) & np.isfinite(near_d) & ~self_hit[:, 0]
    if not ok.any():
        return np.zeros((0,), np.int64)
    t = utgt[ok].astype(np.int64)
    m = near_i[ok].astype(np.int32)
    d = near_d[ok].astype(np.float32)
    graph.add_edges(t, m, d)
    graph.add_edges(m.astype(np.int64), t.astype(np.int32), d)
    return np.unique(np.concatenate([t, m.astype(np.int64)]))


#: per batch of the last ``build_anng`` run: (rows, seconds, graph_search
#: steps); each batch ends with its results on the host, so the seconds
#: hold its device work
last_batches: list[tuple[int, float, int]] = []


def build_anng(store: VectorStore, graph: GraphStore, seeder: Seeder, prop: Property,
               pending: np.ndarray, mirror: DeviceMirror | None = None,
               progress=None) -> DeviceMirror:
    """Index every id in ``pending`` (stored objects without graph nodes)
    in batches of ``device_batch_size`` (ngt_tpu/graph/build.py:1250-1533):

    * a fresh graph bootstraps from the exact k-NN of its first batch;
    * each batch searches the current graph (insertion epsilon
      ``insertion_radius_coefficient - 1``) or, for KNNG and BKNNG, scans
      exactly (``linear_search``); ``build_mode="sq8"`` traverses int8
      neighbor blocks and re-ranks exactly;
    * the intra-batch pairwise top-kb joins the candidates; IANNG keeps a
      neighbor only where the new node would enter its k-NN;
    * rows are set, reverse edges merged (all but KNNG), rows over
      ``truncation_threshold`` dropped and relinked, and the changed rows
      scattered into the mirror; the seeds refresh once the graph doubles;
    * ``build_time_limit`` (minutes) halves the insertion epsilon, down to
      0.02, while the projected build time exceeds it;
    * ``progress(done, total)``, when given, is called after each batch
      with the ids indexed so far (the bootstrap batch included) and
      ``len(pending)`` (ngt_tpu/graph/build.py:1528-1529)."""
    k = int(prop.edge_size_for_creation)
    eps = float(prop.insertion_radius_coefficient) - 1.0
    metric = store.metric
    dev = store.device
    batch = int(prop.device_batch_size)
    pending = np.asarray(pending, dtype=np.int32)
    last_batches.clear()
    if len(pending) == 0:
        if mirror is None:
            mirror = DeviceMirror(store, graph)
            mirror.sync_full()
        return mirror
    graph.ensure_capacity(store._x.shape[0])

    # bootstrap: the exact k-NN among the first batch (the reference grows
    # from one object; an exact mini k-NN graph is one matmul)
    start = 0
    if graph.node_count() == 0:
        b0 = min(batch, len(pending))
        ids0 = pending[:b0]
        q = torch.from_numpy(store._x[ids0]).to(dev)   # keeps uint8 for the bit metrics
        d = D.pairwise(metric, q, q).cpu().numpy().copy()
        np.fill_diagonal(d, INF)
        kk = min(k, b0 - 1) if b0 > 1 else 0
        if kk > 0:
            nn = np.argsort(d, axis=1, kind="stable")[:, :kk]
            nd = np.take_along_axis(d, nn, axis=1)
            graph.set_nodes(ids0, ids0[nn].astype(np.int32), nd.astype(np.float32))
            graph.add_edges(ids0[nn].ravel().astype(np.int64),
                            np.repeat(ids0, kk).astype(np.int32),
                            nd.ravel().astype(np.float32))
            if prop.truncation_threshold > 0:
                graph.truncate_rows(ids0.astype(np.int64), int(prop.truncation_threshold))
        else:
            graph.set_nodes(ids0, np.full((b0, 1), -1, np.int32),
                            np.full((b0, 1), INF, np.float32))
        start = b0
        seeder.refresh(ids0, store._x, num_reps=min(1024, b0))

    if mirror is None:
        mirror = DeviceMirror(store, graph)
    mirror.sync_full()
    next_seed_refresh = max(2 * graph.node_count(), 1024)
    if seeder.num_reps == 0 and graph.node_count() > 0:
        live = np.nonzero(graph._has_node)[0].astype(np.int32)
        seeder.refresh(live, store._x, num_reps=default_reps(len(live)))

    def reps():
        rows = torch.from_numpy(store._x[seeder.rep_ids]).to(dev)
        return (rows, D.sq_norms(rows) if mirror.sqnorm is not None else None,
                torch.from_numpy(seeder.rep_ids).to(dev, copy=True))

    rep_rows, rep_sq, rep_ids_dev = reps()
    # sq8 insertion search (opt-in: the reference measured that per-batch
    # block maintenance costs more than the cheaper traversal saves)
    sq8 = (prop.build_mode == "sq8" and metric in _SQ8_METRICS
           and prop.graph_type not in (GraphType.KNNG, GraphType.BKNNG))
    codes_dev = blocks_dev = None
    sq8_scale = 1.0
    if sq8:
        sample = store._x[pending[: min(len(pending), 4096)]]
        peak = float(np.abs(sample).max()) if len(sample) else 1.0
        sq8_scale = max(peak * 1.25, 1e-30) / 127.0
        codes_dev, blocks_dev = _make_codes_blocks(
            mirror.x, mirror.nbr, torch.tensor(np.float32(1.0 / sq8_scale)))
    exact_candidates = prop.graph_type in (GraphType.KNNG, GraphType.BKNNG)
    limit_s = float(prop.build_time_limit) * 60.0
    t_start = time.time()
    for off in range(start, len(pending), batch):
        t_batch = time.perf_counter()
        if limit_s > 0 and off > start:
            frac = (off - start) / max(len(pending) - start, 1)
            projected = (time.time() - t_start) / max(frac, 1e-9)
            if projected > limit_s and eps > 0.02:
                eps = max(eps * 0.5, 0.02)
        chunk = pending[off : off + batch]
        bsz = len(chunk)
        q = torch.from_numpy(store._x[chunk]).to(dev)
        bits, exact = wrap_hash_bits(mirror.capacity, prop.visited_bits_log2)
        kb = max(min(k, _bucket(bsz) - 1), 1)
        steps = 0
        if exact_candidates:
            # KNNG/BKNNG: exact k-NN edges (searchForKNNGInsertion is a
            # linear scan, Index.h:839-856)
            f_ids, f_d = BF.linear_search(q, mirror.x, mirror.valid, metric, k,
                                          x_sqnorm=mirror.sqnorm)
            batch_nn = _batch_topk(metric, q, kb)
        elif sq8:
            qmax = float(np.abs(store._x[chunk]).max())
            if qmax > 127.0 * sq8_scale:
                # an outlier past the int8 range: double the scale until it
                # fits and re-encode
                while qmax > 127.0 * sq8_scale:
                    sq8_scale *= 2.0
                codes_dev, blocks_dev = _make_codes_blocks(
                    mirror.x, mirror.nbr, torch.tensor(np.float32(1.0 / sq8_scale)))
            f_ids, f_d, batch_nn, steps = _fused_insert_search_sq8(
                mirror, blocks_dev, codes_dev, rep_rows, rep_sq, rep_ids_dev, q, eps,
                torch.tensor(np.float32(1.0 / sq8_scale)), metric=metric, k=k, kb=kb,
                s=max(prop.seed_size, 10), width=max(32, 2 * k), hash_bits=bits,
                exact_hash=exact,
            )
        else:
            f_ids, f_d, batch_nn, steps = _fused_insert_search(
                mirror, rep_rows, rep_sq, rep_ids_dev, q, eps, metric=metric, k=k,
                kb=kb, s=max(prop.seed_size, 10), width=max(32, 2 * k),
                hash_bits=bits, exact_hash=exact, expand=max(prop.search_expand, 1),
            )
        found_i, found_d = f_ids.cpu().numpy(), f_d.cpu().numpy()
        b_ids, b_d = (t.cpu().numpy() for t in batch_nn)

        # intra-batch pairwise merge (reference Index.cpp:687-703): batch
        # positions -> ids; empty entries masked
        if bsz > 1:
            bi = np.clip(b_ids, 0, bsz - 1)
            bd = b_d.astype(np.float32)
            cand_i = np.concatenate([found_i, np.where(np.isfinite(bd), chunk[bi], -1)], axis=1)
            cand_d = np.concatenate([found_d, bd], axis=1)
        else:
            cand_i, cand_d = found_i, found_d
        # never link a node to itself (a reused slot can alias a stale
        # representative)
        cand_i = np.where(cand_i == chunk[:, None], -1, cand_i)
        cand_d = np.where(cand_i >= 0, cand_d, INF)
        order = np.argsort(cand_d, axis=1, kind="stable")[:, :k]
        sel_i = np.take_along_axis(cand_i, order, axis=1)
        sel_d = np.take_along_axis(cand_d, order, axis=1)
        sel_i[~np.isfinite(sel_d)] = -1

        if prop.graph_type == GraphType.IANNG:
            # mutual-k pruning (insertIANNGNode, Graph.h:628-635): keep a
            # neighbor only if the new node would enter ITS current k-NN
            tgt = np.clip(sel_i, 0, graph.capacity - 1)
            kth = np.where(graph.degree[tgt] >= k,
                           graph.nbr_dist[tgt, np.minimum(k, graph.e_max) - 1], INF)
            drop = (sel_i >= 0) & (sel_d > kth)
            sel_d[drop] = INF
            sel_i[drop] = -1

        graph.set_nodes(chunk, sel_i, sel_d)
        ok = sel_i >= 0
        if prop.graph_type != GraphType.KNNG:
            # reverse edges (KNNG is directed: insertKNNGNode adds none,
            # Graph.h:577-609)
            graph.add_edges(sel_i[ok].astype(np.int64),
                            np.repeat(chunk, ok.sum(axis=1)).astype(np.int32),
                            sel_d[ok].astype(np.float32))
        tr_tgts = None
        tr_touched = np.zeros((0,), np.int64)
        if prop.graph_type != GraphType.KNNG and prop.truncation_threshold > 0:
            tr_tgts, tr_touched = truncate_drop(graph, sel_i[ok].astype(np.int64),
                                                int(prop.truncation_threshold))
        affected = np.unique(np.concatenate(
            [chunk.astype(np.int64), sel_i[ok].astype(np.int64), tr_touched]))
        mirror.update_rows(chunk, affected)
        if tr_tgts is not None and len(tr_tgts):
            touched2 = truncate_relink(store, graph, prop, mirror, tr_tgts, rep_rows,
                                       rep_sq, rep_ids_dev, metric)
            if len(touched2):
                mirror.update_rows(None, touched2)
        if sq8:
            if codes_dev.shape[0] != mirror.capacity:
                codes_dev, blocks_dev = _make_codes_blocks(
                    mirror.x, mirror.nbr, torch.tensor(np.float32(1.0 / sq8_scale)))
            else:
                obj_codes = np.clip(np.round(store._x[chunk].astype(np.float32) / sq8_scale),
                                    -127, 127).astype(np.int8)
                _update_codes_blocks(
                    codes_dev, blocks_dev, torch.from_numpy(chunk.astype(np.int64)).to(dev),
                    torch.from_numpy(obj_codes).to(dev),
                    torch.from_numpy(affected).to(dev),
                    torch.from_numpy(graph.nbr_ids[affected]).to(dev),
                )
        if graph.node_count() >= next_seed_refresh:
            live = np.nonzero(graph._has_node)[0].astype(np.int32)
            seeder.refresh(live, store._x, num_reps=default_reps(len(live)))
            next_seed_refresh = 2 * graph.node_count()
            rep_rows, rep_sq, rep_ids_dev = reps()
        last_batches.append((bsz, time.perf_counter() - t_batch, int(steps)))
        if progress is not None:
            progress(off + bsz, len(pending))

    live = np.nonzero(graph._has_node)[0].astype(np.int32)
    seeder.refresh(live, store._x, num_reps=default_reps(len(live)))
    return mirror


# ------------------------------------------------------------------------
# removal
# ------------------------------------------------------------------------


def _group_pairwise(metric, rows: torch.Tensor) -> torch.Tensor:
    """Pairwise distances within each group of rows [C, E, D] -> [C, E, E]
    in one batched call (the reference's ``jax.vmap`` of ``pairwise``);
    sparse Jaccard, whose indicator matmul sizes itself by the ids present,
    runs group by group."""
    if DistanceType(metric) == DistanceType.SPARSE_JACCARD:
        return torch.stack([D.pairwise(metric, r, r) for r in rows])
    return torch.vmap(lambda r: D.pairwise(metric, r, r))(rows)


def _nearest_in_groups(metric, rows: torch.Tensor, ok: torch.Tensor):
    """Per member of each group: the nearest other live member (argmin,
    first on ties) and its distance; dead members and the diagonal are
    masked to +inf."""
    d = _group_pairwise(metric, rows)
    e = d.shape[1]
    eye = torch.eye(e, dtype=torch.bool, device=d.device)
    d = torch.where(~ok[:, :, None] | ~ok[:, None, :] | eye[None], INF, d)
    nn = d.argmin(2)
    return nn, d.gather(2, nn[:, :, None])[:, :, 0]


def batch_remove_objects(store: VectorStore, graph: GraphStore, oids: np.ndarray,
                         metric) -> np.ndarray:
    """Delete a set of objects with batch-wide passes
    (ngt_tpu/graph/build.py:1536-1629), the per-delete semantics of the
    reference's ``removeEdgesReliably`` (Graph.cpp:641-864) for every id:

    1. tombstone every removed node, keeping its former neighbor list;
    2. one vectorized reverse scan drops every edge into the removed set;
    3. repair: each removed node's surviving former neighbors are linked
       both ways to their nearest surviving former co-neighbor, one batched
       pairwise per chunk of ``(1 << 22) // E^2`` groups.

    Returns the ids whose adjacency rows changed."""
    oids = np.unique(np.asarray(oids, np.int64))
    if len(oids) == 0:
        return np.zeros((0,), np.int64)
    n = store._x.shape[0]
    graph.ensure_capacity(n)
    cap = graph.capacity
    gone = np.zeros(cap, bool)
    gone[oids] = True
    formers = graph.nbr_ids[oids].copy()               # [R, E]
    graph.nbr_ids[oids] = -1
    graph.nbr_dist[oids] = INF
    graph.degree[oids] = 0
    graph._has_node[oids] = False
    rows_i = graph.nbr_ids[:n]
    hit_rows = np.nonzero((gone[np.clip(rows_i, 0, cap - 1)] & (rows_i >= 0)).any(axis=1))[0]
    graph.remove_edges_to_many(hit_rows, gone)
    for oid in oids:
        store.remove(int(oid))

    fsafe = np.clip(formers, 0, n - 1)
    fc = np.clip(formers, 0, cap - 1)
    alive = (formers >= 0) & ~gone[fc] & graph._has_node[fc]   # [R, E]
    touched = [oids, hit_rows.astype(np.int64)]
    groups = np.nonzero(alive.sum(axis=1) >= 2)[0]
    if len(groups):
        e = formers.shape[1]
        chunk = max(1, min(len(groups), (1 << 22) // max(e * e, 1)))
        src_all, dst_all, d_all = [], [], []
        for off in range(0, len(groups), chunk):
            gsel = groups[off : off + chunk]
            ok = alive[gsel]
            nn, nd = _nearest_in_groups(
                metric, torch.from_numpy(store._x[fsafe[gsel]]).to(store.device),
                torch.from_numpy(ok).to(store.device))
            nn, nd = nn.cpu().numpy(), nd.cpu().numpy()
            gi, mi = np.nonzero(ok & np.isfinite(nd))
            src_all.append(formers[gsel[gi], mi])
            dst_all.append(formers[gsel[gi], nn[gi, mi]])
            d_all.append(nd[gi, mi])
        src = np.concatenate(src_all).astype(np.int64)
        dst = np.concatenate(dst_all).astype(np.int32)
        dd = np.concatenate(d_all).astype(np.float32)
        graph.add_edges(src, dst, dd)
        graph.add_edges(dst.astype(np.int64), src.astype(np.int32), dd)
        touched += [src, dst.astype(np.int64)]
    return np.unique(np.concatenate(touched))


def remove_object(store: VectorStore, graph: GraphStore, oid: int, metric) -> np.ndarray:
    """Delete one object: tombstone, a vectorized reverse scan that unlinks
    it, and the local repair that links each former neighbor (out and in)
    both ways to its nearest other former neighbor
    (ngt_tpu/graph/build.py:1632-1676).  Returns the ids whose adjacency
    rows changed, ``oid`` included."""
    former = graph.remove_node(oid)
    former = former[former >= 0]
    n = store._x.shape[0]
    hit_rows = np.nonzero((graph.nbr_ids[:n] == oid).any(axis=1))[0]
    graph.remove_edges_to(hit_rows, oid)
    store.remove(oid)
    former = np.unique(np.concatenate([former, hit_rows.astype(np.int32)]))
    former = former[(former != oid) & (former >= 0)]
    former = former[graph._has_node[former]]
    touched = [np.asarray([oid], np.int64), former.astype(np.int64)]
    if len(former) >= 2:
        rows = torch.from_numpy(store._x[former]).to(store.device)
        d = D.pairwise(metric, rows, rows).cpu().numpy().copy()
        np.fill_diagonal(d, INF)
        nn = np.argmin(d, axis=1)
        nd = d[np.arange(len(former)), nn]
        graph.add_edges(former.astype(np.int64), former[nn].astype(np.int32),
                        nd.astype(np.float32))
        graph.add_edges(former[nn].astype(np.int64), former.astype(np.int32),
                        nd.astype(np.float32))
        touched.append(former[nn].astype(np.int64))
    return np.unique(np.concatenate(touched))
