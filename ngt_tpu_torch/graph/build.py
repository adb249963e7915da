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

Appends to a built graph and the incremental ANNG build wait for ROADMAP
Queue 1, M11.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from ngt_tpu_torch.graph.storage import GraphStore, merge_edge_rows
from ngt_tpu_torch.ops import bruteforce as BF
from ngt_tpu_torch.ops import distances as D
from ngt_tpu_torch.ops import window_scan as WS
from ngt_tpu_torch.properties import DistanceType, GraphType, Property
from ngt_tpu_torch.seeds import Seeder, default_reps
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
    """``mark(label)`` closes a build phase when NGT_TPU_BUILD_PROFILE=1 (the
    reference's switch): it synchronizes the card, so each phase holds its
    own device work, and appends the phase's seconds to ``last_profile``.
    A no-op otherwise."""

    def __init__(self, dev: torch.device):
        self.on = os.environ.get("NGT_TPU_BUILD_PROFILE", "") == "1"
        self.dev = dev
        if self.on:
            last_profile.clear()
            self.t = time.perf_counter()

    def __call__(self, label: str) -> None:
        if not self.on:
            return
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        now = time.perf_counter()
        last_profile.append((label, now - self.t))
        self.t = now

    def report(self) -> None:
        if self.on:
            print("# build_bulk profile: " + " ".join(
                f"{label}={sec:.2f}s" for label, sec in last_profile), file=sys.stderr)


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

    def _search_valid(self) -> np.ndarray:
        # a search may only return indexed objects: live AND graph node
        cap = self.store._x.shape[0]
        return self.store._valid[:cap] & self.graph._has_node[:cap]

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
    the host with add_edges semantics (sorted bounded insert, duplicates
    skipped; Graph.h:888-934), write them back IN PLACE into the deferred
    tensors (the build owns them)."""
    dev_i, dev_d, dev_g, _ = graph._deferred
    targets = np.concatenate([piv, tgt]).astype(np.int64)
    srcs = np.concatenate([tgt, piv]).astype(np.int32)
    dd = np.concatenate([td, td]).astype(np.float32)
    order = np.argsort(targets, kind="stable")
    targets, srcs, dd = targets[order], srcs[order], dd[order]
    uniq = np.unique(targets)
    idx = torch.from_numpy(uniq).to(dev_i.device)
    new_i, new_d, new_deg = merge_edge_rows(
        uniq, dev_i[idx].cpu().numpy(), dev_d[idx].cpu().numpy(),
        targets, srcs, dd, graph.e_max,
    )
    dev_i[idx] = torch.from_numpy(new_i).to(dev_i.device)
    dev_d[idx] = torch.from_numpy(new_d).to(dev_i.device)
    dev_g[idx] = torch.from_numpy(new_deg).to(dev_i.device, dev_g.dtype)
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

    Labels come from ``first_labels`` when given, else from min-label
    propagation over the host adjacency.  Each pass takes one pivot per
    secondary component (its lowest node id) and links it both ways to its
    nearest representative in another component; the bridged labels are
    then merged in place (the bridges are the only new edges).  The main
    component is the largest, ties going to the lowest label as
    ``np.bincount(...).argmax()`` gives.  Returns the final component count
    and the (bridge-updated) device adjacency when one was passed in."""
    n = store.repository_size
    if first_labels is None:
        m = max(n, 1)
        first_labels = _cc_labels_device(
            torch.from_numpy(graph.nbr_ids[:m]), torch.from_numpy(graph._has_node[:m])
        ).numpy()
    labels = np.asarray(first_labels)[:n].astype(np.int64)
    labels[labels >= n] = -1
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
    """Fresh-index bulk construction: EXACT k-NN edges + reverse edges.

    The reference grows its graph incrementally because exact k-NN is
    quadratic on a CPU; on a matrix engine the full distance scan is the
    cheap path, and an exact k-NN graph with reverse edges dominates an
    incrementally grown ANNG in quality."""
    if graph.node_count() != 0:
        raise NotImplementedError(
            "bulk append to a built graph is not ported yet "
            "(ROADMAP Queue 1, M11)"
        )
    k = int(prop.edge_size_for_creation)
    pending = np.asarray(pending, dtype=np.int32)
    cap = store._x.shape[0]
    graph.ensure_capacity(cap)
    if mirror is None:
        mirror = DeviceMirror(store, graph)
    mirror.drop()
    if len(pending) == 0:
        return mirror
    dev = store.device
    mark = _Marks(dev)
    metric = store.metric
    # the narrow upload is what the search mirror adopts; the scan holds a
    # widened f32 working copy of a float store
    x_narrow = _upload(store._x, dev, narrow=True)
    x = _widen(x_narrow, store._x)
    valid = torch.from_numpy(store._valid).to(dev, copy=True)
    sqn = D.sq_norms(x) if mirror._wants_sqnorm() else None
    mark("upload")
    pend = torch.from_numpy(pending).to(dev)
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
        # kc = 2(k+1): any true top-(k+1) neighbor ranks <= k+1 within its
        # own block, so a 2x window never loses it to bf16 noise
        ids, dists = BF.fast_knn_l2_bulk(
            pend, x_fast, valid, sqn_fast, k=k + 1, kc=2 * (k + 1),
            qblock=4096, scan_impl=scan_impl,
        )
        del x_fast, sqn_fast
        dists = _l2_to_metric(dists, metric)
    else:
        parts = [
            BF.linear_search(
                torch.from_numpy(store._x[pending[i : i + LINEAR_QBLOCK]]).to(dev),
                x, valid, metric, k + 1, x_sqnorm=sqn,
            )
            for i in range(0, len(pending), LINEAR_QBLOCK)
        ]
        ids = torch.cat([p[0] for p in parts])
        dists = torch.cat([p[1] for p in parts])
        del parts
    mark("scan")
    reverse = prop.graph_type != GraphType.KNNG
    nbr_dev, nbrd_dev, deg_dev = _bulk_graph_rows(
        pend, ids, dists, e_max=graph.e_max, cap=cap, reverse=reverse,
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
    mark.report()
    return mirror
