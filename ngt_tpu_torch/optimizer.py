"""Search-parameter optimization and the ONNG pipeline — the port's
counterpart of ``ngt_tpu/optimizer.py``, after the reference's
measurement-driven tuners:

* ``AccuracyTable`` — an ε↔accuracy piecewise-linear table serialized as
  "eps:acc,..." (Index::AccuracyTable, lib/NGT/Index.h:293-360), which the
  ``expected_accuracy`` search knob reads (Index.h:1156-1158);
* ``evaluate`` — recall and queries/s per ε (Optimizer::evaluate,
  Optimizer.h:130-226);
* ``explore_epsilon`` — bisect ε to a target accuracy
  (exploreEpsilonForAccuracy, Optimizer.h:523-656);
* ``generate_accuracy_table`` — the ε→accuracy sweep (Optimizer.h:1495-1573);
* ``extract_queries`` — midpoints of neighboring stored objects
  (Optimizer.h:1139-1199);
* ``adjust_edge_size`` and ``adjust_search_edge_size`` — the search edge
  size, fixed or dynamic (adjustSearchEdgeSize, Optimizer.h:688-944);
* ``optimize_number_of_edges`` — the creation edge count for a target
  accuracy from prefix indexes (GraphOptimizer.h:386-543);
* ``GraphOptimizer`` — reconstruct, path-adjust, reseed and tune
  (GraphOptimizer::execute, GraphOptimizer.h:230-300).

Ground truth is the index's exact ``batch_linear_search`` on its device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from ngt_tpu_torch import trace
from ngt_tpu_torch.ops.bruteforce import recall_at_k


class AccuracyTable:
    """ε↔accuracy piecewise-linear interpolation (Index.h:293-360)."""

    def __init__(self, pairs: list[tuple[float, float]] | None = None):
        self.pairs = sorted(pairs or [])  # (epsilon, accuracy)

    @classmethod
    def from_string(cls, s: str) -> "AccuracyTable":
        pairs = []
        for tok in s.split(","):
            tok = tok.strip()
            if tok:
                e, a = tok.split(":")
                pairs.append((float(e), float(a)))
        return cls(pairs)

    def to_string(self) -> str:
        return ",".join(f"{e:g}:{a:g}" for e, a in self.pairs)

    def get_epsilon(self, accuracy: float) -> float:
        """The interpolated ε that reaches ``accuracy`` (Index.h:330-358);
        past the measured range, extrapolated from the last segment."""
        if not self.pairs:
            raise ValueError("empty accuracy table")
        if accuracy <= self.pairs[0][1]:
            return self.pairs[0][0]
        for (e0, a0), (e1, a1) in zip(self.pairs, self.pairs[1:]):
            if a0 <= accuracy <= a1:
                if a1 == a0:
                    return e1
                return e0 + (accuracy - a0) / (a1 - a0) * (e1 - e0)
        (e0, a0), (e1, a1) = self.pairs[-2:] if len(self.pairs) > 1 else (
            self.pairs[0], self.pairs[0])
        if a1 == a0:
            return e1 * 1.5 + 0.1
        return min(e0 + (accuracy - a0) / (a1 - a0) * (e1 - e0), e1 * 4 + 0.5)


@dataclass
class EvalPoint:
    epsilon: float
    recall: float
    qps: float
    mean_distance_count: float
    k: int = 10


def evaluate(index, queries: np.ndarray, gt_ids: np.ndarray,
             epsilons=(0.0, 0.02, 0.05, 0.1, 0.2, 0.4), k: int = 10,
             edge_size: int = -1, repeats: int = 2) -> list[EvalPoint]:
    """Recall, queries/s (mean of ``repeats`` timed calls after one warm
    call) and mean distance computations per ε."""
    out = []
    for eps in epsilons:
        _, _, st = index.batch_search(queries, size=k, epsilon=eps, edge_size=edge_size,
                                      with_stats=True)
        t0 = time.time()
        for _ in range(repeats):
            ids, _ = index.batch_search(queries, size=k, epsilon=eps, edge_size=edge_size)
        dt = (time.time() - t0) / repeats
        out.append(EvalPoint(
            epsilon=float(eps), recall=recall_at_k(np.asarray(ids), np.asarray(gt_ids), k),
            qps=len(queries) / dt,
            mean_distance_count=float(np.mean(st["distance_count"])), k=k,
        ))
    return out


def explore_epsilon(index, queries: np.ndarray, gt_ids: np.ndarray,
                    target_accuracy: float, k: int = 10, lo: float = 0.0,
                    hi: float = 1.5, iters: int = 8) -> float:
    """Bisect ε to the smallest value meeting ``target_accuracy``
    (Optimizer.h:523-656); ``hi`` when even it falls short."""

    def rec(eps):
        ids, _ = index.batch_search(queries, size=k, epsilon=eps)
        return recall_at_k(np.asarray(ids), np.asarray(gt_ids), k)

    if rec(hi) < target_accuracy:
        return hi
    for _ in range(iters):
        mid = (lo + hi) / 2
        if rec(mid) >= target_accuracy:
            hi = mid
        else:
            lo = mid
    return hi


def extract_queries(index, n: int, seed: int = 0) -> np.ndarray:
    """Queries as the midpoint of a random live object and its nearest
    other object found at ε 0.1 (Optimizer::extractQueries,
    Optimizer.h:1139-1199)."""
    rng = np.random.default_rng(seed)
    size = index.store.repository_size
    live = np.nonzero(index.store._valid[:size])[0]
    picks = rng.choice(live, size=min(n, len(live)), replace=False)
    base = index.store._x[picks, : index.store.dimension].astype(np.float32)
    ids, _ = index.batch_search(base, size=2, epsilon=0.1)
    other = np.asarray(ids)[:, 1]
    other = np.where(other >= 0, other + (1 if index.zero_based else 0), picks)
    mate = index.store._x[other, : index.store.dimension].astype(np.float32)
    return (base + mate) / 2.0


def generate_accuracy_table(index, queries: np.ndarray | None = None, k: int = 10,
                            epsilons=(0.0, 0.02, 0.05, 0.1, 0.15, 0.2, 0.3, 0.5, 0.8, 1.2),
                            n_queries: int = 200) -> AccuracyTable:
    """The ε→accuracy sweep, stored in ``prop.accuracy_table``
    (Optimizer::generateAccuracyTable, Optimizer.h:1495-1573)."""
    if queries is None:
        queries = extract_queries(index, n_queries)
    gt_ids, _ = index.batch_linear_search(queries, size=k)
    pairs = []
    for eps in epsilons:
        ids, _ = index.batch_search(queries, size=k, epsilon=eps)
        pairs.append((float(eps), recall_at_k(np.asarray(ids), np.asarray(gt_ids), k)))
    table = AccuracyTable(pairs)
    index.prop.accuracy_table = table.to_string()
    return table


def adjust_edge_size(index, queries: np.ndarray | None = None, k: int = 10,
                     target_accuracy: float = 0.9, candidates=(10, 20, 40, 60, 0),
                     n_queries: int = 200) -> int:
    """The fastest search edge size (0 = every stored edge) whose ε 0.05 or
    0.1 meets ``target_accuracy``; stored in ``prop.edge_size_for_search``
    (the role of adjustSearchEdgeSize, Optimizer.h:874-944)."""
    if queries is None:
        queries = extract_queries(index, n_queries)
    gt_ids, _ = index.batch_linear_search(queries, size=k)
    best = None
    for e in candidates:
        pts = evaluate(index, queries, np.asarray(gt_ids), epsilons=(0.05, 0.1), k=k,
                       edge_size=e)
        score = max((p.qps for p in pts if p.recall >= target_accuracy), default=0.0)
        if best is None or score > best[1]:
            best = (e, score)
    e = best[0]
    index.prop.edge_size_for_search = e if e > 0 else index.graph.e_max
    return e


def _measure_dynamic_time(index, queries, gt_ids, k, accuracy_range, eps_grid,
                          cache) -> float:
    """Mean query-batch seconds at the current dynamic (base, rate) edge
    size, at the smallest ε whose recall reaches the range's floor (the
    role of Optimizer::measure under edgeSize=-2, Optimizer.h:658-686);
    +inf when none does."""
    key = (index.prop.dynamic_edge_size_base, index.prop.dynamic_edge_size_rate)
    if key in cache:
        return cache[key]
    best = np.inf
    for eps in eps_grid:
        ids, _ = index.batch_search(queries, size=k, epsilon=eps, edge_size=-2)
        if recall_at_k(np.asarray(ids), np.asarray(gt_ids), k) < accuracy_range[0]:
            continue
        t0 = time.time()
        for _ in range(2):
            index.batch_search(queries, size=k, epsilon=eps, edge_size=-2)
        best = (time.time() - t0) / 2
        break
    cache[key] = best
    return best


def _descent_1d(measure_at, start, minimum, limit=1000):
    """Shrinking-step 1-D descent on measured time (the inner loop of
    adjustBase/RateSearchEdgeSize, Optimizer.h:688-870): walk up from
    ``start`` in steps 16, 8, 4, 2 until the time stops improving."""
    best_v, best_t = 0, np.inf
    vstart = max(start, minimum)
    for step in (16, 8, 4, 2):
        prev_t = np.inf
        v = vstart
        while v <= limit:
            t = measure_at(v)
            if prev_t <= t:
                vstart = best_v - step if best_v - step >= vstart else vstart
                break
            prev_t = t
            if t < best_t:
                best_t, best_v = t, v
            v += step
    return best_v, best_t


def adjust_search_edge_size(index, queries: np.ndarray | None = None, k: int = 10,
                            base_accuracy_range=(0.30, 0.50),
                            rate_accuracy_range=(0.80, 0.90), n_queries: int = 100,
                            eps_grid=(0.0, 0.02, 0.05, 0.1, 0.2, 0.4, 0.8)) -> tuple[int, int]:
    """Coordinate descent on the dynamic edge size (base, rate) by measured
    query time, with cycle detection (Optimizer::adjustSearchEdgeSize,
    Optimizer.h:874-944); stored in ``prop.dynamic_edge_size_base/rate``."""
    if queries is None:
        queries = extract_queries(index, n_queries)
    gt_ids, _ = index.batch_linear_search(queries, size=k)
    prop = index.prop
    base_cache: dict = {}
    rate_cache: dict = {}

    def measure_base(v):
        prop.dynamic_edge_size_base = int(v)
        return _measure_dynamic_time(index, queries, gt_ids, k, base_accuracy_range,
                                     eps_grid, base_cache)

    def measure_rate(v):
        prop.dynamic_edge_size_rate = int(v)
        return _measure_dynamic_time(index, queries, gt_ids, k, rate_accuracy_range,
                                     eps_grid, rate_cache)

    base, rate = (0, np.inf), (20, np.inf)
    history: dict[tuple[int, int], float] = {}
    for _ in range(8):
        prop.dynamic_edge_size_rate = rate[0]
        base_cache.clear()
        prev_base, base = base, _descent_1d(measure_base, base[0] // 2, 4)
        if prev_base[0] == base[0]:
            break
        prop.dynamic_edge_size_base = base[0]
        rate_cache.clear()
        prev_rate, rate = rate, _descent_1d(measure_rate, rate[0] // 2, 2)
        if prev_rate[0] == rate[0]:
            break
        key = (base[0], rate[0])
        if key in history:   # a loop: the fastest visited pair wins
            best = min(history.items(), key=lambda kv: kv[1])[0]
            base, rate = (best[0], history[best]), (best[1], history[best])
            break
        history[key] = rate[1]
    if base[0] > 0:
        prop.dynamic_edge_size_base = int(base[0])
    if rate[0] > 0:
        prop.dynamic_edge_size_rate = int(rate[0])
    return prop.dynamic_edge_size_base, prop.dynamic_edge_size_rate


def optimize_number_of_edges(index, target_accuracy: float = 0.9, target_size: int = 0,
                             k: int = 10, start_size: int = 2500, num_queries: int = 128,
                             edge_candidates=(5, 10, 15, 20, 30, 40, 60)) -> dict:
    """Estimate the creation edge count for ``target_accuracy`` at
    ``target_size`` from prefix indexes of doubling size, built on the
    index's device, extrapolated on log(size) (GraphOptimizer::
    optimizeNumberOfEdgesForANNG, GraphOptimizer.h:386-543).  Each prefix
    is searched with ``edge_size`` masked on one graph built at
    max(edge_candidates); the largest prefix is then rebuilt at the
    recommendation (at most 3 times, raising it) until it meets the target,
    and ``validated_accuracy`` reports that rebuild's recall."""
    import ngt_tpu_torch

    n = index.store.repository_size
    live = np.nonzero(index.store._valid[:n])[0]
    x = index.store._x[live, : index.store.dimension]
    target_size = target_size or len(live)

    def prefix(size, edges):
        sub = ngt_tpu_torch.create(None, dimension=index.store.dimension,
                                   distance_type=index.prop.distance_type,
                                   edge_size_for_creation=edges, device=index.device)
        sub.batch_insert(x[:size], build=True)
        return sub

    sizes, edges = [], []
    size = min(start_size, len(live))
    rng = np.random.default_rng(0)
    while size <= len(live):
        sub = prefix(size, max(edge_candidates))
        qi = rng.choice(size, size=min(num_queries, size), replace=False)
        queries = x[qi] + rng.normal(scale=1e-3 * np.abs(x).mean() + 1e-6,
                                     size=(len(qi), x.shape[1])).astype(np.float32)
        gt_ids, _ = sub.batch_linear_search(queries, size=k)
        chosen = max(edge_candidates)
        for e in edge_candidates:
            ids, _ = sub.batch_search(queries, size=k, epsilon=0.1, edge_size=e)
            if recall_at_k(np.asarray(ids), np.asarray(gt_ids), k) >= target_accuracy:
                chosen = e
                break
        sizes.append(size)
        edges.append(chosen)
        last_queries, last_gt = queries, np.asarray(gt_ids)
        if size == len(live):
            break
        size = min(size * 2, len(live))

    if len(sizes) >= 2:
        coef = np.polyfit(np.log(sizes), edges, 1)
        estimate = int(np.ceil(np.polyval(coef, np.log(target_size))))
    else:
        estimate = edges[-1]
    estimate = int(np.clip(estimate, min(edge_candidates), 2 * max(edge_candidates)))

    validated = None
    e_cap = 2 * max(edge_candidates)
    for _ in range(3):
        ids, _ = prefix(sizes[-1], estimate).batch_search(last_queries, size=k, epsilon=0.1)
        validated = recall_at_k(np.asarray(ids), last_gt, k)
        if validated >= target_accuracy or estimate >= e_cap:
            break
        estimate = min(max(estimate + 5, (estimate * 3) // 2), e_cap)
    return {
        "sizes": sizes,
        "edges": edges,
        "target_size": target_size,
        "recommended_edge_size_for_creation": estimate,
        "validated_accuracy": float(validated) if validated is not None else None,
    }


@dataclass
class GraphOptimizer:
    """The ONNG pipeline (GraphOptimizer, GraphOptimizer.h:21-653).

    ``execute`` rewrites the index's graph in place on the index's device
    (the reference copies the index directory first; callers can
    ``index.save`` to a new path)."""

    out_edges: int = 10
    in_edges: int = 120
    min_edges_after_adjustment: int = 10
    target_accuracy: float = 0.9
    adjust_paths: bool = True
    tune_parameters: bool = True
    queries: np.ndarray | None = field(default=None, repr=False)

    @trace.public
    def execute(self, index) -> None:
        """KNNG/BKNNG inputs become ANNG first (GraphOptimizer.h:258-264);
        then ``reconstruct_graph``, ``adjust_paths``, graph type ONNG with
        the new ``max_edges``, a fresh device mirror, k-means seeds and,
        with ``tune_parameters``, the accuracy table and the search edge
        size.  With NGT_TPU_BUILD_PROFILE=1 each stage's seconds land in
        ``graph.reconstruct.last_profile`` (materialize, reconstruct,
        detect, phase2, rows, mirror, seeds)."""
        from ngt_tpu_torch.graph import reconstruct as R
        from ngt_tpu_torch.graph.build import _Marks
        from ngt_tpu_torch.properties import GraphType

        dev = index.device
        marks = _Marks(dev, R.last_profile, "reconstruct.")
        n = index.store.repository_size
        graph = index.graph
        if index.prop.graph_type in (GraphType.KNNG, GraphType.BKNNG):
            graph = R.convert_to_anng(graph, n, device=dev)
        # the source rows on the device: the bulk build's deferred rows, or
        # one upload of the host arrays, shared by the steps below
        rows = R._rows_dev(graph, n, dev)
        if graph._deferred is None:
            graph.defer_rows(*rows, n)
        marks("materialize")
        onng = R.reconstruct_graph(graph, n, out_edges=self.out_edges,
                                   in_edges=self.in_edges, device=dev)
        marks("reconstruct")
        if self.adjust_paths:
            onng = R.adjust_paths(onng, n, min_edges=self.min_edges_after_adjustment,
                                  device=dev, marks=marks)
        index.replace_graph(onng)
        index.prop.graph_type = GraphType.ONNG
        index.prop.outgoing_edge = self.out_edges
        index.prop.incoming_edge = self.in_edges
        index.prop.max_edges = onng.e_max
        marks("mirror")
        index.optimize_seeds()
        marks("seeds")
        marks.finish()
        if self.tune_parameters:
            q = self.queries if self.queries is not None else extract_queries(index, 200)
            generate_accuracy_table(index, q)
            adjust_edge_size(index, q, target_accuracy=self.target_accuracy)
