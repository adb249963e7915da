"""ann-benchmarks adapters of the port (the counterpart of
``ngt_tpu/annb.py``).

The reference's canonical evaluation path is the public ann-benchmarks
harness (reference tests/ann-benchmarks-results/*.png, README.md:110-127);
its NGT entries are the ONNG / PANNG / QG adapter classes.  This module
gives the same entry points (and a plain ANNG) in the harness's BaseANN
protocol (fit / set_query_arguments / query / batch_query /
get_batch_results / get_memory_usage / done), each on ``device`` (default
``"cuda"``).  The adapters do not import the ann_benchmarks package; they
implement its protocol.  ``query`` returns zero-based row indices into the
fitted matrix, as the harness expects.
"""

from __future__ import annotations

import numpy as np

import ngt_tpu_torch
from ngt_tpu_torch.utils import get_process_vm_rss

_METRICS = {
    "euclidean": "L2",
    "angular": "Cosine",
    "hamming": "Hamming",
    "jaccard": "Jaccard",
}


def _resolve_metric(metric: str) -> str:
    try:
        return _METRICS[metric]
    except KeyError:
        raise ValueError(
            f"unsupported ann-benchmarks metric {metric!r}; "
            f"expected one of {sorted(_METRICS)}"
        ) from None


class BaseANN:
    """ann-benchmarks algorithm protocol (BaseANN)."""

    name = "ngt_tpu_torch"

    def fit(self, X: np.ndarray) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def set_query_arguments(self, *args) -> None:
        pass

    def query(self, q: np.ndarray, n: int) -> np.ndarray:
        raise NotImplementedError

    def batch_query(self, X: np.ndarray, n: int) -> None:
        self.res = [self.query(q, n) for q in np.asarray(X)]

    def get_batch_results(self):
        return self.res

    def get_memory_usage(self) -> int:
        """Host memory in KiB (the harness's psutil RSS analogue)."""
        return get_process_vm_rss()

    def done(self) -> None:
        pass

    def __str__(self) -> str:
        return self.name


class ANNG(BaseANN):
    """ANNG build + batched traversal (the reference's panng_ngt entry
    without the pruning)."""

    def __init__(self, metric: str, edge_size_for_creation: int = 10,
                 search_mode: str = "auto", device="cuda"):
        self._metric = _resolve_metric(metric)
        self._edge = int(edge_size_for_creation)
        self._search_mode = search_mode
        self._device = device
        self._epsilon = 0.1
        self.index: ngt_tpu_torch.Index | None = None
        self.name = f"ngt_tpu_torch_anng(E{self._edge})"

    def fit(self, X: np.ndarray) -> None:
        X = np.ascontiguousarray(np.asarray(X, dtype=np.float32))
        self.index = ngt_tpu_torch.create(
            None, dimension=X.shape[1], distance_type=self._metric,
            edge_size_for_creation=self._edge, device=self._device,
        )
        self.index.prop.search_mode = self._search_mode
        self.index.batch_insert(X, build=True)

    def set_query_arguments(self, epsilon: float = 0.1) -> None:
        self._epsilon = float(epsilon)

    def query(self, q: np.ndarray, n: int) -> np.ndarray:
        ids, _ = self.index.batch_search(
            np.asarray(q, dtype=np.float32)[None, :], size=n, epsilon=self._epsilon,
        )
        ids = np.asarray(ids)[0]
        return ids[ids >= 0]

    def batch_query(self, X: np.ndarray, n: int) -> None:
        ids, _ = self.index.batch_search(
            np.ascontiguousarray(np.asarray(X, dtype=np.float32)),
            size=n, epsilon=self._epsilon,
        )
        # drop the -1 padding, as the single-query path does
        self.res = [r[r >= 0] for r in np.asarray(ids)]

    def done(self) -> None:
        self.index = None


class PANNG(ANNG):
    """ANNG + pruning (the reference's panng_ngt entry: create -> prune
    -e edge -p path_edge, Command.cpp:598-695)."""

    def __init__(self, metric: str, edge_size_for_creation: int = 20,
                 edge: int = 10, path_edge: int = 40,
                 search_mode: str = "auto", device="cuda"):
        super().__init__(metric, edge_size_for_creation, search_mode, device)
        self._prune_edge = int(edge)
        self._path_edge = int(path_edge)
        self.name = f"ngt_tpu_torch_panng(e{self._prune_edge},p{self._path_edge})"

    def fit(self, X: np.ndarray) -> None:
        from ngt_tpu_torch.graph.reconstruct import adjust_paths, reconstruct_graph

        super().fit(X)
        idx = self.index
        n = idx.store.repository_size
        g = reconstruct_graph(idx.graph, n, out_edges=self._prune_edge,
                              in_edges=self._path_edge, device=idx.device)
        idx.replace_graph(adjust_paths(g, n, min_edges=self._prune_edge, device=idx.device))


class ONNG(ANNG):
    """ANNG -> ONNG reconstruction (the reference's onng_ngt entry:
    create -E edge -> reconstruct-graph -o out -i in)."""

    def __init__(self, metric: str, edge_size_for_creation: int = 40,
                 out_edges: int = 10, in_edges: int = 120,
                 search_mode: str = "auto", device="cuda"):
        super().__init__(metric, edge_size_for_creation, search_mode, device)
        self._out = int(out_edges)
        self._in = int(in_edges)
        self.name = f"ngt_tpu_torch_onng(E{self._edge},o{self._out},i{self._in})"

    def fit(self, X: np.ndarray) -> None:
        from ngt_tpu_torch.optimizer import GraphOptimizer

        super().fit(X)
        GraphOptimizer(
            out_edges=self._out, in_edges=self._in, tune_parameters=False,
        ).execute(self.index)
        self.index.prop.search_mode = self._search_mode


class QG(ANNG):
    """Quantized-graph search (the reference's qg_ngt entry: NGTQG)."""

    def __init__(self, metric: str, edge_size_for_creation: int = 40,
                 mode: str = "sq8", result_expansion: float = 3.0, device="cuda"):
        super().__init__(metric, edge_size_for_creation, device=device)
        self._mode = mode
        self._expansion = float(result_expansion)
        self._qg = None
        self.name = f"ngt_tpu_torch_qg({mode})"

    def fit(self, X: np.ndarray) -> None:
        from ngt_tpu_torch.quant.qgraph import QuantizedGraphIndex

        super().fit(X)
        self._qg = QuantizedGraphIndex.quantize(self.index, mode=self._mode)

    def set_query_arguments(self, epsilon: float = 0.02,
                            result_expansion: float = 0.0) -> None:
        self._epsilon = float(epsilon)
        if result_expansion > 0:
            self._expansion = float(result_expansion)

    def query(self, q: np.ndarray, n: int) -> np.ndarray:
        ids, _ = self._qg.batch_search(
            np.asarray(q, dtype=np.float32)[None, :], size=n,
            epsilon=self._epsilon, result_expansion=self._expansion,
        )
        ids = np.asarray(ids)[0]
        return ids[ids >= 0]

    def batch_query(self, X: np.ndarray, n: int) -> None:
        ids, _ = self._qg.batch_search(
            np.ascontiguousarray(np.asarray(X, dtype=np.float32)),
            size=n, epsilon=self._epsilon, result_expansion=self._expansion,
        )
        self.res = [r[r >= 0] for r in np.asarray(ids)]

    def done(self) -> None:
        self._qg = None
        super().done()
