"""Drop-in ``ngtpy`` module of the port (the counterpart of
``ngt_tpu/ngtpy.py``).

Mirrors the reference's pybind11 module surface (python/src/ngtpy.cpp:
500-639), so ngtpy code runs on the port by changing its import:

    import ngt_tpu_torch.ngtpy as ngtpy
    ngtpy.create(path, dim, distance_type="L2")
    index = ngtpy.Index(path)
    index.batch_insert(vectors)
    index.search(query, size=10, epsilon=0.1)

Each constructor takes ``device`` (default ``"cuda"``), the device the
index runs on.  Differences from ngtpy: no shared-memory flag (the index
lives in device memory); ``Index.index`` exposes the batched API.
"""

from __future__ import annotations

import numpy as np

import ngt_tpu_torch
from ngt_tpu_torch import optimizer as _opt
from ngt_tpu_torch.quant.qgraph import QuantizedGraphIndex as _QG


def create(
    path: str,
    dimension: int,
    edge_size_for_creation: int = 10,
    edge_size_for_search: int = 40,
    distance_type: str = "L2",
    object_type: str = "Float",
    device="cuda",
) -> None:
    """ngtpy.create (reference ngtpy.cpp:505-529)."""
    idx = ngt_tpu_torch.create(
        path,
        dimension=dimension,
        edge_size_for_creation=edge_size_for_creation,
        edge_size_for_search=edge_size_for_search,
        distance_type=distance_type,
        object_type=object_type,
        device=device,
    )
    idx.save()


class Index:
    """ngtpy.Index (reference ngtpy.cpp:28-497)."""

    def __init__(self, path: str, read_only: bool = False,
                 zero_based_numbering: bool = True, log_disabled: bool = False,
                 device="cuda"):
        del read_only, log_disabled  # no read-only mode: the index lives on the device
        self._idx = ngt_tpu_torch.open_index(
            path, zero_based_numbering=zero_based_numbering, device=device
        )

    # -- mutation
    def insert(self, obj):
        return self._idx.insert(np.asarray(obj))

    def batch_insert(self, objects, num_threads: int = 8, debug: bool = False):
        del num_threads, debug
        self._idx.batch_insert(np.asarray(objects), build=True)

    def build_index(self, num_threads: int = 8):
        self._idx.build_index(num_threads)

    def remove(self, object_id: int):
        self._idx.remove(object_id)

    # -- queries
    def search(self, query, size: int = 10, epsilon: float = 0.1,
               edge_size: int = -1, expected_accuracy: float = -1.0,
               with_distance: bool = True):
        return self._idx.search(
            query, size=size, epsilon=epsilon, edge_size=edge_size,
            expected_accuracy=expected_accuracy, with_distance=with_distance,
        )

    def linear_search(self, query, size: int = 10, with_distance: bool = True):
        res = self._idx.linear_search(query, size=size)
        return res if with_distance else [i for i, _ in res]

    def get_object(self, object_id: int):
        return self._idx.get_object(object_id).tolist()

    def get_num_of_objects(self) -> int:
        return len(self._idx)

    # -- persistence / maintenance
    def save(self, path: str | None = None):
        self._idx.save(path)

    def close(self):
        self._idx.close()

    def refine_anng(self, epsilon: float = 0.1, num_of_edges: int = 0,
                    **_ignored):
        from ngt_tpu_torch.graph.reconstruct import refine_anng

        refine_anng(self._idx, epsilon=epsilon, num_edges=num_of_edges)

    def set(self, num_of_search_objects: int = -1,
            search_radius: float = -1.0):
        if num_of_search_objects > 0:
            self._default_size = num_of_search_objects
        if search_radius >= 0:
            self._default_radius = search_radius

    def export_index(self, path: str):
        with open(path, "w") as fh:
            self._idx.export_index(fh)

    @property
    def index(self) -> ngt_tpu_torch.Index:
        """The underlying port index (for the batched API)."""
        return self._idx


class Optimizer:
    """ngtpy.Optimizer (reference ngtpy.cpp:560-610): the ONNG pipeline,
    run on ``device``."""

    def __init__(self, num_of_outgoings: int = 10, num_of_incomings: int = 120,
                 log_disabled: bool = False, device="cuda", **_ignored):
        del log_disabled
        self._out = num_of_outgoings
        self._in = num_of_incomings
        self._device = device

    def execute(self, in_index_path: str, out_index_path: str):
        idx = ngt_tpu_torch.open_index(in_index_path, device=self._device)
        _opt.GraphOptimizer(
            out_edges=self._out, in_edges=self._in
        ).execute(idx)
        idx.save(out_index_path)

    def adjust_search_coefficients(self, index_path: str):
        idx = ngt_tpu_torch.open_index(index_path, device=self._device)
        _opt.generate_accuracy_table(idx)
        _opt.adjust_edge_size(idx)
        idx.save()

    def set(self, num_of_outgoings: int = -1, num_of_incomings: int = -1,
            **_ignored):
        if num_of_outgoings > 0:
            self._out = num_of_outgoings
        if num_of_incomings > 0:
            self._in = num_of_incomings

    def optimize_number_of_edges_for_anng(
        self, index_path: str, target_accuracy: float = 0.9, **_ignored
    ) -> int:
        """ngtpy.Optimizer.optimize_number_of_edges_for_anng
        (ngtpy.cpp:588-604)."""
        idx = ngt_tpu_torch.open_index(index_path, device=self._device)
        out = _opt.optimize_number_of_edges(
            idx, target_accuracy=target_accuracy
        )
        return out["recommended_edge_size_for_creation"]


class QuantizedIndex:
    """ngtpy.QuantizedIndex (reference ngtpy.cpp:612-639): NGTQG search."""

    def __init__(self, path: str, max_no_of_edges: int = 128,
                 zero_based_numbering: bool = True, log_disabled: bool = False,
                 device="cuda"):
        del max_no_of_edges, log_disabled
        self._qg = _QG.open(path, device=device)
        self._qg.index.zero_based = zero_based_numbering

    @classmethod
    def quantize(cls, path: str, dimension_of_subvector: int = 2, device="cuda"):
        idx = ngt_tpu_torch.open_index(path, device=device)
        qg = _QG.quantize(idx, dsub=dimension_of_subvector)
        qg.save(path)

    def search(self, query, size: int = 10, epsilon: float = 0.02,
               result_expansion: float = 3.0, with_distance: bool = True):
        res = self._qg.search(
            query, size=size, epsilon=epsilon,
            result_expansion=result_expansion,
        )
        return res if with_distance else [i for i, _ in res]

    def save(self, path: str | None = None):
        self._qg.save(path)

    def close(self):
        pass
