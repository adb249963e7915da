"""``ngt.base``-style wrapper of the port (the counterpart of
``ngt_tpu/base.py``).

The reference ships a legacy ctypes wrapper over its C API
(python/ngt/base.py:42-501: Index.create/open/search/insert/insert_blob/
insert_from_tsv/build_index/remove/get_object/save), with 1-based ids.  This
module gives the same class surface over the port's in-process index, on
``device`` (default ``"cuda"``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import ngt_tpu_torch


class ObjectDistance(NamedTuple):
    id: int
    distance: float


class APIError(Exception):
    pass


class Index:
    def __init__(self, path: str, device="cuda"):
        try:
            self._idx = ngt_tpu_torch.open_index(path, zero_based_numbering=False,
                                                 device=device)
        except Exception as exc:
            raise APIError(f"cannot open index: {path}: {exc}") from exc
        self.path = path

    # -- creators (reference base.py create/open) --
    @classmethod
    def create(
        cls,
        path: str,
        dimension: int,
        edge_size_for_creation: int = 10,
        edge_size_for_search: int = 40,
        object_type: str = "Float",
        distance_type: str = "L2",
        device="cuda",
    ) -> "Index":
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
        return cls(path, device=device)

    @classmethod
    def open(cls, path: str, device="cuda") -> "Index":
        return cls(path, device=device)

    # -- mutation --
    def insert_object(self, obj) -> int:
        return self._idx.insert(np.asarray(obj, np.float32))

    insert = insert_object

    def insert_blob(self, objects) -> list[int]:
        """Insert many objects and build (reference base.py insert_blob)."""
        ids = self._idx.batch_insert(np.asarray(objects, np.float32), build=True)
        return [int(i) for i in ids]

    def insert_from_tsv(self, path: str) -> list[int]:
        from ngt_tpu_torch.native import parse_tsv

        return self.insert_blob(parse_tsv(path, self._idx.store.dimension))

    def build_index(self, num_threads: int = 4) -> None:
        self._idx.build_index(num_threads)

    def remove_object(self, object_id: int) -> None:
        self._idx.remove(object_id)

    remove = remove_object

    # -- queries --
    def search(self, query, k: int = 20, epsilon: float = 0.1):
        res = self._idx.search(np.asarray(query, np.float32), size=k, epsilon=epsilon)
        return [ObjectDistance(int(i), float(d)) for i, d in res]

    def get_object(self, object_id: int):
        return self._idx.get_object(object_id).tolist()

    # -- persistence --
    def save(self, path: str | None = None) -> None:
        self._idx.save(path)

    def close(self) -> None:
        self._idx.close()
