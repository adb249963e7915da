"""VectorStore — the object space as dense arrays (the port's counterpart of
``ngt_tpu/store.py``).

One host numpy matrix is authoritative (append in place, geometric growth)
and is mirrored to a device tensor on demand.  The reference's conventions
are kept, so the saved arrays equal the JAX package's:

* ids are 1-based; slot 0 is a dummy row (reference Common.h:1711) and the
  validity mask keeps it (and removed rows) out of every search;
* removed ids go to a free list reused by later inserts
  (``Repository::removedList``, Common.h:1747-1774);
* the Normalized* metrics L2-normalize at insertion
  (ObjectSpaceRepository.h:560-618); Cosine and Angle store raw rows;
* the feature dim is padded to a multiple of 128 (``d_pad``; the analogue
  of ``getPaddedDimension``, ObjectSpace.h:249): zeros for dense rows, -1
  for the sorted int32 id sets of a Sparse-Jaccard store.

Object types: FLOAT rows are float32, UINT8 rows uint8 (bit patterns for
Hamming and Jaccard); BFLOAT16 keeps a float32 host copy, and only the
store's own device copy (what linear search reads) is rounded to bf16.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

from ngt_tpu_torch import trace
from ngt_tpu_torch.ops import distances as D
from ngt_tpu_torch.ops.bruteforce import pad_dim
from ngt_tpu_torch.properties import DistanceType, ObjectType
from ngt_tpu_torch.utils import narrow_host


_OBJECT_DTYPES = {
    ObjectType.FLOAT: np.float32,
    ObjectType.UINT8: np.uint8,
    ObjectType.BFLOAT16: np.float32,  # host copy in f32; device copy bf16
}

#: metrics whose device arrays (the store's and the search mirror's) carry
#: the row squared norms
SQNORM_METRICS = (
    DistanceType.L2, DistanceType.COSINE, DistanceType.ANGLE, DistanceType.POINCARE,
)


def pad_sparse(id_lists, dimension: int) -> np.ndarray:
    """Pack variable-length feature-id sets into a sorted, -1-padded int32
    matrix (the analogue of ``Index::makeSparseObject``,
    Index.cpp:303-320)."""
    out = np.full((len(id_lists), dimension), -1, np.int32)
    for i, ids in enumerate(id_lists):
        ids = sorted(int(v) for v in ids)
        if len(ids) > dimension:
            raise ValueError(
                f"sparse object has {len(ids)} ids; index dimension is {dimension}"
            )
        out[i, : len(ids)] = ids
    return out


class VectorStore:
    def __init__(
        self,
        dimension: int,
        metric: DistanceType = DistanceType.L2,
        object_type: ObjectType = ObjectType.FLOAT,
        capacity: int = 1024,
        device="cuda",
    ):
        if dimension <= 0:
            raise ValueError("dimension must be positive")
        self.dimension = int(dimension)
        self.metric = DistanceType(metric)
        self.object_type = ObjectType(object_type)
        self.d_pad = pad_dim(dimension)
        self.device = torch.device(device)
        #: Sparse-Jaccard objects are sorted feature-id sets (int32, -1 pad)
        self.sparse = self.metric == DistanceType.SPARSE_JACCARD
        self._dtype = np.int32 if self.sparse else _OBJECT_DTYPES[self.object_type]
        self._pad_value = -1 if self.sparse else 0
        #: the Normalized* metrics store unit rows (Cosine and Angle do not)
        self.normalize = D.needs_normalization(self.metric)
        cap = max(int(capacity), 16)
        self._x = np.full((cap, self.d_pad), self._pad_value, dtype=self._dtype)
        self._valid = np.zeros((cap,), dtype=bool)
        self._size = 1  # next fresh slot; slot 0 is the dummy
        self._free: list[int] = []  # min-heap of reusable ids
        self._device_x: torch.Tensor | None = None
        self._device_valid: torch.Tensor | None = None
        self._device_sqnorm: torch.Tensor | None = None
        self._dirty = True
        #: bumped on every insert and removal, so derived structures (the
        #: quantized codes) detect staleness without holding array references
        self.mutation_count = 0

    # ----------------------------------------------------------- sizing ----
    def __len__(self) -> int:
        """Number of live objects."""
        return int(self._valid.sum())

    @property
    def repository_size(self) -> int:
        """1 + highest slot ever used (reference Repository::size)."""
        return self._size

    def _ensure_capacity(self, n: int) -> None:
        if n <= self._x.shape[0]:
            return
        cap = self._x.shape[0]
        while cap < n:
            cap *= 2
        x = np.full((cap, self.d_pad), self._pad_value, dtype=self._dtype)
        x[: self._x.shape[0]] = self._x
        self._x = x
        valid = np.zeros((cap,), dtype=bool)
        valid[: self._valid.shape[0]] = self._valid
        self._valid = valid
        self._dirty = True

    # ---------------------------------------------------------- mutation ----
    def _prepare(self, v: np.ndarray) -> np.ndarray:
        v = np.asarray(v)
        if v.ndim == 1:
            v = v[None, :]
        if self.sparse:
            # -1-padded sorted id sets of width <= dimension
            if v.shape[-1] > self.dimension:
                raise ValueError(
                    f"sparse width {v.shape[-1]} exceeds dimension {self.dimension}"
                )
            big = np.iinfo(np.int32).max
            out = np.full((v.shape[0], self.d_pad), -1, np.int32)
            out[:, : v.shape[-1]] = np.sort(np.where(v < 0, big, v), axis=-1)
            out[out == big] = -1
            return out
        if v.shape[-1] != self.dimension:
            raise ValueError(
                f"dimension mismatch: got {v.shape[-1]}, want {self.dimension}"
            )
        out = np.zeros((v.shape[0], self.d_pad), dtype=self._dtype)
        if self.normalize:
            vf = v.astype(np.float64)
            norms = np.linalg.norm(vf, axis=-1, keepdims=True)
            if np.any(norms == 0):
                raise ValueError("cannot normalize a zero vector")
            out[:, : self.dimension] = (vf / norms).astype(self._dtype)
        else:
            out[:, : self.dimension] = v.astype(self._dtype)
        return out

    def insert(self, v: np.ndarray) -> int:
        """Insert one vector; returns its 1-based id (reuses removed slots,
        reference Common.h:1747-1760)."""
        return int(self.batch_insert(v)[0])

    def batch_insert(self, vs: np.ndarray) -> np.ndarray:
        """Insert many vectors; returns their 1-based ids.  With the
        tracer's build family on, the host span ``store.fill`` covers the
        rows' preparation and their write into the store."""
        with trace.span("store.fill", trace.BUILD):
            rows = self._prepare(vs)
            n = rows.shape[0]
            ids = np.empty((n,), dtype=np.int32)
            i = 0
            while self._free and i < n:
                ids[i] = heapq.heappop(self._free)
                i += 1
            fresh = n - i
            if fresh:
                start = self._size
                self._size += fresh
                self._ensure_capacity(self._size)
                ids[i:] = np.arange(start, start + fresh, dtype=np.int32)
            self._x[ids] = rows
            self._valid[ids] = True
        self._dirty = True
        self.mutation_count += 1
        return ids

    def remove(self, oid: int) -> None:
        """Free ``oid``'s slot for reuse (Common.h:1761-1774)."""
        if not self.contains(oid):
            raise KeyError(f"no such object id: {oid}")
        self._valid[oid] = False
        self._x[oid] = self._pad_value
        heapq.heappush(self._free, int(oid))
        self._dirty = True
        self.mutation_count += 1

    def get(self, oid: int) -> np.ndarray:
        if not self.contains(oid):
            raise KeyError(f"no such object id: {oid}")
        return np.array(self._x[oid, : self.dimension])

    def contains(self, oid: int) -> bool:
        return 0 < oid < self._size and bool(self._valid[oid])

    # ------------------------------------------------------------ device ----
    def device_arrays(self):
        """(x [cap, d_pad], valid [cap] bool, sqnorm [cap] f32 or None) on
        the store's device, re-uploaded whole when the host copy changed.
        x is bf16 for a BFLOAT16 store, else the narrowest lossless dtype
        (every distance casts to f32, so results are equal); sqnorm is kept
        for L2, Cosine, Angle and Poincare."""
        if self._dirty or self._device_x is None:
            if self.object_type == ObjectType.BFLOAT16:
                dx = torch.from_numpy(self._x).to(self.device).to(torch.bfloat16)
            else:
                # copy=True: on the CPU a plain .to() would alias the host array
                dx = torch.from_numpy(narrow_host(self._x)).to(self.device, copy=True)
            self._device_x = dx
            self._device_valid = torch.from_numpy(self._valid).to(
                self.device, copy=True
            )
            self._device_sqnorm = (
                D.sq_norms(dx) if self.metric in SQNORM_METRICS else None
            )
            self._dirty = False
        return self._device_x, self._device_valid, self._device_sqnorm

    def release_device(self) -> None:
        """Drop the cached device arrays."""
        self._device_x = self._device_valid = self._device_sqnorm = None
        self._dirty = True

    def prepare_queries_host(self, q: np.ndarray) -> np.ndarray:
        """Pad (and for the Normalized* metrics normalize) dense queries on
        the host like stored objects (ObjectSpaceRepository.h:560-618); a
        zero query keeps norm 1."""
        q = np.asarray(q, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.shape[-1] != self.dimension:
            raise ValueError(
                f"query dimension mismatch: got {q.shape[-1]}, want {self.dimension}"
            )
        if self.normalize:
            norms = np.linalg.norm(q, axis=-1, keepdims=True)
            norms[norms == 0] = 1.0
            q = q / norms
        out = np.zeros((q.shape[0], self.d_pad), dtype=self._dtype)
        out[:, : self.dimension] = q.astype(self._dtype)
        return out

    def prepare_queries(self, q: np.ndarray) -> torch.Tensor:
        """Host prep + device upload (see prepare_queries_host); a sparse
        store takes id sets and packs them like stored objects."""
        if self.sparse:
            host = self._prepare(np.asarray(q, dtype=np.int64))
        else:
            host = self.prepare_queries_host(q)
        return torch.from_numpy(host).to(self.device)

    # -------------------------------------------------------- persistence ----
    def state_dict(self) -> dict:
        return {
            "x": self._x[: self._size],
            "valid": self._valid[: self._size],
            "free": np.asarray(sorted(self._free), dtype=np.int32),
            "dimension": self.dimension,
            "metric": int(self.metric),
            "object_type": int(self.object_type),
        }

    @classmethod
    def from_state(cls, state: dict, device="cuda", copy: bool = True) -> "VectorStore":
        """A store holding ``state`` (``state_dict``'s keys).  ``copy=False``
        adopts the caller's row array as it is, e.g. a copy-on-write
        ``np.load(mmap_mode="c")`` view whose pages reader processes share;
        growth past it moves the rows into a private array
        (``_ensure_capacity``), and the device copy uploads them as usual
        (ngt_tpu/store.py:296-318)."""
        n = state["x"].shape[0]
        vs = cls(
            dimension=int(state["dimension"]),
            metric=DistanceType(int(state["metric"])),
            object_type=ObjectType(int(state["object_type"])),
            capacity=max(n, 16) if copy else 16,
            device=device,
        )
        if copy:
            vs._x[:n] = state["x"]
            vs._valid[:n] = state["valid"]
        else:
            vs._x = state["x"]
            vs._valid = np.array(state["valid"])
        vs._size = n
        vs._free = [int(i) for i in state["free"]]
        heapq.heapify(vs._free)
        vs._dirty = True
        return vs
