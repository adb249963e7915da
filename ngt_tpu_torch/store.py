"""VectorStore — the object space as dense arrays (the port's counterpart of
``ngt_tpu/store.py``).

One host numpy matrix is authoritative (append in place, geometric growth)
and is mirrored to a device tensor on demand.  The reference's conventions
are kept, so the saved arrays equal the JAX package's:

* ids are 1-based; slot 0 is a dummy row (reference Common.h:1711) and the
  validity mask keeps it (and removed rows) out of every search;
* removed ids go to a free list reused by later inserts
  (``Repository::removedList``, Common.h:1747-1774);
* the feature dim is zero-padded to a multiple of 128 (``d_pad``; the
  analogue of ``getPaddedDimension``, ObjectSpace.h:249).

This slice stores float32 objects under the L2 metric; other object types
and metrics raise ``NotImplementedError`` (ROADMAP Queue 1, M2/M3).
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

from ngt_tpu_torch.ops import distances as D
from ngt_tpu_torch.ops.bruteforce import pad_dim
from ngt_tpu_torch.properties import DistanceType, ObjectType


class VectorStore:
    #: sparse id-set rows (SPARSE_JACCARD) are not ported (ROADMAP M3): the
    #: port's store is always dense
    sparse = False

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
        if ObjectType(object_type) != ObjectType.FLOAT:
            raise NotImplementedError(
                f"object type {ObjectType(object_type).name} is not ported "
                "yet (ROADMAP Queue 1, M3)"
            )
        D._check_metric(metric)
        self.dimension = int(dimension)
        self.metric = DistanceType(metric)
        self.object_type = ObjectType(object_type)
        self.d_pad = pad_dim(dimension)
        self.device = torch.device(device)
        cap = max(int(capacity), 16)
        self._x = np.zeros((cap, self.d_pad), dtype=np.float32)
        self._valid = np.zeros((cap,), dtype=bool)
        self._size = 1  # next fresh slot; slot 0 is the dummy
        self._free: list[int] = []  # min-heap of reusable ids
        self._device_x: torch.Tensor | None = None
        self._device_valid: torch.Tensor | None = None
        self._device_sqnorm: torch.Tensor | None = None
        self._dirty = True
        #: bumped on every insert, so derived structures (the quantized
        #: codes) detect staleness without holding array references
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
        x = np.zeros((cap, self.d_pad), dtype=np.float32)
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
        if v.shape[-1] != self.dimension:
            raise ValueError(
                f"dimension mismatch: got {v.shape[-1]}, want {self.dimension}"
            )
        out = np.zeros((v.shape[0], self.d_pad), dtype=np.float32)
        out[:, : self.dimension] = v.astype(np.float32)
        return out

    def insert(self, v: np.ndarray) -> int:
        """Insert one vector; returns its 1-based id (reuses removed slots,
        reference Common.h:1747-1760)."""
        return int(self.batch_insert(v)[0])

    def batch_insert(self, vs: np.ndarray) -> np.ndarray:
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

    def get(self, oid: int) -> np.ndarray:
        if not (0 < oid < self._size) or not self._valid[oid]:
            raise KeyError(f"no such object id: {oid}")
        return np.array(self._x[oid, : self.dimension])

    # ------------------------------------------------------------ device ----
    def device_arrays(self):
        """(x [cap, d_pad] f32, valid [cap] bool, sqnorm [cap] f32) on the
        store's device, re-uploaded whole when the host copy changed."""
        if self._dirty or self._device_x is None:
            # copy=True: on the CPU a plain .to() would alias the host arrays
            self._device_x = torch.from_numpy(self._x).to(self.device, copy=True)
            self._device_valid = torch.from_numpy(self._valid).to(
                self.device, copy=True
            )
            self._device_sqnorm = D.sq_norms(self._device_x)
            self._dirty = False
        return self._device_x, self._device_valid, self._device_sqnorm

    def release_device(self) -> None:
        """Drop the cached device arrays."""
        self._device_x = self._device_valid = self._device_sqnorm = None
        self._dirty = True

    def prepare_queries_host(self, q: np.ndarray) -> np.ndarray:
        """Pad queries on the host like stored objects."""
        q = np.asarray(q, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.shape[-1] != self.dimension:
            raise ValueError(
                f"query dimension mismatch: got {q.shape[-1]}, want {self.dimension}"
            )
        out = np.zeros((q.shape[0], self.d_pad), dtype=np.float32)
        out[:, : self.dimension] = q
        return out

    def prepare_queries(self, q: np.ndarray) -> torch.Tensor:
        """Host prep + device upload (see prepare_queries_host)."""
        return torch.from_numpy(self.prepare_queries_host(q)).to(self.device)

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
    def from_state(cls, state: dict, device="cuda") -> "VectorStore":
        n = state["x"].shape[0]
        vs = cls(
            dimension=int(state["dimension"]),
            metric=DistanceType(int(state["metric"])),
            object_type=ObjectType(int(state["object_type"])),
            capacity=max(n, 16),
            device=device,
        )
        vs._x[:n] = state["x"]
        vs._valid[:n] = state["valid"]
        vs._size = n
        vs._free = [int(i) for i in state["free"]]
        heapq.heapify(vs._free)
        vs._dirty = True
        return vs
