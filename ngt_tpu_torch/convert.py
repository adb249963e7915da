"""Carry an index's state between the JAX package and the port as numpy
arrays — the arrays of ``VectorStore.state_dict`` (float32, uint8 or
sparse int32 rows; a BFLOAT16 store's float32 host rows),
``GraphStore.state_dict``, ``Seeder.rep_ids`` and the reps' squared norms,
the store's free-slot list and mutation count, plus the property fields,
a quantized graph's codes, mode, scale, block width and product quantizer
(codebooks and mean), and an IVFPQ index's centroids, codebooks, mean,
``global_range``, assignments, packed codes, ids, liveness and raw rows.
Tests and the card-against-CPU checks use it to give both packages (or
both devices) the same graph, the same slots to reuse, the same codebooks
and the same codes.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from ngt_tpu_torch.graph.storage import GraphStore
from ngt_tpu_torch.index import Index
from ngt_tpu_torch.properties import DistanceType, Property
from ngt_tpu_torch.quant.ivfpq import IVFPQIndex
from ngt_tpu_torch.quant.pq import ProductQuantizer
from ngt_tpu_torch.quant.qgraph import QuantizedGraphIndex
from ngt_tpu_torch.store import VectorStore


def _property(prop_dict: dict) -> Property:
    prop = Property()
    for key, val in prop_dict.items():
        if key in Property._ENUM_FIELDS:
            val = Property._ENUM_FIELDS[key](int(val))
        setattr(prop, key, val)
    return prop


def from_ngt_tpu_arrays(objects, valid, nbr_ids, nbr_dist, degree, has_node,
                        rep_ids, prop_dict, device="cuda", free=None,
                        rep_sq=None, mutation_count=0) -> Index:
    """A port ``Index`` holding the given state: ``objects`` [n, d_pad] in
    the store's dtype and ``valid`` [n] (row 0 the dummy slot), the
    adjacency arrays of n rows, the seed representative ids (with their
    squared norms ``rep_sq`` when given, else computed), a dict of
    ``Property`` fields, the free slots ``free`` (reused smallest first by
    later inserts) and the store's ``mutation_count``."""
    prop = _property(prop_dict)
    idx = Index(prop=prop, device=device)
    idx.store = VectorStore.from_state(
        {
            "x": np.asarray(objects),
            "valid": np.asarray(valid, bool),
            "free": np.zeros(0, np.int32) if free is None else np.asarray(free),
            "dimension": prop.dimension,
            "metric": int(prop.distance_type),
            "object_type": int(prop.object_type),
        },
        device=device,
    )
    idx.store.mutation_count = int(mutation_count)
    idx.graph = GraphStore.from_state({
        "nbr_ids": nbr_ids, "nbr_dist": nbr_dist, "degree": degree,
        "has_node": has_node, "e_max": np.asarray(nbr_ids).shape[1],
    })
    idx.graph.ensure_capacity(idx.store._x.shape[0])
    if len(rep_ids):
        idx.seeder.set_representatives(np.asarray(rep_ids, np.int32), idx.store._x)
        if rep_sq is not None:
            idx.seeder._rep_sq = torch.from_numpy(
                np.array(rep_sq, np.float32)).to(idx.device)
    return idx


def to_numpy_state(index: Index) -> dict:
    """The keyword arguments of ``from_ngt_tpu_arrays`` (without
    ``device``) for ``index``; enum fields of ``prop_dict`` as ints."""
    n = index.store.repository_size
    ss = index.store.state_dict()
    gs = index.graph.state_dict(n)
    prop = {
        f.name: int(v) if isinstance(v, enum.IntEnum) else v
        for f in dataclasses.fields(index.prop)
        for v in [getattr(index.prop, f.name)]
    }
    return {
        "objects": ss["x"], "valid": ss["valid"], "free": ss["free"],
        "nbr_ids": gs["nbr_ids"], "nbr_dist": gs["nbr_dist"],
        "degree": gs["degree"], "has_node": gs["has_node"],
        "rep_ids": index.seeder.rep_ids, "prop_dict": prop,
        "rep_sq": (None if index.seeder._rep_sq is None
                   else index.seeder._rep_sq.cpu().numpy()),
        "mutation_count": index.store.mutation_count,
    }


def pq_from_state(state: dict, device="cuda") -> ProductQuantizer:
    """A port ``ProductQuantizer`` from a ``state_dict`` of either
    package's (codebooks, mean, dsub, ksub, dimension as numpy or ints)."""
    return ProductQuantizer.from_state(state, device=device)


def qg_from_ngt_tpu_state(index: Index, mode: str, sq_scale: float, codes,
                          block_edges: int = 0, pq_state: dict | None = None,
                          ) -> QuantizedGraphIndex:
    """A port ``QuantizedGraphIndex`` over ``index`` holding a reference
    quantized graph's state: its ``mode``, ``sq_scale``, codes as numpy
    ([n or cap, d_pad] int8, uint8 for u8-exact codes, or [n or cap,
    ceil(M/2)] packed pq4 codes; padded to the store's capacity here),
    ``block_edges`` and, for pq4, its quantizer's ``state_dict``."""
    codes = np.asarray(codes)
    full = np.zeros((index.store._x.shape[0], codes.shape[1]), codes.dtype)
    full[: codes.shape[0]] = codes
    pq = None if pq_state is None else pq_from_state(pq_state, index.device)
    return QuantizedGraphIndex(index, full, mode=mode, sq_scale=sq_scale,
                               block_edges=block_edges, pq=pq)


#: the IVFPQIndex fields ``ivfpq_state`` carries besides its arrays
_IVF_META = ("dimension", "n_centroids", "raw_store", "raw_path", "rebuild_factor",
             "train_sample", "device_refine_max_bytes", "centroid_mode")


def ivfpq_state(ivf) -> dict:
    """The state of a built IVFPQ index of either package as numpy and
    plain values: the keyword arguments of ``ivfpq_from_state``."""
    st = {k: getattr(ivf, k) for k in _IVF_META}
    st.update(
        metric=int(ivf.metric), pq=ivf.pq.state_dict(),
        centroids=np.asarray(ivf.centroids, np.float32),
        global_range=float(ivf.global_range), assign=ivf._assign, codes=ivf._codes,
        ids=ivf._ids, valid=ivf._valid, next_id=int(ivf._next_id),
        trained_size=int(ivf._trained_size),
        raw=None if ivf._raw is None else np.asarray(ivf._raw, np.float32),
    )
    return st


def ivfpq_from_state(pq, centroids, global_range, assign, codes, ids, valid,
                     next_id, trained_size, raw, metric, device="cuda",
                     **meta) -> IVFPQIndex:
    """A port ``IVFPQIndex`` on ``device`` holding the given state
    (``ivfpq_state``); a raw store "mmap" writes ``raw`` to its
    ``raw_path``."""
    ivf = IVFPQIndex(
        meta["dimension"], n_centroids=meta["n_centroids"], dsub=int(pq["dsub"]),
        ksub=int(pq["ksub"]), metric=DistanceType(int(metric)), device=device,
        **{k: meta[k] for k in _IVF_META[2:]},
    )
    ivf.pq = pq_from_state(pq, device)
    ivf.centroids = np.array(centroids, np.float32)
    ivf.global_range = float(global_range)
    ivf._assign = np.array(assign, np.int32)
    ivf._codes = np.array(codes, np.uint8)
    ivf._ids = np.array(ids, np.int64)
    ivf._valid = np.array(valid, bool)
    ivf._next_id, ivf._trained_size = int(next_id), int(trained_size)
    if raw is not None and ivf.raw_store == "mmap":
        ivf._append_raw(np.asarray(raw, np.float32))
    elif raw is not None and ivf.raw_store != "none":
        ivf._raw = np.array(raw, np.float32)
    return ivf
