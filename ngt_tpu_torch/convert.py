"""Carry an index's state between the JAX package and the port as numpy
arrays — the arrays of ``VectorStore.state_dict`` (float32, uint8 or
sparse int32 rows; a BFLOAT16 store's float32 host rows),
``GraphStore.state_dict``, ``Seeder.rep_ids`` and the reps' squared norms,
the store's free-slot list and mutation count, plus the property fields,
and a quantized graph's codes, mode, scale and block width.  Tests use it
to give both packages the same graph, the same slots to reuse and the same
codes.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from ngt_tpu_torch.graph.storage import GraphStore
from ngt_tpu_torch.index import Index
from ngt_tpu_torch.properties import Property
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


def qg_from_ngt_tpu_state(index: Index, mode: str, sq_scale: float, codes,
                          block_edges: int = 0) -> QuantizedGraphIndex:
    """A port ``QuantizedGraphIndex`` over ``index`` holding a reference
    quantized graph's state: its ``mode``, ``sq_scale``, codes as numpy
    ([n or cap, d_pad] int8, or uint8 for u8-exact codes; padded to the
    store's capacity here) and ``block_edges``."""
    codes = np.asarray(codes)
    full = np.zeros((index.store._x.shape[0], codes.shape[1]), codes.dtype)
    full[: codes.shape[0]] = codes
    return QuantizedGraphIndex(index, full, mode=mode, sq_scale=sq_scale,
                               block_edges=block_edges)
