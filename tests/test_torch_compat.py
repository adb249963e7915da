"""The port's compatibility shims (``ngt_tpu_torch.ngtpy``, ``.base`` and
``.annb``, each on ``device="cpu"``) against the JAX package's (as in
tests/test_compat.py and tests/test_annb.py), on the CPU, on the same
numpy inputs.  The rows are integers, so distances are exact in float32
and ids and distances must be equal:

* ``ngtpy.Index``: insert, search, linear search, get_object, remove, save
  and reopen; ``ngtpy.Optimizer``: the ONNG it writes (rows and accuracy
  table) and its search ids at every stored edge; ``ngtpy.QuantizedIndex``:
  quantize and search;
* ``base.Index``: 1-based ids from ``insert_blob`` and ``insert_from_tsv``,
  search;
* the ann-benchmarks adapters ANNG, PANNG, ONNG and QG: ``query`` and
  ``batch_query`` results.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import ngt_tpu
import ngt_tpu.annb as JA
import ngt_tpu.base as JBASE
import ngt_tpu.ngtpy as JP
import ngt_tpu_torch
import ngt_tpu_torch.annb as TA
import ngt_tpu_torch.base as TBASE
import ngt_tpu_torch.ngtpy as TP

DIM = 16
CPU = {"device": "cpu"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data():
    return np.random.default_rng(12).integers(0, 64, size=(240, DIM)).astype(np.float32)


def _ngtpy_session(mod, kw, path, data):
    mod.create(path, DIM, **kw)
    index = mod.Index(path, **kw)
    index.batch_insert(data[:120])
    out = [index.get_num_of_objects(), index.insert(data[120]), index.get_object(33)]
    index.build_index()
    out += [index.search(data[33] + 1, size=5, epsilon=0.2),
            index.linear_search(data[33] + 1, size=3),
            index.search(data[7], size=4, with_distance=False)]
    index.remove(33)
    out.append(index.search(data[33] + 1, size=5, epsilon=0.3))
    index.save()
    index.close()
    again = mod.Index(path, **kw)
    out.append(again.search(data[34], size=5))
    return out


def test_ngtpy_index_matches_jax(data, tmp_path):
    got = _ngtpy_session(TP, CPU, str(tmp_path / "t"), data)
    want = _ngtpy_session(JP, {}, str(tmp_path / "j"), data)
    assert got == want
    assert got[3][0][0] == 33 and all(i != 33 for i, _ in got[6])


def test_ngtpy_optimizer_and_quantized_match_jax(data, tmp_path):
    """``Optimizer.execute`` tunes the search edge size by measured speed,
    so the ids are compared at every stored edge (``edge_size=0``).  On
    64 rows: the tuning searches its whole extracted query set."""
    data = data[:64]
    res = {}
    for name, mod, kw in (("jax", JP, {}), ("torch", TP, CPU)):
        src, out = str(tmp_path / name / "in"), str(tmp_path / name / "onng")
        mod.create(src, DIM, **kw)
        index = mod.Index(src, **kw)
        index.batch_insert(data)
        index.save()
        mod.Optimizer(num_of_outgoings=8, num_of_incomings=24, **kw).execute(src, out)
        onng = mod.Index(out, **kw)
        g = onng.index.graph
        n = onng.index.store.repository_size
        mod.QuantizedIndex.quantize(src, dimension_of_subvector=2, **kw)
        qidx = mod.QuantizedIndex(src, **kw)
        res[name] = [g.nbr_ids[:n], g.nbr_dist[:n], onng.index.prop.accuracy_table,
                     [onng.search(q, size=5, edge_size=0) for q in data[:20] + 1],
                     [qidx.search(q, size=5, epsilon=0.1) for q in data[:20] + 1]]
    for got, want in zip(res["torch"], res["jax"]):
        if isinstance(want, np.ndarray):
            np.testing.assert_array_equal(got, want)
        else:
            assert got == want
    assert res["torch"][4][5][0][0] == 5


def test_base_matches_jax(data, tmp_path):
    tsv = str(tmp_path / "more.tsv")
    np.savetxt(tsv, data[100:120], delimiter="\t", fmt="%.0f")
    res = {}
    for name, mod, kw in (("jax", JBASE, {}), ("torch", TBASE, CPU)):
        path = str(tmp_path / name)
        idx = mod.Index.create(path, DIM, **kw)
        ids = idx.insert_blob(data[:100])
        ids += idx.insert_from_tsv(tsv)
        found = [idx.search(q, k=3) for q in data[:10] + 1]
        idx.remove(5)
        idx.save()
        again = mod.Index.open(path, **kw)
        res[name] = [ids, found, again.search(data[4], k=3), again.get_object(6)]
    assert res["torch"] == res["jax"]
    assert res["torch"][0][0] == 1 and res["torch"][1][0][0].id == 1
    with pytest.raises(TBASE.APIError):
        TBASE.Index(str(tmp_path / "missing"), device="cpu")


#: the adapters' arguments; one creation edge size, so the reference's
#: bulk build compiles once for all four
ADAPTERS = {"ANNG": {}, "PANNG": {"edge": 6, "path_edge": 12},
            "ONNG": {"out_edges": 8, "in_edges": 24}, "QG": {}}


@pytest.mark.parametrize("cls", list(ADAPTERS))
def test_annb_adapter_matches_jax(data, cls):
    res = {}
    for name, mod, kw in (("jax", JA, {}), ("torch", TA, CPU)):
        algo = getattr(mod, cls)("euclidean", edge_size_for_creation=10, **ADAPTERS[cls], **kw)
        algo.fit(data[:128])
        algo.set_query_arguments(0.1)
        one = algo.query(data[123] + 1, 10)
        algo.batch_query(data[:40] + 1, 10)
        res[name] = [one, algo.get_batch_results()]
        assert algo.get_memory_usage() > 0
        algo.done()
    np.testing.assert_array_equal(res["torch"][0], res["jax"][0])
    assert len(res["torch"][1]) == 40
    for got, want in zip(res["torch"][1], res["jax"][1]):
        np.testing.assert_array_equal(got, want)
    assert 123 in set(res["torch"][0].tolist())
    assert str(getattr(TA, cls)("euclidean", device="cpu")).startswith("ngt_tpu_torch_")
    with pytest.raises(ValueError):
        TA._resolve_metric("mahalanobis")


def test_package_exports_match_jax():
    """What ``ngt_tpu/__init__.py`` exports for these modules."""
    for name in ("DistanceType", "ObjectType", "IndexType", "GraphType", "SeedType",
                 "Property", "Index", "create", "open_index", "enable_log",
                 "disable_log", "IVFPQIndex", "QuantizedGraphIndex"):
        assert hasattr(ngt_tpu, name) and hasattr(ngt_tpu_torch, name), name
    assert os.path.basename(ngt_tpu_torch.__file__) == "__init__.py"
