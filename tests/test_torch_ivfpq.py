"""The port's IVFPQ index (ngt_tpu_torch/quant/ivfpq.py) and the crossover
of ``Index.batch_search`` onto an auto-built IVFPQ mirror past the
quantized-graph size ceiling, against the JAX package on the CPU.

* A reference index built on tests/test_quant.py's ivf_setup data, its
  state carried into the port by convert.py: ids equal and distances to
  rtol 1e-5 in every aggregation mode and with the raw rows in host
  memory or an mmap file, whatever the query chunk size; the same
  incremental inserts (rows beyond ``global_range`` create centroids),
  removals and ``compress`` in both packages leave equal centroids, codes,
  ids and results.  Each package opens the other's ``ivfpq.npz``.
* The port's own build (its k-means draws another random stream than the
  reference's) reaches the reference's own recall less 0.02.
* The crossover (tests/test_index.py::test_qg_ivfpq_crossover's data):
  routing, the mirror rebuilt after a mutation with no removed id served,
  ``search_fallback="exact"`` opting out; recall against exact k-NN at
  least the reference's on the same data less 0.02.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest

import ngt_tpu
import ngt_tpu_torch
from ngt_tpu.quant.ivfpq import IVFPQIndex as JIVF
from ngt_tpu_torch import convert
from ngt_tpu_torch.ops.bruteforce import recall_at_k
from ngt_tpu_torch.quant import ivfpq as TI

MODES = ["approx", "lut", "cached-lut", "refine", "exact"]


@pytest.fixture(scope="module")
def ref():
    rng = np.random.default_rng(21)
    centers = rng.normal(size=(30, 24)).astype(np.float32) * 4
    data = (centers[rng.integers(0, 30, size=3000)]
            + rng.normal(size=(3000, 24)).astype(np.float32))
    q = (centers[rng.integers(0, 30, size=32)]
         + rng.normal(size=(32, 24)).astype(np.float32))
    j = JIVF(24, n_centroids=64, dsub=2, ksub=16)
    j.batch_insert(data)
    j.build()
    full = np.linalg.norm(q[:, None, :] - data[None, :, :], axis=-1)
    return SimpleNamespace(data=data, q=q, j=j, gt=np.argsort(full, axis=1)[:, :10])


def _port(j, tmp_path=None, raw_store=None):
    st = convert.ivfpq_state(j)
    if raw_store is not None:
        st["raw_store"] = raw_store
        st["raw_path"] = str(tmp_path / "raw.f32") if raw_store == "mmap" else None
    return convert.ivfpq_from_state(device="cpu", **st)


def _same(t_out, j_out):
    ti, td = t_out
    ji, jd = (np.asarray(a) for a in j_out)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_modes_match_jax(ref, mode):
    t = _port(ref.j)
    assert t.verify() == []
    kw = dict(size=10, nprobe=16, mode=mode)
    _same(t.batch_search(ref.q, **kw), ref.j.batch_search(ref.q, **kw))


@pytest.mark.parametrize("raw_store", ["host", "mmap"])
def test_raw_stores_match_jax(ref, tmp_path, raw_store):
    t = _port(ref.j, tmp_path, raw_store)
    assert t._device()["x"] is None   # the rows are not integral: a host gather
    for mode in ("refine", "exact"):
        kw = dict(size=10, nprobe=16, mode=mode)
        _same(t.batch_search(ref.q, **kw), ref.j.batch_search(ref.q, **kw))


def test_chunk_size_is_invisible(ref, monkeypatch):
    """Queries are independent: one query per chunk gives the ids and
    distances of one chunk for all."""
    t = _port(ref.j)
    whole = {m: t.batch_search(ref.q, size=10, nprobe=16, mode=m) for m in MODES}
    monkeypatch.setattr(TI, "SEARCH_BYTES", 1)
    assert t._query_chunk(t._device(), 16, 30, "exact") == 1
    for m in MODES:
        got = t.batch_search(ref.q, size=10, nprobe=16, mode=m)
        np.testing.assert_array_equal(got[0], whole[m][0])
        np.testing.assert_array_equal(got[1], whole[m][1])


def test_insert_remove_compress_match_jax(ref):
    """The same mutations in both packages: inserts near the clusters and
    far from them (dynamic centroids), removals, compress."""
    j = _reference_copy(ref.j)
    t = _port(j)
    rng = np.random.default_rng(4)
    near = ref.data[:40] + 0.1 * rng.normal(size=(40, 24)).astype(np.float32)
    far = 60.0 + rng.normal(size=(30, 24)).astype(np.float32)
    for rows in (near, far):
        j.batch_insert(rows)
        t.batch_insert(rows)
    assert len(t.centroids) > 64 and len(t.centroids) == len(j.centroids)
    np.testing.assert_allclose(t.centroids, j.centroids, rtol=1e-6)
    np.testing.assert_array_equal(t._assign, j._assign)
    np.testing.assert_array_equal(t._codes, j._codes)
    assert t.verify() == [] and not t.needs_rebuild()
    q = np.concatenate([ref.q, far[:4] + 0.05])
    _same(t.batch_search(q, size=10, nprobe=16), j.batch_search(q, size=10, nprobe=16))
    gone = np.arange(0, 3070, 37)
    assert t.remove(gone) == j.remove(gone) == len(gone)
    with pytest.raises(ValueError):
        t.remove([0])
    for mode in ("refine", "approx", "exact"):
        got = t.batch_search(q, size=10, nprobe=16, mode=mode)
        assert not np.isin(got[0], gone).any()
        _same(got, j.batch_search(q, size=10, nprobe=16, mode=mode))
    assert t.compress() == j.compress() == len(gone)
    assert t.size == j.size and t.verify() == []
    _same(t.batch_search(q, size=10, nprobe=16), j.batch_search(q, size=10, nprobe=16))
    rep, jrep = t.memory_report(), j.memory_report()
    assert rep == jrep
    assert t.quantization_error(sample=256) == pytest.approx(
        j.quantization_error(sample=256), rel=1e-5)


def _reference_copy(j):
    """A reference index with ``j``'s state (the module's index stays as
    it is)."""
    st = convert.ivfpq_state(j)
    c = JIVF(24, n_centroids=64, dsub=2, ksub=16)
    c.centroids, c.global_range = st["centroids"].copy(), st["global_range"]
    c._assign, c._codes = st["assign"].copy(), st["codes"].copy()
    c._ids, c._valid = st["ids"].copy(), st["valid"].copy()
    c._next_id, c._trained_size = st["next_id"], st["trained_size"]
    c._raw = st["raw"].copy()
    c.pq = j.pq
    return c


def test_port_build_and_mmap(ref, tmp_path):
    """The port's own build: recall at least the reference's own less 0.02;
    the mmap raw store (rows spilled to the file before the build) builds
    the same index as host memory, and takes inserts, rebuild and
    save/open."""
    t = TI.IVFPQIndex(24, n_centroids=64, dsub=2, ksub=16, device="cpu")
    t.batch_insert(ref.data)
    t.build()
    assert t.verify() == [] and set(t.timings) >= {"kmeans", "pq_fit", "assign_encode"}
    kw = dict(size=10, nprobe=16, mode="refine")
    rt = recall_at_k(t.batch_search(ref.q, **kw)[0], ref.gt, 10)
    rj = recall_at_k(ref.j.batch_search(ref.q, **kw)[0], ref.gt, 10)
    assert rt >= rj - 0.02, (rt, rj)
    m = TI.IVFPQIndex(24, n_centroids=64, dsub=2, ksub=16, raw_store="mmap",
                      raw_path=str(tmp_path / "raw.f32"), device="cpu")
    for s in range(0, len(ref.data), 700):
        m.batch_insert(ref.data[s : s + 700])
    assert m._pending == [] and os.path.getsize(tmp_path / "raw.f32") == ref.data.nbytes
    m.build()
    np.testing.assert_array_equal(m.centroids, t.centroids)
    np.testing.assert_array_equal(m._codes, t._codes)
    np.testing.assert_array_equal(m.batch_search(ref.q, **kw)[0], t.batch_search(ref.q, **kw)[0])
    m.batch_insert(ref.data[:64] + 0.01)
    m.rebuild()
    assert m.verify() == [] and m.size == len(ref.data) + 64
    m.save(str(tmp_path / "m"))
    back = TI.IVFPQIndex.open(str(tmp_path / "m"), device="cpu")
    np.testing.assert_array_equal(back.batch_search(ref.q, **kw)[0],
                                  m.batch_search(ref.q, **kw)[0])


def test_ivfpq_opens_in_the_other_package(ref, tmp_path):
    t = _port(ref.j)
    t.remove([3, 5])
    ref.j.save(str(tmp_path / "from_jax"))
    got = TI.IVFPQIndex.open(str(tmp_path / "from_jax"), device="cpu")
    assert got.verify() == [] and got.global_range == ref.j.global_range
    for mode in ("refine", "exact"):
        kw = dict(size=10, nprobe=16, mode=mode)
        _same(got.batch_search(ref.q, **kw), ref.j.batch_search(ref.q, **kw))
    t.save(str(tmp_path / "from_port"))
    back = JIVF.open(str(tmp_path / "from_port"))
    assert back.verify() == [] and back.live_size == t.live_size
    _same(t.batch_search(ref.q, size=10, nprobe=16), back.batch_search(ref.q, size=10, nprobe=16))


def test_crossover_matches_jax(tmp_path, monkeypatch):
    """Past NGT_TPU_QG_MAX_GB the auto route serves from the IVFPQ mirror
    in both packages (each trains its own), with recall against exact k-NN
    at least the reference's less 0.02 and exact distances."""
    rng = np.random.default_rng(42)
    data = rng.normal(size=(3000, 24)).astype(np.float32) * 10
    q = data[rng.choice(3000, 48, replace=False)] + rng.normal(size=(48, 24)).astype(np.float32)
    path = str(tmp_path / "idx")
    t = ngt_tpu_torch.create(path, dimension=24, device="cpu", search_qg_threshold=1000)
    t.batch_insert(data, build=True)
    t.save()
    j = ngt_tpu.open_index(path)
    monkeypatch.setenv("NGT_TPU_QG_MAX_GB", "0.0000001")
    monkeypatch.setenv("NGT_TPU_AUTO_IVFPQ_NPROBE", "96")
    monkeypatch.setenv("NGT_TPU_AUTO_IVFPQ_EXP", "30")
    gt, _ = t.batch_linear_search(q, size=10)
    ti, td = t.batch_search(q, size=10)
    ji, _ = j.batch_search(q, size=10)
    assert t._qg is None and t._ivfpq_mirror is not None and j._ivfpq_mirror is not None
    assert len(t._ivfpq_mirror.centroids) == len(j._ivfpq_mirror.centroids) == 256
    rt, rj = recall_at_k(ti, gt, 10), recall_at_k(np.asarray(ji), gt, 10)
    assert rt >= rj - 0.02 and rt >= 0.9, (rt, rj)
    np.testing.assert_allclose(td[:, 0], np.linalg.norm(data[ti[:, 0]] - q, axis=1), rtol=1e-4)
    # a mutation rebuilds the mirror; a removed id never comes back
    key0, mirror0 = t._ivfpq_key, t._ivfpq_mirror
    gone = ti[:8, 0]
    t.batch_remove(gone)
    ti2, _ = t.batch_search(q, size=10)
    assert t._ivfpq_key != key0 and t._ivfpq_mirror is not mirror0
    assert not np.isin(ti2, gone).any()
    again, _ = t.batch_search(q, size=10)
    np.testing.assert_array_equal(again, ti2)   # the mirror is reused as it is
    # opting out serves the exact route
    t.prop.search_fallback = "exact"
    t._ivfpq_mirror = None
    te, _ = t.batch_search(q, size=10)
    assert t._ivfpq_mirror is None
    t.prop.search_mode = "exact"
    np.testing.assert_array_equal(te, t.batch_search(q, size=10)[0])
