"""The port's export stream, import and memory-mapped open
(``ngt_tpu_torch/index.py`` ``export_index`` / ``import_index`` /
``_import_v1`` / ``open_index(memory_mapped=True)``, the host library's text
codecs in ``native.py``) against the JAX package's, on the CPU, on the same
numpy inputs:

* the host library's TSV parser, row formatters and row parsers give
  byte-equal output to the reference's native library on random rows with
  removed rows, ``-0.0``, large and tiny values and integral rows;
* two indexes carried from the reference into the port by convert.py (an
  ANNG with removed rows and an ONNG) export the same bytes from both
  packages, to a text and to a binary stream;
* each package imports the other's export into equal arrays (objects,
  validity, free slots, adjacency, seeds) and equal search ids;
* a legacy v1 stream (vectors only, holes as ``-``) imports alike into both
  packages, which rebuild the graph from it;
* ``open_index(memory_mapped=True)`` of a directory the reference saved
  gives the plain open's search ids, and an insert into a freed slot and an
  append leave the files unchanged.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import io
import json
import os

import numpy as np
import pytest
import ref_native_build  # noqa: F401  (builds the reference's library under a lock)

import ngt_tpu
import ngt_tpu_torch
from ngt_tpu import native as JN
from ngt_tpu_torch import convert
from ngt_tpu_torch import native as TN

#: 512 rows: the reference's bulk scan pads a build's rows to the next power
#: of two, so 600 would cost it twice the scan of 512
N, DIM = 512, 16


def carry(j):
    """A CPU port Index holding the reference index ``j``'s state."""
    n = j.store.repository_size
    ss, gs = j.store.state_dict(), j.graph.state_dict(n)
    prop = {f.name: int(v) if isinstance(v, enum.IntEnum) else v
            for f in dataclasses.fields(j.prop) for v in [getattr(j.prop, f.name)]}
    return convert.from_ngt_tpu_arrays(
        objects=ss["x"], valid=ss["valid"], free=ss["free"],
        nbr_ids=gs["nbr_ids"], nbr_dist=gs["nbr_dist"], degree=gs["degree"],
        has_node=gs["has_node"], rep_ids=j.seeder.rep_ids, prop_dict=prop,
        mutation_count=j.store.mutation_count, device="cpu",
    )


def arrays(idx) -> dict:
    """The state an export carries, as numpy arrays."""
    n = idx.store.repository_size
    return {"x": idx.store._x[:n], "valid": idx.store._valid[:n],
            "free": np.sort(np.asarray(idx.store._free, np.int64)),
            "nbr_ids": idx.graph.nbr_ids[:n], "nbr_dist": idx.graph.nbr_dist[:n],
            "degree": idx.graph.degree[:n], "has_node": idx.graph._has_node[:n],
            "rep_ids": idx.seeder.rep_ids, "prf": idx.prop.to_prf()}


def assert_same(a, b, dist_rtol: float = 0.0) -> None:
    """Equal state; with ``dist_rtol`` the edge distances to that relative
    tolerance (each package sums the squares of a float row in its own
    order)."""
    a, b = arrays(a), arrays(b)
    assert a.keys() == b.keys()
    for key in a:
        if key == "prf":
            assert a[key] == b[key]
        elif key == "nbr_dist" and dist_rtol:
            np.testing.assert_allclose(b[key], a[key], rtol=dist_rtol, err_msg=key)
        else:
            np.testing.assert_array_equal(b[key], a[key], err_msg=key)


# --------------------------------------------------------------- codecs ---


def _rows(kind: str, rng) -> np.ndarray:
    x = rng.normal(size=(257, 9)).astype(np.float32)
    if kind == "integral":
        x = np.rint(x * 100)
    elif kind == "extremes":
        x[::3] *= np.float32(3e37)
        x[1::3] *= np.float32(1e-38)
        x[5, :] = -0.0
        x[6, 0] = np.float32(16777216.0)       # past the digit loop's range
        x[7, 0] = np.float32(-16777215.0)      # the loop's last integer
    return x


@pytest.mark.parametrize("kind", ["normal", "integral", "extremes"])
def test_codecs_byte_equal(kind, tmp_path):
    """format_obj_rows / format_graph_rows / parse_obj_rows /
    parse_graph_rows / tsv_parse (with tsv_count_rows) of both libraries."""
    assert JN.available(), "the reference's native library did not load"
    rng = np.random.default_rng(len(kind))
    x = _rows(kind, rng)
    valid = rng.random(len(x)) > 0.2
    obj = TN.format_obj_rows(x, valid)
    assert obj == JN.format_obj_rows(x, valid)
    for got, want in zip(TN.parse_obj_rows(obj, len(x), x.shape[1]),
                         JN.parse_obj_rows(obj, len(x), x.shape[1])):
        np.testing.assert_array_equal(got, want)
    e = 7
    nbr = rng.integers(-1, 1 << 20, size=(len(x), e)).astype(np.int32)
    dist = np.abs(x[:, :e])
    deg = rng.integers(0, e + 1, len(x)).astype(np.int32)
    has = rng.random(len(x)) > 0.1
    grp = TN.format_graph_rows(nbr, dist, deg, has)
    assert grp == JN.format_graph_rows(nbr, dist, deg, has)
    for got, want in zip(TN.parse_graph_rows(grp, len(x), e),
                         JN.parse_graph_rows(grp, len(x), e)):
        np.testing.assert_array_equal(got, want)
    path = str(tmp_path / "rows.tsv")
    with open(path, "wb") as fh:   # extra columns, blank and header lines
        fh.write(b"# a header\n\n" + obj.replace(b"+", b"").replace(b"-\n", b"1\t2\n"))
    np.testing.assert_array_equal(TN.parse_tsv(path, 5), JN.parse_tsv(path, 5))


def test_codec_inputs_checked(tmp_path):
    """Malformed streams and impossible rows raise; nothing falls back."""
    with pytest.raises(ValueError, match="object rows"):
        TN.parse_obj_rows(b"+1\t2\n*\n", 2, 2)
    with pytest.raises(ValueError, match="graph rows"):
        TN.parse_graph_rows(b"3;1.5\n", 1, 4)
    with pytest.raises(ValueError, match="degree"):
        TN.format_graph_rows(np.zeros((2, 3), np.int32), np.zeros((2, 3), np.float32),
                             np.array([4, 0], np.int32), np.ones(2, bool))
    with pytest.raises(OSError):
        TN.parse_tsv(str(tmp_path / "missing.tsv"), 4)


# -------------------------------------------------------------- indexes ---


@pytest.fixture(scope="module")
def ref_indexes():
    """An ANNG with removed rows and an ONNG, built by the reference."""
    from ngt_tpu.optimizer import GraphOptimizer

    data = np.random.default_rng(21).normal(size=(N, DIM)).astype(np.float32)
    anng = ngt_tpu.create(None, dimension=DIM)
    anng.batch_insert(data, build=True)
    onng = ngt_tpu.Index.import_index(_export(anng, binary=True))   # a copy
    for oid in (5, 99, 100, 417):
        anng.remove(oid)
    GraphOptimizer(out_edges=8, in_edges=24, tune_parameters=False).execute(onng)
    return {"anng": anng, "onng": onng}


def _export(idx, binary: bool):
    fh = io.BytesIO() if binary else io.StringIO()
    idx.export_index(fh)
    fh.seek(0)
    return fh


@pytest.mark.parametrize("binary", [False, True], ids=["text", "binary"])
@pytest.mark.parametrize("which", ["anng", "onng"])
def test_export_bytes_equal(ref_indexes, which, binary):
    j = ref_indexes[which]
    t = carry(j)
    assert_same(j, t)
    assert _export(t, binary).getvalue() == _export(j, binary).getvalue()


@pytest.mark.parametrize("which", ["anng", "onng"])
def test_import_both_directions(ref_indexes, which, tmp_path):
    """Each package imports the other's stream into the same arrays, saves
    them, and answers the same queries alike."""
    j = ref_indexes[which]
    t = carry(j)
    t_from_j = ngt_tpu_torch.Index.import_index(_export(j, binary=True), device="cpu",
                                                path=str(tmp_path / "t"))
    j_from_t = ngt_tpu.Index.import_index(_export(t, binary=False))
    assert_same(j, t_from_j)
    assert_same(j, j_from_t)
    again = ngt_tpu_torch.open_index(str(tmp_path / "t"), device="cpu")
    assert_same(j, again)
    q = np.random.default_rng(4).normal(size=(32, DIM)).astype(np.float32)
    want = j.batch_search(q, size=10, epsilon=0.1)[0]
    for idx in (t_from_j, again):
        np.testing.assert_array_equal(idx.batch_search(q, size=10, epsilon=0.1)[0], want)
    with pytest.raises(KeyError):
        t_from_j.get_object(5 if which == "anng" else N)


def test_import_v1_stream(tmp_path):
    """The legacy vectors-only form that ``_import_v1`` reads: the header,
    the properties, then ``+v\\tv...`` per object and ``-`` for a hole; both
    packages rebuild the graph and free the holes alike: equal ids, edge
    distances to float32 rounding (rtol 1e-6: each package's exact re-rank
    sums a row's squares in its own order)."""
    prop = ngt_tpu_torch.create(None, dimension=DIM, device="cpu").prop
    data = np.random.default_rng(8).normal(size=(256, DIM)).astype(np.float32)
    holes = {3, 150, 255}
    lines = ["# ngt_tpu export", json.dumps(prop.to_prf())]
    lines += ["-" if i in holes else "+" + "\t".join(repr(float(v)) for v in row)
              for i, row in enumerate(data)]
    text = "\n".join(lines) + "\n"
    j = ngt_tpu.Index.import_index(io.StringIO(text))
    t = ngt_tpu_torch.Index.import_index(io.BytesIO(text.encode()), device="cpu",
                                         path=str(tmp_path / "v1"))
    assert_same(j, t, dist_rtol=1e-6)
    assert len(t) == 253 and t.verify() == []
    q = data[::25] + np.float32(0.01)
    np.testing.assert_array_equal(t.batch_search(q, size=5)[0], j.batch_search(q, size=5)[0])


def _digest(path: str) -> dict:
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as fh:
            out[name] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_memory_mapped_open(ref_indexes, tmp_path):
    """The reference's saved directory opens mapped: the same search ids as
    a plain open and as the reference; a removal, an insert into the freed
    slot and an append past the mapped rows work, and the files stay as
    they were."""
    path = str(tmp_path / "saved")
    j = ref_indexes["anng"]
    j.save(path)
    before = _digest(path)
    q = np.random.default_rng(6).normal(size=(24, DIM)).astype(np.float32)
    want = j.batch_search(q, size=10, epsilon=0.1)[0]
    plain = ngt_tpu_torch.open_index(path, device="cpu")
    mm = ngt_tpu_torch.open_index(path, memory_mapped=True, device="cpu")
    assert isinstance(mm.store._x, np.memmap) and isinstance(mm.graph.nbr_ids, np.memmap)
    for idx in (plain, mm):
        np.testing.assert_array_equal(idx.batch_search(q, size=10, epsilon=0.1)[0], want)
    mm.remove(7)
    slot = mm.insert(np.zeros(DIM, np.float32))            # the freed slot
    assert isinstance(mm.store._x, np.memmap)              # written in the private map
    fresh = mm.insert(np.ones(DIM, np.float32))            # past the mapped rows
    mm.build_index()
    assert mm.search(np.zeros(DIM, np.float32), size=1)[0][0] == slot
    assert mm.search(np.ones(DIM, np.float32), size=1)[0][0] == fresh
    assert mm.verify() == []
    assert _digest(path) == before
    np.testing.assert_array_equal(
        ngt_tpu_torch.open_index(path, memory_mapped=True, device="cpu")
        .batch_search(q, size=10, epsilon=0.1)[0], want)
