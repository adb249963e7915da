"""The port's Index (ngt_tpu_torch/index.py) end to end against the JAX
package, on the CPU: create -> batch_insert(build=True) -> batch_search on
the exact route gives equal ids; an index saved by either package opens in
the other and searches alike, the round-1 graph.npz layout included; the
port runs with JAX unimportable and imports neither JAX nor the JAX
package anywhere.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

import ngt_tpu
import ngt_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, DIM = 1800, 40


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(123)
    return (rng.standard_normal((N, DIM)).astype(np.float32),
            rng.standard_normal((50, DIM)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_index(data, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax") / "idx")
    idx = ngt_tpu.create(path, dimension=DIM, search_mode="exact")
    idx.batch_insert(data[0], build=True)
    idx.save()
    return idx


def test_end_to_end_matches_jax(data, jax_index):
    base, q = data
    t = ngt_tpu_torch.create(None, dimension=DIM, search_mode="exact", device="cpu")
    t.batch_insert(base, build=True)
    ti, td = t.batch_search(q, size=10)
    ji, jd = jax_index.batch_search(q, size=10)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(td, np.asarray(jd), rtol=1e-5)
    _, _, ts = t.batch_search(q, size=10, with_stats=True)
    _, _, js = jax_index.batch_search(q, size=10, with_stats=True)
    np.testing.assert_array_equal(ts["distance_count"], js["distance_count"])
    assert t.search(base[7], size=3)[0][0] == 7
    assert t.linear_search(base[7], size=3)[0][0] == 7


def test_jax_index_opens_in_port(data, jax_index):
    q = data[1]
    t = ngt_tpu_torch.open_index(jax_index.path, device="cpu")
    assert t.verify() == []
    ti, td = t.batch_search(q, size=10)
    ji, jd = jax_index.batch_search(q, size=10)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(td, np.asarray(jd), rtol=1e-5)


def test_port_index_opens_in_jax(data, tmp_path):
    base, q = data
    path = str(tmp_path / "port")
    t = ngt_tpu_torch.create(path, dimension=DIM, search_mode="exact", device="cpu")
    t.batch_insert(base, build=True)
    t.save()
    ti, td = t.batch_search(q, size=10)
    j = ngt_tpu.open_index(path)
    assert j.verify() == []
    ji, jd = j.batch_search(q, size=10)
    np.testing.assert_array_equal(np.asarray(ji), ti)
    np.testing.assert_allclose(np.asarray(jd), td, rtol=1e-5)
    # and back: the port reopens its own index with identical results
    t2 = ngt_tpu_torch.open_index(path, device="cpu")
    np.testing.assert_array_equal(t2.batch_search(q, size=10)[0], ti)


def test_unported_routes_raise(data, monkeypatch):
    base = data[0][:300]
    t = ngt_tpu_torch.create(None, dimension=DIM, device="cpu", search_qg_threshold=100)
    t.batch_insert(base, build=True)
    ids, _ = t.batch_search(base[:2])       # auto routing -> quantized graph
    assert t._qg is not None and list(ids[:, 0]) == [0, 1]
    # past the qg size ceiling: the IVFPQ mirror serves (M15, since ported);
    # the exact fallback serves as search_mode="exact" does
    monkeypatch.setenv("NGT_TPU_QG_MAX_GB", "1e-6")
    t._qg = None
    ids, _ = t.batch_search(base[:2])
    assert t._ivfpq_mirror is not None and list(ids[:, 0]) == [0, 1]
    t.prop.search_fallback = "exact"
    got = t.batch_search(base[:4])
    t.prop.search_mode = "exact"
    want = t.batch_search(base[:4])
    np.testing.assert_array_equal(got[0], want[0])
    monkeypatch.delenv("NGT_TPU_QG_MAX_GB")
    # a block budget too small for 8 sq8 columns picks pq4 codes (M12,
    # since ported)
    monkeypatch.setenv("NGT_TPU_QG_BLOCK_GB", "1e-6")
    t.prop.search_mode = "qg"
    t.batch_search(base[:2])
    assert t._qg.mode == "pq4"
    assert list(t.batch_insert(base[:5])) == [300, 301, 302, 303, 304]   # append
    # expected_accuracy (M14, since ported) reads the accuracy table, which
    # this index has none of, and says so as the reference does
    with pytest.raises(ValueError, match="accuracy table"):
        t.batch_search(base[:2], expected_accuracy=0.9)


def _legacy_dir(jax_index, path):
    """A copy of ``jax_index``'s directory in the round-1 layout: the graph
    and store arrays in one graph.npz with the reference's keys."""
    import shutil

    shutil.copytree(jax_index.path, path)
    g = {"e_max": np.int64(jax_index.graph.e_max)}
    for name in ("nbr_ids", "nbr_dist", "degree", "has_node", "valid", "free"):
        g[name] = np.load(os.path.join(path, name + ".npy"))
        os.remove(os.path.join(path, name + ".npy"))
    os.remove(os.path.join(path, "meta.json"))
    np.savez(os.path.join(path, "graph.npz"), **g)


def test_legacy_graph_npz_opens_alike(data, jax_index, tmp_path):
    """Both packages read a round-1 graph.npz directory to the same ids."""
    path = str(tmp_path / "legacy")
    _legacy_dir(jax_index, path)
    q = data[1]
    t = ngt_tpu_torch.open_index(path, device="cpu")
    j = ngt_tpu.open_index(path)
    assert t.verify() == []
    ti, td = t.batch_search(q, size=10)
    np.testing.assert_array_equal(ti, np.asarray(j.batch_search(q, size=10)[0]))
    np.testing.assert_array_equal(ti, np.asarray(jax_index.batch_search(q, size=10)[0]))


def test_port_save_removes_stale_graph_npz(data, jax_index, tmp_path):
    """A port save into a directory that holds a round-1 graph.npz deletes
    it, so neither package reads the stale graph afterwards."""
    path = str(tmp_path / "stale")
    _legacy_dir(jax_index, path)
    base, q = data
    t = ngt_tpu_torch.create(None, dimension=DIM, search_mode="exact", device="cpu")
    t.batch_insert(base[::2], build=True)   # another corpus, another graph
    t.save(path)
    assert not os.path.exists(os.path.join(path, "graph.npz"))
    want = t.batch_search(q, size=10)[0]
    np.testing.assert_array_equal(ngt_tpu_torch.open_index(path, device="cpu")
                                  .batch_search(q, size=10)[0], want)
    np.testing.assert_array_equal(np.asarray(ngt_tpu.open_index(path)
                                             .batch_search(q, size=10)[0]), want)


def test_port_runs_without_jax():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'ngt_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np, ngt_tpu_torch\n"
        "x = np.random.default_rng(0).standard_normal((300, 16)).astype(np.float32)\n"
        "idx = ngt_tpu_torch.create(None, dimension=16, device='cpu')\n"
        "idx.batch_insert(x, build=True)\n"
        "ids, _ = idx.batch_search(x[:5], size=3)\n"
        "assert list(ids[:, 0]) == [0, 1, 2, 3, 4], ids\n"
        "idx.remove(3)\n"                              # the g++-built host library
        "assert list(idx.batch_insert(x[:2])) == [3, 300]\n"
        "assert idx.verify() == []\n"
        "assert not any(m.startswith('jax') for m in sys.modules if sys.modules[m])\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_jax_imports_in_port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for top in ("ngt_tpu_torch", os.path.join("samples", "torch")):
        for root, _, names in os.walk(os.path.join(REPO, top)):
            files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    assert len(files) > 10
    assert any(os.sep + "samples" + os.sep in f for f in files)
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "ngt_tpu"), f"{path} imports {mod}"
