"""The port's quantized-graph route (ngt_tpu_torch/quant/qgraph.py) against
the JAX package on the CPU: sq8 codes and scale equal byte for byte, and
equal ids (distances to rtol 1e-6: the sums run in another order) from the
auto route of default properties, from explicit search_mode="qg", and from
one graph and one set of codes carried into the port through
ngt_tpu_torch/convert.py, with the tail refine engaged, in both visited
regimes, with expand 2, with a radius rank below the pool size and across
512-query chunks; each package opens the other's qg/quantized.npz.

One corpus serves both code formats: 6,000 x 32 integers in 0..255, so
the narrow mirror is u8 and the codes are u8-exact; with
NGT_TPU_MIRROR_NARROW=0 (the reference's switch) the mirror stays f32 and
the codes are scaled int8.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import ngt_tpu
import ngt_tpu_torch
from ngt_tpu.quant.qgraph import QuantizedGraphIndex as JQ
from ngt_tpu_torch import convert
from ngt_tpu_torch.quant.qgraph import QuantizedGraphIndex as TQ

N, DIM = 6000, 32
#: NGT_TPU_QG_BLOCK_GB at which an opened index (capacity 6,001 rows, 128
#: bytes of codes each) gets 16-edge blocks, below e_max = 64: the tail
#: refine engages
REFINE_GB = "0.0115"


def _boundary_ties(x: np.ndarray, k: int) -> int:
    """Rows whose k-th and (k+1)-th nearest rows (self included) lie at the
    same exact distance."""
    xf = x.astype(np.float64)
    sq = (xf * xf).sum(1)
    d2 = np.sort(np.rint(sq[:, None] + sq[None, :] - 2.0 * xf @ xf.T), axis=1)
    return int((d2[:, k - 1] == d2[:, k]).sum())


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    data = np.random.default_rng(14).integers(0, 256, (N, DIM)).astype(np.float32)
    # the two bulk builds keep different targets where two rows tie exactly
    # at a row's last k-NN edge (ROADMAP Queue 3); on this corpus no row
    # does, so both packages build the same graph
    assert _boundary_ties(data, 11) == 0
    rng = np.random.default_rng(1)
    q = data[rng.choice(N, 600)] + 8.0 * rng.standard_normal((600, DIM)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("qg") / "idx")
    j = ngt_tpu.create(path, dimension=DIM)
    j.batch_insert(data, build=True)
    j.save()
    return SimpleNamespace(data=data, q=q, path=path, j=j)


def _state(j):
    st = j.store.state_dict()
    gs = j.graph.state_dict(j.store.repository_size)
    return {
        "objects": st["x"], "valid": st["valid"], "free": st["free"],
        "nbr_ids": gs["nbr_ids"], "nbr_dist": gs["nbr_dist"],
        "degree": gs["degree"], "has_node": gs["has_node"],
        "rep_ids": j.seeder.rep_ids, "prop_dict": dict(vars(j.prop)),
    }


def _same(t_out, j_out, n=None):
    ti, td = t_out
    ji, jd = (np.asarray(a) for a in j_out)
    np.testing.assert_array_equal(ti[:n], ji[:n])
    np.testing.assert_allclose(td[:n], jd[:n], rtol=1e-6)


@pytest.mark.parametrize("codes,props", [
    ("u8", {}),
    ("sq8", {}),
    ("u8", {"search_mode": "qg", "search_qg_threshold": 10**9}),
])
def test_route_matches_jax(ref, monkeypatch, codes, props):
    """create -> batch_insert(build=True) -> batch_search with default
    properties (or explicit search_mode="qg") takes the qg route in both
    packages with the same graph, codes, scale and ids."""
    if codes == "sq8":
        monkeypatch.setenv("NGT_TPU_MIRROR_NARROW", "0")
    j = ref.j
    if codes == "sq8" or props:
        j = ngt_tpu.open_index(ref.path)
        for key, val in props.items():
            setattr(j.prop, key, val)
    t = ngt_tpu_torch.create(None, dimension=DIM, device="cpu", **props)
    t.batch_insert(ref.data, build=True)
    np.testing.assert_array_equal(t.graph.nbr_ids[: N + 1], j.graph.nbr_ids[: N + 1])
    _same(t.batch_search(ref.q, size=10), j.batch_search(ref.q, size=10))
    tq, jq = t._qg, j._qg
    assert tq.mode == jq.mode == "sq8"
    assert tq.sq_scale == jq.sq_scale
    tc, jc = tq._host_codes(), jq._host_codes()
    assert tc.dtype == jc.dtype == (np.uint8 if codes == "u8" else np.int8)
    # an opened index holds exactly its rows, a built one a power of two
    np.testing.assert_array_equal(tc[: N + 1], jc[: N + 1])
    assert not tc[N + 1 :].any() and not jc[N + 1 :].any()
    if codes == "u8":
        assert tq._dev_codes() is t._mirror.x and tq.sq_scale == 1.0
    else:
        assert t._mirror.x.dtype == torch.float32 and tq.sq_scale != 1.0


@pytest.mark.parametrize("env", [
    {"NGT_TPU_MIRROR_NARROW": "0"},        # device encode of the f32 mirror
    {"NGT_TPU_QG_HOST_QUANTIZE": "1"},     # host encode (rows / scale)
])
def test_quantize_matches_jax(ref, monkeypatch, env):
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    j = ngt_tpu.open_index(ref.path)
    t = convert.from_ngt_tpu_arrays(device="cpu", **_state(ref.j))
    jq, tq = JQ.quantize(j, mode="sq8"), TQ.quantize(t, mode="sq8")
    assert tq.sq_scale == jq.sq_scale
    tc, jc = tq._host_codes(), jq._host_codes()
    assert tc.dtype == jc.dtype == np.int8
    np.testing.assert_array_equal(tc, jc)


def test_block_sizing_matches_jax(monkeypatch):
    """Format, block width and refine budget equal the reference's at every
    size, 1M x 128 included (sq8, eb 48 of 64, refine 16)."""
    def fake(cap, d_pad, e_max=64, refine=-1, block_edges=0):
        index = SimpleNamespace(
            store=SimpleNamespace(_x=np.empty((cap, 0))),
            graph=SimpleNamespace(e_max=e_max),
            prop=SimpleNamespace(search_refine=refine),
        )
        return SimpleNamespace(index=index, codes=np.empty((0, d_pad)),
                               block_edges=block_edges)

    cases = [(1 << 20, 128), (1 << 13, 128), (1 << 22, 128), (1 << 23, 128),
             (3 << 21, 256), (1 << 20, 130), (1 << 16, 960)]
    for gb in ("6", REFINE_GB, "1"):
        monkeypatch.setenv("NGT_TPU_QG_BLOCK_GB", gb)
        for cap, d_pad in cases:
            assert TQ.pick_mode(cap, d_pad) == JQ.pick_mode(cap, d_pad)
            for refine, block_edges in ((-1, 0), (-1, 24), (7, 0)):
                f = fake(cap, d_pad, refine=refine, block_edges=block_edges)
                eb = TQ._effective_block_edges(f)
                assert eb == JQ._effective_block_edges(f)
                assert TQ._resolve_refine(f, 64, eb) == JQ._resolve_refine(f, 64, eb)
    monkeypatch.setenv("NGT_TPU_QG_BLOCK_GB", "6")
    f = fake(1 << 20, 128)
    assert TQ.pick_mode(1 << 20, 128) == "sq8"
    assert TQ._effective_block_edges(f) == 48 and TQ._resolve_refine(f, 64, 48) == 16
    # bench.py's budgets of its 4M arm (8 GiB at a 2^22-row capacity: sq8,
    # eb 16, 8.6e9 bytes of blocks) and its gist-960 arm (8.5 GiB at 2^19
    # rows of 1,024 padded columns: eb 17)
    for gb, cap, d_pad, eb_want in (("8", 1 << 22, 128, 16), ("8.5", 1 << 19, 1024, 17)):
        monkeypatch.setenv("NGT_TPU_QG_BLOCK_GB", gb)
        assert TQ.pick_mode(cap, d_pad) == JQ.pick_mode(cap, d_pad) == "sq8"
        for e_max in (64, 96):
            f = fake(cap, d_pad, e_max=e_max)
            eb = TQ._effective_block_edges(f)
            assert eb == JQ._effective_block_edges(f) == eb_want
            assert TQ._resolve_refine(f, e_max, eb) == JQ._resolve_refine(f, e_max, eb)


@pytest.mark.parametrize("codes,env,prop,kw", [
    ("sq8", {}, {}, {}),
    ("sq8", {"NGT_TPU_QG_BLOCK_GB": REFINE_GB}, {}, {}),
    ("sq8", {}, {"visited_bits_log2": 10}, {}),          # lossy visited table
    ("sq8", {"NGT_TPU_QG_BLOCK_GB": REFINE_GB}, {"visited_bits_log2": 10}, {"expand": 2}),
    ("sq8", {}, {}, {"ef": 20}),                         # radius rank 20 of 30
    ("u8", {"NGT_TPU_QG_BLOCK_GB": REFINE_GB}, {}, {"epsilon": 0.05}),
])
def test_qg_search_matches_jax(ref, monkeypatch, codes, env, prop, kw):
    """One graph and one set of codes in both packages (the reference's
    quantized graph carried into the port by convert.py)."""
    if codes == "sq8":
        monkeypatch.setenv("NGT_TPU_MIRROR_NARROW", "0")
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    j = ngt_tpu.open_index(ref.path)
    t = convert.from_ngt_tpu_arrays(device="cpu", **_state(ref.j))
    for key, val in prop.items():
        setattr(j.prop, key, val)
        setattr(t.prop, key, val)
    jq = JQ.quantize(j, mode="sq8")
    tq = convert.qg_from_ngt_tpu_state(t, jq.mode, jq.sq_scale, jq._host_codes(),
                                       jq.block_edges)
    eb = tq._effective_block_edges()
    assert eb == (16 if env else 64) and tq._dev_blocks()[1].shape[1] == eb
    q = ref.q[:200]
    _same(tq.batch_search(q, size=10, **kw), jq.batch_search(q, size=10, **kw))


def test_chunks_are_invisible(ref):
    """A query's result does not depend on its 512-query chunk or its
    padding: 600 queries in one call (two chunks) equal the reference's and
    the port's own calls of 37 and of 1."""
    t = convert.from_ngt_tpu_arrays(device="cpu", **_state(ref.j))
    tq = TQ.quantize(t)
    j = ngt_tpu.open_index(ref.path)
    jq = JQ.quantize(j, mode="sq8")
    whole = tq.batch_search(ref.q, size=10)
    _same(whole, jq.batch_search(ref.q, size=10))
    part = tq.batch_search(ref.q[560:597], size=10)
    np.testing.assert_array_equal(part[0], whole[0][560:597])
    np.testing.assert_array_equal(part[1], whole[1][560:597])
    assert tq.search(ref.q[599], size=10) == [
        (int(i), float(d)) for i, d in zip(whole[0][599], whole[1][599])
    ]


@pytest.mark.parametrize("codes", ["u8", "sq8"])
def test_saved_qg_opens_in_the_other_package(ref, monkeypatch, tmp_path, codes):
    if codes == "sq8":
        monkeypatch.setenv("NGT_TPU_MIRROR_NARROW", "0")
    q = ref.q[:100]
    jq = JQ.quantize(ngt_tpu.open_index(ref.path), mode="sq8")
    jq.save(str(tmp_path / "from_jax"))
    tq = TQ.open(str(tmp_path / "from_jax"), device="cpu")
    assert tq.codes.dtype == (np.uint8 if codes == "u8" else np.int8)
    want = jq.batch_search(q, size=10)
    _same(tq.batch_search(q, size=10), want)
    tq.save(str(tmp_path / "from_port"))
    back = JQ.open(str(tmp_path / "from_port"))
    assert back.codes.dtype == tq.codes.dtype and back.sq_scale == tq.sq_scale
    np.testing.assert_array_equal(np.asarray(back.batch_search(q, size=10)[0]),
                                  np.asarray(want[0]))


def test_reencode_after_insert_matches_jax(ref):
    """Inserts after quantize() re-encode every live row (the store's
    mutation count changed): u8-exact codes stay u8 while the rows are
    integral in 0..255 and switch to scaled int8 codes after one that is
    not, as in the reference."""
    j = ngt_tpu.open_index(ref.path)
    t = convert.from_ngt_tpu_arrays(device="cpu", **_state(ref.j))
    jq, tq = JQ.quantize(j, mode="sq8"), TQ.quantize(t)
    assert tq.codes.dtype == np.uint8 and tq._codes_mut == t.store.mutation_count
    for row in (ref.data[5] // 2, ref.data[9] * 1.5 - 20.25):
        j.insert(row)
        t.insert(row)
        jc, tc = np.asarray(jq._dev_codes()), tq._dev_codes().numpy()
        assert tc.dtype == jc.dtype and tq.sq_scale == jq.sq_scale
        np.testing.assert_array_equal(tc, jc)
    assert tc.dtype == np.int8


def test_port_qg_imports_no_jax():
    """A fresh interpreter that imports the port and its qg module and runs
    a CPU qg search holds neither JAX nor the JAX package."""
    import subprocess
    import sys

    code = (
        "import sys, numpy as np\n"
        "import ngt_tpu_torch, ngt_tpu_torch.quant.qgraph\n"
        "x = np.random.default_rng(0).standard_normal((400, 16)).astype(np.float32)\n"
        "idx = ngt_tpu_torch.create(None, dimension=16, device='cpu', search_mode='qg')\n"
        "idx.batch_insert(x, build=True)\n"
        "ids, _ = idx.batch_search(x[:5], size=3)\n"
        "assert idx._qg is not None and list(ids[:, 0]) == [0, 1, 2, 3, 4], ids\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ngt_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
