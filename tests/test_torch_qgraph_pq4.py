"""The port's pq4 quantized-graph route (ngt_tpu_torch/quant/qgraph.py with
quant/pq.py) against the JAX package on the CPU.

One graph (built by the port, saved, and opened by both packages) and the
reference's fitted codebooks carried into the port: the device encode and
the host re-encode after an insert give the reference's packed codes byte
for byte, and the neighbor blocks are equal.  ``batch_search`` over those
codes returns the reference's ids and distances to rtol 1e-6, the
tolerance tests/test_torch_qgraph.py holds sq8 to, with the tail refine
engaged (the ADC sums over the M subspaces run in another order, so the
distances the traversal compares may differ in the last bit; on this
corpus no admission turns on it).  Under a
tight NGT_TPU_QG_BLOCK_GB both packages' auto routes pick pq4 and each
fits its own codebooks: the port's recall is the reference's less at most
0.02.  Each package opens the other's pq4 ``qg/`` directory.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest

import ngt_tpu
import ngt_tpu_torch
from ngt_tpu.quant.qgraph import QuantizedGraphIndex as JQ
from ngt_tpu_torch import convert
from ngt_tpu_torch.ops.bruteforce import recall_at_k
from ngt_tpu_torch.quant.qgraph import QuantizedGraphIndex as TQ

N, DIM = 2500, 32
#: NGT_TPU_QG_BLOCK_GB that picks pq4 at this size in both packages (an
#: opened index holds 2,501 rows: 8 sq8 columns need 2.4 MiB)
TIGHT_GB = "0.001"


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    # tests/test_quant.py::test_pq4_fused_matches_eager_with_refine's corpus
    rng = np.random.default_rng(5)
    centers = rng.normal(size=(30, DIM)).astype(np.float32) * 3
    data = (centers[rng.integers(0, 30, size=N)]
            + rng.normal(size=(N, DIM)).astype(np.float32))
    q = (centers[rng.integers(0, 30, size=64)]
         + rng.normal(size=(64, DIM)).astype(np.float32))
    path = str(tmp_path_factory.mktemp("pq4") / "idx")
    t = ngt_tpu_torch.create(path, dimension=DIM, edge_size_for_creation=24, device="cpu")
    t.batch_insert(data, build=True)
    t.save()
    j = ngt_tpu.open_index(path)
    gt = np.asarray(j.batch_linear_search(q, size=10)[0])
    return SimpleNamespace(data=data, q=q, path=path, gt=gt)


def _pair(ref):
    """The reference's pq4 quantized graph over the saved index and the
    port's over the same index with the reference's codebooks."""
    j = ngt_tpu.open_index(ref.path)
    jq = JQ.quantize(j, mode="pq4")
    t = ngt_tpu_torch.open_index(ref.path, device="cpu")
    tq = TQ.encode_pq4(t, convert.pq_from_state(jq.pq.state_dict(), device="cpu"))
    return jq, tq


def _same(t_out, j_out):
    ti, td = t_out
    ji, jd = (np.asarray(a) for a in j_out)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-6)


def test_pq4_codes_and_blocks_match_jax(ref):
    jq, tq = _pair(ref)
    assert tq.mode == jq.mode == "pq4" and tq.pq.m == jq.pq.m == 64
    tc, jc = tq._host_codes(), jq._host_codes()
    assert tc.dtype == jc.dtype == np.uint8 and tc.shape[1] == 32
    np.testing.assert_array_equal(tc, jc)
    for q in (tq, jq):
        q.block_edges = 16
    tb, jb = tq._dev_blocks(), jq._dev_blocks()
    np.testing.assert_array_equal(tb[0].numpy(), np.asarray(jb[0]))
    np.testing.assert_array_equal(tb[1].numpy(), np.asarray(jb[1]))


@pytest.mark.parametrize("block_edges,kw", [
    (16, {}),                                     # the tail refine engaged
    (0, {"epsilon": 0.05, "result_expansion": 6.0}),
    (16, {"expand": 2, "ef": 20}),
])
def test_pq4_search_matches_jax(ref, block_edges, kw):
    jq, tq = _pair(ref)
    for q in (tq, jq):
        q.block_edges = block_edges
    assert tq._resolve_refine(64, tq._effective_block_edges()) == (48 if block_edges else 0)
    _same(tq.batch_search(ref.q, size=10, **kw), jq.batch_search(ref.q, size=10, **kw))
    # the same state carried by convert.py (codes and quantizer)
    t2 = ngt_tpu_torch.open_index(ref.path, device="cpu")
    tq2 = convert.qg_from_ngt_tpu_state(t2, "pq4", 1.0, jq._host_codes(), block_edges,
                                        pq_state=jq.pq.state_dict())
    np.testing.assert_array_equal(tq2.batch_search(ref.q, size=10, **kw)[0],
                                  tq.batch_search(ref.q, size=10, **kw)[0])


def test_pq4_reencode_after_insert_matches_jax(ref):
    """An insert after quantize() re-encodes every live row on the host
    with the same codebooks (dead rows code 0)."""
    jq, tq = _pair(ref)
    row = ref.data[11] * 0.5 + 1.0
    jq.index.insert(row)
    tq.index.insert(row)
    np.testing.assert_array_equal(tq._dev_codes().numpy(), np.asarray(jq._dev_codes()))
    _same(tq.batch_search(ref.q, size=10), jq.batch_search(ref.q, size=10))


def test_auto_route_picks_pq4_in_both(ref, monkeypatch):
    """A block budget too small for 8 sq8 columns: both auto routes take
    pq4 with their own codebooks (k-means from different random streams);
    the port's recall is at least the reference's less 0.02."""
    monkeypatch.setenv("NGT_TPU_QG_BLOCK_GB", TIGHT_GB)
    j = ngt_tpu.open_index(ref.path)
    t = ngt_tpu_torch.open_index(ref.path, device="cpu")
    for idx in (j, t):
        idx.prop.result_expansion = 6.0
        idx.prop.search_mode = "qg"   # the corpus is below search_qg_threshold
    ji, _ = j.batch_search(ref.q, size=10, epsilon=0.1)
    ti, _ = t.batch_search(ref.q, size=10, epsilon=0.1)
    assert j._qg.mode == t._qg.mode == "pq4"
    assert TQ.pick_mode(N + 1, 128) == JQ.pick_mode(N + 1, 128) == "pq4"
    rj, rt = recall_at_k(np.asarray(ji), ref.gt, 10), recall_at_k(ti, ref.gt, 10)
    assert rt >= rj - 0.02, (rt, rj)
    assert rt >= 0.8


def test_pq4_qg_opens_in_the_other_package(ref, tmp_path):
    jq, tq = _pair(ref)
    want = jq.batch_search(ref.q, size=10)
    jq.save(str(tmp_path / "from_jax"))
    got = TQ.open(str(tmp_path / "from_jax"), device="cpu")
    assert got.mode == "pq4" and got.pq.m == 64
    np.testing.assert_array_equal(got.codes[: N + 1], jq._host_codes()[: N + 1])
    np.testing.assert_array_equal(got.pq.codebooks, jq.pq.codebooks)
    _same(got.batch_search(ref.q, size=10), want)
    tq.save(str(tmp_path / "from_port"))
    back = JQ.open(str(tmp_path / "from_port"))
    assert back.mode == "pq4"
    st = np.load(os.path.join(str(tmp_path / "from_port"), "qg", "quantized.npz"))
    assert bool(st["packed"]) and st["codes"].shape == (N + 1, 32)
    np.testing.assert_array_equal(back.codes[: N + 1], tq._host_codes()[: N + 1])
    np.testing.assert_array_equal(np.asarray(back.batch_search(ref.q, size=10)[0]),
                                  np.asarray(want[0]))
