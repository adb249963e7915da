"""The port's bulk build (ngt_tpu_torch/graph/build.py) against the JAX
package on the same numpy inputs, on the CPU: adjacency rows equal, edge
distances to fp32 rounding (rtol 1e-5; bridge distances come from a matmul
whose sums run in another order), the same seed representatives.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ngt_tpu
import ngt_tpu_torch
from ngt_tpu.graph import build as JB
from ngt_tpu_torch.graph import build as TB


def test_bulk_graph_rows_matches_jax():
    """Forward + reverse triples with self edges, -1 slots, duplicated
    (row, target) pairs and rows that overflow e_max."""
    rng = np.random.default_rng(8)
    cap, npq, kk, e_max = 300, 200, 9, 12
    src = rng.choice(np.arange(1, cap), npq, replace=False).astype(np.int32)
    f_ids = rng.integers(-1, 40, (npq, kk)).astype(np.int32)  # hubs overflow
    f_ids[:, 0] = src                                       # self matches
    f_d = rng.random((npq, kk)).astype(np.float32)
    f_d[:, 1] = 0.5                                         # distance ties
    for reverse in (True, False):
        jn, jd, jg = JB._bulk_graph_rows(
            jnp.asarray(src), jnp.asarray(f_ids), jnp.asarray(f_d),
            e_max=e_max, cap=cap, reverse=reverse,
        )
        tn, td, tg = TB._bulk_graph_rows(
            torch.from_numpy(src), torch.from_numpy(f_ids), torch.from_numpy(f_d),
            e_max=e_max, cap=cap, reverse=reverse,
        )
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


def _clustered(rng, n, d, clusters):
    """Equal-size clusters whose exact 10-NN never cross (checked below):
    the k-NN graph splits into one component per cluster, with a tie for
    the largest, so the build must bridge them.  Separation 2 keeps the
    centered bf16 scan exact (far-apart clusters make the centered norms
    so large that bf16 rounding reorders neighbors)."""
    centers = rng.standard_normal((clusters, d)) * 2.0
    lab = np.arange(n) % clusters
    x = (centers[lab] + rng.standard_normal((n, d))).astype(np.float32)
    dm = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(dm, np.inf)
    assert (lab[np.argsort(dm, axis=1)[:, :10]] == lab[:, None]).all()
    return x, lab


@pytest.mark.parametrize("corpus,props", [
    ("random", {}),
    ("clustered", {}),
    ("random", {"truncation_threshold": 6}),   # host-side connectivity path
    ("random", {"graph_type": 2}),             # KNNG: no reverse edges
])
def test_build_bulk_matches_jax(corpus, props):
    rng = np.random.default_rng(21)
    n, d = 2000, 48
    if corpus == "random":
        data = rng.standard_normal((n, d)).astype(np.float32)
    else:
        data, lab = _clustered(rng, n, d, 8)
    j = ngt_tpu.create(None, dimension=d, **props)
    j.batch_insert(data, build=True)
    t = ngt_tpu_torch.create(None, dimension=d, device="cpu", **props)
    t.batch_insert(data, build=True)
    m = n + 1
    np.testing.assert_array_equal(t.graph.nbr_ids[:m], j.graph.nbr_ids[:m])
    np.testing.assert_array_equal(t.graph.degree[:m], j.graph.degree[:m])
    np.testing.assert_allclose(t.graph.nbr_dist[:m], j.graph.nbr_dist[:m], rtol=1e-5)
    np.testing.assert_array_equal(t.seeder.rep_ids, j.seeder.rep_ids)
    assert t.verify() == []
    if "graph_type" not in props:
        labels = TB._cc_labels_device(
            torch.from_numpy(t.graph.nbr_ids[:m]),
            torch.from_numpy(t.graph._has_node[:m]),
        ).numpy()
        assert len(np.unique(labels[1:])) == 1   # one component
    if corpus == "clustered":
        nb = t.graph.nbr_ids[1:m]
        src_lab = np.repeat(lab, nb.shape[1]).reshape(nb.shape)
        cross = (nb >= 1) & (lab[np.clip(nb - 1, 0, n - 1)] != src_lab)
        assert cross.any()                       # the bridges exist


def test_cc_labels_are_component_minima():
    """Min-label propagation gives each component its lowest node id."""
    nbr = np.full((9, 2), -1, np.int32)
    for a, b in ((1, 2), (2, 3), (5, 4), (7, 8)):   # {1,2,3} {4,5} {7,8} {6}
        nbr[a, 0] = b
    valid = np.ones(9, bool)
    valid[0] = False
    lab = TB._cc_labels_device(torch.from_numpy(nbr), torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(lab, [9, 1, 1, 1, 4, 4, 6, 7, 7])


def test_build_profile_marks_the_reference_phases(monkeypatch, capsys):
    """NGT_TPU_BUILD_PROFILE=1 (the reference's switch) splits the port's
    bulk build into the reference's phases, in the reference's order, and
    leaves the graph as it is without the switch."""
    rng = np.random.default_rng(8)
    data = rng.standard_normal((600, 32)).astype(np.float32)
    plain = ngt_tpu_torch.create(None, dimension=32, device="cpu")
    plain.batch_insert(data, build=True)
    monkeypatch.setenv("NGT_TPU_BUILD_PROFILE", "1")
    capsys.readouterr()
    j = ngt_tpu.create(None, dimension=32)
    j.batch_insert(data, build=True)
    t = ngt_tpu_torch.create(None, dimension=32, device="cpu")
    t.batch_insert(data, build=True)
    lines = [ln for ln in capsys.readouterr().err.splitlines()
             if ln.startswith("# build_bulk profile: ")]
    assert len(lines) == 2
    j_labels, t_labels = (
        [part.split("=")[0] for part in ln.split(": ", 1)[1].split()] for ln in lines
    )
    assert t_labels == j_labels
    assert [label for label, _ in TB.last_profile] == t_labels
    assert all(sec >= 0.0 for _, sec in TB.last_profile)
    np.testing.assert_array_equal(t.graph.nbr_ids[:601], plain.graph.nbr_ids[:601])
