"""The port's graph search (ngt_tpu_torch/graph/search.py) against the JAX
package: both packages get the same graph — built by ngt_tpu, carried to
the port through ngt_tpu_torch/convert.py — and the same fixed seeds.
Ids, visit counts, distance counts and loop steps must be equal, in the
exact visited-table regime and in the lossy (hashed) one; distances equal
to fp32 rounding (rtol 1e-6: the 32-term sums run in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ngt_tpu
from ngt_tpu.graph import search as JS
from ngt_tpu_torch import convert
from ngt_tpu_torch.graph import search as TS
from ngt_tpu_torch.properties import DistanceType


@pytest.fixture(scope="module")
def graph_state():
    rng = np.random.default_rng(17)
    data = rng.standard_normal((1500, 32)).astype(np.float32)
    idx = ngt_tpu.create(None, dimension=32)
    idx.batch_insert(data, build=True)
    st = dict(idx.store.state_dict())
    gs = idx.graph.state_dict(idx.store.repository_size)
    return {
        "objects": st["x"], "valid": st["valid"], "free": st["free"],
        "nbr_ids": gs["nbr_ids"], "nbr_dist": gs["nbr_dist"],
        "degree": gs["degree"], "has_node": gs["has_node"],
        "rep_ids": idx.seeder.rep_ids,
        "prop_dict": {k: v for k, v in vars(idx.prop).items()},
    }


@pytest.mark.parametrize("regime", ["exact", "lossy"])
def test_graph_search_matches_jax(graph_state, regime):
    port = convert.from_ngt_tpu_arrays(device="cpu", **graph_state)
    mirror = port._ensure_mirror()
    n = mirror.x.shape[0]
    bits, exact = (
        TS.wrap_hash_bits(n) if regime == "exact" else (10, False)
    )
    assert exact == (regime == "exact") and n > (1 << 10)
    rng = np.random.default_rng(4)
    q = np.zeros((24, mirror.x.shape[1]), np.float32)
    q[:, :32] = rng.standard_normal((24, 32))
    seeds = rng.integers(1, n, size=(24, 10)).astype(np.int32)
    seeds[0, 3] = seeds[0, 1]     # a repeated seed
    seeds[1, 5] = -1              # an empty seed slot
    kw = dict(k=10, epsilon=0.1, width=64, edge_size=20, hash_bits=bits,
              exact_hash=exact)
    jr = JS.graph_search(
        jnp.asarray(mirror.x.numpy()), jnp.asarray(mirror.nbr.numpy()),
        jnp.asarray(mirror.valid.numpy()), jnp.asarray(q), jnp.asarray(seeds),
        metric=ngt_tpu.DistanceType.L2, **kw,
    )
    tr = TS.graph_search(
        mirror.x, mirror.nbr, mirror.valid, torch.from_numpy(q),
        torch.from_numpy(seeds), metric=DistanceType.L2, **kw,
    )
    np.testing.assert_array_equal(tr.ids.numpy(), np.asarray(jr.ids))
    np.testing.assert_allclose(tr.dists.numpy(), np.asarray(jr.dists), rtol=1e-6)
    np.testing.assert_array_equal(tr.visit_count.numpy(), np.asarray(jr.visit_count))
    np.testing.assert_array_equal(tr.dist_count.numpy(), np.asarray(jr.dist_count))
    assert tr.iters == int(jr.iters)


@pytest.mark.parametrize("ids", [[0, 1, 31, 32, 1023, 70000], [5, 99999, 2**30 + 7]])
def test_hash_slots_match_jax(ids):
    """The uint32 multiply wraparound of the lossy regime, bit for bit."""
    for bits, exact in ((10, False), (16, False), (20, True)):
        jw, j1, j2 = JS._hash_slots(jnp.asarray(ids, jnp.int32), bits, exact)
        tw, t1, t2 = TS._hash_slots(torch.tensor(ids), bits, exact)
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(t1.numpy(), np.asarray(j1))
        np.testing.assert_array_equal(t2.numpy(), np.asarray(j2))


def test_wrap_hash_bits_matches_jax():
    for cap in (2, 1000, 1025, 1 << 20, (1 << 20) + 1, 5_000_000):
        for override in (0, 12):
            assert TS.wrap_hash_bits(cap, override) == JS.wrap_hash_bits(cap, override)


def test_seeder_matches_jax():
    """Same representative ids from the same rng stream, and the same seeds
    (bf16-rounded, centered scores summed in f32 on both sides)."""
    from ngt_tpu.seeds import Seeder as JSeeder
    from ngt_tpu_torch.seeds import Seeder as TSeeder

    rng = np.random.default_rng(6)
    x = np.zeros((3000, 128), np.float32)
    x[1:, :24] = rng.standard_normal((2999, 24))
    live = np.arange(1, 3000, dtype=np.int32)
    js = JSeeder(ngt_tpu.DistanceType.L2)
    ts = TSeeder(DistanceType.L2, device="cpu")
    for _ in range(2):                     # the rng stream advances alike
        js.refresh(live, x, num_reps=1024)
        ts.refresh(live, x, num_reps=1024)
        np.testing.assert_array_equal(ts.rep_ids, js.rep_ids)
    q = np.zeros((16, 128), np.float32)
    q[:, :24] = rng.standard_normal((16, 24))
    np.testing.assert_array_equal(
        ts.seeds_for(torch.from_numpy(q)).numpy(), np.asarray(js.seeds_for(jnp.asarray(q)))
    )
    assert ts.verify(np.ones(3000, bool), x) == []


def test_seeder_ties_match_jax():
    """Representatives with identical rows tie exactly at the s-th place:
    both packages must pick the lower position (the reference's top-k order
    of ties), so the seed ids are equal.  Each twin pair holds the higher
    object id at the lower position, so position order is not id order."""
    from ngt_tpu.seeds import Seeder as JSeeder
    from ngt_tpu_torch.seeds import Seeder as TSeeder

    rng = np.random.default_rng(12)
    half = 64
    x = np.zeros((2 * half + 1, 128), np.float32)
    x[1 : half + 1, :16] = rng.standard_normal((half, 16))
    x[half + 1 :] = x[1 : half + 1]                  # object i + half twins i
    reps = np.concatenate([np.arange(half + 1, 2 * half + 1), np.arange(1, half + 1)])
    q = np.zeros((32, 128), np.float32)
    q[:, :16] = x[rng.integers(1, half + 1, 32), :16] + 0.05 * rng.standard_normal((32, 16))
    js = JSeeder(ngt_tpu.DistanceType.L2)
    ts = TSeeder(DistanceType.L2, device="cpu")
    js.set_representatives(reps.astype(np.int32), x)
    ts.set_representatives(reps.astype(np.int32), x)
    for s in (9, 7):                                 # the s-th place splits a twin pair
        jid = np.asarray(js.seeds_for(jnp.asarray(q), s))
        tid = ts.seeds_for(torch.from_numpy(q), s).numpy()
        np.testing.assert_array_equal(tid, jid)
        # the tie really is at the s-th place: the next seed is the twin
        nxt = ts.seeds_for(torch.from_numpy(q), s + 1).numpy()[:, -1]
        assert (np.abs(nxt - tid[:, -1]) == half).all()


def _sq8(x):
    """int8 codes of x with one global scale, as the quantized graph makes
    them (max |component| / 127, round half to even)."""
    scale = float(np.abs(x).max()) / 127.0
    inv = np.float32(1.0 / scale)
    return np.clip(np.round(x * inv), -127, 127).astype(np.int8), scale


@pytest.mark.parametrize("regime,expand,k_radius,edge_size", [
    ("exact", 1, 0, 0),
    ("lossy", 1, 0, 0),
    ("exact", 2, 0, 0),
    ("lossy", 3, 0, 12),
    ("exact", 1, 5, 0),       # k_radius < k: explore with the 5th radius
    ("lossy", 2, 4, 20),
])
def test_block_graph_search_matches_jax(graph_state, regime, expand, k_radius, edge_size):
    """Block mode (one neighbor block row per expanded node, seeds scored
    from the per-object codes) with ``expand`` > 1, ``k_radius`` < k and an
    edge limit below the block width: the quantized graph's traversal."""
    port = convert.from_ngt_tpu_arrays(device="cpu", **graph_state)
    mirror = port._ensure_mirror()
    n = mirror.x.shape[0]
    eb = 24
    x = mirror.x.numpy().astype(np.float32)
    codes, scale = _sq8(x)
    nbr = mirror.nbr.numpy()[:, :eb]
    blocks = codes[np.clip(nbr, 0, n - 1)].reshape(n, -1)
    bits, exact = TS.wrap_hash_bits(n) if regime == "exact" else (10, False)
    rng = np.random.default_rng(9)
    q = np.zeros((40, x.shape[1]), np.float32)
    q[:, :32] = rng.standard_normal((40, 32)) / scale
    seeds = rng.integers(1, n, size=(40, 10)).astype(np.int32)
    seeds[2, 4] = seeds[2, 0]
    seeds[3, 7] = -1
    kw = dict(k=30, k_radius=k_radius, epsilon=0.1, width=64, edge_size=edge_size,
              hash_bits=bits, exact_hash=exact, expand=expand, block_mode=True)
    jr = JS.graph_search(
        jnp.asarray(blocks), jnp.asarray(nbr), jnp.asarray(mirror.valid.numpy()),
        jnp.asarray(q), jnp.asarray(seeds), metric=ngt_tpu.DistanceType.L2,
        seed_x=jnp.asarray(codes), **kw,
    )
    tr = TS.graph_search(
        torch.from_numpy(blocks), torch.from_numpy(nbr), mirror.valid,
        torch.from_numpy(q), torch.from_numpy(seeds), metric=DistanceType.L2,
        seed_x=torch.from_numpy(codes), **kw,
    )
    np.testing.assert_array_equal(tr.ids.numpy(), np.asarray(jr.ids))
    np.testing.assert_allclose(tr.dists.numpy(), np.asarray(jr.dists), rtol=1e-6)
    np.testing.assert_array_equal(tr.visit_count.numpy(), np.asarray(jr.visit_count))
    np.testing.assert_array_equal(tr.dist_count.numpy(), np.asarray(jr.dist_count))
    assert tr.iters == int(jr.iters)


def test_scorer_replaces_the_metric(graph_state):
    """A pluggable scorer (queries, rows) -> [B, E] drives the traversal:
    an L1 scorer gives the reference's traversal under its own L1 scorer."""
    port = convert.from_ngt_tpu_arrays(device="cpu", **graph_state)
    mirror = port._ensure_mirror()
    n = mirror.x.shape[0]
    rng = np.random.default_rng(3)
    q = np.zeros((16, mirror.x.shape[1]), np.float32)
    q[:, :32] = rng.standard_normal((16, 32))
    seeds = rng.integers(1, n, size=(16, 8)).astype(np.int32)
    kw = dict(k=10, epsilon=0.1, width=64, hash_bits=16, exact_hash=False)
    jr = JS.graph_search(
        jnp.asarray(mirror.x.numpy()), jnp.asarray(mirror.nbr.numpy()),
        jnp.asarray(mirror.valid.numpy()), jnp.asarray(q), jnp.asarray(seeds),
        metric=ngt_tpu.DistanceType.L2,
        scorer=lambda qs, rows, rsq, qsq: jnp.abs(qs[:, None, :] - rows).sum(-1), **kw,
    )
    tr = TS.graph_search(
        mirror.x, mirror.nbr, mirror.valid, torch.from_numpy(q), torch.from_numpy(seeds),
        metric=DistanceType.L2,
        scorer=lambda qs, rows: (qs[:, None, :] - rows).abs().sum(-1), **kw,
    )
    np.testing.assert_array_equal(tr.ids.numpy(), np.asarray(jr.ids))
    np.testing.assert_allclose(tr.dists.numpy(), np.asarray(jr.dists), rtol=1e-6)
    np.testing.assert_array_equal(tr.dist_count.numpy(), np.asarray(jr.dist_count))
