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


def _replay_inputs(graph_state, mode, seeds_case, nq=40):
    """Row or block inputs over the fixture's graph, and queries with their
    seeds: ``normal`` (ten seeds a query), ``spread`` (a third of the chunk
    starts with no seed and is done at once, a third with one far seed) or
    ``empty`` (no query has a seed: the pools start empty)."""
    port = convert.from_ngt_tpu_arrays(device="cpu", **graph_state)
    mirror = port._ensure_mirror()
    n = mirror.x.shape[0]
    rng = np.random.default_rng(23)
    q = np.zeros((nq, mirror.x.shape[1]), np.float32)
    q[:, :32] = rng.standard_normal((nq, 32))
    seeds = rng.integers(1, n, size=(nq, 10)).astype(np.int32)
    if seeds_case == "spread":
        seeds[: nq // 3] = -1
        seeds[nq // 3 : 2 * nq // 3, 1:] = -1
    elif seeds_case == "empty":
        seeds[:] = -1
    if mode == "row":
        args = (mirror.x, mirror.nbr, mirror.valid, torch.from_numpy(q))
        return args, torch.from_numpy(seeds), {}
    x = mirror.x.numpy().astype(np.float32)
    codes, scale = _sq8(x)
    nbr = mirror.nbr.numpy()[:, :24]
    blocks = codes[np.clip(nbr, 0, n - 1)].reshape(n, -1)
    args = (torch.from_numpy(blocks), torch.from_numpy(nbr), mirror.valid,
            torch.from_numpy(q / scale))
    return args, torch.from_numpy(seeds), dict(block_mode=True, seed_x=torch.from_numpy(codes))


@pytest.mark.parametrize("mode,regime,expand,max_iters,seeds_case", [
    ("row", "exact", 1, 0, "normal"),
    ("row", "lossy", 1, 0, "normal"),
    ("row", "exact", 2, 0, "normal"),
    ("block", "lossy", 2, 0, "normal"),
    ("row", "exact", 1, 13, "normal"),      # the limit cuts queries not done
    ("block", "lossy", 2, 21, "normal"),
    ("row", "lossy", 1, 0, "spread"),       # queries done at very different steps
    ("block", "exact", 1, 0, "empty"),      # done at the seeds
])
def test_replays_match_a_check_every_step(graph_state, monkeypatch, mode, regime,
                                                  expand, max_iters, seeds_case):
    """The loop of ``REPLAY_STEPS`` steps between done checks (run eagerly
    here) gives the ids, distances, counts, steps and each query's own
    steps of a loop that checks before every step."""
    from ngt_tpu_torch import trace

    monkeypatch.setenv(trace.SEARCH, "1")
    args, seeds, extra = _replay_inputs(graph_state, mode, seeds_case)
    n = args[0].shape[0]
    bits, exact = TS.wrap_hash_bits(n) if regime == "exact" else (10, False)
    kw = dict(metric=DistanceType.L2, k=20, epsilon=0.1, width=64, hash_bits=bits,
              exact_hash=exact, expand=expand, max_iters=max_iters, **extra)
    assert TS.REPLAY_STEPS == 8 and TS.EAGER_STEPS == 1
    monkeypatch.setattr(TS, "EAGER_STEPS", TS.REPLAY_STEPS)
    got = TS.graph_search(*args, seeds, **kw)
    monkeypatch.setattr(TS, "EAGER_STEPS", 1)
    want = TS.graph_search(*args, seeds, **kw)
    for name in ("ids", "dists", "visit_count", "dist_count", "own_steps"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert got.iters == want.iters
    if max_iters:
        assert want.iters == max_iters
        # one step more and some query still steps: the limit cut it
        assert TS.graph_search(*args, seeds, **dict(kw, max_iters=max_iters + 1)).iters \
            == max_iters + 1
    elif seeds_case == "empty":
        assert got.iters == 0 and (got.ids == -1).all()
    elif seeds_case == "spread":
        own = got.own_steps.numpy()
        assert own[: len(own) // 3].max() <= 1 < 8 < own.max()


#: the state tensors of a traversal (graph/search.py ``_Loop``)
_STATE = ("pool_d", "pool_i", "pool_e", "visited", "done", "vc", "dc", "own", "steps")


@pytest.mark.parametrize("mode,regime,expand", [
    ("row", "exact", 1), ("row", "lossy", 2), ("block", "lossy", 1), ("block", "exact", 2),
])
def test_steps_after_done_change_no_state(graph_state, monkeypatch, mode, regime, expand):
    """Steps taken once every query is done leave every state tensor bit
    for bit as it was: what makes the spare steps of a replay harmless."""
    from ngt_tpu_torch import trace

    monkeypatch.setenv(trace.SEARCH, "1")
    seen = []
    run = TS._run
    monkeypatch.setattr(TS, "_run", lambda t, ins, *a: seen.append((t, ins)) or run(t, ins, *a))
    args, seeds, extra = _replay_inputs(graph_state, mode, "normal")
    bits, exact = TS.wrap_hash_bits(args[0].shape[0]) if regime == "exact" else (10, False)
    TS.graph_search(*args, seeds, metric=DistanceType.L2, k=20, epsilon=0.1, width=64,
                    hash_bits=bits, exact_hash=exact, expand=expand, **extra)
    (t, ins), = seen
    assert bool(t.done.all()) and int(t.steps) > 0
    before = {name: getattr(t, name).clone() for name in _STATE}
    for _ in range(TS.REPLAY_STEPS):
        TS._step(t, ins)
    for name in _STATE:
        a, b = before[name], getattr(t, name)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), name


def test_two_threads_search_at_once(graph_state):
    """Searches from two threads at once each get the answers of the same
    search run alone."""
    import threading

    args, seeds, _ = _replay_inputs(graph_state, "row", "normal")
    kw = dict(metric=DistanceType.L2, k=20, epsilon=0.1, width=64, hash_bits=10,
              exact_hash=False)
    halves = [(args[3][:20], seeds[:20]), (args[3][20:], seeds[20:])]
    alone = [TS.graph_search(*args[:3], q, sd, **kw) for q, sd in halves]
    got = [[], []]
    start = threading.Barrier(2)

    def search(j):
        start.wait()
        for _ in range(3):
            got[j].append(TS.graph_search(*args[:3], *halves[j], **kw))

    threads = [threading.Thread(target=search, args=(j,)) for j in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for want, runs in zip(alone, got):
        assert len(runs) == 3
        for res in runs:
            for name in ("ids", "dists", "visit_count", "dist_count"):
                assert torch.equal(getattr(res, name), getattr(want, name)), name
            assert res.iters == want.iters


def test_graph_cache_keeps_the_newest_within_its_bounds(monkeypatch):
    """The captured graphs' cache drops the least recently kept first, past
    ``GRAPH_CACHE`` entries or ``GRAPH_CACHE_BYTES`` of state, and always
    keeps the newest."""
    import collections

    class Loop:
        def __init__(self, nbytes):
            self.nbytes = nbytes

    monkeypatch.setattr(TS, "_GRAPHS", collections.OrderedDict())
    assert TS.GRAPH_CACHE >= 5     # the qg route's batch buckets, 32-512 rows
    for j in range(TS.GRAPH_CACHE + 3):
        TS._keep(j, Loop(1))
    assert list(TS._GRAPHS) == list(range(3, TS.GRAPH_CACHE + 3))
    third = TS.GRAPH_CACHE_BYTES // 3
    for key in "abc":
        TS._keep(key, Loop(third))
    assert list(TS._GRAPHS)[-3:] == ["a", "b", "c"]
    assert sum(t.nbytes for t in TS._GRAPHS.values()) <= TS.GRAPH_CACHE_BYTES
    TS._keep("big", Loop(2 * TS.GRAPH_CACHE_BYTES))
    assert list(TS._GRAPHS) == ["big"]
    TS._keep("small", Loop(1))
    assert list(TS._GRAPHS) == ["small"]


def _route_inputs(case):
    """``_kernel_route``'s inputs for one case: the qg route's sq8 block
    traversal on a card (``qg``), or that with one input changed."""
    import types

    from ngt_tpu_torch.quant.pq import make_packed_scorer

    e, m = {"e_over_max": (257, 128), "smem": (48, 4480), "m_not_16": (48, 100)}.get(
        case, (48, 128))
    x = torch.zeros((8, e * m), dtype=torch.float32 if case == "f32_block" else torch.int8)
    nbr = torch.zeros((8, e), dtype=torch.int32)
    kw = dict(x=x, nbr=nbr, valid=torch.ones(8, dtype=torch.bool), x_sqnorm=None,
              metric=DistanceType.L1 if case == "l1" else DistanceType.L2,
              scorer=make_packed_scorer(16, 16) if case == "pq4" else None,
              block_mode=case != "row", e_max=e)
    dev = torch.device("cpu" if case == "cpu" else "cuda")
    queries = types.SimpleNamespace(device=dev, dtype=torch.float32, shape=(512, m))
    t = types.SimpleNamespace(w=64, p=2 if case == "expand2" else 1,
                              hash_bits=4 if case == "hash_bits" else 20)
    return TS._Inputs(**kw), queries, t


@pytest.mark.parametrize("case,kernel", [
    ("qg", True), ("row", False), ("pq4", False), ("expand2", False), ("f32_block", False),
    ("l1", False), ("cpu", False), ("e_over_max", False), ("smem", False),
    ("m_not_16", False), ("hash_bits", False),
])
def test_kernel_route_takes_only_the_sq8_block_traversal_on_a_card(case, kernel):
    """The traversal kernel runs the sq8 block traversal on a CUDA device
    (int8 blocks, L2, no scorer, one expansion a step, float32 queries);
    row mode, a pq4 scorer, ``expand`` 2, float blocks, another metric and
    the CPU keep the torch step loop, and so do sizes past the kernel's
    limits: 257 edges read, a 4,480-wide query whose 48-edge block row
    overfills one warp's shared memory, a width that is not a multiple of
    16 and a 2^4-bit visited table."""
    assert TS._kernel_route(*_route_inputs(case)) is kernel


def _kernel_args(case):
    """The kernel's arguments on a 64-node toy graph (e_max 8, M 16), one
    of them wrong for ``case``."""
    from ngt_tpu_torch.ops import traverse as TV

    q = torch.zeros((4, 16), dtype=torch.float32)
    t = TS._Loop(q, 16, 8, 4, 1, 10, True, 0.1, False)
    t.start(q, None, torch.zeros((4, 16)), torch.zeros((4, 16), dtype=torch.int32), TS.INF)
    x = torch.zeros((64, 8 * 16), dtype=torch.float32 if case == "dtype" else torch.int8)
    if case == "width":
        x = torch.zeros((64, 7 * 16), dtype=torch.int8)
    nbr = torch.zeros((64, 8), dtype=torch.int64 if case == "nbr_dtype" else torch.int32)
    args = (x, nbr, torch.ones(64, dtype=torch.bool), t.queries, t.radius0, t.pool_d,
            t.pool_i, t.pool_e, t.visited, t.done, t.vc, t.dc, t.own, t.steps)
    kw = dict(e_max=8, k=8, kr=4, eps_coeff=1.1, hash_bits=10, exact_hash=True, max_iters=5)
    return TV.traverse, args, kw


@pytest.mark.parametrize("case,exc,match", [
    ("dtype", TypeError, "int8 or uint8"),
    ("width", ValueError, "e_max x M"),
    ("nbr_dtype", TypeError, "nbr must be int32"),
    ("cpu", ValueError, "CUDA device"),
])
def test_traverse_wrapper_raises_on_what_the_kernel_does_not_take(case, exc, match):
    """The wrapper checks types and shapes before anything launches: float
    block rows, a block row that is not e_max x M codes wide and int64
    adjacency raise; inputs it takes, on the CPU, raise for the device."""
    fn, args, kw = _kernel_args(case)
    with pytest.raises(exc, match=match):
        fn(*args, **kw)


@pytest.mark.parametrize("mode,regime,expand,max_iters,seeds_case", [
    ("row", "exact", 1, 0, "normal"),
    ("block", "lossy", 1, 0, "normal"),
    ("block", "exact", 2, 0, "normal"),
    ("block", "exact", 1, 13, "normal"),    # the limit cuts queries not done
    ("block", "lossy", 1, 0, "spread"),     # queries done at very different steps
    ("row", "exact", 1, 0, "empty"),        # done at the seeds
])
def test_steps_are_the_most_steps_of_any_query(graph_state, monkeypatch, mode, regime,
                                               expand, max_iters, seeds_case):
    """The loop's step count is the largest of the queries' own steps: what
    lets the traversal kernel, where each query steps to its own done,
    report the lockstep loop's count."""
    from ngt_tpu_torch import trace

    monkeypatch.setenv(trace.SEARCH, "1")
    args, seeds, extra = _replay_inputs(graph_state, mode, seeds_case)
    bits, exact = TS.wrap_hash_bits(args[0].shape[0]) if regime == "exact" else (10, False)
    res = TS.graph_search(*args, seeds, metric=DistanceType.L2, k=20, epsilon=0.1, width=64,
                          hash_bits=bits, exact_hash=exact, expand=expand,
                          max_iters=max_iters, **extra)
    assert res.iters == int(res.own_steps.max())
    if max_iters:
        assert res.iters == max_iters
    if seeds_case == "empty":
        assert res.iters == 0
