"""CUDA-only tests of the port: each hand kernel against its plain torch
version on the card, and the distances of every metric on the card against
the CPU.  They carry the ``gpu`` marker and skip where no card
is present (decided inside the test, never at import).  This file imports
neither JAX nor the JAX package, so it also runs on a machine that has only
torch:  python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import contextlib

import numpy as np
import pytest
import torch

from ngt_tpu_torch.ops import window_scan as WS

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(rng, n, d, b, dev):
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = x[:b] + 0.1 * rng.standard_normal((b, d)).astype(np.float32)
    ss = (x ** 2).sum(1).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return t(q).to(torch.bfloat16), t(x).to(torch.bfloat16), t(ss)


@pytest.mark.parametrize("n,d,b", [
    (65536, 128, 1024), (4096, 256, 100), (1024, 512, 64),
    (128 * 37, 128, 100), (128 * 37, 128, 4097), (128 * 37, 384, 300),
    (8192, 512, 257),
])
def test_window_scan_kernel_matches_plain(cuda, n, d, b):
    """Scores to rtol 1e-4 / atol 1e-3 and ids on >= 99.9% of entries (the
    tolerances of tests/test_pallas_scan.py; f32 sums in another order can
    swap near-tied rows of one window).  b = 100, 257, 300 and 4097 leave a
    ragged 128-query tile; 37 windows are not a whole 32-window run; d runs
    over 128, 256, 384 and 512 (the kernel's shared-memory plans)."""
    q16, x16, ss = _inputs(np.random.default_rng(7), n, d, b, cuda)
    wd, wi = WS.window_scan(q16, x16, ss)
    pd, pi = WS.window_scan_plain(q16, x16, ss)
    torch.cuda.synchronize()
    np.testing.assert_allclose(wd.cpu().numpy(), pd.cpu().numpy(), rtol=1e-4, atol=1e-3)
    assert (wi == pi).float().mean().item() >= 0.999


def test_window_scan_kernel_masks_invalid_rows(cuda):
    q16, x16, ss = _inputs(np.random.default_rng(3), 2048, 128, 64, cuda)
    ss[:128] = float(WS.BIG)   # a dead window
    ss[130] = float(WS.BIG)    # one dead row
    wd, wi = WS.window_scan(q16, x16, ss)
    assert (wd[:, 0] >= float(WS.BIG) * 0.5).all()
    assert (wi[:, 1] != 130).all()


def test_window_scan_kernel_rejects_wide_rows(cuda):
    q16, x16, ss = _inputs(np.random.default_rng(1), 1024, 640, 8, cuda)
    with pytest.raises(ValueError):
        WS.window_scan(q16, x16, ss)


def test_window_scan_kernel_duplicate_rows_take_the_lowest(cuda):
    """A window of identical rows ties exactly in every query: the id must
    be the window's first row, exactly, as the plain version gives it."""
    q16, x16, ss = _inputs(np.random.default_rng(5), 4096, 128, 300, cuda)
    x16[256:384] = x16[300].clone()
    ss[256:384] = ss[300].clone()
    x16[1024 + 7] = x16[1024 + 90]   # one tied pair inside a window
    ss[1024 + 7] = ss[1024 + 90]
    q16[:50] = x16[1024 + 90]        # queries that land on the pair
    wd, wi = WS.window_scan(q16, x16, ss)
    pd, pi = WS.window_scan_plain(q16, x16, ss)
    torch.cuda.synchronize()
    assert (wi[:, 2] == 256).all() and (pi[:, 2] == 256).all()
    assert (wi[:50, 8] == 1024 + 7).all() and (pi[:50, 8] == 1024 + 7).all()
    np.testing.assert_allclose(wd.cpu().numpy(), pd.cpu().numpy(), rtol=1e-4, atol=1e-3)


def test_window_scan_kernel_rejects_misaligned_pointers(cuda):
    """TMA reads 16-byte aligned tensors only: a contiguous view 2 bytes off
    a 16-byte boundary must raise, not launch."""
    n, d = 1024, 128
    q16, x16, ss = _inputs(np.random.default_rng(2), n, d, 64, cuda)
    off = torch.empty(n * d + 1, dtype=torch.bfloat16, device=cuda)[1:].view(n, d)
    off.copy_(x16)
    assert off.is_contiguous() and off.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="aligned"):
        WS.window_scan(q16, off, ss)


def test_top_seeds_orders_ties_by_position_on_the_card(cuda):
    """torch.topk leaves the order of ties open on the card; top_seeds must
    take the lower position, as the reference's top-k does."""
    from ngt_tpu_torch.seeds import top_seeds

    rng = np.random.default_rng(4)
    scores = rng.integers(0, 6, size=(256, 4096)).astype(np.float32)
    got = top_seeds(torch.from_numpy(scores).to(cuda), 10).cpu().numpy()
    want = np.argsort(scores, axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(got, want)


def _port_index(rng, n, d, dev, **props):
    """A port index built on the CPU, carried to ``dev``: both devices
    then search one graph."""
    import ngt_tpu_torch
    from ngt_tpu_torch import convert

    x = rng.standard_normal((n, d)).astype(np.float32)
    cpu = ngt_tpu_torch.create(None, dimension=d, device="cpu", **props)
    cpu.batch_insert(x, build=True)
    return x, cpu, convert.from_ngt_tpu_arrays(device=dev, **convert.to_numpy_state(cpu))


@pytest.mark.parametrize("regime,expand", [("exact", 1), ("lossy", 2)])
def test_block_graph_search_on_the_card_matches_cpu(cuda, regime, expand):
    """Block-mode graph_search on the card against the CPU port on the same
    blocks and seeds: ids on >= 99.9% of entries (f32 sums run in another
    order on the card), distances to rtol 1e-5 where the ids agree."""
    from ngt_tpu_torch.graph import search as TS
    from ngt_tpu_torch.properties import DistanceType

    rng = np.random.default_rng(11)
    _, cpu, _ = _port_index(rng, 6000, 32, cuda)
    m = cpu._ensure_mirror()
    n, eb = m.x.shape[0], 24
    x = m.x.numpy().astype(np.float32)
    scale = float(np.abs(x).max()) / 127.0
    codes = np.clip(np.round(x * np.float32(1.0 / scale)), -127, 127).astype(np.int8)
    nbr = m.nbr.numpy()[:, :eb].copy()
    blocks = codes[np.clip(nbr, 0, n - 1)].reshape(n, -1)
    q = rng.standard_normal((300, x.shape[1])).astype(np.float32) / scale
    q[:, 32:] = 0.0
    seeds = rng.integers(1, 6001, size=(300, 10)).astype(np.int32)
    bits, exact = TS.wrap_hash_bits(n) if regime == "exact" else (10, False)
    kw = dict(metric=DistanceType.L2, k=30, k_radius=10, epsilon=0.1, width=64,
              hash_bits=bits, exact_hash=exact, expand=expand, block_mode=True)
    args = [torch.from_numpy(a) for a in (blocks, nbr, m.valid.numpy(), q, seeds, codes)]
    want = TS.graph_search(*args[:5], seed_x=args[5], **kw)
    got = TS.graph_search(*[a.to(cuda) for a in args[:5]], seed_x=args[5].to(cuda), **kw)
    same = got.ids.cpu() == want.ids
    assert same.float().mean().item() >= 0.999
    np.testing.assert_allclose(got.dists.cpu()[same].numpy(), want.dists[same].numpy(),
                               rtol=1e-5)


@pytest.mark.parametrize("bits", [0, 10])
def test_qg_batch_search_on_the_card_matches_cpu(cuda, bits):
    """The quantized-graph route on the card against the CPU port, one
    graph: codes and scale equal exactly, ids on >= 99.9% of entries."""
    rng = np.random.default_rng(12)
    x, cpu, card = _port_index(rng, 8192, 48, cuda, search_mode="qg",
                               visited_bits_log2=bits)
    q = x[:700] + 0.3 * rng.standard_normal((700, 48)).astype(np.float32)
    ci, cd = cpu.batch_search(q, size=10)
    gi, gd = card.batch_search(q, size=10)
    assert card._qg._codes_dev.is_cuda
    assert card._qg.sq_scale == cpu._qg.sq_scale
    # the carried index holds exactly its rows, the built one 2^k
    np.testing.assert_array_equal(card._qg._host_codes(), cpu._qg._host_codes()[:8193])
    same = gi == ci
    assert same.mean() >= 0.999
    np.testing.assert_allclose(gd[same], cd[same], rtol=1e-5)


def test_rerank_orders_ties_by_position_on_the_card(cuda):
    """The qg re-rank keeps the lower candidate position on exact distance
    ties, as the reference's top-k does: duplicate rows tie exactly, and
    position order is not id order here."""
    from ngt_tpu_torch.properties import DistanceType
    from ngt_tpu_torch.quant.qgraph import _rerank_body

    rng = np.random.default_rng(13)
    x = rng.integers(0, 4, (64, 128)).astype(np.float32)
    x[32:] = x[:32]                                   # row i + 32 twins row i
    q = rng.integers(0, 4, (256, 128)).astype(np.float32)
    cand = np.stack([rng.permutation(64)[:40] for _ in range(256)]).astype(np.int32)
    ok = np.ones_like(cand, bool)
    d = np.sqrt(((q[:, None, :] - x[cand]) ** 2).sum(-1))
    want = np.take_along_axis(cand, np.argsort(d, axis=1, kind="stable")[:, :10], 1)
    t = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    ids, _ = _rerank_body(t(x), t(q), t(cand), t(ok), DistanceType.L2, 10)
    np.testing.assert_array_equal(ids.cpu().numpy(), want)


def _metric_rows(metric, n, d, rng):
    from ngt_tpu_torch.ops import distances as TD
    from ngt_tpu_torch.properties import DistanceType as DT
    from ngt_tpu_torch.store import pad_sparse

    if metric in TD.BITWISE_METRICS:
        return rng.integers(0, 256, (n, d), dtype=np.uint8)
    if metric == DT.SPARSE_JACCARD:
        return pad_sparse([rng.choice(4 * d, rng.integers(1, d // 2), replace=False)
                           for _ in range(n)], d)
    if metric == DT.POINCARE:
        x = rng.normal(size=(n, d))
        return (x / (np.linalg.norm(x, axis=1, keepdims=True) * 2.0)).astype(np.float32)
    if metric == DT.LORENTZ:
        sp = rng.normal(size=(n, d - 1)) * 0.4
        return np.concatenate([np.sqrt(1.0 + (sp**2).sum(1, keepdims=True)), sp],
                              1).astype(np.float32)
    x = rng.normal(size=(n, d))
    if metric in TD.NORMALIZED_METRICS:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32)


@pytest.mark.parametrize("metric", list(range(12)))
def test_metric_distances_on_the_card_match_cpu(cuda, metric):
    """pairwise, gathered and linear_search of every metric on the card
    against the CPU: counts exactly, the rest to rtol 1e-5 (the angle and
    hyperbolic metrics in their acos/acosh argument), ids on >= 99.9%."""
    from ngt_tpu_torch.ops import bruteforce as TB
    from ngt_tpu_torch.ops import distances as TD
    from ngt_tpu_torch.properties import DistanceType as DT

    metric = [m for m in DT if m != DT.NONE][metric]
    rng = np.random.default_rng(int(metric) + 3)
    x = _metric_rows(metric, 3000, 128, rng)
    q = _metric_rows(metric, 64, 128, rng)
    xs = x[rng.integers(0, 3000, (64, 40))]
    exact = metric in TD.BITWISE_METRICS or metric == DT.SPARSE_JACCARD

    def close(a, b):
        a, b = a.double().cpu().numpy(), b.double().cpu().numpy()
        if metric in (DT.ANGLE, DT.NORMALIZED_ANGLE):
            a, b = np.cos(a), np.cos(b)
        elif metric in (DT.POINCARE, DT.LORENTZ):
            a, b = np.cosh(a), np.cosh(b)
        if exact:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)

    tq, tx, txs = (torch.from_numpy(a) for a in (q, x, xs))
    close(TD.pairwise(metric, tq.to(cuda), tx.to(cuda)), TD.pairwise(metric, tq, tx))
    close(TD.gathered(metric, tq.to(cuda), txs.to(cuda)), TD.gathered(metric, tq, txs))
    valid = torch.ones(3000, dtype=torch.bool)
    gi, gd = TB.linear_search(tq.to(cuda), tx.to(cuda), valid.to(cuda), metric, 10, block=1024)
    ci, cd = TB.linear_search(tq, tx, valid, metric, 10)
    close(gd, cd)
    assert (gi.cpu() == ci).double().mean() >= 0.999


@contextlib.contextmanager
def _eager_loop(monkeypatch):
    """The traversal as a loop of eager steps with a done check before
    each one (no captured graph, no traversal kernel)."""
    from ngt_tpu_torch.graph import search as TS

    assert TS.EAGER_STEPS == 1
    with monkeypatch.context() as m:
        m.setattr(TS, "_graph_key", lambda *a, **k: None)
        m.setattr(TS, "_kernel_route", lambda *a, **k: False)
        yield


def _kernel_off(monkeypatch):
    """The sq8 block traversal on the captured step loop, the traversal
    kernel's route turned off."""
    from ngt_tpu_torch.graph import search as TS

    monkeypatch.setattr(TS, "_kernel_route", lambda *a, **k: False)


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.parametrize("metric", list(range(12)))
def test_captured_steps_take_every_metric_on_the_card(cuda, monkeypatch, metric):
    """Row-mode graph_search of every metric on a random 16-edge graph: the
    captured replays give the eager loop's ids, distances, counts and
    steps bit for bit (a step that synchronized could not be captured)."""
    from ngt_tpu_torch.graph import search as TS
    from ngt_tpu_torch.ops import distances as TD
    from ngt_tpu_torch.properties import DistanceType as DT

    metric = [m for m in DT if m != DT.NONE][metric]
    rng = np.random.default_rng(int(metric) + 5)
    n = 3000
    t = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    x = t(_metric_rows(metric, n, 128, rng))
    q = t(_metric_rows(metric, 64, 128, rng))
    nbr = t(rng.integers(0, n, (n, 16)).astype(np.int32))
    seeds = t(rng.integers(0, n, (64, 8)).astype(np.int32))
    valid = torch.ones(n, dtype=torch.bool, device=cuda)
    sq = TD.sq_norms(x) if metric in TD.ANGULAR_METRICS or metric == DT.POINCARE else None
    kw = dict(metric=metric, k=10, epsilon=0.1, width=32, hash_bits=12, exact_hash=True,
              x_sqnorm=sq)
    got = TS.graph_search(x, nbr, valid, q, seeds, **kw)
    with _eager_loop(monkeypatch):
        want = TS.graph_search(x, nbr, valid, q, seeds, **kw)
    for name in ("ids", "dists", "visit_count", "dist_count"):
        assert _bits_equal(getattr(got, name), getattr(want, name)), name
    assert got.iters == want.iters > TS.REPLAY_STEPS


@pytest.mark.parametrize("route", ["sq8", "pq4", "row"])
def test_captured_traversal_equals_the_eager_loop_on_the_card(cuda, monkeypatch, route):
    """The qg route in sq8 and in pq4, and the exact route's row mode, on
    a 20k-row index: the captured replays give the eager loop's ids,
    distances, counts and steps bit for bit on a first call, on a call
    with other queries, after rows of the mirror are updated in place,
    after an append and after a full upload that moves the mirror.  A repeated shape captures
    once, and a chunk runs fewer than REPLAY_STEPS spare steps.  The sq8 route steps the
    captured loop with the traversal kernel's route off (its twin below takes the kernel)."""
    import collections

    import ngt_tpu_torch
    from ngt_tpu_torch import trace
    from ngt_tpu_torch.graph import search as TS
    from ngt_tpu_torch.quant import qgraph as QG

    monkeypatch.delenv(trace.SEARCH, raising=False)
    _kernel_off(monkeypatch)
    if route == "pq4":
        monkeypatch.setenv("NGT_TPU_QG_BLOCK_GB", "0.001")
    rng = np.random.default_rng(21)
    d = 32
    x = rng.standard_normal((20000, d)).astype(np.float32)
    q1 = x[:1024] + 0.3 * rng.standard_normal((1024, d)).astype(np.float32)
    q2 = rng.standard_normal((1024, d)).astype(np.float32)
    idx = ngt_tpu_torch.create(None, dimension=d, device=cuda)
    idx.batch_insert(x[:19800], build=True)
    kw = dict(size=10, epsilon=0.1, **({"expand": 1} if route == "row" else {}))

    seen = []
    orig = TS.graph_search

    def spy(*args, **kwargs):
        res = orig(*args, **kwargs)
        seen.append(res)
        return res

    spy.steps = 0
    monkeypatch.setattr(TS, "graph_search", spy)
    monkeypatch.setattr(QG, "graph_search", spy)

    def both(q):
        seen.clear()
        gi, gd = idx.batch_search(q, **kw)
        got = list(seen)
        seen.clear()
        with _eager_loop(monkeypatch):
            wi, wd = idx.batch_search(q, **kw)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gd.view(np.int32), wd.view(np.int32))
        assert len(got) == len(seen) > 0
        for a, b in zip(got, seen):
            for name in ("ids", "dists", "visit_count", "dist_count"):
                assert _bits_equal(getattr(a, name), getattr(b, name)), name
            assert a.iters == b.iters
        return got

    assert len(both(q1)) == (1 if route == "row" else 2)
    if route != "row":
        assert idx._qg.mode == route
    both(q2)
    m = idx._mirror
    ptrs = (m.x.data_ptr(), m.nbr.data_ptr())
    idx.store._x[1:201, :d] = x[19800:]
    m.update_rows(np.arange(1, 201), None)
    assert (m.x.data_ptr(), m.nbr.data_ptr()) == ptrs   # updated in place
    both(q1)
    idx.batch_insert(x[19800:], build=True)   # the insertion searches step too
    both(q2)
    ptrs = m.x.data_ptr()
    m.sync_full()
    assert m.x.data_ptr() != ptrs
    both(q1)

    # traced calls replay the untraced calls' graphs: from an empty cache the
    # first call captures one graph (both chunks are one shape), the next none
    monkeypatch.setattr(TS, "_GRAPHS", collections.OrderedDict())
    monkeypatch.setenv(trace.SEARCH, "1")
    for captures in (1, 0):
        trace.clear()
        idx.batch_search(q1, **kw)
        recs = trace.records()
        assert sum(r.value for r in recs if r.name == "traverse.captures") == captures
        spare = [r.value for r in recs if r.name == "traverse.spare_steps"]
        assert spare and all(0 <= s < TS.REPLAY_STEPS for s in spare)
    trace.clear()


def _qg_index(cuda, rows=20000, d=32, seed=21):
    import ngt_tpu_torch

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, d)).astype(np.float32)
    idx = ngt_tpu_torch.create(None, dimension=d, device=cuda)
    idx.batch_insert(x, build=True)
    return idx, x, rng


@pytest.mark.parametrize("route", ["sq8", "row"])
def test_two_threads_search_one_index_on_the_card(cuda, monkeypatch, route):
    """Two threads search one index at once, with other queries of the same
    shape (so the same captured graph and state), the graph captured in one
    thread while the other uses the card: each gets the answers of its
    queries searched alone."""
    import collections
    import threading

    from ngt_tpu_torch import trace
    from ngt_tpu_torch.graph import search as TS

    monkeypatch.delenv(trace.SEARCH, raising=False)
    idx, x, rng = _qg_index(cuda)
    kw = dict(size=10, epsilon=0.1, **({"expand": 1} if route == "row" else {}))
    qs = [x[j * 256:(j + 1) * 256] + 0.3 * rng.standard_normal((256, 32)).astype(np.float32)
          for j in range(2)]
    alone = [idx.batch_search(q, **kw) for q in qs]
    if route == "sq8":
        assert idx._qg.mode == "sq8"
    monkeypatch.setattr(TS, "_GRAPHS", collections.OrderedDict())
    got, errors = [[], []], []
    start = threading.Barrier(2)

    def search(j):
        try:
            start.wait()
            for _ in range(6):
                got[j].append(idx.batch_search(qs[j], **kw))
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=search, args=(j,)) for j in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors
    for (wi, wd), runs in zip(alone, got):
        assert len(runs) == 6
        for gi, gd in runs:
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gd.view(np.int32), wd.view(np.int32))


def test_mixed_batch_sizes_capture_once_each_on_the_card(cuda, monkeypatch):
    """Batches of 1-512 queries on the qg route pad to its five buckets
    (32-512 rows): the first round captures one graph a bucket, a second
    round none, and each answer equals the eager loop's (the traversal kernel's route off;
    its twin below takes the kernel)."""
    import collections

    from ngt_tpu_torch import trace
    from ngt_tpu_torch.graph import search as TS

    _kernel_off(monkeypatch)
    monkeypatch.setattr(TS, "_GRAPHS", collections.OrderedDict())
    monkeypatch.setenv(trace.SEARCH, "1")
    idx, x, rng = _qg_index(cuda)
    sizes = (1, 40, 100, 200, 400, 512, 3, 33)
    counts = []
    for _ in range(2):
        trace.clear()
        for nq in sizes:
            q = x[:nq] + 0.3 * rng.standard_normal((nq, 32)).astype(np.float32)
            gi, gd = idx.batch_search(q, size=10, epsilon=0.1)
            with _eager_loop(monkeypatch):
                wi, wd = idx.batch_search(q, size=10, epsilon=0.1)
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gd.view(np.int32), wd.view(np.int32))
        counts.append(sum(r.value for r in trace.records() if r.name == "traverse.captures"))
    trace.clear()
    assert idx._qg.mode == "sq8"
    assert counts == [5, 0]
    assert len(TS._GRAPHS) <= TS.GRAPH_CACHE


def test_kernel_traversal_agrees_with_the_eager_loop_on_the_card(cuda, monkeypatch):
    """The kernel-route twin of the captured sq8 test: the qg route's traversal as one
    launch of the traversal kernel a chunk, on the same 20k-row index, on a first call, a call
    with other queries, after rows of the mirror are updated in place, after an append and
    after a full upload.  Ids agree with the eager loop's on >= 99.9% of entries (the standard
    that holds under another order of the distance sums), distances to rtol 1e-5 where they
    agree, the steps are equal, and no call captures a graph."""
    import collections

    import ngt_tpu_torch
    from ngt_tpu_torch import trace
    from ngt_tpu_torch.graph import search as TS
    from ngt_tpu_torch.ops import traverse as TV
    from ngt_tpu_torch.quant import qgraph as QG

    monkeypatch.setattr(TS, "_GRAPHS", collections.OrderedDict())
    monkeypatch.setenv(trace.SEARCH, "1")
    rng = np.random.default_rng(21)
    d = 32
    x = rng.standard_normal((20000, d)).astype(np.float32)
    q1 = x[:1024] + 0.3 * rng.standard_normal((1024, d)).astype(np.float32)
    q2 = rng.standard_normal((1024, d)).astype(np.float32)
    idx = ngt_tpu_torch.create(None, dimension=d, device=cuda)
    idx.batch_insert(x[:19800], build=True)

    seen = []
    orig = TS.graph_search

    def spy(*args, **kwargs):
        res = orig(*args, **kwargs)
        seen.append(res)
        return res

    monkeypatch.setattr(QG, "graph_search", spy)

    def both(q):
        seen.clear()
        trace.clear()
        launches = TV.traverse.launches
        gi, gd = idx.batch_search(q, size=10, epsilon=0.1)
        recs = trace.records()
        got = list(seen)
        assert TV.traverse.launches - launches == len(got) == 2
        assert sum(r.value for r in recs if r.name == "traverse.kernel_launches") == 2
        assert sum(r.value for r in recs if r.name == "traverse.captures") == 0
        seen.clear()
        with _eager_loop(monkeypatch):
            wi, wd = idx.batch_search(q, size=10, epsilon=0.1)
        assert TV.traverse.launches - launches == 2
        same = gi == wi
        assert same.mean() >= 0.999
        np.testing.assert_allclose(gd[same], wd[same], rtol=1e-5)
        for a, b in zip(got, seen):
            assert a.iters == b.iters
            assert (a.ids == b.ids).float().mean().item() >= 0.999

    both(q1)
    assert idx._qg.mode == "sq8"
    both(q2)
    m = idx._mirror
    idx.store._x[1:201, :d] = x[19800:]
    m.update_rows(np.arange(1, 201), None)
    both(q1)
    idx.batch_insert(x[19800:], build=True)
    both(q2)
    m.sync_full()
    both(q1)
    trace.clear()


def test_mixed_batch_sizes_take_the_kernel_on_the_card(cuda, monkeypatch):
    """The kernel-route twin of the mixed-sizes test: batches of 1-512 queries pad to the
    qg route's five buckets and launch the traversal kernel once each, capture nothing in
    either round, and agree with the eager loop's ids on >= 99.9% of all entries."""
    import collections

    from ngt_tpu_torch import trace
    from ngt_tpu_torch.graph import search as TS
    from ngt_tpu_torch.ops import traverse as TV

    monkeypatch.setattr(TS, "_GRAPHS", collections.OrderedDict())
    monkeypatch.setenv(trace.SEARCH, "1")
    idx, x, rng = _qg_index(cuda)
    sizes = (1, 40, 100, 200, 400, 512, 3, 33)
    for _ in range(2):
        trace.clear()
        launches = TV.traverse.launches
        got, want = [], []
        for nq in sizes:
            q = x[:nq] + 0.3 * rng.standard_normal((nq, 32)).astype(np.float32)
            got.append(idx.batch_search(q, size=10, epsilon=0.1))
            with _eager_loop(monkeypatch):
                want.append(idx.batch_search(q, size=10, epsilon=0.1))
        recs = trace.records()
        assert TV.traverse.launches - launches == len(sizes)
        assert sum(r.value for r in recs if r.name == "traverse.captures") == 0
        gi, wi = (np.concatenate([r[0] for r in rs]) for rs in (got, want))
        assert (gi == wi).mean() >= 0.999
    trace.clear()
    assert idx._qg.mode == "sq8"


#: the traversal kernel's test shapes: the benchmark cells' searches at their widths on a
#: smaller graph (rows n, dimension d padded to 128, block width eb of the 64 adjacency
#: columns, the e edges read, pool width w, k, kr, epsilon, the visited table, queries b,
#: uint8 codes or int8).  A BIGANN shard (``ShardedQG``) traverses int8 sq8 codes; the
#: u8-exact qg route (an integral corpus, whose codes are the uint8 mirror itself) is the
#: one that traverses uint8 blocks
_KERNEL_SHAPES = {
    "sift": dict(n=40000, d=128, eb=48, e=48, w=64, k=30, kr=10, eps=0.1, bits=20,
                 exact=True, b=512, u8=False),
    "glove": dict(n=40000, d=100, eb=48, e=24, w=240, k=120, kr=40, eps=0.02, bits=16,
                  exact=False, b=512, u8=False),
    "bigann": dict(n=40000, d=128, eb=48, e=48, w=64, k=30, kr=10, eps=0.1, bits=22,
                   exact=True, b=2048, u8=False),
    "u8_exact": dict(n=40000, d=128, eb=48, e=48, w=64, k=30, kr=10, eps=0.1, bits=20,
                     exact=True, b=512, u8=True),
}


def _kernel_inputs(cuda, shape, seed=31):
    """``graph_search``'s arguments at one ``_KERNEL_SHAPES`` entry, from the
    smoke's generator (``chip_smoke.py::traverse_inputs``: a clustered
    corpus and its 64-NN graph on the card with invalid rows, -1 and
    repeated adjacency, and queries with no seed, done at the start)."""
    import chip_smoke

    sp = _KERNEL_SHAPES[shape]
    return chip_smoke.traverse_inputs(cuda, sp, seed, n=sp["n"])


@pytest.mark.parametrize("shape,max_iters", [
    ("sift", 0), ("glove", 0), ("bigann", 0), ("sift", 7), ("u8_exact", 0),
])
def test_traversal_kernel_matches_the_step_loop_on_the_card(cuda, monkeypatch, shape,
                                                            max_iters):
    """The traversal kernel against the captured ``_step`` loop on the same blocks, seeds
    and state, at SIFT's shape (int8, w 64, e 48, k 30, kr 10, exact 2^20 bits), glove's
    (w 240, 24 edges of a 48-wide block row, the two-bit hash), a BIGANN shard's (int8,
    exact 2^22 bits, 2,048 rows) and the u8-exact qg route's (uint8 blocks, SIFT's widths),
    and with a ``max_iters`` cut: ids on >= 99.9% of entries,
    distances to rtol 1e-5 where they agree, equal steps, and equal visit, distance and own
    step counts on the rows whose ids agree.  Queries with no seed are done at the start."""
    from ngt_tpu_torch import trace
    from ngt_tpu_torch.graph import search as TS
    from ngt_tpu_torch.ops import traverse as TV

    monkeypatch.setenv(trace.SEARCH, "1")
    args, kw = _kernel_inputs(cuda, shape)
    kw.update(max_iters=max_iters)
    launches = TV.traverse.launches
    got = TS.graph_search(*args, **kw)
    assert TV.traverse.launches == launches + 1
    with monkeypatch.context() as mp:
        mp.setattr(TS, "_kernel_route", lambda *a, **k: False)
        want = TS.graph_search(*args, **kw)
    assert TV.traverse.launches == launches + 1
    trace.clear()
    same = got.ids == want.ids
    assert same.float().mean().item() >= 0.999
    torch.testing.assert_close(got.dists[same], want.dists[same], rtol=1e-5, atol=0)
    assert got.iters == want.iters > 0
    rows = same.all(1)
    for name in ("visit_count", "dist_count", "own_steps"):
        assert torch.equal(getattr(got, name)[rows], getattr(want, name)[rows]), name
    assert (got.own_steps[:5] == 0).all() and (got.ids[:5] == -1).all()
    if max_iters:
        assert got.iters == max_iters


def test_traverse_smem_matches_the_kernel_layout_on_the_card(cuda):
    """The route predicate's shared-memory count (``ops/traverse.py::smem_bytes``) is
    the kernel's own layout at the cells' widths and around the limit."""
    from ngt_tpu_torch.ops import _build
    from ngt_tpu_torch.ops import traverse as TV

    lib = _build.load()
    for w, e, m in ((64, 48, 128), (240, 24, 128), (64, 48, 4480), (17, 3, 1040),
                    (500, 256, 256)):
        assert lib.ngt_traverse_smem(w, e, m) == TV.smem_bytes(w, e, m), (w, e, m)


def test_traversal_kernel_two_threads_on_one_card(cuda):
    """Two threads launch the traversal kernel on one card at once, on the
    same shape (one cached state, taken in turns): each gets the answers,
    counts and steps of its queries searched alone, bit for bit."""
    import threading

    from ngt_tpu_torch.graph import search as TS

    args, kw = _kernel_inputs(cuda, "sift")
    halves = [(args[3][:256], args[4][:256]), (args[3][256:], args[4][256:])]
    alone = [TS.graph_search(*args[:3], q, sd, **kw) for q, sd in halves]
    got, errors = [[], []], []
    start = threading.Barrier(2)

    def search(j):
        try:
            start.wait()
            for _ in range(4):
                got[j].append(TS.graph_search(*args[:3], *halves[j], **kw))
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=search, args=(j,)) for j in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors
    for want, runs in zip(alone, got):
        assert len(runs) == 4
        for res in runs:
            for name in ("ids", "dists", "visit_count", "dist_count"):
                assert _bits_equal(getattr(res, name), getattr(want, name)), name
            assert res.iters == want.iters


def _mirror_after_mutations(dev, integral: bool):
    """An index on ``dev`` after a bulk build, an incremental append, a
    batch removal, a single removal and an append into the freed slots;
    returns it with its mirror's tensors, which ``update_rows`` kept."""
    import ngt_tpu_torch

    rng = np.random.default_rng(9)
    x = rng.standard_normal((1300, 32)).astype(np.float32)
    if integral:
        x = np.rint(np.clip(x * 40 + 128, 0, 255)).astype(np.float32)
    idx = ngt_tpu_torch.create(None, dimension=32, device=dev, device_batch_size=256)
    idx.batch_insert(x[:1000], build=True)
    idx.batch_insert(x[1000:1200], build=True)
    idx.batch_remove(np.arange(10, 60))
    idx.remove(3)
    idx.batch_insert(x[1200:1300], build=True)
    m = idx._mirror
    if integral:
        # a row the u8 mirror cannot hold: the scatter widens it to f32
        assert m.x.dtype == torch.uint8
        idx.store._x[5, :32] += np.float32(1.0 / 3.0)
        m.update_rows(np.array([5]), None)
    return idx, [t.clone() for t in (m.x, m.valid, m.nbr, m.sqnorm)]


@pytest.mark.parametrize("integral", [False, True], ids=["f32", "u8-widened"])
def test_update_rows_on_the_card_matches_sync_full(cuda, integral):
    """The mirror that the per-batch and per-removal scatters leave on the
    card equals a full upload of the same host state: rows, valid bits and
    adjacency exactly, squared norms to rtol 1e-6 (host and device sums).
    The integral corpus keeps a u8 mirror through the mutations, until a
    row it cannot hold widens it to f32."""
    from ngt_tpu_torch.graph.build import DeviceMirror

    idx, (x, valid, nbr, sq) = _mirror_after_mutations(cuda, integral)
    assert x.dtype == torch.float32
    ref = DeviceMirror(idx.store, idx.graph)
    ref.sync_full()
    torch.testing.assert_close(x, ref.x.to(torch.float32), rtol=0, atol=0)
    assert torch.equal(valid, ref.valid) and torch.equal(nbr, ref.nbr)
    torch.testing.assert_close(sq, ref.sqnorm, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("snap,min_edges", [(1, 0), (8, 10), (40, 3)])
def test_adjust_paths_on_the_card_matches_cpu(cuda, snap, min_edges):
    """The ONNG's path adjustment (graph/reconstruct.py): shortcut detection
    (packed candidate bits) and the rank-ordered phase 2 under R(1), R(8)
    and one window of 40 ranks, on the card against the same torch code on
    the CPU; no float arithmetic happens, so bits and kept masks are equal.
    Detection runs in several row chunks on both."""
    from ngt_tpu_torch.graph import reconstruct as TR

    rng = np.random.default_rng(4)
    n, e = 3000, 40
    x = rng.standard_normal((n, 8)).astype(np.float32)
    d = np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1)).astype(np.float32)
    np.fill_diagonal(d, np.inf)
    ids = np.argsort(d, axis=1, kind="stable")[:, :e].astype(np.int32)
    dist = np.take_along_axis(d, ids, axis=1)
    deg = rng.integers(e // 2, e + 1, n).astype(np.int32)
    ids[np.arange(e)[None, :] >= deg[:, None]] = -1
    dist[ids < 0] = np.inf
    out = []
    old = TR.CHUNK_ELEMS
    TR.CHUNK_ELEMS = 500 * e * e
    try:
        for dev in (cuda, torch.device("cpu")):
            t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
            cand = TR._detect_shortcuts_all(t(ids), t(dist), e=e)
            kept = TR._adjust_phase2(t(ids), t(deg), cand, e=e, min_edges=min_edges, snap=snap)
            out.append((cand.cpu().numpy(), kept.cpu().numpy()))
    finally:
        TR.CHUNK_ELEMS = old
    assert out[0][0].any() and not out[0][1].all()
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])


def _integral_rows(n: int = 300, d: int = 16, seed: int = 5) -> np.ndarray:
    """Integer rows (exact distances on either device) with no tie between
    any row's 10th and 11th neighbour."""
    x = np.random.default_rng(seed).integers(0, 64, size=(n, d)).astype(np.float32)
    d2 = ((x[:, None] - x[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    kth = np.sort(d2, axis=1)[:, 9:11]
    assert (kth[:, 0] < kth[:, 1]).all()
    return x


def test_cli_runs_on_the_card_by_default(cuda, tmp_path, monkeypatch, capsys):
    """Without ``--device`` the CLI's indexes live on the card, and its
    output equals the CPU's."""
    import ngt_tpu_torch
    from ngt_tpu_torch import cli

    x = _integral_rows()
    tsv, qtsv = str(tmp_path / "d.tsv"), str(tmp_path / "q.tsv")
    np.savetxt(tsv, x, delimiter="\t", fmt="%.0f")
    np.savetxt(qtsv, x[:5] + 1, delimiter="\t", fmt="%.0f")
    devices = []
    real_open = ngt_tpu_torch.open_index

    def spy(*a, **k):
        idx = real_open(*a, **k)
        devices.append(idx.device.type)
        return idx

    monkeypatch.setattr(ngt_tpu_torch, "open_index", spy)
    out = {}
    for where, pre in (("cuda", []), ("cpu", ["--device", "cpu"])):
        path = str(tmp_path / where)
        assert cli.main(pre + ["create", "-d", "16", path, tsv]) == 0
        capsys.readouterr()
        assert cli.main(pre + ["search", "-o", "e", "-n", "5", path, qtsv]) == 0
        out[where] = [ln for ln in capsys.readouterr().out.splitlines()
                      if not ln.startswith(("# Query Time", "# Average Query Time"))]
    assert devices == ["cuda", "cpu"]
    assert out["cuda"] == out["cpu"] and "# End of Evaluation" in out["cuda"]


def test_export_of_a_card_index_equals_the_cpu_port(cuda):
    """The same rows built on the card and on the CPU export the same bytes,
    and the card's stream imports on the CPU into the card's arrays."""
    import io

    import ngt_tpu_torch

    x = _integral_rows()
    streams = {}
    for where in ("cuda", "cpu"):
        idx = ngt_tpu_torch.create(None, dimension=16, device=where)
        idx.batch_insert(x, build=True)
        idx.remove(7)
        fh = io.BytesIO()
        idx.export_index(fh)
        streams[where] = fh.getvalue()
        if where == "cuda":
            card = idx
    assert streams["cuda"] == streams["cpu"]
    back = ngt_tpu_torch.Index.import_index(io.BytesIO(streams["cuda"]), device="cpu")
    n = card.store.repository_size
    np.testing.assert_array_equal(back.graph.nbr_ids[:n], card.graph.nbr_ids[:n])
    np.testing.assert_array_equal(back.graph.nbr_dist[:n], card.graph.nbr_dist[:n])
    np.testing.assert_array_equal(back.store._x[:n], card.store._x[:n])


def test_sharded_search_on_the_card_matches_cpu(cuda):
    """ShardedIndex over make_mesh(2) (both shards on the one card) against
    the same build on a CPU mesh at 4,096 rows: ids on >= 99.9% of
    entries (each shard's build sums in another order on the card)."""
    from ngt_tpu_torch.parallel.sharding import ShardedIndex, make_mesh

    rng = np.random.default_rng(9)
    data = rng.normal(size=(4096, 32)).astype(np.float32)
    queries = rng.normal(size=(200, 32)).astype(np.float32)
    mesh = make_mesh(2)
    assert [d.type for d in mesh.devices] == ["cuda", "cuda"]
    card = ShardedIndex.build(data, mesh=mesh)
    host = ShardedIndex.build(data, mesh=make_mesh(2, device="cpu"))
    ci, cd = card.batch_search(queries, size=10, epsilon=0.1)
    hi, hd = host.batch_search(queries, size=10, epsilon=0.1)
    assert (ci == hi).mean() >= 0.999
    np.testing.assert_allclose(cd[ci == hi], hd[ci == hi], rtol=1e-5)


def test_sharded_qg_fans_out_over_the_cards(cuda, monkeypatch, capsys):
    """ShardedIndex over one shard a card (make_mesh() over every card; it
    needs two or more), 600,000 uint8 rows a shard of the BIGANN proxy so
    each shard's build launches the window-scan kernel on its own card, and
    ShardedQG over 4,096 queries (two chunks): the fan-out gives the serial
    loop's ids and distances bit for bit, its shards' device spans overlap,
    and a repeated call captures no graph."""
    import time

    from h100_bench.gen import bigann_proxy
    from ngt_tpu_torch import trace
    from ngt_tpu_torch.parallel import sharding as T
    from ngt_tpu_torch.properties import ObjectType

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        pytest.skip("needs two or more CUDA devices")
    monkeypatch.delenv(trace.SEARCH, raising=False)
    gen = dict(clusters=2048, spectrum=-0.4, zipf=1.05, center_scale=0.9, noise_scale=0.45,
               dimension=128)
    base, queries = bigann_proxy.make(gen, 600_000 * n_cards, 4096, 2**31 + 3, cuda)
    mesh = T.make_mesh()
    assert mesh.size == n_cards and len(set(mesh.devices)) == n_cards
    launches = WS.window_scan.launches
    t0 = time.perf_counter()
    sidx = T.ShardedIndex.build(base.astype(np.uint8), mesh=mesh, object_type=ObjectType.UINT8)
    build_s = time.perf_counter() - t0
    assert WS.window_scan.launches - launches >= n_cards
    assert [p.device for p in sidx._sharded.x.parts] == mesh.devices
    qg = T.ShardedQG.from_sharded_index(sidx)
    q = torch.from_numpy(queries)

    def timed():
        t = time.perf_counter()
        ids, dists = qg.search(q, k=10, epsilon=0.1)
        return ids.cpu(), dists.cpu(), time.perf_counter() - t

    fanned = [timed() for _ in range(2)]
    with monkeypatch.context() as mp:
        mp.setattr(T, "_device_groups", lambda m: [list(range(len(m.local_shards)))])
        serial = [timed() for _ in range(2)]
    for fi, fd, _ in fanned:
        assert torch.equal(fi, serial[0][0])
        assert torch.equal(fd.view(torch.int32), serial[0][1].view(torch.int32))
    monkeypatch.setenv(trace.SEARCH, "1")
    trace.clear()
    qg.search(q, k=10, epsilon=0.1)
    recs = trace.records()
    trace.clear()
    fan = sum(r.value for r in recs if r.name == "shard.fanout")
    busy = sum(r.value for r in recs if r.name.endswith((".traverse", ".rerank"))
               and r.name.startswith("shard"))
    captures = sum(r.value for r in recs if r.name == "traverse.captures")
    with capsys.disabled():
        print(f"\n{n_cards} cards: build {build_s:.1f} s; search of 4,096 queries fanned "
              f"{[round(f[2], 3) for f in fanned]} s, serial {[round(x[2], 3) for x in serial]} s; "
              f"overlap {100 * busy / (n_cards * fan):.1f}%, captures {captures}")
    assert captures == 0
    assert busy / (n_cards * fan) > 0.5


#: a C program on the C ABI with the default device: 300 rows, build, and
#: every row's own search must return it first
_CARD_C = r"""
#include <stdbool.h>
#include <stdint.h>
#include <stdio.h>
typedef void *H;
typedef struct { uint32_t id; float distance; } OD;
extern H ngt_create_error_object(void);
extern const char *ngt_get_error_string(const H);
extern H ngt_create_property(H);
extern bool ngt_set_property_dimension(H, int32_t, H);
extern H ngt_create_graph_and_tree_in_memory(H, H);
extern bool ngt_batch_append_index(H, float *, uint32_t, H);
extern bool ngt_create_index(H, uint32_t, H);
extern H ngt_create_empty_results(H);
extern OD ngt_get_result(const H, uint32_t, H);
extern bool ngt_search_index_as_float(H, float *, int32_t, size_t, float, float, H, H);
int main(void) {
  static float rows[300 * 16];
  uint32_t st = 7u;
  for (int i = 0; i < 300 * 16; ++i) { st = st * 1664525u + 1013904223u; rows[i] = (float)(st >> 8) / 16777216.0f; }
  H err = ngt_create_error_object();
  H prop = ngt_create_property(err);
  ngt_set_property_dimension(prop, 16, err);
  H idx = ngt_create_graph_and_tree_in_memory(prop, err);
  if (!idx || !ngt_batch_append_index(idx, rows, 300, err) || !ngt_create_index(idx, 4, err)) {
    fprintf(stderr, "%s\n", ngt_get_error_string(err)); return 1;
  }
  H res = ngt_create_empty_results(err);
  for (int i = 0; i < 300; ++i) {
    if (!ngt_search_index_as_float(idx, rows + i * 16, 16, 3, 0.1f, 1e30f, res, err) ||
        ngt_get_result(res, 0, err).id != (uint32_t)(i + 1)) {
      fprintf(stderr, "row %d: %s\n", i, ngt_get_error_string(err)); return 1;
    }
  }
  printf("CARD C API OK\n");
  return 0;
}
"""


def test_capi_runs_on_the_card_by_default(cuda, tmp_path):
    """build_capi() on the card's machine, and one C program with
    NGT_TPU_TORCH_DEVICE unset (the default, cuda)."""
    import os
    import subprocess

    from ngt_tpu_torch import native

    so = native.build_capi()
    src = tmp_path / "card.c"
    src.write_text(_CARD_C)
    exe = str(tmp_path / "card")
    subprocess.run(["g++", "-O1", "-o", exe, str(src), so, *native.python_link()[1],
                    f"-Wl,-rpath,{os.path.dirname(so)}"],
                   check=True, capture_output=True, timeout=120)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "NGT_TPU_TORCH_DEVICE"}
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([exe], capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "CARD C API OK" in r.stdout
