"""The port's tracer (``ngt_tpu_torch/trace.py``) on a small index: with
its switches off it records nothing and the answers are those of a traced
run; each query's own traversal steps are the steps it takes alone; the
views the benchmark reads keep their keys and labels; records carry their
parents and call ids in a bounded buffer; and a span lies on the clock of
``torch.profiler``'s events.  The tests marked ``gpu`` read device spans
on the card and skip without one.  This file imports neither JAX nor the
JAX package."""

import time

import numpy as np
import pytest
import torch

import ngt_tpu_torch
from ngt_tpu_torch import trace
from ngt_tpu_torch.graph import build as TB
from ngt_tpu_torch.graph.search import graph_search
from ngt_tpu_torch.quant import qgraph as QG

#: the reference's build phases of a fresh bulk build, in order
BUILD_LABELS = ["upload", "scan", "rows", "cc", "defer", "seeds", "connect", "mirror"]
QG_STAGES = {"quantize", "blocks", "seeds", "traverse", "rerank", "refine"}


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    for var in (trace.SEARCH, trace.BUILD, "NGT_TPU_QG_CHUNK"):
        monkeypatch.delenv(var, raising=False)
    trace.clear()
    QG.last_profile.clear()
    yield
    trace.clear()
    torch.set_num_threads(old)


def _data(n=1500, d=16, nq=40, seed=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((nq, d)).astype(np.float32))


def _index(data, device="cpu"):
    idx = ngt_tpu_torch.create(None, dimension=data.shape[1], device=device, search_mode="qg")
    idx.batch_insert(data, build=True)
    return idx


def _named(name):
    return [r for r in trace.records() if r.name == name]


def test_switches_off_record_nothing_and_change_no_answer(monkeypatch):
    data, q = _data()
    plain = _index(data)
    ids0, d0 = plain.batch_search(q, size=10, epsilon=0.1)
    assert trace.records() == [] and QG.last_profile == {}

    monkeypatch.setenv(trace.BUILD, "1")
    monkeypatch.setenv(trace.SEARCH, "1")
    traced = _index(data)
    ids1, d1 = traced.batch_search(q, size=10, epsilon=0.1)
    np.testing.assert_array_equal(traced.graph.nbr_ids, plain.graph.nbr_ids)
    np.testing.assert_array_equal(ids1, ids0)
    np.testing.assert_array_equal(d1, d0)
    names = {r.name for r in trace.records()}
    assert {"store.fill", "build.scan", "qg.traverse", "traverse.steps",
            "traverse.query_steps"} <= names
    assert trace.dropped == 0


def _spy(monkeypatch):
    """Records each chunk's SearchResult of the qg route."""
    seen = []
    orig = QG._qg_fused_search

    def spy(*args, **kwargs):
        out = orig(*args, **kwargs)
        seen.append(out[2])
        return out

    monkeypatch.setattr(QG, "_qg_fused_search", spy)
    return seen


def test_own_steps_are_the_steps_a_query_takes_alone(monkeypatch):
    """Three chunks of 16, 16 and 8 real rows: each query's own steps equal
    the steps it takes searched alone, ``traverse.query_steps`` sums them
    over the real rows and ``traverse.slot_steps`` is each chunk's steps
    times its real rows."""
    data, q = _data()
    idx = _index(data)
    monkeypatch.setenv(trace.SEARCH, "1")
    monkeypatch.setenv("NGT_TPU_QG_CHUNK", "16")
    seen = _spy(monkeypatch)
    idx.batch_search(q, size=10, epsilon=0.1)
    assert [len(r.own_steps) for r in seen] == [16, 16, 16]   # the last chunk padded
    real = [16, 16, 8]
    own = np.concatenate([r.own_steps[:m].numpy() for r, m in zip(seen, real)])
    assert all(int(r.own_steps.max()) == r.iters for r in seen)
    assert [r.value for r in _named("traverse.steps")] == [r.iters for r in seen]
    (qs,), (ss,) = _named("traverse.query_steps"), _named("traverse.slot_steps")
    assert qs.value == int(own.sum())
    assert ss.value == sum(r.iters * m for r, m in zip(seen, real))
    assert 0 < qs.value < ss.value

    alone = []
    for i in range(len(q)):
        seen.clear()
        trace.clear()
        idx.batch_search(q[i : i + 1], size=10, epsilon=0.1)
        (res,) = seen
        assert (res.own_steps == res.iters).all()   # 32 copies of one query
        assert _named("traverse.query_steps")[0].value == res.iters
        alone.append(res.iters)
    np.testing.assert_array_equal(own, alone)


def test_replay_counters_on_the_cpu(monkeypatch):
    """Beside ``traverse.steps`` each traversal records its replays, its
    spare steps and its captures: off CUDA a check every ``EAGER_STEPS``
    steps (one: no spare step), and no capture.  With ``REPLAY_STEPS``
    steps a check, as on CUDA, a chunk runs fewer than ``REPLAY_STEPS``
    spare steps, and below ``max_iters`` every step is a replay's, so the
    steps and the spare steps make whole replays."""
    from ngt_tpu_torch.graph import search as TS

    data, q = _data()
    idx = _index(data)
    monkeypatch.setenv(trace.SEARCH, "1")
    monkeypatch.setenv("NGT_TPU_QG_CHUNK", "16")

    def counters():
        trace.clear()
        idx.batch_search(q, size=10, epsilon=0.1)
        return [[r.value for r in _named("traverse." + name)]
                for name in ("steps", "replays", "spare_steps", "captures")]

    steps, replays, spare, captures = counters()
    assert len(steps) == len(replays) == len(spare) == len(captures) == 3
    assert captures == [0, 0, 0] and spare == [0, 0, 0] and replays == steps
    monkeypatch.setattr(TS, "EAGER_STEPS", TS.REPLAY_STEPS)
    steps8, replays, spare, captures = counters()
    assert steps8 == steps and captures == [0, 0, 0]
    assert all(0 <= s < TS.REPLAY_STEPS for s in spare)
    assert [(s + x) for s, x in zip(steps, spare)] == [TS.REPLAY_STEPS * r for r in replays]
    assert {r.parent for r in trace.records() if r.name.startswith("traverse.")
            and r.name not in ("traverse.query_steps", "traverse.slot_steps")} == {"qg.traverse"}


def test_the_views_keep_their_keys_and_labels(monkeypatch, capsys):
    data, q = _data()
    monkeypatch.setenv(trace.BUILD, "1")
    capsys.readouterr()
    idx = _index(data)
    lines = [ln for ln in capsys.readouterr().err.splitlines()
             if ln.startswith("# build_bulk profile: ")]
    assert len(lines) == 1
    assert [p.split("=")[0] for p in lines[0].split(": ", 1)[1].split()] == BUILD_LABELS
    assert [label for label, _ in TB.last_profile] == BUILD_LABELS
    marks = [r for r in trace.records() if r.name.startswith("build.")]
    assert [(r.name, r.value) for r in marks] == [("build." + k, v) for k, v in TB.last_profile]

    monkeypatch.delenv(trace.BUILD)
    monkeypatch.setenv(trace.SEARCH, "1")
    graph_search.steps = 0
    idx.batch_search(q, size=10, epsilon=0.1)
    assert {"quantize", "blocks", "seeds", "traverse", "rerank"} <= set(QG.last_profile)
    assert set(QG.last_profile) <= QG_STAGES
    for key, sec in QG.last_profile.items():
        assert sum(r.value for r in _named("qg." + key)) == pytest.approx(sec)
    assert graph_search.steps == sum(r.value for r in _named("traverse.steps")) > 0


def test_parents_call_ids_and_a_bounded_buffer(monkeypatch):
    data, q = _data()
    idx = _index(data)
    monkeypatch.setenv(trace.SEARCH, "1")
    idx.batch_search(q, size=10, epsilon=0.1)
    idx.batch_search(q[:5], size=10, epsilon=0.1)
    recs = trace.records()
    calls = sorted({r.call for r in recs})
    assert len(calls) == 2 and 0 not in calls
    first, second = ([r for r in recs if r.call == c] for c in calls)
    assert max(r.t1 for r in first) <= min(r.t0 for r in second)
    # the first search quantizes: the nested public calls share its id
    assert "qg.quantize" in {r.name for r in first}
    assert {"qg.traverse", "qg.rerank"} <= {r.name for r in second}
    parents = {(r.name, r.parent) for r in recs}
    assert ("qg.traverse", None) in parents
    assert ("traverse.launch", "qg.traverse") in parents
    assert ("traverse.query_steps", None) in parents
    assert all(r.clock == "host" for r in recs if r.name.startswith("qg."))

    monkeypatch.setattr(trace, "CAPACITY", 6)
    trace.clear()
    idx.batch_search(q[:5], size=10, epsilon=0.1)
    kept = trace.records()
    assert len(kept) == 6 and trace.dropped == len(second) - 6 > 0
    assert [r.name for r in kept] == [r.name for r in second[-6:]]
    monkeypatch.undo()
    trace.clear()
    assert trace._records.maxlen == trace.CAPACITY


def test_a_span_lies_on_the_profilers_clock(monkeypatch):
    """A torch.mm profiled inside a span: its Kineto start, less the
    tracer's offset read after the span, lies inside the span."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setenv(trace.SEARCH, "1")
    a = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("mm", trace.SEARCH) as rec:
            time.sleep(0.005)
            torch.mm(a, a)
            time.sleep(0.005)
        offset = trace.kineto_offset_ns()
    events = [ev for ev in prof.profiler.kineto_results.events() if ev.name() == "aten::mm"]
    assert events
    ev = events[0]
    start = int(ev.start_ns()) if hasattr(ev, "start_ns") else int(ev.start_us() * 1000)
    assert rec.t0 <= start - offset <= rec.t1


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_device_spans_on_the_card(cuda, monkeypatch):
    """On the card the qg stages, the build marks and each window-scan
    launch are device spans, resolved by the end of their public call; the
    kernel's seconds lie inside the scan mark's."""
    from ngt_tpu_torch.ops import window_scan as WS

    rng = np.random.default_rng(5)
    x = rng.standard_normal((4096, 128)).astype(np.float32)
    q16 = torch.from_numpy(x[:256]).to(cuda, torch.bfloat16)
    x16 = torch.from_numpy(x).to(cuda, torch.bfloat16)
    ss = torch.from_numpy((x ** 2).sum(1)).to(cuda)
    monkeypatch.setenv(trace.BUILD, "1")
    WS.window_scan(q16, x16, ss)
    (k1,) = trace.records()
    assert k1.name == "k1" and k1.clock == "device" and 0 < k1.value < 1.0

    trace.clear()
    data, q = _data(n=6000, d=32)
    monkeypatch.setenv(trace.SEARCH, "1")
    idx = _index(data, device=cuda)
    idx.batch_search(q, size=10, epsilon=0.1)
    recs = trace.records()
    assert all(r.value is not None for r in recs)
    assert all(r.clock == "device" for r in recs if r.name.startswith(("qg.", "build.")))
    assert _named("store.fill")[0].clock == "host"
