"""The readers of the program's own tracer (``metrics/_trace.py`` and the
five metrics that use it): on a synthetic run they sum only the records
inside part B's requests and read None where nothing was recorded; in a
traced run on the CPU the search and build cells report them."""

import sys
import time

import pytest

from h100_bench import harness
from h100_bench.tests.util import ROOT, run_cpu
from ngt_tpu_torch import trace

READERS = ("step_occupancy.batch", "launch_ms_per_step.batch", "launch_ms_per_step.online",
           "store_fill_s.build", "scan_kernel_share.build")


def _read(run, name):
    return harness.Bench(ROOT).reader("per_layer", name).read(run)


def _request(part, body):
    t0 = time.perf_counter()
    body()
    return harness.Request(t0, time.perf_counter(), 1, part, {}, None, None)


def _records(query_steps, slot_steps, steps, launch_s, fill_s, k1_s, scan_s):
    def body():
        t0 = time.perf_counter_ns()
        trace.add("traverse.query_steps", query_steps)
        trace.add("traverse.slot_steps", slot_steps)
        trace.add("traverse.steps", steps)
        trace.add("traverse.launch", launch_s, t0)
        trace.add("store.fill", fill_s, t0)
        trace.add("k1", k1_s, t0)
        trace.add("build.scan", scan_s, t0)
    return body


def _run(requests):
    return harness.Run("a test", {}, {}, {}, requests, 1.0, 1.0, harness.Spans(), {}, None,
                       "cpu")


@pytest.fixture()
def empty_tracer():
    trace.clear()
    yield
    trace.clear()


def test_readers_sum_only_the_records_inside_part_b(empty_tracer):
    reqs = [_request("A", _records(1, 1000, 1000, 9.0, 9.0, 9.0, 10.0)),
            _request("B", _records(30, 40, 6, 0.012, 0.5, 0.25, 1.0)),
            _request("U", _records(1, 1000, 1000, 9.0, 9.0, 9.0, 10.0)),
            _request("B", _records(10, 40, 4, 0.008, 0.7, 0.35, 1.0))]
    _records(1, 1000, 1000, 9.0, 9.0, 9.0, 10.0)()   # after every request
    run = _run(reqs)
    assert _read(run, "step_occupancy.batch") == pytest.approx(100.0 * 40 / 80)
    assert _read(run, "launch_ms_per_step.batch") == pytest.approx(1e3 * 0.02 / 10)
    assert _read(run, "launch_ms_per_step.online") == pytest.approx(2.0)
    assert _read(run, "store_fill_s.build") == pytest.approx(1.2 / 2)
    assert _read(run, "scan_kernel_share.build") == pytest.approx(100.0 * 0.6 / 2.0)


def test_readers_read_none_where_nothing_was_recorded(empty_tracer, monkeypatch):
    run = _run([_request("B", lambda: None)])
    assert [_read(run, name) for name in READERS] == [None] * len(READERS)
    # records outside part B's requests, and a program without the tracer
    _records(1, 2, 3, 0.1, 0.1, 0.1, 0.2)()
    assert [_read(run, name) for name in READERS] == [None] * len(READERS)
    run = _run([_request("B", _records(1, 2, 3, 0.1, 0.1, 0.1, 0.2))])
    assert _read(run, "step_occupancy.batch") == pytest.approx(50.0)
    monkeypatch.delitem(sys.modules, "ngt_tpu_torch.trace")
    assert [_read(run, name) for name in READERS] == [None] * len(READERS)


def test_readers_read_none_from_a_buffer_that_dropped_records(empty_tracer, monkeypatch):
    run = _run([_request("B", _records(1, 2, 3, 0.1, 0.1, 0.1, 0.2))])
    assert _read(run, "step_occupancy.batch") == pytest.approx(50.0)
    monkeypatch.setattr(trace, "dropped", 1)
    assert [_read(run, name) for name in READERS] == [None] * len(READERS)


@pytest.mark.parametrize("cell, present, absent", [
    ("glove-100-angular.batch", {"step_occupancy.batch", "launch_ms_per_step.batch"}, set()),
    # no window-scan launch below 2^19 rows or off the card
    ("sift-128-euclidean.build", {"store_fill_s.build"}, {"scan_kernel_share.build"}),
])
def test_a_traced_run_reports_the_tracer_metrics(tiny_root, cell, present, absent):
    res = run_cpu(tiny_root, cell, seconds=0.5, trace=True)
    assert res["correct"]
    got = set(res["metrics"])
    assert present <= got and not absent & got
    if "step_occupancy.batch" in present:
        assert 0 < res["metrics"]["step_occupancy.batch"]["value"] <= 100
