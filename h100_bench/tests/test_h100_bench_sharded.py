"""The ``bigann-10m.sharded`` cell: its files are found by name, its
generator draws whole numbers in 0..255, and on the CPU at 6,000 rows (four
shards on one device) a sound run reads ``correct`` and reports the
tracer's shard metrics, while each planted fault does not: a merge that
drops one shard, a traversal that stops after one step, and the control
(the exact scan over the program's sq8 codes).  The test marked ``gpu``
reads a one-step traversal at the cell's own size on the machine's cards."""

import io
import json
import time

import numpy as np
import pytest
import torch

from h100_bench import harness
from h100_bench.tests.util import ROOT, run_cpu

CELL = "bigann-10m.sharded"
#: the per-layer metrics that read the program's tracer (the device's idle
#: share needs a card)
TRACER_METRICS = {"shard_overlap_pct.sharded", "shard_skew.sharded",
                  "merge_ms_per_request.sharded", "steps_per_request.sharded"}


@pytest.fixture()
def sharded_root(tiny_root):
    """The tiny checkout with this cell at 100 queries (part A's requests
    64) and its own ``recall_gap`` limit: at 1,500 rows a shard, with
    1,024 of them seeds, its sound answers are exact, and the tiny runs'
    looser limit would let a stalled traversal pass."""
    bench_dir = tiny_root / "h100_bench"
    for path, change in ((bench_dir / "configs" / "bigann-10m.json", {"queries": 100}),
                         (bench_dir / "traffic" / "sharded.json",
                          {"trace_queries_per_request": 64})):
        d = json.loads(path.read_text())
        d.update(change)
        path.write_text(json.dumps(d))
    cell = bench_dir / "cells" / f"{CELL}.json"
    cell.write_text(json.dumps(harness.Bench(ROOT).limits(CELL)))
    return tiny_root


def _merge_drops_a_shard(mp):
    from ngt_tpu_torch.parallel import sharding

    orig = sharding._merge_topk

    def dropped(mesh, dists, gids, k):
        dists = list(dists)
        dists[-1] = torch.full_like(dists[-1], float("inf"))
        return orig(mesh, dists, gids, k)

    mp.setattr(sharding, "_merge_topk", dropped)


def _traversal_stalls(mp):
    from ngt_tpu_torch.parallel import sharding

    orig = sharding.graph_search
    mp.setattr(sharding, "graph_search", lambda *a, **kw: orig(*a, **dict(kw, max_iters=1)))


def test_the_cells_files_are_found_by_name():
    bench = harness.Bench(ROOT)
    cell = bench.cell(CELL)
    assert cell["chips"] == 4 and cell["config"] == "bigann-10m"
    config = bench.config(cell["config"])
    assert (config["rows"], config["queries"], config["dimension"]) == (10_000_000, 10_000, 128)
    assert (config["object_type"], config["distance_type"], config["k"]) == ("Byte", "L2", 10)
    assert config["shards"] == 4 and config["generator"]["name"] == "bigann_proxy"
    traffic = bench.traffic(cell["traffic"])
    assert traffic["kind"] == "sharded" and traffic["queries_per_request"] == "all"
    assert callable(bench.kind("sharded").program) and callable(bench.kind("sharded").control)
    assert callable(bench.judge("sharded").judge)
    assert set(bench.limits(CELL)["limits"]) == {"dist_gap", "recall_gap"}
    per_layer = {m["name"] for m in bench.metrics("per_layer", CELL)}
    assert per_layer == TRACER_METRICS | {"device_idle_pct.sharded"}
    assert {m["name"] for m in bench.metrics("end_to_end", CELL)} == {
        "qps", "recall_at_10", "setup_s"}
    for name in per_layer:
        assert callable(bench.reader("per_layer", name).read)


def test_bigann_proxy_draws_whole_numbers_in_0_to_255():
    bench = harness.Bench(ROOT)
    config = bench.config("bigann-10m")
    gen = bench.generator("bigann_proxy")
    params = dict(config["generator"], dimension=128)
    cpu = torch.device("cpu")
    base, held = gen.make(params, 3000, 50, 2**31 + 7, cpu)
    again, held2 = gen.make(params, 3000, 50, 2**31 + 7, cpu)
    np.testing.assert_array_equal(base, again)
    np.testing.assert_array_equal(held, held2)
    assert not np.array_equal(base, gen.make(params, 3000, 50, 8, cpu)[0])
    for a in (base, held):
        assert a.min() >= 0 and a.max() <= 255
        np.testing.assert_array_equal(a, a.astype(np.uint8))
    assert base.max() == 255
    d = ((held[:, None, :] - base[None, :, :]) ** 2).sum(-1)
    assert d.min() > 0


def test_sound_run_is_correct_and_traced_reports_the_shard_metrics(sharded_root):
    res = run_cpu(sharded_root, CELL, seconds=0.5)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and {"qps", "recall_at_10", "setup_s"} <= set(res["metrics"])
    traced = run_cpu(sharded_root, CELL, seconds=0.5, trace=True)
    assert traced["correct"], traced["checks"]
    got = traced["metrics"]
    assert TRACER_METRICS <= set(got)
    # four shards on one device take turns: each works a quarter of the fan-out
    assert 0 < got["shard_overlap_pct.sharded"]["value"] <= 25.0 + 1e-6
    assert got["shard_skew.sharded"]["value"] >= 1.0
    assert got["steps_per_request.sharded"]["value"] > 0


@pytest.mark.parametrize("fault", [_merge_drops_a_shard, _traversal_stalls],
                         ids=lambda f: f.__name__.strip("_"))
def test_fault_reads_incorrect(sharded_root, monkeypatch, fault):
    fault(monkeypatch)
    res = run_cpu(sharded_root, CELL, seconds=0.5)
    assert not res["correct"], res["checks"]


def test_the_sq8_control_reads_incorrect(sharded_root):
    res = run_cpu(sharded_root, CELL, seconds=1e9, system="control", max_requests=1)
    assert not res["correct"] and res["failed"] == 0
    assert res["checks"]["dist_gap"]["value"] > res["checks"]["dist_gap"]["limit"]


@pytest.mark.gpu
def test_stalled_traversal_reads_incorrect_on_the_cards(cuda, monkeypatch):
    """At the cell's own size, on the machine's cards (the shards laid
    round-robin over them), one pass over every query: the upper reading of
    the cell's ``recall_gap``, printed on standard error."""
    _traversal_stalls(monkeypatch)
    devices = [torch.device(f"cuda:{i}") for i in range(torch.cuda.device_count())]
    res = harness.run(ROOT, CELL, 2**31 + 41, 1e9, False, devices, time.perf_counter(),
                      out=io.StringIO(), max_requests=1)
    assert not res["correct"], res["checks"]
    assert res["checks"]["recall_gap"]["value"] > res["checks"]["recall_gap"]["limit"]
