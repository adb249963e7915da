"""The control (the reference in TF32 in the program's place, ``control``
of kinds/<kind>.py) reads ``correct`` false under every cell's limits: on
the CPU at a few thousand rows, and on the card at the cell's own size."""

import io
import time

import pytest

from h100_bench import harness
from h100_bench.tests.util import ROOT, run_cpu

CELLS = [w["name"] for w in harness.Bench(ROOT).spec["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_control_reads_incorrect(tiny_root, workload):
    res = run_cpu(tiny_root, workload, seconds=1e9, system="control", max_requests=3)
    assert not res["correct"], res["checks"]
    assert res["failed"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_reads_incorrect_on_the_card(cuda, workload):
    """As many answers as a run judges: a one-query cell's thousand
    requests, a batch cell's pass over every query, a build cell's ten
    builds."""
    bench = harness.Bench(ROOT)
    per = bench.traffic(bench.cell(workload)["traffic"]).get("queries_per_request")
    requests = {1: 1000, "all": 1}.get(per, 10)
    res = harness.run(ROOT, workload, 2**31 + 23, 1e9, False, [cuda], time.perf_counter(),
                      system="control", out=io.StringIO(), max_requests=requests)
    assert not res["correct"], res["checks"]
