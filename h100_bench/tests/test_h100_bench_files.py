"""The harness finds what a later change adds as files, by name, with no
file already there edited (a configuration, a traffic mix, a metric, a
kind of traffic); and no module the benchmark runs imports JAX or the JAX
package."""

import ast
import hashlib
import json
import os
import sys
import types

import pytest

from h100_bench import harness
from h100_bench.tests.util import ROOT, run_cpu

FORBIDDEN = {"jax", "jaxlib", "flax", "ngt_tpu"}


def _imports(path: str) -> set[str]:
    """Top-level names of every module a file imports, compared whole."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _sources():
    for d, _, files in os.walk(os.path.join(ROOT, "h100_bench")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not _imports(path) & FORBIDDEN, path
    # ngt_tpu_torch begins with ngt_tpu, and is allowed: names are whole
    assert "ngt_tpu_torch" in _imports(os.path.join(ROOT, "h100_bench", "systems.py"))


def test_reference_and_judge_import_nothing_of_the_program():
    judges = os.path.join(ROOT, "h100_bench", "judges")
    names = ["reference.py", "judge.py"] + [os.path.join("judges", f)
                                            for f in sorted(os.listdir(judges))
                                            if f.endswith(".py")]
    assert "judges/search.py" in names and "judges/build.py" in names
    for name in names:
        assert _imports(os.path.join(ROOT, "h100_bench", name)) <= {
            "__future__", "numpy", "torch", "h100_bench"}, name
    assert _imports(os.path.join(ROOT, "h100_bench", "reference.py")) <= {
        "__future__", "numpy", "torch"}


def test_a_run_that_loaded_jax_prints_no_result(tiny_root, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(SystemExit, match="jax"):
        run_cpu(tiny_root, "sift-128-euclidean.build", seconds=0.1)


def _digests(root) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_added_config_traffic_and_metric_are_found_by_name(tiny_root):
    bench_dir = tiny_root / "h100_bench"
    before = _digests(tiny_root)
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    cfg = json.loads((bench_dir / "configs" / "sift-128-euclidean.json").read_text())
    cfg.update(name="small-16-euclidean", dimension=16, source="a test's own deployment")
    (bench_dir / "configs" / "small-16-euclidean.json").write_text(json.dumps(cfg))
    (bench_dir / "traffic" / "small_batch.json").write_text(json.dumps(
        {"kind": "search", "queries_per_request": 64, "trace_seconds": 0.2}))
    (bench_dir / "cells" / "small-16-euclidean.small_batch.json").write_text(json.dumps(
        {"entry": "Index.batch_search", "limits": {"dist_gap": 1e-4, "recall_gap": 0.2}}))
    (bench_dir / "metrics" / "answered_queries.small.py").write_text(
        "def read(run):\n    return sum(r.units for r in run.part('B'))\n")
    cell = "small-16-euclidean.small_batch"
    spec["configs"].append({"name": "small-16-euclidean", "source": "a test",
                            "file": "h100_bench/configs/small-16-euclidean.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": cell, "config": "small-16-euclidean",
                              "traffic": "small_batch", "chips": 1, "why": "a test"})
    next(m for m in spec["end_to_end"] if m["name"] == "qps")["workloads"].append(cell)
    spec["per_layer"].append({"name": "answered_queries.small", "unit": "queries",
                              "better": "higher", "source": "program_counter",
                              "layer": "entry points (index.py)", "moves": "qps",
                              "workloads": [cell]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))

    plain = run_cpu(tiny_root, cell, seconds=0.5)
    assert plain["correct"] and set(plain["metrics"]) == {"qps", "setup_s"}
    traced = run_cpu(tiny_root, cell, seconds=0.5, trace=True)
    assert traced["correct"]
    assert traced["metrics"]["answered_queries.small"]["value"] >= 64
    after = _digests(tiny_root)
    changed = {p for p in before if before[p] != after.get(p)}
    assert changed == {"BENCHMARK.json"}


COUNT_KIND = '''
class Count:
    def __init__(self, config, devices):
        pass

    def load(self):
        pass

    def setup(self, base, queries, sample, spans):
        pass

    def request(self, units):
        return len(units)

    def collect(self, out, units):
        return units, out

    def profile(self, on):
        pass

    def snapshot(self):
        return {}

    def close(self):
        pass


def program(config, devices):
    return Count(config, devices)


control = program
'''

COUNT_JUDGE = '''
from h100_bench.judge import checks


def judge(answers, base, queries, sample, config, limits, device):
    readings = {"lost": float(sum(len(units) - n for units, n in answers))}
    return {"readings": readings, "checks": checks(readings, limits)}
'''


def test_added_traffic_kind_is_found_by_name(tiny_root):
    """A kind of traffic that no cell had: its driver and its judge are two
    files, found by the kind's name; no file already there is edited."""
    bench_dir = tiny_root / "h100_bench"
    before = _digests(tiny_root)
    (bench_dir / "kinds" / "count.py").write_text(COUNT_KIND)
    (bench_dir / "judges" / "count.py").write_text(COUNT_JUDGE)
    (bench_dir / "traffic" / "count.json").write_text(json.dumps(
        {"kind": "count", "queries_per_request": 8, "trace_seconds": 0.1}))
    cell = "sift-128-euclidean.count"
    (bench_dir / "cells" / f"{cell}.json").write_text(json.dumps(
        {"entry": "a test's own", "limits": {"lost": 0}}))
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": cell, "config": "sift-128-euclidean",
                              "traffic": "count", "chips": 1, "why": "a test"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))

    res = run_cpu(tiny_root, cell, seconds=0.2)
    assert res["correct"] and res["attempted"] >= 1 and "setup_s" in res["metrics"]
    assert res["checks"] == {"lost": {"value": 0.0, "limit": 0.0}}
    assert not run_cpu(tiny_root, cell, seconds=0.2, system="control")["metrics"].get("qps")
    after = _digests(tiny_root)
    assert {p for p in before if before[p] != after.get(p)} == {"BENCHMARK.json"}


def test_every_cell_names_files_that_exist():
    bench = harness.Bench(ROOT)
    for w in bench.spec["workloads"]:
        bench.config(w["config"])
        bench.traffic(w["traffic"])
        assert bench.limits(w["name"])["limits"]
        kind = bench.traffic(w["traffic"])["kind"]
        assert callable(bench.kind(kind).program) and callable(bench.kind(kind).control)
        assert callable(bench.judge(kind).judge)
        for kind in ("end_to_end", "per_layer"):
            for m in bench.metrics(kind, w["name"]):
                assert callable(bench.reader(kind, m["name"]).read)
