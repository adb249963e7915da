"""The benchmark's harness: it reads ``BENCHMARK.json``, finds the cell's
configuration, traffic mix, limits and metric readers as files by the
names given there, sets up the system, drives the measured window, has the
reference judge what the window produced, and prints the result line.

Nothing here belongs to one cell: a cell, a configuration, a traffic mix
or its kind, a generator or a metric is added as a file of its own (see
README.md).

A run, in one process:

1. set-up: the kernel library, the data from the seed, the cell's index,
   one warm request of the cell's own shape (``setup_s`` ends here);
2. the window: requests from one client in a closed loop, started while
   fewer than ``--seconds`` have passed, so it closes when the last one
   ends.  A traced run (``--trace 1``) profiles the device over its first
   ``trace_seconds`` with the program's stage timers off (part A), sends
   part A's requests again with the profiler off to time them as a run
   does (part U: the profiler slows the host), then runs a window with the
   timers on (part B: they synchronize the card, which would read as idle);
3. the device's peak memory; the program's state is freed;
4. the reference judges every answer of the window; the metrics' readers
   read the run; the checks print last on standard error and last in the
   result line, which is the last line of standard output.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

from h100_bench.systems import sync

#: top-level module names that no run may hold once its window has closed
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "ngt_tpu")
#: the benchmark's folder under the checkout's root
BENCH_DIR = "h100_bench"


class Spans:
    """Spans (name, start, end, parent) kept in memory, host clock."""

    def __init__(self):
        self.items: list[dict] = []
        self._open: list[int] = []

    @contextlib.contextmanager
    def span(self, name: str):
        rec = {"name": name, "start": time.perf_counter(), "end": None,
               "parent": self.items[self._open[-1]]["name"] if self._open else None}
        self.items.append(rec)
        self._open.append(len(self.items) - 1)
        try:
            yield rec
        finally:
            self._open.pop()
            rec["end"] = time.perf_counter()

    def seconds(self, name: str) -> float:
        return sum(s["end"] - s["start"] for s in self.items if s["name"] == name)


@dataclasses.dataclass
class Request:
    """One request of the window: its host-clock interval, the units it
    carried (queries, or one build), which part of a traced window it ran
    in ("" untraced, "A" profiled, "U" part A again unprofiled, "B" stage
    timers on), the change of the
    program's counters over it, its answer and any error."""

    t0: float
    t1: float
    units: int
    part: str
    counters: dict
    answer: object
    error: str | None


@dataclasses.dataclass
class Run:
    """What metric readers read."""

    workload: str
    cell: dict
    config: dict
    traffic: dict
    requests: list
    window_s: float
    setup_s: float
    spans: Spans
    judged: dict
    trace: dict | None
    platform: str

    def part(self, part: str) -> list:
        return [r for r in self.requests if r.part == part and r.error is None]


def load_file(path: str, name: str):
    """A Python file of the benchmark, loaded by path (file names may hold
    dots and dashes)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """``BENCHMARK.json`` under ``root`` and the files it names."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.dir = os.path.join(self.root, BENCH_DIR)
        with open(os.path.join(self.root, "BENCHMARK.json")) as fh:
            self.spec = json.load(fh)

    def _json(self, *parts: str) -> dict:
        with open(os.path.join(self.dir, *parts)) as fh:
            return json.load(fh)

    def cell(self, workload: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == workload:
                return w
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as fh:
                    return json.load(fh)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name + ".json")

    def limits(self, workload: str) -> dict:
        return self._json("cells", workload + ".json")

    def metrics(self, kind: str, workload: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` entries the cell reports."""
        return [m for m in self.spec[kind] if workload in m.get("workloads", [workload])]

    def reader(self, kind: str, name: str):
        folder = {"end_to_end": "end_to_end", "per_layer": "metrics"}[kind]
        return load_file(os.path.join(self.dir, folder, name + ".py"),
                         f"{BENCH_DIR}_{folder}_{name}")

    def generator(self, name: str):
        return load_file(os.path.join(self.dir, "gen", name + ".py"), f"{BENCH_DIR}_gen_{name}")

    def kind(self, name: str):
        """``kinds/<kind>.py``: the traffic kind's ``program`` and ``control``."""
        return load_file(os.path.join(self.dir, "kinds", name + ".py"),
                         f"{BENCH_DIR}_kinds_{name}")

    def judge(self, name: str):
        """``judges/<kind>.py``: the traffic kind's ``judge``."""
        return load_file(os.path.join(self.dir, "judges", name + ".py"),
                         f"{BENCH_DIR}_judges_{name}")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN_MODULES})


# ------------------------------------------------------------------ window --
def query_sequence(traffic: dict, n: int, seed: int) -> np.ndarray:
    """The held-out queries as the traffic sends them: cut into blocks of
    ``block`` consecutive queries, the whole blocks in an order drawn from
    the seed and a short last block kept last, so that every block starts
    at a multiple of ``block``.  Every seed sends the same blocks, so the
    same work, in another order."""
    block = int(traffic.get("block", 1))
    whole = np.random.default_rng([int(seed) % (1 << 63), 2]).permutation(n // block)
    seq = (whole[:, None] * block + np.arange(block)).reshape(-1)
    return np.concatenate([seq, np.arange(len(seq), n)])


def _units(traffic: dict, seq: np.ndarray, i: int, per=None):
    """The query indices of request i, walking ``seq`` and wrapping (a
    request of "all" takes the whole sequence), or None where the traffic
    sends no queries (``queries_per_request``), as a build's does not."""
    if "queries_per_request" not in traffic:
        return None
    per = per or traffic["queries_per_request"]
    per = len(seq) if per == "all" else int(per)
    return seq[(i * per + np.arange(per)) % len(seq)]


def _one(system, units, requests, part, defer=False) -> None:
    """One request of ``units``: timed, then its answer collected, or with
    ``defer`` left in ``answer`` as the raw output for ``_collect``."""
    c0 = system.snapshot()
    t0 = time.perf_counter()
    out, error = None, None
    try:
        out = system.request(units)
    except Exception:   # a failed request is counted, and the window goes on
        error = traceback.format_exc()
        print(f"request {len(requests)} failed:\n{error}", file=sys.stderr)
    t1 = time.perf_counter()
    c1 = system.snapshot()
    delta = {k: v - c0.get(k, 0) for k, v in c1.items()}
    n = len(units) if units is not None else 1
    requests.append(Request(t0, t1, n, part, delta, (units, out), error))
    if not defer:
        _collect(system, requests[-1])


def _collect(system, req: Request) -> None:
    """The request's answer from its raw output (untimed)."""
    units, out = req.answer
    req.answer = None
    if req.error is not None:
        return
    try:
        req.answer = system.collect(out, units)
    except Exception:
        req.error = traceback.format_exc()
        print(f"a request's answer failed:\n{req.error}", file=sys.stderr)


def drive(system, traffic: dict, seconds: float, trace: bool, order, devices, spans,
          max_requests: int = 0):
    """The measured window: (requests, window seconds, trace summary).
    ``max_requests`` > 0 ends an untraced window after that many."""
    requests: list[Request] = []
    summary = None
    with spans.span("window"):
        t_w = time.perf_counter()
        if not trace:
            while (time.perf_counter() - t_w < seconds
                   and not 0 < max_requests <= len(requests)):
                _one(system, _units(traffic, order, len(requests)), requests, "")
            return requests, requests[-1].t1 - t_w, None
        from h100_bench import device_trace as TR

        # part A: the device profiled over the requests alone, their
        # answers collected once the profile has stopped
        a_s = min(float(traffic["trace_seconds"]), seconds)
        sent = []
        with TR.DeviceTrace(devices) as prof:
            t_a = time.perf_counter()
            while True:
                sent.append(_units(traffic, order, len(requests),
                                   traffic.get("trace_queries_per_request")))
                _one(system, sent[-1], requests, "A", defer=True)
                if time.perf_counter() - t_a >= a_s:
                    break
            sync(devices)
            a_window = time.perf_counter() - t_a
        for req in requests:
            _collect(system, req)
        with spans.span("trace.read"):
            summary = prof.summary(a_window)
        # part U: part A's requests again, the profiler off, timed as in a
        # run: the idle share is part A's busy seconds over these seconds
        u_first = len(requests)
        t_u = time.perf_counter()
        for units in sent:
            _one(system, units, requests, "U", defer=True)
        sync(devices)
        if summary is not None:
            summary["replay_s"] = time.perf_counter() - t_u
        for req in requests[u_first:]:
            _collect(system, req)
        # part B: a window of its own length with the stage timers on
        system.profile(True)
        try:
            t_b = time.perf_counter()
            while time.perf_counter() - t_b < seconds:
                _one(system, _units(traffic, order, len(requests)), requests, "B")
        finally:
            system.profile(False)
        return requests, time.perf_counter() - t_w, summary


# -------------------------------------------------------------------- run --
def _finite(v: float) -> float:
    """JSON has no infinity: a check that reads infinite prints 1e300."""
    return float(v) if np.isfinite(v) else 1e300


def run(root: str, workload: str, seed: int, seconds: float, trace: bool, devices,
        t_process: float, system: str = "program", out=None, max_requests: int = 0) -> dict:
    """One run of ``workload`` on ``devices`` (the cell's cards, or one CPU
    device in the tests); prints and returns the result object.
    ``system="control"`` stands the traffic kind's control in the program's
    place, and ``max_requests`` ends its window (control.py)."""
    out = out or sys.stdout
    spans = Spans()
    bench = Bench(root)
    cell = bench.cell(workload)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    limits = bench.limits(workload)["limits"]
    devices = list(devices)
    device = devices[0]
    with spans.span("setup"):
        system = getattr(bench.kind(traffic["kind"]), system)(config, devices)
        with spans.span("setup.load"):
            system.load()
        with spans.span("setup.data"):   # the configuration's data set
            gen = bench.generator(config["generator"]["name"])
            base, queries = gen.make(dict(config["generator"], dimension=config["dimension"]),
                                     int(config["rows"]), int(config["queries"]),
                                     int(config["data_seed"]), device)
        order = query_sequence(traffic, len(queries), seed)
        sample = np.sort(np.random.default_rng([int(seed) % (1 << 63), 3]).choice(
            len(base), min(int(traffic.get("judged_rows", 0)), len(base)), replace=False))
        system.setup(base, queries, sample, spans)
        with spans.span("setup.warm"):   # one request of the cell's own shape
            units = _units(traffic, order, 0, traffic.get("warm_queries_per_request"))
            system.collect(system.request(units), units)
            sync(devices)
    setup_s = time.perf_counter() - t_process
    requests, window_s, summary = drive(system, traffic, seconds, trace, order, devices, spans,
                                        max_requests)
    peak = max((int(torch.cuda.max_memory_allocated(d)) for d in devices if d.type == "cuda"),
               default=0)
    system.close()
    del system
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    from h100_bench import judge

    with spans.span("reference"):
        judged = judge.judge(bench.judge(traffic["kind"]).judge, requests, base, queries,
                             sample, config, limits, device)
    platform = "gpu" if device.type == "cuda" else device.type
    result_run = Run(workload, cell, config, traffic, requests, window_s, setup_s, spans,
                     judged, summary, platform)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench.metrics(kind, workload):
        value = bench.reader(kind, m["name"]).read(result_run)
        if value is not None and np.isfinite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    failed = sum(r.error is not None for r in requests)
    checks = judged["checks"]
    correct = bool(failed == 0 and requests
                   and all(c["value"] <= c["limit"] for c in checks.values()))
    dev = {"platform": platform,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": len(devices), "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(requests), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and summary is not None:
        dev["busy_s"], dev["window_s"] = summary["busy_s"], summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = {name: {"value": _finite(c["value"]), "limit": c["limit"]}
                        for name, c in checks.items()}
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the run loaded {', '.join(found)}; the benchmark measures "
                         "ngt_tpu_torch alone")
    print(f"setup {setup_s:.3f} s, window {window_s:.3f} s, {len(requests)} requests, "
          f"{failed} failed, reference {spans.seconds('reference'):.3f} s; spans: "
          + ", ".join(f"{s['name']} {s['end'] - s['start']:.3f}" for s in spans.items
                      if s["name"] != "window"), file=sys.stderr)
    print("readings: " + ", ".join(f"{k} {v!r}" for k, v in judged["readings"].items())
          + "; requests (ms/steps): " + " ".join(
              f"{(r.t1 - r.t0) * 1e3:.0f}/{r.counters.get('steps', 0)}" for r in requests[:60]),
          file=sys.stderr)
    if summary is not None:
        print(f"trace: busy {summary['busy_s']:.4f} s of {summary['window_s']:.4f} s "
              f"(unprofiled {summary.get('replay_s', 0.0):.4f} s), "
              f"{summary['device_events']} device events, read {summary['read_s']}",
              file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), file=out, flush=True)
    return result
