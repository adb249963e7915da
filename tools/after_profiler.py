#!/usr/bin/env python3
"""Whether a torch.profiler window leaves the host work after it slower.

    python3 tools/after_profiler.py --workload sift-128-euclidean.batch --seed 7 --requests 3

run from the root of a checkout on a CUDA card.  Sets a search cell of
h100_bench up as a run does, then times requests of the cell's traced
shape (``trace_queries_per_request``, else ``queries_per_request``) in five
phases: the program's search tracer off, on, one window of the cell's
``trace_seconds`` under ``h100_bench.device_trace.DeviceTrace`` (the
profiler of a traced run's part A), then off and on again.  Prints one
JSON line: each phase's median request in ms, and for the phases with the
tracer on, the host's ms per traversal step spent issuing its work
(``traverse.launch`` over ``traverse.steps``).
"""

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--requests", type=int, default=5, help="timed requests a phase")
    args = ap.parse_args(argv)
    sys.path[0] = ROOT
    import torch

    from h100_bench import device_trace, harness
    from h100_bench.systems import sync
    from ngt_tpu_torch import trace

    bench = harness.Bench(ROOT)
    cell = bench.cell(args.workload)
    config, traffic = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    if traffic["kind"] != "search":
        raise SystemExit(f"{args.workload} is not a search cell")
    devices = [torch.device("cuda:0")]
    system = bench.kind("search").program(config, devices)
    system.load()
    gen = bench.generator(config["generator"]["name"])
    base, queries = gen.make(dict(config["generator"], dimension=config["dimension"]),
                             int(config["rows"]), int(config["queries"]),
                             int(config["data_seed"]), devices[0])
    order = harness.query_sequence(traffic, len(queries), args.seed)
    system.setup(base, queries, None, harness.Spans())
    per = traffic.get("trace_queries_per_request")
    sent = [0]

    def request():
        units = harness._units(traffic, order, sent[0], per)
        sent[0] += 1
        t0 = time.perf_counter()
        system.request(units)
        return (time.perf_counter() - t0) * 1e3

    def phase(traced: bool) -> dict:
        system.profile(traced)
        trace.clear()
        try:
            ms = [request() for _ in range(args.requests)]
        finally:
            system.profile(False)
        out = {"median_ms": statistics.median(ms), "ms": ms}
        if traced:
            recs = trace.records()
            steps = sum(r.value for r in recs if r.name == "traverse.steps")
            launch = sum(r.value for r in recs if r.name == "traverse.launch")
            out["launch_ms_per_step"] = 1e3 * launch / steps if steps else None
        return out

    request()   # the warm-up a run makes
    result = {"workload": args.workload, "card": torch.cuda.get_device_name(devices[0]),
              "before_off": phase(False), "before_on": phase(True)}
    t0 = time.perf_counter()
    with device_trace.DeviceTrace(devices):
        n = 0
        while n == 0 or time.perf_counter() - t0 < float(traffic["trace_seconds"]):
            request()
            n += 1
        sync(devices)
    result["profiled"] = {"requests": n, "seconds": time.perf_counter() - t0}
    result["after_off"], result["after_on"] = phase(False), phase(True)
    system.close()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
