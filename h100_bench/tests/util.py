"""Helpers of the benchmark's tests."""

import io
import os
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
#: rows and queries of every configuration in a CPU run
TINY_ROWS, TINY_QUERIES = 6000, 300
#: the recall_gap limit of every search cell in those runs (conftest.py)
TINY_RECALL_GAP = 0.15


def run_cpu(root, workload, seed=2**31 + 11, seconds=1.0, trace=False, **kw):
    """One run of the harness on the CPU; its result object."""
    from h100_bench import harness

    return harness.run(str(root), workload, seed, seconds, trace, [torch.device("cpu")],
                       time.perf_counter(), out=io.StringIO(), **kw)
