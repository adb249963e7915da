"""Tests of the benchmark itself.  They import neither JAX nor the JAX
package and run the harness on the CPU at a few thousand rows; the tests
marked ``gpu`` need a CUDA card and skip without one (decided inside the
test).  Run them from the repository's root:

    python -m pytest -q -p no:cacheprovider h100_bench/tests
"""

import json
import os
import shutil

import pytest
import torch

from h100_bench.tests.util import ROOT, TINY_QUERIES, TINY_RECALL_GAP, TINY_ROWS


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture()
def tiny_root(tmp_path):
    """A copy of BENCHMARK.json and the benchmark's folder whose
    configurations hold TINY_ROWS rows and TINY_QUERIES queries."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "h100_bench"), root / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for cfg in (root / "h100_bench" / "configs").glob("*.json"):
        d = json.loads(cfg.read_text())
        d.update(rows=TINY_ROWS, queries=TINY_QUERIES)
        cfg.write_text(json.dumps(d))
    # at 6,000 rows the glove proxy's held-out queries reach a recall@10 of
    # about 0.91 (0.99 on the SIFT proxy): the tiny runs hold recall_gap to
    # TINY_RECALL_GAP, every other limit as the cell has it
    for cell in (root / "h100_bench" / "cells").glob("*.json"):
        d = json.loads(cell.read_text())
        if "recall_gap" in d["limits"]:
            d["limits"]["recall_gap"] = TINY_RECALL_GAP
        cell.write_text(json.dumps(d))
    return root
