"""Each corpus generator at a tiny size: deterministic for one seed,
different for another, and valid for seeds past 2**31."""

import json
import os

import numpy as np
import pytest
import torch

from h100_bench import harness
from h100_bench.tests.util import ROOT


def _configs():
    bench = harness.Bench(ROOT)
    return [bench.config(c["name"]) for c in bench.spec["configs"]]


@pytest.mark.parametrize("config", _configs(), ids=lambda c: c["name"])
def test_generator_deterministic(config):
    gen = harness.Bench(ROOT).generator(config["generator"]["name"])
    params = dict(config["generator"], dimension=config["dimension"])
    cpu = torch.device("cpu")
    a_base, a_q = gen.make(params, 500, 40, 2**31 + 5, cpu)
    b_base, b_q = gen.make(params, 500, 40, 2**31 + 5, cpu)
    c_base, _ = gen.make(params, 500, 40, 3, cpu)
    assert a_base.shape == (500, config["dimension"]) and a_q.shape == (40, config["dimension"])
    assert a_base.dtype == np.float32 and a_q.dtype == np.float32
    np.testing.assert_array_equal(a_base, b_base)
    np.testing.assert_array_equal(a_q, b_q)
    assert not np.array_equal(a_base, c_base)
    assert np.isfinite(a_base).all() and np.isfinite(a_q).all()
    # no held-out query is a corpus row
    d = ((a_q[:, None, :] - a_base[None, :, :]) ** 2).sum(-1)
    assert d.min() > 0


def test_sift_rows_are_non_negative():
    bench = harness.Bench(ROOT)
    config = bench.config("sift-128-euclidean")
    gen = bench.generator("sift_proxy")
    base, _ = gen.make(dict(config["generator"], dimension=128), 2000, 10, 9, torch.device("cpu"))
    assert base.min() >= 0.0


def test_every_config_file_is_named_in_benchmark_json():
    bench = harness.Bench(ROOT)
    named = {os.path.normpath(c["file"]) for c in bench.spec["configs"]}
    on_disk = {os.path.join("h100_bench", "configs", f)
               for f in os.listdir(os.path.join(ROOT, "h100_bench", "configs"))}
    assert named == on_disk
    for c in bench.spec["configs"]:
        with open(os.path.join(ROOT, c["file"])) as fh:
            assert json.load(fh)["name"] == c["name"]
