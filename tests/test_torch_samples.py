"""Every sample of samples/torch/ run in-process on the CPU at a small
size through its ``main(argv)``: each one asserts its own check (a
self-match first, the radius bound, recall@10 above 0.9, ``verify``
empty) and returns what it found; no module of JAX or of the JAX package
may be imported while it runs."""

import importlib.util
import os
import sys

import pytest
import torch

SAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "samples", "torch")

#: each sample's small-size arguments
ARGS = {
    "l2_float": ["--n", "600", "--dim", "32"],
    "cosine_float": ["--n", "500", "--dim", "32"],
    "hamming_uint8": ["--n", "400"],
    "hyperbolic": ["--n", "500"],
    "jaccard_sparse": ["--n", "400"],
    "quantized_graph": ["--n", "800", "--dim", "64"],
    "range_search": ["--n", "600"],
    "sharded_search": ["--shards", "4", "--n", "1200", "--dim", "32", "--queries", "32"],
    "large_single_chip": ["--n", "6000", "--queries", "48", "--block-gb", "0.5"],
    "ngtq_10m": ["--n", "12000", "--queries", "64", "--centroids", "48"],
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_every_sample_is_covered():
    assert sorted(f[:-3] for f in os.listdir(SAMPLES) if f.endswith(".py")) == sorted(ARGS)


def _reference_modules():
    return {m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ngt_tpu")}


@pytest.mark.parametrize("name", sorted(ARGS))
def test_sample_runs(name, capsys):
    before = _reference_modules()
    spec = importlib.util.spec_from_file_location(
        f"ngt_tpu_torch_sample_{name}", os.path.join(SAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--device", "cpu", *ARGS[name]])
    assert out
    assert _reference_modules() == before, _reference_modules() - before
    printed = capsys.readouterr()
    assert (printed.out + printed.err).strip()
