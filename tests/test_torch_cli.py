"""The port's CLI (``ngt_tpu_torch.cli``, ``--device cpu``) against the JAX
package's (``ngt_tpu.cli``) on the same argv and the same files, on the CPU.

Standard output must be equal line by line, except the lines that carry
wall time (``# Query Time (msec)=``, ``Query Time=`` and the average), and
so must standard error apart from its timing lines; the files that
``export`` writes must be byte-equal and ``export-graph``'s output equal.
Each scenario runs on its own copies of one index pair that both CLIs
created from one TSV (``create``, ``append``, ``create --no-build`` +
``build``).  Commands whose result depends on wall time or on a random
k-means init are held only where they do not: ``reconstruct-graph`` runs
with ``-m s`` (no edge-size tuning by measured speed), ``quantize`` in the
auto mode (sq8 codes), ``optimize-search-parameters`` to its accuracy
table, and the ``ngtq-*`` family on copies of an IVFPQ index that the JAX
package's ``ngtq-create`` trained (the port's own ``ngtq-create`` is held
to ``ngtq-info``, which its k-means does not decide).
"""

from __future__ import annotations

import contextlib
import io
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import ref_native_build  # noqa: F401  (builds the reference's library under a lock)
import torch

from ngt_tpu import cli as JC
from ngt_tpu import native as JN
from ngt_tpu_torch import cli as TC

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM = 16
#: lines that carry wall time (stdout) or timings (stderr)
TIME_PREFIXES = ("# Query Time (msec)=", "Query Time=", "# Average Query Time (msec)=",
                 "Data loading time=", "Index creation time=", "Rebuild time=",
                 "Compress time=")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU search loops run many small ops; beside the suite's
    other workers one intra-op thread is faster."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run(pkg: str, argv: list[str]) -> tuple[int, list[str], list[str]]:
    """(exit code, stdout lines, stderr lines) of one CLI call in-process."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = JC.main(argv) if pkg == "jax" else TC.main(["--device", "cpu", *argv])
    return rc, out.getvalue().splitlines(), err.getvalue().splitlines()


def untimed(lines: list[str]) -> list[str]:
    return [ln for ln in lines if not ln.startswith(TIME_PREFIXES)]


def both(dirs: dict, argv: list[str]) -> list[str]:
    """Run ``argv`` (``{I}``-style placeholders filled per package) through
    both CLIs; assert equal exit codes, stdout and stderr; return stdout."""
    res = {}
    for pkg in ("jax", "torch"):
        res[pkg] = run(pkg, [a.format(**dirs[pkg]) for a in argv])
    (jrc, jout, jerr), (trc, tout, terr) = res["jax"], res["torch"]
    assert trc == jrc, argv
    assert untimed(tout) == untimed(jout), argv
    assert untimed(terr) == untimed(jerr), argv
    return tout


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    """An index pair made through both CLIs from the same TSV files, with
    the outputs of making them: ``create`` + ``append`` (an incremental
    build) of 360 rows, and ``create --no-build`` + ``build`` of 40 (the
    index ``optimize-search-parameters`` tunes on its whole extracted
    query set)."""
    assert JN.available(), "the reference's native library did not load"
    root = tmp_path_factory.mktemp("cli")
    # integers in 0..63: every distance is exact in float32 in both
    # packages, so the printed distances and the exported bytes can be
    # held equal; no row ties at its 10th and 11th neighbour, where the two
    # bulk builds keep different rows (ROADMAP, Queue 3; pinned by
    # tests/test_torch_metrics.py::test_tied_last_edges_pinned)
    data = np.random.default_rng(5).integers(0, 64, size=(360, DIM)).astype(np.float32)
    d2 = ((data[:300, None] - data[None, :300]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    kth = np.sort(d2, axis=1)[:, 9:11]
    assert (kth[:, 0] < kth[:, 1]).all()
    files = {"D": str(root / "data.tsv"), "A": str(root / "more.tsv"),
             "S": str(root / "small.tsv"), "Q": str(root / "query.tsv")}
    np.savetxt(files["D"], data[:300], delimiter="\t", fmt="%.0f")
    np.savetxt(files["A"], data[300:], delimiter="\t", fmt="%.0f")
    np.savetxt(files["S"], data[:40], delimiter="\t", fmt="%.0f")
    np.savetxt(files["Q"], data[:4] + 1, delimiter="\t", fmt="%.0f")
    dirs = {pkg: {**files, "I": str(root / pkg / "idx"), "B": str(root / pkg / "built")}
            for pkg in ("jax", "torch")}
    outputs = [both(dirs, argv) for argv in (
        ["create", "-d", str(DIM), "{I}", "{D}"],
        ["append", "{I}", "{A}"],
        ["create", "-d", str(DIM), "--no-build", "{B}", "{S}"],
        ["build", "{B}"],
    )]
    return root, dirs, outputs


@pytest.fixture()
def pair(made, tmp_path):
    """Fresh copies of the index pair, and the placeholders of both."""
    _, dirs, _ = made
    out = {}
    for pkg in ("jax", "torch"):
        d = dict(dirs[pkg])
        for key in ("I", "B"):
            d[key] = str(tmp_path / pkg / os.path.basename(dirs[pkg][key]))
            shutil.copytree(dirs[pkg][key], d[key])
        d["O"] = str(tmp_path / pkg / "out")
        d["F"] = str(tmp_path / pkg / "export.txt")
        out[pkg] = d
    return out


def test_create_append_build(made, pair):
    """The making commands print the same, and the two indexes answer the
    same queries alike."""
    _, _, outputs = made
    assert all(out == [] for out in outputs)
    for key in ("I", "B"):
        lines = both(pair, ["search", "-o", "e", "-n", "5", "{" + key + "}", "{Q}"])
        assert "# End of Evaluation" in lines


S = ["search", "-o", "e", "-n", "5"]
SCENARIOS = {
    "search eval": [S + ["{I}", "{Q}"]],
    "search plain": [["search", "-n", "5", "{I}", "{Q}"]],
    "search epsilon sweep": [S + ["-e", "0:0.2:0.1", "{I}", "{Q}"]],
    "search linear": [S + ["-i", "s", "{I}", "{Q}"]],
    "remove": [["remove", "{I}", "3", "7", "20"], ["remove", "{I}", "11"],
               S + ["{I}", "{Q}"], ["info", "-m", "v", "{I}"]],
    "info": [["info", "{I}"], ["info", "-m", "e", "{I}"], ["info", "-m", "v", "{I}"],
             ["info", "-m", "c", "{I}"]],
    "repair": [["repair", "{I}"], ["info", "-m", "v", "{I}"]],
    "reconstruct-graph": [["reconstruct-graph", "-m", "s", "-o", "8", "-i", "24", "{I}", "{O}"],
                          S + ["{O}", "{Q}"], ["info", "-m", "e", "{O}"]],
    "reconstruct-anng": [["reconstruct-anng", "-e", "5", "-o", "{O}", "{I}"],
                         S + ["{O}", "{Q}"], ["export-graph", "{O}"]],
    "refine-anng": [["refine-anng", "-e", "0.1", "{I}"], S + ["{I}", "{Q}"]],
    "prune": [["prune", "-e", "6", "-p", "12", "{I}"], S + ["{I}", "{Q}"],
              ["info", "-m", "e", "{I}"]],
    "export-graph": [["export-graph", "{B}"]],
    "optimize-search-parameters": [["optimize-search-parameters", "{B}"]],
    "extract-query": [["extract-query", "-n", "5", "{I}"]],
    "quantize": [["quantize", "{I}"], ["qsearch", "-n", "5", "{I}", "{Q}"],
                 ["qsearch", "-n", "5", "-e", "0.02:0.04:0.02", "-p", "2:3", "{I}", "{Q}"]],
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_jax(pair, name):
    for argv in SCENARIOS[name]:
        both(pair, argv)


def test_export_import_files_equal(pair):
    """``export`` writes the same bytes; each package's ``import`` of its
    own stream answers alike, and each imports the other's."""
    both(pair, ["export", "{I}", "{F}"])
    with open(pair["jax"]["F"], "rb") as a, open(pair["torch"]["F"], "rb") as b:
        assert a.read() == b.read()
    both(pair, ["import", "{O}", "{F}"])
    both(pair, S + ["{O}", "{Q}"])
    both(pair, ["info", "-m", "e", "{O}"])
    crossed = {"jax": dict(pair["jax"], F=pair["torch"]["F"]),
               "torch": dict(pair["torch"], F=pair["jax"]["F"], O=pair["torch"]["O"] + "2")}
    crossed["jax"]["O"] = pair["jax"]["O"] + "2"
    both(crossed, ["import", "{O}", "{F}"])
    both(crossed, S + ["{O}", "{Q}"])


def test_eval_matches_jax(made, pair):
    """``eval`` of one ground-truth stream and one result stream, both
    written by the JAX package's ``search``, prints the same table."""
    root, _, _ = made
    gt, res = str(root / "gt.txt"), str(root / "res.txt")
    for path, extra in ((gt, ["-i", "s"]), (res, ["-e", "0:0.1:0.1"])):
        _, lines, _ = run("jax", S + extra + [pair["jax"]["I"], pair["jax"]["Q"]])
        with open(path, "w") as fh:
            fh.write("\n".join(lines) + "\n")
    out = both(pair, ["eval", "-n", "5", gt, res])
    assert out[0] == "# epsilon\tprecision\tqueries\tavg-time(ms)" and len(out) == 3


@pytest.fixture(scope="module")
def ngtq(made):
    """An IVFPQ index trained by the JAX package's ``ngtq-create`` (the
    k-means inits of the two packages are drawn differently), and the
    port's own ``ngtq-create`` of the same rows."""
    root, dirs, _ = made
    argv = ["ngtq-create", "-d", str(DIM), "-C", "8", "-Q", "2", "{N}", "{D}"]
    made_by = {}
    for pkg in ("jax", "torch"):
        path = str(root / pkg / "ngtq")
        rc, out, _ = run(pkg, [a.format(N=path, **dirs[pkg]) for a in argv])
        assert rc == 0 and out == []
        made_by[pkg] = path
    return made_by


def test_ngtq_create_matches_jax(ngtq):
    """``ngtq-info`` of each package's own ``ngtq-create``: counts, shapes
    and bytes, none of which the k-means decides."""
    info = {pkg: run(pkg, ["ngtq-info", ngtq[pkg]]) for pkg in ngtq}
    assert info["torch"] == info["jax"]
    assert "objects\t300" in info["jax"][1] and "centroids\t8" in info["jax"][1]


@pytest.mark.parametrize("steps", [
    [["ngtq-info", "{N}"], ["ngtq-validate", "{N}"],
     ["ngtq-search", "-n", "5", "-p", "4", "{N}", "{Q}"],
     ["ngtq-search", "-n", "5", "-m", "e", "-b", "2:4:x2", "{N}", "{Q}"]],
    [["ngtq-append", "{N}", "{A}"], ["ngtq-remove", "{N}", "3", "5"],
     ["ngtq-compress", "{N}"], ["ngtq-info", "{N}"],
     ["ngtq-search", "-n", "5", "-m", "a", "{N}", "{Q}"]],
], ids=["read", "mutate"])
def test_ngtq_family_matches_jax(made, ngtq, tmp_path, steps):
    """The ``ngtq-*`` commands on copies of the JAX package's IVFPQ index."""
    _, dirs, _ = made
    pair = {}
    for pkg in ("jax", "torch"):
        path = str(tmp_path / pkg)
        shutil.copytree(ngtq["jax"], path)
        pair[pkg] = dict(dirs[pkg], N=path)
    for argv in steps:
        both(pair, argv)


def test_rebuild_runs(ngtq, tmp_path):
    """``ngtq-rebuild`` retrains the codebooks (the init draw differs), so
    only its output and the index's shape are held."""
    pair = {}
    for pkg in ("jax", "torch"):
        pair[pkg] = {"N": str(tmp_path / pkg)}
        shutil.copytree(ngtq["jax"], pair[pkg]["N"])
    both(pair, ["ngtq-rebuild", "{N}"])
    _, info, _ = run("torch", ["ngtq-info", pair["torch"]["N"]])
    assert "objects\t300" in info and "centroids\t8" in info


def test_module_entry_point(made, tmp_path):
    """``python -m ngt_tpu_torch --device cpu`` in a fresh interpreter
    without JAX prints what the in-process call prints."""
    _, dirs, _ = made
    argv = ["search", "-n", "3", dirs["torch"]["I"], dirs["torch"]["Q"]]
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-m", "ngt_tpu_torch", "--device", "cpu", *argv],
                          capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert untimed(proc.stdout.splitlines()) == untimed(run("torch", argv)[1])
