"""The port's entry points (ngt_tpu_torch/graft_entry.py) against the
repository's ``__graft_entry__.py`` on the CPU, and the port's utils
probes against the reference's.

* ``entry(device="cpu")``: the same toy graph, queries and seeds through
  both packages' ``graph_search`` (the reference under ``jax.jit``): ids
  equal, distances to rtol 1e-5 / atol 1e-4 (the packages sum a row's
  squares in another order);
* ``dryrun_multichip(8, device="cpu")``: 8 CPU shards print the line the
  reference prints on conftest's 8 virtual devices;
* ``Timer`` and the VM probes hold what tests/test_cli_native.py holds of
  the reference's, and both modules offer the same public names.
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from ngt_tpu import utils as JU
from ngt_tpu_torch import graft_entry as TE
from ngt_tpu_torch import utils as TU

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference():
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", os.path.join(_ROOT, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_toy_index_matches_reference():
    for a, b in zip(TE._toy_index(), _reference()._toy_index()):
        np.testing.assert_array_equal(a, b)


def test_entry_matches_reference():
    fn, args = TE.entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)
    ti, td = fn(*args)
    jfn, jargs = _reference().entry()
    ji, jd = jax.jit(jfn)(*jargs)
    assert tuple(ti.shape) == tuple(ji.shape) == (32, 10)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-4)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_dryrun_multichip_matches_reference(capsys):
    _reference().dryrun_multichip(8)
    want = capsys.readouterr().out.strip().splitlines()[-1]
    TE.dryrun_multichip(8, device="cpu")
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert want.startswith("dryrun_multichip ok: 8 devices")
    assert got == want


def test_entry_points_default_to_cuda():
    """Without a card the default device raises; nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        TE.entry()
    with pytest.raises(RuntimeError):
        TE.dryrun_multichip(2)


def test_utils_probes_and_timer():
    assert TU.get_process_vm_rss() > 0
    assert TU.get_process_vm_size() >= TU.get_process_vm_rss()
    assert TU.get_process_vm_peak() >= TU.get_process_vm_rss() // 2
    assert TU.get_process_vm_peak() >= TU.get_process_vm_size() // 2
    assert abs(TU.get_process_vm_peak() - JU.get_process_vm_peak()) <= \
        JU.get_process_vm_peak() // 2
    t = TU.Timer().start()
    t.stop()
    assert t.time >= 0
    first = t.time
    t.stop()                       # a stop without a start adds nothing
    assert t.time == first
    t.start().stop()
    assert t.time >= first
    assert t.reset().time == 0.0 and t._t0 is None
    TU.disable_log()
    TU.enable_log()


def test_utils_public_names_match_reference():
    def public(m):
        return {n for n in dir(m) if not n.startswith("_")}

    assert public(TU) == public(JU)
