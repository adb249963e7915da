"""What every system under test shares: ngt_tpu_torch's kernel libraries
and an index built as the configuration states.

A traffic mix names its kind, and ``kinds/<kind>.py`` drives it: its
``program(config, devices)`` is the program under test and its
``control(config, devices)`` the control of ``correct`` (control.py); the
comparison that judges its answers is ``judges/<kind>.py``.  A new kind
adds those two files and edits none.

A system has ``load`` (kernel libraries), ``setup(base, queries, sample,
spans)``, ``request(units)`` (the timed call; it returns once the device
has finished), ``collect(out, units)`` (the answer, untimed), ``profile(on)``
(the program's stage timers), ``snapshot()`` (cumulative counters) and
``close`` (frees the program's state).  ``devices`` are the cards the cell
asks for (``chips``), the first of them where a kind uses one.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def sync(devices) -> None:
    for device in devices:
        if device.type == "cuda":
            torch.cuda.synchronize(device)


class Program:
    """ngt_tpu_torch on the first of the cell's cards."""

    #: the program's stage-timer switch (graph/build.py, quant/qgraph.py)
    ENV = ""

    def __init__(self, config: dict, devices):
        self.config, self.devices, self.device = config, list(devices), devices[0]
        self.k = int(config["k"])

    def load(self) -> None:
        """The kernel library (nvcc, built once per checkout) and the host
        graph library (g++), so that no request builds them."""
        from ngt_tpu_torch import native

        if self.device.type == "cuda":
            from ngt_tpu_torch.ops import _build

            _build.load()
        native.load()

    def _create(self):
        import ngt_tpu_torch

        c = self.config
        return ngt_tpu_torch.create(None, dimension=int(c["dimension"]),
                                    distance_type=c["distance_type"],
                                    object_type=c["object_type"], device=self.device,
                                    **c["index"])

    def _build(self, base: np.ndarray):
        idx = self._create()
        ids = idx.batch_insert(base, build=True)
        sync([self.device])
        return idx, ids

    def profile(self, on: bool) -> None:
        if on:
            os.environ[self.ENV] = "1"
        else:
            os.environ.pop(self.ENV, None)
