"""The ``build`` kind: a fresh bulk build per request, ``create`` +
``batch_insert(rows, build=True)``, the host store fill included.

The answer is the first ``edge_size_for_creation`` edges of the judged
rows, read after the timed call, and the index is freed before the next.
The control is the reference's exact k-NN edges of those rows, its scan in
TF32."""

from __future__ import annotations

import gc
import os

import numpy as np

from h100_bench.kinds.search import SearchControl
from h100_bench.systems import Program


class BuildProgram(Program):
    ENV = "NGT_TPU_BUILD_PROFILE"

    def setup(self, base, queries, sample, spans) -> None:
        self.base, self.sample = base, sample
        self.edges = int(self.config["index"].get("edge_size_for_creation", 10))
        self.phases: dict[str, float] = {}

    def request(self, units):
        idx, ids = self._build(self.base)
        if os.environ.get(self.ENV) == "1":
            from ngt_tpu_torch.graph import build

            for label, sec in build.last_profile:
                self.phases["build." + label] = self.phases.get("build." + label, 0.0) + sec
        return idx, ids

    def collect(self, out, units):
        idx, ids = out
        try:
            if not np.array_equal(ids, np.arange(len(self.base))):
                raise RuntimeError("the index did not number the rows 0..n-1 in order")
            e_ids = np.full((len(self.sample), self.edges), -1, np.int64)
            e_d = np.full((len(self.sample), self.edges), np.inf)
            for j, r in enumerate(self.sample):
                try:
                    row = idx.get_edges(int(r))[: self.edges]
                except KeyError:   # no graph node: its edges never came
                    continue
                e_ids[j, : len(row)] = [i for i, _ in row]
                e_d[j, : len(row)] = [d for _, d in row]
        finally:
            idx.close()
            del idx, out
            gc.collect()
        return e_ids, e_d

    def snapshot(self) -> dict:
        return dict(self.phases)

    def close(self) -> None:
        pass


class BuildControl(SearchControl):
    """Exact k-NN edges of the judged rows, the scan in TF32."""

    def setup(self, base, queries, sample, spans) -> None:
        super().setup(base, queries, sample, spans)
        self.base, self.sample = base, sample

    def request(self, units):
        k = int(self.config["index"].get("edge_size_for_creation", 10))
        return self.ref.topk(self.base[self.sample], k, exclude=self.sample)

    def collect(self, out, units):
        return out


def program(config: dict, devices):
    return BuildProgram(config, devices)


def control(config: dict, devices):
    return BuildControl(config, devices)
