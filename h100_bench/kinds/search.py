"""The ``search`` kind: requests of held-out queries to an index built once
in set-up.

The program is ``Index.batch_search``; at the configurations' sizes with
default properties it routes ``_maybe_qg`` → ``QuantizedGraphIndex.
batch_search``.  The control is the reference's exact top k with its scan
in TF32."""

from __future__ import annotations

import numpy as np

from h100_bench.systems import Program


class SearchProgram(Program):
    ENV = "NGT_TPU_QG_PROFILE"

    def setup(self, base, queries, sample, spans) -> None:
        self.queries = queries
        with spans.span("setup.build"):
            self.idx, ids = self._build(base)
        if not np.array_equal(ids, np.arange(len(base))):
            raise RuntimeError("the index did not number the rows 0..n-1 in order")

    def request(self, units):
        return self.idx.batch_search(self.queries[units], size=self.k,
                                     epsilon=float(self.config["search"]["epsilon"]))

    def collect(self, out, units):
        ids, dists = out
        return units, np.asarray(ids), np.asarray(dists)

    def snapshot(self) -> dict:
        from ngt_tpu_torch.graph.search import graph_search
        from ngt_tpu_torch.quant import qgraph

        out = {"steps": graph_search.steps}
        out.update({"qg." + k: v for k, v in qgraph.last_profile.items()})
        return out

    def close(self) -> None:
        self.idx.close()
        del self.idx


class SearchControl:
    """Exact top-k of each request's queries, the scan in TF32."""

    def __init__(self, config: dict, devices):
        self.config, self.device = config, devices[0]

    def load(self) -> None:
        pass

    def setup(self, base, queries, sample, spans) -> None:
        from h100_bench.reference import ExactSearch

        self.queries = queries
        self.ref = ExactSearch(base, self.config["distance_type"], self.device, control=True)

    def request(self, units):
        return self.ref.topk(self.queries[units], int(self.config["k"]))

    def collect(self, out, units):
        return units, out[0], out[1]

    def profile(self, on: bool) -> None:
        pass

    def snapshot(self) -> dict:
        return {}

    def close(self) -> None:
        del self.ref


def program(config: dict, devices):
    return SearchProgram(config, devices)


def control(config: dict, devices):
    return SearchControl(config, devices)
