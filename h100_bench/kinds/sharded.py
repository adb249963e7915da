"""The ``sharded`` kind: requests of held-out queries to an index whose rows
are sharded over the cell's cards, one shard a card (the configuration's
``shards``, laid round-robin over the cards there are).

The program is the port's sharded sq8 route, as a vald deployment runs it:
``ShardedIndex.build(base, mesh, metric, object_type, ...)`` and
``ShardedQG.from_sharded_index`` in set-up, ``ShardedQG.search`` a request
(each shard's traversal and re-rank on its own card, the per-shard top-k
lists merged on the first).

The control is not the TF32 reference: the rows and queries of a Byte
configuration are whole numbers up to 255, which TF32's 11-bit significand
holds exactly, and their products and sums of 128 stay below 2^24, exact
in its float32 accumulation, so a TF32 scan would read ``correct``.  The
control is the exact scan over
the program's own sq8 codes at its global scale (``ShardedQG``'s codes of
the same shards), with no re-rank on the rows: the precision the
traversal works at."""

from __future__ import annotations

import sys

import numpy as np
import torch

from h100_bench.systems import Program, sync

#: candidates per query the control's matmul scan keeps before it ranks
#: them by the elementwise distance over the codes
MARGIN = 32


def _mesh(config: dict, devices):
    from ngt_tpu_torch.parallel.sharding import Mesh

    return Mesh([devices[s % len(devices)] for s in range(int(config["shards"]))])


class ShardedProgram(Program):
    ENV = "NGT_TPU_QG_PROFILE"

    def setup(self, base, queries, sample, spans) -> None:
        from ngt_tpu_torch.parallel.sharding import ShardedIndex, ShardedQG
        from ngt_tpu_torch.properties import resolve_distance_type, resolve_object_type

        c = self.config
        with spans.span("setup.build"):
            self.index = ShardedIndex.build(
                base, mesh=_mesh(c, self.devices),
                metric=resolve_distance_type(c["distance_type"]),
                object_type=resolve_object_type(c["object_type"]), **c["index"])
            self.qg = ShardedQG.from_sharded_index(self.index)
            sync(self.devices)
        width = self.qg.x.shape[1]
        q = np.zeros((len(queries), width), np.float32)
        q[:, : queries.shape[1]] = queries
        self.queries = torch.from_numpy(q)

    def request(self, units):
        ids, dists = self.qg.search(self.queries[units], k=self.k,
                                    epsilon=float(self.config["search"]["epsilon"]))
        return ids.cpu(), dists.cpu()

    def collect(self, out, units):
        ids, dists = (t.numpy() for t in out)
        rows = np.where(ids >= 0, self.index.id_map[np.clip(ids, 0, None)], -1)
        return units, rows, dists

    def snapshot(self) -> dict:
        from ngt_tpu_torch.graph.search import graph_search

        return {"steps": graph_search.steps}

    def close(self) -> None:
        """Frees the index, after printing on standard error each card's
        peak and held memory, the traversal loops it keeps cached, and the
        graphs captured while the tracer was on (in a traced run: part B)."""
        from ngt_tpu_torch import trace
        from ngt_tpu_torch.graph import search

        cards = [d for d in self.devices if d.type == "cuda"]
        if cards:
            print("cards (peak / held GiB, cached loops): " + ", ".join(
                f"{d} {torch.cuda.max_memory_allocated(d) / 2**30:.2f} / "
                f"{torch.cuda.memory_allocated(d) / 2**30:.2f}, "
                f"{sum(key[0] == str(d) for key in search._GRAPHS)}" for d in cards)
                + "; traced captures "
                + str(sum(r.value for r in trace.records() if r.name == "traverse.captures")),
                file=sys.stderr)
        del self.qg, self.index


class ShardedControl:
    """Exact top-k of each request's queries over the program's sq8 codes,
    divided by its global scale, the distances scaled back."""

    def __init__(self, config: dict, devices):
        self.config, self.devices = config, list(devices)

    def load(self) -> None:
        pass

    def setup(self, base, queries, sample, spans) -> None:
        from ngt_tpu_torch.parallel.sharding import ShardedQG
        from ngt_tpu_torch.properties import resolve_distance_type

        mesh = _mesh(self.config, self.devices)
        p, n = mesh.size, len(base)
        self.n_local = n_local = (n + p - 1) // p
        x = np.zeros((p, n_local, base.shape[1]), np.float32)
        valid = np.zeros((p, n_local), bool)
        for s in range(p):
            x[s, : len(base[s::p])] = base[s::p]
            valid[s, : len(base[s::p])] = True
        # the program's codes and scale, of the shards with no graph
        qg = ShardedQG(mesh, x, np.full((p, n_local, 1), -1, np.int32), valid,
                       np.zeros((p, 1), np.int32), resolve_distance_type(
                           self.config["distance_type"]))
        del x
        self.scale, self.mesh = qg.sq_scale, mesh
        self.codes = [c.float() for c in qg.codes.parts]
        self.code_sq = [torch.where(v, (c * c).sum(1), torch.inf)
                        for c, v in zip(self.codes, qg.valid.parts)]
        self.queries = queries

    def request(self, units, chunk: int = 256):
        k = int(self.config["k"])
        p = self.mesh.size
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            d_all, i_all = [], []
            for s, (codes, code_sq) in enumerate(zip(self.codes, self.code_sq)):
                dev = codes.device
                ds, ix = [], []
                for lo in range(0, len(units), chunk):
                    q = torch.from_numpy(self.queries[units[lo : lo + chunk]]).to(dev)
                    q = q / np.float32(self.scale)
                    sc = code_sq[None, :] - 2.0 * (q @ codes.T)
                    cand = torch.topk(sc, min(k + MARGIN, sc.shape[1]), dim=1,
                                      largest=False).indices
                    del sc
                    diff = q[:, None, :] - codes[cand]
                    d2 = torch.where(torch.isfinite(code_sq[cand]), (diff * diff).sum(-1),
                                     torch.inf)
                    d2, order = torch.sort(d2, dim=1, stable=True)
                    ds.append(torch.sqrt(d2[:, :k]).cpu().numpy() * self.scale)
                    ix.append((cand.gather(1, order[:, :k]) * p + s).cpu().numpy())
                d_all.append(np.concatenate(ds))
                i_all.append(np.concatenate(ix))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
        d = np.concatenate(d_all, 1)
        i = np.concatenate(i_all, 1)
        top = np.argsort(d, axis=1, kind="stable")[:, :k]
        return np.take_along_axis(i, top, 1), np.take_along_axis(d, top, 1)

    def collect(self, out, units):
        return units, out[0], out[1]

    def profile(self, on: bool) -> None:
        pass

    def snapshot(self) -> dict:
        return {}

    def close(self) -> None:
        del self.codes, self.code_sq


def program(config: dict, devices):
    return ShardedProgram(config, devices)


def control(config: dict, devices):
    return ShardedControl(config, devices)
