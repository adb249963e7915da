"""The plain reference: exact nearest neighbours under L2 and cosine, and
the arithmetic that judges an answer against them.

It reads only the rows and queries the benchmark made, never anything the
program under test made, and imports neither the program nor JAX.  The
candidate scan is a chunked matmul in float32 with TF32 off; every
candidate's distance is then computed again in float64 from the rows
themselves (no norm trick), so the top k does not inherit the matmul's
cancellation.  ``control=True`` gives the control of ``correct``: the same
search with its products in TF32, the precision one below the float32
(TF32 off) the configurations state and a one-line change away, and the
scan's own float32 distances returned.  TF32 is applied by rounding the
matmul's inputs to its 10 mantissa bits, as the tensor cores do, so that
it holds for one-row products too, which cuBLAS would run in float32.
"""

from __future__ import annotations

import numpy as np
import torch

METRICS = ("L2", "Cosine")
#: candidates kept per query by the float32 scan before the float64 re-rank
MARGIN = 32


def exact_distances(queries: np.ndarray, rows: np.ndarray, metric: str) -> np.ndarray:
    """float64 distance of each query [B, D] to each of its rows [B, K, D]:
    Euclidean, or 1 - cos."""
    q = np.asarray(queries, np.float64)[:, None, :]
    x = np.asarray(rows, np.float64)
    if metric == "L2":
        return np.sqrt(((q - x) ** 2).sum(-1))
    if metric == "Cosine":
        qn = np.linalg.norm(q, axis=-1)
        xn = np.linalg.norm(x, axis=-1)
        return 1.0 - (q * x).sum(-1) / np.maximum(qn * xn, 1e-300)
    raise ValueError(f"the reference knows {METRICS}, not {metric!r}")


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits, to nearest)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class ExactSearch:
    """Exhaustive k-NN over ``base`` (float32 host rows) on ``device``;
    ``control=True`` computes the scan in TF32 and returns its distances."""

    def __init__(self, base: np.ndarray, metric: str, device, control: bool = False):
        if metric not in METRICS:
            raise ValueError(f"the reference knows {METRICS}, not {metric!r}")
        self.base = np.asarray(base, np.float32)
        self.metric, self.device, self.low = metric, torch.device(device), control
        self.x = self._prep(self.base)
        self.x_sq = (self.x * self.x).sum(1) if metric == "L2" else None
        self.x_tf32 = tf32_round(self.x) if control else None

    def _prep(self, rows: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(rows, np.float32)).to(self.device)
        if self.metric == "Cosine":
            t = t.double()
            t = t / t.norm(dim=1, keepdim=True).clamp_min(1e-300)
        return t.float()

    def _dot(self, q: torch.Tensor) -> torch.Tensor:
        if self.low:
            return tf32_round(q) @ self.x_tf32.T
        return q @ self.x.T

    def topk(self, queries: np.ndarray, k: int, exclude: np.ndarray | None = None,
             chunk: int = 1024) -> tuple[np.ndarray, np.ndarray]:
        """Top-``k`` row ids [B, k] (int64) and distances [B, k] (float64),
        nearest first; ``exclude`` [B] names one row per query to leave out
        (a corpus row's own id).  The scan keeps ``k + MARGIN`` candidates
        and float64 distances rank them; the control returns the scan's own
        top k and distances."""
        old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            keep = min(k + (0 if self.low else MARGIN), len(self.base))
            out_i, out_d = [], []
            for lo in range(0, len(queries), chunk):
                qh = np.asarray(queries[lo : lo + chunk], np.float32)
                q = self._prep(qh)
                dot = self._dot(q)
                s = self.x_sq[None, :] - 2.0 * dot if self.metric == "L2" else -dot
                del dot
                if exclude is not None:
                    own = torch.from_numpy(
                        np.asarray(exclude[lo : lo + chunk], np.int64)).to(self.device)
                    s.scatter_(1, own[:, None], float("inf"))
                sv, si = torch.topk(s, keep, dim=1, largest=False, sorted=True)
                del s
                ids = si.cpu().numpy().astype(np.int64)
                if self.low:
                    if self.metric == "L2":
                        d = torch.sqrt(torch.clamp(sv + (q * q).sum(1)[:, None], min=0))
                    else:
                        d = 1.0 + sv
                    out_i.append(ids[:, :k])
                    out_d.append(d[:, :k].cpu().numpy().astype(np.float64))
                    continue
                d = exact_distances(qh, self.base[ids], self.metric)
                if exclude is not None:
                    d[ids == np.asarray(exclude[lo : lo + chunk])[:, None]] = np.inf
                order = np.argsort(d, axis=1, kind="stable")[:, :k]
                out_i.append(np.take_along_axis(ids, order, 1))
                out_d.append(np.take_along_axis(d, order, 1))
            return np.concatenate(out_i), np.concatenate(out_d)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def hits(found: np.ndarray, exact: np.ndarray) -> np.ndarray:
    """Per row, how many of ``exact``'s ids ``found`` holds (NGT's
    Optimizer::evaluate: |found ∩ exact|); negative ids never count."""
    f = np.asarray(found, np.int64)
    e = np.asarray(exact, np.int64)
    same = (f[:, :, None] == e[:, None, :]) & (f[:, :, None] >= 0)
    return same.any(1).sum(1)


def distance_gaps(queries: np.ndarray, base: np.ndarray, ids: np.ndarray,
                  dists: np.ndarray, metric: str) -> np.ndarray:
    """Per answer, the largest gap between a distance the answer reports and
    the float64 distance of the id it names, as a share of that distance
    (floored at a thousandth of the answers' median distance).  An answer
    that names an id twice, an id outside the corpus, no id (-1) or a
    distance that is not finite reads infinity."""
    ids = np.asarray(ids, np.int64)
    dists = np.asarray(dists, np.float64)
    n = len(base)
    ok = (ids >= 0) & (ids < n) & np.isfinite(dists)
    srt = np.sort(ids, axis=1)
    dup = (srt[:, 1:] == srt[:, :-1]).any(1)
    ref = exact_distances(queries, base[np.clip(ids, 0, n - 1)], metric)
    floor = max(1e-3 * float(np.median(ref)), 1e-30) if ref.size else 1e-30
    gap = np.abs(dists - ref) / np.maximum(np.abs(ref), floor)
    gap = np.where(ok, gap, np.inf).max(1)
    return np.where(dup, np.inf, gap)
