"""Batched k-means (the port's counterpart of ``ngt_tpu/quant/clustering.py``)
— the redesign of the reference's ``Clustering`` (lib/NGT/Clustering.h:45-927)
as Lloyd iterations over ``[S, n, d]`` stacks of independent problems (the
S subspaces of a product quantizer train together).

* Each iteration scores every row against every centroid with one batched
  matmul (``torch.bmm``, full fp32: ``ops/distances.py`` keeps TF32 off,
  the port's form of ``Precision.HIGHEST``), takes the nearest centroid
  (``torch.argmin``: the first index on ties, as ``jnp.argmin``), and
  moves each centroid to the mean of its rows by ``index_add_``; an empty
  cluster keeps its centroid.  Rows are processed in chunks whose distance
  tile stays under ``TILE_BYTES``.
* The three init modes of the reference (head / random / k-means++,
  Clustering.h:259-333) draw their random numbers on the host from
  ``numpy.random.default_rng(seed)`` and then move them to the device, so a
  run on the card and a run on the CPU start from the same draws.  The
  reference's ``jax.random`` stream cannot be reproduced, so the two
  packages start from different centroids unless one is injected
  (``init=``).  k-means++ draws one uniform per pick and selects by inverse
  CDF over the running minimum distances.
"""

from __future__ import annotations

import numpy as np
import torch

_F32 = torch.float32

#: bytes the [S, rows, k] distance tile of one Lloyd chunk may hold
TILE_BYTES = 1 << 30


def pairwise_sq(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """[S, n, d] x [S, k, d] -> [S, n, k] squared L2 (the reference's
    ``_pairwise_sq``: |x|^2 + |c|^2 - 2 x.c)."""
    dot = torch.bmm(x, c.transpose(1, 2))
    return (x * x).sum(-1)[:, :, None] + (c * c).sum(-1)[:, None, :] - 2.0 * dot


def init_centroids(x: torch.Tensor, k: int, mode: str, seed: int) -> torch.Tensor:
    """x [S, n, d] -> initial centroids [S, k, d]; random draws on the host."""
    s, n, _ = x.shape
    ar = torch.arange(s, device=x.device)
    if mode == "head":
        return x[:, :k].clone()
    rng = np.random.default_rng(seed)
    if mode == "random":
        pick = np.stack([rng.choice(n, k, replace=False) for _ in range(s)])
        return x[ar[:, None], torch.from_numpy(pick).to(x.device)]
    if mode == "kmeans++":
        first = torch.from_numpy(rng.integers(0, n, size=s)).to(x.device)
        u = torch.from_numpy(rng.random((s, max(k - 1, 0)))).to(x.device)
        cents = torch.zeros((s, k, x.shape[2]), dtype=_F32, device=x.device)
        c = x[ar, first]
        cents[:, 0] = c
        mind = ((x - c[:, None, :]) ** 2).sum(-1)
        for i in range(1, k):
            # inverse CDF of p = mind / sum(mind): the first row whose
            # running sum passes u * total (a row at distance 0 never wins)
            cdf = torch.cumsum(mind.to(torch.float64), 1)
            t = (u[:, i - 1] * cdf[:, -1])[:, None]
            pick = torch.searchsorted(cdf, t, right=True)[:, 0].clamp_(max=n - 1)
            c = x[ar, pick]
            cents[:, i] = c
            mind = torch.minimum(mind, ((x - c[:, None, :]) ** 2).sum(-1))
        return cents
    raise ValueError(f"unknown init mode: {mode}")


def _chunk_rows(s: int, n: int, k: int) -> int:
    return int(max(1, min(n, TILE_BYTES // max(s * k * 12, 1))))


def nearest(x: torch.Tensor, cents: torch.Tensor):
    """Nearest centroid per row: (assign [S, n] int64, squared dist [S, n])."""
    s, n, _ = x.shape
    step = _chunk_rows(s, n, cents.shape[1])
    out_a, out_d = [], []
    for i in range(0, n, step):
        d = pairwise_sq(x[:, i : i + step], cents)
        dm, am = torch.min(d, dim=2)
        out_a.append(am)
        out_d.append(dm)
    return torch.cat(out_a, 1), torch.cat(out_d, 1)


def lloyd(x: torch.Tensor, cents: torch.Tensor, iters: int,
          valid: torch.Tensor | None = None):
    """``iters`` Lloyd iterations from ``cents`` over x [S, n, d]; rows where
    ``valid`` [n] is False take no part.  Returns (centroids [S, k, d],
    assignment [S, n] int64 of every row)."""
    s, _, d = x.shape
    k = cents.shape[1]
    xv = x if valid is None else x[:, valid]
    n = xv.shape[1]
    step = _chunk_rows(s, n, k)
    off = (torch.arange(s, device=x.device) * k)[:, None]
    cents = cents.to(_F32).clone()
    for _ in range(iters):
        sums = torch.zeros((s * k, d), dtype=_F32, device=x.device)
        counts = torch.zeros((s * k,), dtype=_F32, device=x.device)
        for i in range(0, n, step):
            xc = xv[:, i : i + step]
            a = torch.argmin(pairwise_sq(xc, cents), dim=2)
            idx = (a + off).reshape(-1)
            sums.index_add_(0, idx, xc.reshape(-1, d))
            counts.index_add_(0, idx, torch.ones_like(idx, dtype=_F32))
        sums, counts = sums.view(s, k, d), counts.view(s, k, 1)
        cents = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), cents)
    return cents, nearest(x, cents)[0]


def kmeans_dev(x: torch.Tensor, k: int, iters: int = 25, mode: str = "kmeans++",
               seed: int = 0, valid: torch.Tensor | None = None,
               init: torch.Tensor | None = None):
    """Device k-means of each of the S problems in x [S, n, d] f32; ``init``
    [S, k, d] replaces the init draw.  Returns (centroids, assignment)."""
    x = x.to(_F32)
    cents = init_centroids(x, k, mode, seed) if init is None else init.to(x.device, _F32)
    return lloyd(x, cents, iters, valid)


def kmeans(x, k: int, iters: int = 25, mode: str = "kmeans++", valid=None,
           seed: int = 0, init=None, device="cuda"):
    """Single k-means on ``device``.  Returns numpy (centroids [k, D],
    assignment [N] int32)."""
    dev = torch.device(device)
    xt = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)[None]
    v = None if valid is None else torch.from_numpy(np.asarray(valid, bool)).to(dev)
    ini = None if init is None else torch.from_numpy(np.asarray(init, np.float32))[None]
    c, a = kmeans_dev(xt, int(k), int(iters), mode, seed, v, ini)
    return c[0].cpu().numpy(), a[0].to(torch.int32).cpu().numpy()


def kmeans_multi(xs, k: int, iters: int = 25, mode: str = "kmeans++",
                 seed: int = 0, init=None, device="cuda"):
    """xs [M, N, Dsub] -> numpy (centroids [M, k, Dsub], assignment [M, N])."""
    dev = torch.device(device)
    xt = torch.from_numpy(np.ascontiguousarray(xs, np.float32)).to(dev)
    ini = None if init is None else torch.from_numpy(np.asarray(init, np.float32))
    c, a = kmeans_dev(xt, int(k), int(iters), mode, seed, None, ini)
    return c.cpu().numpy(), a.to(torch.int32).cpu().numpy()


def mean_squared_error(x, centroids, assign) -> float:
    """Quantization MSE (Clustering::calculateMSE, Clustering.h:781-831)."""
    diff = np.asarray(x, np.float32) - np.asarray(centroids)[assign]
    return float((diff**2).sum(axis=1).mean())
