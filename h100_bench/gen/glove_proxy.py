"""A glove-100-shaped angular corpus: bench.py's recipe (and the smoke's
``glove_proxy``) drawn on the device.  A flat power-law spectrum under a
random rotation, Zipf cluster sizes, a log-normal anisotropy and scale per
cluster, log-normal row norms (rows stored un-normalized).  The queries are
further rows of the same generator, drawn after the base."""

from __future__ import annotations

import numpy as np
import torch

from h100_bench.gen._common import generator, power_law, rotation


def make(params: dict, rows: int, queries: int, seed: int, device):
    """(base [rows, d], queries [queries, d]) float32 host arrays."""
    d, kc = int(params["dimension"]), int(params["clusters"])
    g = generator(seed, device)
    v = rotation(d, g, device)
    s = power_law(d, params["spectrum"], device).float()
    w = power_law(kc, -params["zipf"], device)
    centers = (torch.randn(kc, d, generator=g, device=device) * (params["center_scale"] * s)) @ v.T
    local = s * torch.exp(params["anisotropy"] * torch.randn(kc, d, generator=g, device=device))
    lo, hi = params["cluster_scale"]
    local *= lo + (hi - lo) * torch.rand(kc, 1, generator=g, device=device)
    n = rows + queries
    labels = torch.multinomial(w / w.sum(), n, replacement=True, generator=g)
    x = centers[labels] + (torch.randn(n, d, generator=g, device=device) * local[labels]) @ v.T
    del labels
    x *= torch.exp(params["norm_spread"] * torch.randn(n, 1, generator=g, device=device))
    out = x.cpu().numpy()
    return np.ascontiguousarray(out[:rows]), np.ascontiguousarray(out[rows:])
