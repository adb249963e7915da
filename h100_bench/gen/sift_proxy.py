"""A SIFT-shaped clustered corpus: bench.py's recipe (and the smoke's
``sift_proxy``) drawn on the device.  A power-law spectrum under a random
rotation, Zipf cluster sizes, rows shifted non-negative by the base rows'
least value per column.  The queries are further rows of the same clusters
and shift, drawn after the base, so no query is a corpus row."""

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
    n = rows + queries
    labels = torch.multinomial(w / w.sum(), n, replacement=True, generator=g)
    noise = torch.randn(n, d, generator=g, device=device) * (params["noise_scale"] * s)
    x = centers[labels] + noise @ v.T
    del noise, labels
    x += x[:rows].min(0).values.abs()
    out = x.cpu().numpy()
    return np.ascontiguousarray(out[:rows]), np.ascontiguousarray(out[rows:])
