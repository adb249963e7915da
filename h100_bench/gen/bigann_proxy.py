"""A BIGANN-shaped corpus: the SIFT-shaped recipe of ``sift_proxy`` (a
power-law spectrum under a random rotation, Zipf cluster sizes, rows
shifted non-negative), scaled so that the base rows' largest value is 255,
rounded and clipped to 0..255: the uint8 SIFT descriptors of BIGANN.  The
queries are further rows of the same clusters, drawn after the base and
scaled alike, so no query is a corpus row.  The values are whole numbers
in float32 arrays, as every generator returns; a Byte index stores them
as uint8 exactly."""

from __future__ import annotations

import numpy as np

from h100_bench.gen import sift_proxy


def make(params: dict, rows: int, queries: int, seed: int, device):
    """(base [rows, d], queries [queries, d]) float32 host arrays of whole
    numbers in 0..255."""
    base, held = sift_proxy.make(params, rows, queries, seed, device)
    scale = np.float32(255.0) / base.max()
    for a in (base, held):
        np.multiply(a, scale, out=a)
        np.rint(a, out=a)
        np.clip(a, 0, 255, out=a)
    return base, held
