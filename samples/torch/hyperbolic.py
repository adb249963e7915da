"""Hyperbolic-metric sample (the port's copy of samples/hyperbolic.py):
Poincare-ball and Lorentz-hyperboloid search (NGT's
PrimitiveComparator.h:596-637).  Hyperbolic embeddings encode hierarchies:
points near the ball's boundary are leaves, points near the origin roots,
so a nearest-neighbor search retrieves tree relatives.

Run:  python samples/torch/hyperbolic.py [--device cuda] [--n 5000]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

import ngt_tpu_torch  # noqa: E402  (path set above)


def poincare_points(rng, n, d):
    """Clustered points in the open unit ball (|x| < 1)."""
    centers = rng.normal(size=(16, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True) * 2.0
    x = centers[rng.integers(0, 16, size=n)] + rng.normal(size=(n, d)) * 0.08
    norm = np.linalg.norm(x, axis=1, keepdims=True)
    return np.where(norm > 0.85, x * (0.85 / norm), x).astype(np.float32)


def lorentz_points(rng, n, d):
    """Points on the hyperboloid x0 = sqrt(1 + |x_space|^2)."""
    sp = rng.normal(size=(n, d - 1)) * 0.5
    x0 = np.sqrt(1.0 + (sp ** 2).sum(axis=1, keepdims=True))
    return np.concatenate([x0, sp], axis=1).astype(np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Poincare and Lorentz search")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=5000)
    ap.add_argument("--dim", type=int, default=16)
    args = ap.parse_args(argv)
    rng = np.random.default_rng(3)
    out = {}
    for metric, maker in (("Poincare", poincare_points), ("Lorentz", lorentz_points)):
        data = maker(rng, args.n, args.dim)
        index = ngt_tpu_torch.create(None, dimension=args.dim, distance_type=metric,
                                     device=args.device)
        index.batch_insert(data, build=True)
        res = index.search(data[123], size=3, epsilon=0.1)
        print(f"-- {metric}")
        for oid, dist in res:
            print(f"id={oid}\t{metric} distance={dist:.6f}")
        assert res[0][0] == 123, (metric, res)
        out[metric] = res
    return out


if __name__ == "__main__":
    main()
