"""Radius (range) search sample (the port's copy of samples/range_search.py,
after NGT's samples/l2-uint8-range-search): a radius bound with epsilon.

Run:  python samples/torch/range_search.py [--device cuda] [--n 3000]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

import ngt_tpu_torch  # noqa: E402  (path set above)


def main(argv=None):
    ap = argparse.ArgumentParser(description="radius search")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=3000)
    ap.add_argument("--radius", type=float, default=1.0)
    args = ap.parse_args(argv)
    data = np.random.default_rng(3).normal(size=(args.n, 16)).astype(np.float32)
    index = ngt_tpu_torch.create(None, dimension=16, device=args.device)
    index.batch_insert(data, build=True)
    res = index.search(data[100] + 0.01, size=50, epsilon=0.2, radius=args.radius)
    print(f"{len(res)} objects within radius {args.radius}:")
    for oid, dist in res:
        print(f"id={oid}\tdistance={dist:.4f}")
    assert res and res[0][0] == 100, res
    assert all(dist <= args.radius for _, dist in res)
    return res


if __name__ == "__main__":
    main()
