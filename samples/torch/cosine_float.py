"""Cosine/float sample (the port's copy of samples/cosine_float.py, after
NGT's samples/cosine-float).

Run:  python samples/torch/cosine_float.py [--device cuda] [--n 5000]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

import ngt_tpu_torch  # noqa: E402  (path set above)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Cosine/float search")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=5000)
    ap.add_argument("--dim", type=int, default=64)
    args = ap.parse_args(argv)
    data = np.random.default_rng(1).normal(size=(args.n, args.dim)).astype(np.float32)
    index = ngt_tpu_torch.create(None, dimension=args.dim, distance_type="Cosine",
                                 device=args.device)
    index.batch_insert(data, build=True)
    res = index.search(data[7], size=3, epsilon=0.1)
    for oid, dist in res:
        print(f"id={oid}\tcosine distance={dist:.6f}")
    assert res[0][0] == 7 and res[0][1] < 1e-5, res
    return res


if __name__ == "__main__":
    main()
