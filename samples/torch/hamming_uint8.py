"""Hamming/uint8 sample (the port's copy of samples/hamming_uint8.py, after
NGT's samples/hamming-uint8): vectors are raw bit patterns stored as uint8.

Run:  python samples/torch/hamming_uint8.py [--device cuda] [--n 2000]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

import ngt_tpu_torch  # noqa: E402  (path set above)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Hamming/uint8 search")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--dim", type=int, default=32)
    args = ap.parse_args(argv)
    data = np.random.default_rng(2).integers(0, 256, size=(args.n, args.dim), dtype=np.uint8)
    index = ngt_tpu_torch.create(None, dimension=args.dim, distance_type="Hamming",
                                 object_type="Byte", device=args.device)
    index.batch_insert(data, build=True)
    res = index.search(data[5].astype(np.float32), size=3, epsilon=0.2)
    for oid, dist in res:
        print(f"id={oid}\thamming={int(dist)}")
    assert res[0] == (5, 0.0), res
    return res


if __name__ == "__main__":
    main()
