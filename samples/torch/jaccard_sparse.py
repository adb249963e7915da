"""Sparse-Jaccard sample (the port's copy of samples/jaccard_sparse.py,
after NGT's samples/jaccard-sparse): objects are feature-id sets packed
with make_sparse_object (Index.cpp:303-320).

Run:  python samples/torch/jaccard_sparse.py [--device cuda] [--n 3000]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

import ngt_tpu_torch  # noqa: E402  (path set above)
from ngt_tpu_torch.store import pad_sparse  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description="Sparse Jaccard search")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=3000)
    args = ap.parse_args(argv)
    rng = np.random.default_rng(5)
    # each object: 5-15 feature ids out of a 10k vocabulary
    sets = [sorted(rng.choice(10000, size=rng.integers(5, 16), replace=False))
            for _ in range(args.n)]
    index = ngt_tpu_torch.create(None, dimension=16, distance_type="Sparse Jaccard",
                                 device=args.device)
    index.batch_insert(pad_sparse(sets, 16), build=True)
    res = index.search(index.make_sparse_object(sets[123]), size=5, epsilon=0.3)
    for oid, dist in res:
        print(f"id={oid}\tjaccard distance={dist:.4f}")
    assert res[0] == (123, 0.0), res
    return res


if __name__ == "__main__":
    main()
