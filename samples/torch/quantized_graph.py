"""Quantized-graph sample (the port's copy of samples/quantized_graph.py,
NGT's ngtqg workflow): build, quantize, search with result expansion.

Run:  python samples/torch/quantized_graph.py [--device cuda] [--n 8000]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

import ngt_tpu_torch  # noqa: E402  (path set above)
from ngt_tpu_torch.quant.qgraph import QuantizedGraphIndex  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description="quantized-graph build and search")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=8000)
    ap.add_argument("--dim", type=int, default=128)
    args = ap.parse_args(argv)
    data = np.random.default_rng(4).normal(size=(args.n, args.dim)).astype(np.float32) * 20 + 100
    index = ngt_tpu_torch.create(None, dimension=args.dim, device=args.device)
    index.batch_insert(data, build=True)
    qg = QuantizedGraphIndex.quantize(index, dsub=2, ksub=16)
    res = qg.search(data[11] + 0.5, size=5, epsilon=0.02, result_expansion=3.0)
    for oid, dist in res:
        print(f"id={oid}\tdistance={dist:.4f}")
    assert res[0][0] == 11, res
    return res


if __name__ == "__main__":
    main()
