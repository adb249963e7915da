"""L2/float end-to-end sample (the port's copy of samples/l2_float.py, after
NGT's samples/l2-uint8 flow): create -> append -> build -> save -> search.

Run:  python samples/torch/l2_float.py [--device cuda] [--n 10000]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

import ngt_tpu_torch  # noqa: E402  (path set above)
import tempfile  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description="L2/float create, build, save, search")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=10000)
    ap.add_argument("--dim", type=int, default=128)
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    data = rng.normal(size=(args.n, args.dim)).astype(np.float32)
    with tempfile.TemporaryDirectory(prefix="ngt_tpu_torch_sample_l2_") as tmp:
        path = os.path.join(tmp, "index")
        index = ngt_tpu_torch.create(path, dimension=args.dim, distance_type="L2",
                                     device=args.device)
        index.batch_insert(data, build=True)
        index.save()
        index = ngt_tpu_torch.open_index(path, device=args.device)
        res = index.search(data[42] + 0.05, size=5, epsilon=0.1)
    for oid, dist in res:
        print(f"id={oid}\tdistance={dist:.4f}")
    assert res[0][0] == 42, res
    return res


if __name__ == "__main__":
    main()
