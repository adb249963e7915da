"""pq4 quantized-graph recall of the JAX package and the PyTorch port on
the same clustered corpus, on the CPU (not collected by pytest).

    JAX_PLATFORMS=cpu python tests/pq4_recall_vs_jax.py [n] [eb] [queries]

Builds one index from ``chip_smoke.sift_proxy(n + queries, kc=n // 488)``
(the 1M main path's 488 rows a cluster) with the port, saves it, fits the
reference's pq4 codebooks over it and carries them into the port; both
packages then search the held-out rows at epsilon 0.1 over blocks ``eb``
wide (25: the width the pq4 route takes at 1M under
NGT_TPU_QG_BLOCK_GB=0.75).  Prints both recall@10 against the exact k-NN,
the share of equal ids, and the port's sq8 recall over the same graph.
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
import ngt_tpu  # noqa: E402
import ngt_tpu_torch  # noqa: E402
from ngt_tpu.quant.qgraph import QuantizedGraphIndex as JQ  # noqa: E402
from ngt_tpu_torch import convert  # noqa: E402
from ngt_tpu_torch.ops.bruteforce import recall_at_k  # noqa: E402
from ngt_tpu_torch.quant.qgraph import QuantizedGraphIndex as TQ  # noqa: E402


def main(n: int = 20000, eb: int = 25, queries: int = 500) -> None:
    allx = chip_smoke.sift_proxy(n + queries, kc=max(8, n // 488))
    base, held = allx[:n], allx[n:]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "index")
        t = ngt_tpu_torch.create(path, dimension=base.shape[1], device="cpu")
        t.batch_insert(base, build=True)
        t.save()
        gt, _ = t.batch_linear_search(held, 10)
        jq = JQ.quantize(ngt_tpu.open_index(path), mode="pq4")
        tq = TQ.encode_pq4(t, convert.pq_from_state(jq.pq.state_dict(), device="cpu"))
        sq = TQ.quantize(t, mode="sq8")
        for q in (jq, tq, sq):
            q.block_edges = eb
        ji = np.asarray(jq.batch_search(held, size=10, epsilon=0.1)[0])
        ti = tq.batch_search(held, size=10, epsilon=0.1)[0]
        si = sq.batch_search(held, size=10, epsilon=0.1)[0]
    print(f"n {n}, eb {eb}, {queries} queries at epsilon 0.1: pq4 recall@10 "
          f"ngt_tpu {recall_at_k(ji, gt, 10):.4f}, ngt_tpu_torch "
          f"{recall_at_k(ti, gt, 10):.4f}, ids equal {float((ji == ti).mean()):.6f}; "
          f"sq8 recall@10 (port) {recall_at_k(si, gt, 10):.4f}")


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:4]))
