"""NGTQ-scale sample (the port's copy of samples/ngtq_10m.py): a 10M-row
IVF+PQ build and search on one card (NGTQ, NGT's billion-scale subsystem,
NGTQ/Quantizer.h; the ngtq command, NGTQCommand.h:574-613), recall@10 and
queries/s against exact ground truth:

* corpus: 5,000 integral base rows tiled, plus sigma-12 noise, rounded to
  0..255 (SIFT's value domain), seed 0, written to a uint8 memmap;
* index: 4,096 coarse centroids, PQ with 2-dim subspaces of 16 centroids
  (packed 4-bit codes, 32 bytes a row at d = 128); the raw rows for the
  refine in an on-disk float32 memmap (the ArrayFile analogue), so host
  memory stays bounded;
* five (nprobe, expansion) settings of the refine mode, then verify.

Files go to ``--work-dir`` (a temporary directory by default, removed at
the end).  No number of this script at its documented size has been
measured on the card; PERF.md lists the sizes chip_smoke.py ran it at.

Run:  python samples/torch/ngtq_10m.py [--device cuda] [--n 10000000] [--queries 1024]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

import tempfile  # noqa: E402

import torch  # noqa: E402

from ngt_tpu_torch.ops import bruteforce as BF  # noqa: E402
from ngt_tpu_torch.properties import DistanceType  # noqa: E402
from ngt_tpu_torch.quant.ivfpq import IVFPQIndex  # noqa: E402

#: (nprobe, result_expansion) settings of the refine search
SETTINGS = ((8, 3.0), (16, 3.0), (16, 10.0), (16, 30.0), (32, 30.0))


def rss_gb() -> float:
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmHWM"):
                return int(line.split()[1]) / 1e6
    return 0.0


def make_corpus(path: str, n: int, base: np.ndarray) -> np.ndarray:
    """The tiled, noised, rounded corpus as a read-only uint8 memmap."""
    out = np.lib.format.open_memmap(path, mode="w+", dtype=np.uint8, shape=(n, base.shape[1]))
    g = np.random.default_rng(0)
    for s in range(0, n, len(base)):
        e = min(s + len(base), n)
        blk = base[: e - s] + g.normal(scale=12.0, size=(e - s, base.shape[1])).astype(np.float32)
        out[s:e] = np.clip(np.rint(blk), 0, 255).astype(np.uint8)
    out.flush()
    del out
    return np.load(path, mmap_mode="r")


def exact_gt(corpus, queries: np.ndarray, k: int, device) -> np.ndarray:
    """Exact top-k by a blocked scan on the device, the corpus streamed in
    segments of 2^21 rows and the per-segment lists merged on the host."""
    qd = torch.from_numpy(queries).to(device)
    best_d = np.full((len(queries), k), np.inf, np.float32)
    best_i = np.full((len(queries), k), -1, np.int64)
    seg = 1 << 21
    for s in range(0, len(corpus), seg):
        x = torch.from_numpy(np.asarray(corpus[s : s + seg], np.float32)).to(device)
        valid = torch.ones(x.shape[0], dtype=torch.bool, device=device)
        ii, dd = BF.linear_search(qd, x, valid, DistanceType.L2, k)
        cat_d = np.concatenate([best_d, dd.cpu().numpy()], axis=1)
        cat_i = np.concatenate([best_i, ii.cpu().numpy().astype(np.int64) + s], axis=1)
        order = np.argsort(cat_d, axis=1, kind="stable")[:, :k]
        best_d = np.take_along_axis(cat_d, order, axis=1)
        best_i = np.take_along_axis(cat_i, order, axis=1)
    return best_i


def main(argv=None):
    ap = argparse.ArgumentParser(description="IVF+PQ build and search at NGTQ scale")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--centroids", type=int, default=4096)
    ap.add_argument("--work-dir", default=None)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="ngt_tpu_torch_ngtq_") as tmp:
        work = args.work_dir or tmp
        os.makedirs(work, exist_ok=True)
        return _run(args, work)


def _run(args, work: str):
    g = np.random.default_rng(1)
    base = np.random.default_rng(0).integers(0, 200, size=(5000, 128)).astype(np.float32)
    t0 = time.time()
    corpus = make_corpus(os.path.join(work, "corpus_u8.npy"), args.n, base)
    queries = base[g.choice(len(base), args.queries, replace=False)]
    queries = (queries + g.normal(scale=12.0, size=queries.shape)).astype(np.float32)
    gt = exact_gt(corpus, queries, 10, args.device)
    print(f"# corpus and exact ground truth in {time.time() - t0:.1f} s", file=sys.stderr)

    idx = IVFPQIndex(dimension=128, n_centroids=args.centroids, dsub=2, ksub=16,
                     raw_store="mmap", raw_path=os.path.join(work, "ivfpq_raw.f32"),
                     device=args.device)
    t0 = time.time()
    step = 1 << 20
    for s in range(0, args.n, step):
        idx.batch_insert(np.asarray(corpus[s : s + step], np.float32))
    idx.build()
    build_s = time.time() - t0
    idx.save(os.path.join(work, "ivfpq_idx"))
    rep = idx.memory_report()
    print(f"# n={idx.size} build={build_s:.1f}s rss_peak={rss_gb():.1f}GB "
          f"codes={rep['codes_bytes'] / 1e6:.0f}MB ids={rep['ids_bytes'] / 1e6:.0f}MB "
          f"raw={rep['raw_store']}(disk)", file=sys.stderr)

    out = []
    for nprobe, exp in SETTINGS:
        idx.batch_search(queries[:256], size=10, nprobe=nprobe, result_expansion=exp)  # warm
        t0 = time.time()
        ids, _ = idx.batch_search(queries, size=10, nprobe=nprobe, result_expansion=exp)
        dt = time.time() - t0
        rec = BF.recall_at_k(ids, gt, 10)
        print(f"# ivfpq-refine nprobe={nprobe} exp={exp:g} recall@10={rec:.4f} "
              f"queries/s={len(queries) / dt:.0f}", file=sys.stderr)
        out.append({"nprobe": nprobe, "expansion": exp, "recall": rec,
                    "queries_per_s": len(queries) / dt})
    errs = idx.verify()
    print(f"# verify: {errs if errs else 'ok'}", file=sys.stderr)
    assert not errs, errs
    assert out[-1]["recall"] >= 0.9, out
    return {"build_s": build_s, "settings": out}


if __name__ == "__main__":
    main()
