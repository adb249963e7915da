#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ngt_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Drives the port's main path at 1M x 128 float32 — ``create`` ->
``batch_insert(build=True)`` (the bulk build, whose candidate scan runs the
hand-written window-scan kernel) -> ``batch_search`` on the exact-graph
route — and checks each result:

 1. device: the card's name and power limit;
 2. build of the CUDA kernels from ``ngt_tpu_torch/csrc`` (plain nvcc): its
    ptxas registers, spills (any spill fails the run) and warnings, and the
    scan's shared-memory plan;
 3. the window-scan kernel against its plain torch version at 65,536 x 128
    with 1,024 queries, a ragged case (100 queries, 37 windows) and a
    masked case (scores to rtol 1e-4 / atol 1e-3, ids on >= 99.9% of
    entries: the tolerances of tests/test_pallas_scan.py);
 4. the kernel's time at the main path's shape (4096 queries x the 2^20-row
    store), beside its bound, the plain version and a library yardstick,
    and the same comparison at that shape;
 5. the 1M build, with the kernel's launch count on that path and its phase
    split (the build's NGT_TPU_BUILD_PROFILE marks, each closed by a
    synchronize), and the kernel's share of the scan phase;
 6. build quality: the first edge_size_for_creation edges of 2,000 sampled
    rows against exact ground truth (>= 99% agreement) and ``verify``;
 7. search: at least SELF_HIT_FLOOR of 1,000 corpus rows find themselves
    first; recall@10 of 10,000 held-out queries at epsilon 0.1 above
    RECALL_FLOOR, and queries/s;
 8. save + open_index: the self-queries return identical ids.

It prints a few dozen short lines as it goes, then one JSON line of the
kernels, the nvidia-smi line and, last, one JSON line with ``"ok": true``.
Any failure raises, so the run exits non-zero and prints no result; so
does a machine without a CUDA device.  Data is generated from a seed.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_BASE = 1_000_000
N_HELD_OUT = 10_000
DIM = 128
SEED = 11
#: recall@10 floor of the 10,000 held-out queries at epsilon 0.1: the first
#: H100 run measured 0.9873 on this data; the floor sits 1.7 points below to
#: absorb reduction-order changes across torch/CUDA versions (PERF.md)
RECALL_FLOOR = 0.97
#: share of 1,000 corpus rows that must return themselves first.  Not 1.0:
#: seeds are a 1/32 sample of the rows, so a small cluster may hold no seed,
#: and the exact k-NN graph rarely leads into it from another cluster.  The
#: JAX package misses the same rows on the same data (PERF.md).
SELF_HIT_FLOOR = 0.99
#: H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor-core FLOP/s, HBM bytes/s
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def sift_proxy(n: int, d: int = DIM, seed: int = SEED, kc: int = 2048) -> np.ndarray:
    """A SIFT-shaped clustered corpus: a power-law spectrum (i^-0.4) under a
    random rotation, Zipf(1.05) cluster sizes, shifted non-negative, rows
    shuffled (the recipe of bench.py's gist_proxy, at d = 128)."""
    rng = np.random.default_rng(seed)
    v = np.linalg.qr(rng.normal(size=(d, d)))[0].astype(np.float32)
    s = np.arange(1, d + 1, dtype=np.float32) ** -0.4
    w = np.arange(1, kc + 1, dtype=np.float64) ** -1.05
    sizes = rng.multinomial(n, w / w.sum())
    centers = (rng.normal(size=(kc, d)).astype(np.float32) * (0.9 * s)) @ v.T
    out = np.empty((n, d), np.float32)
    off = 0
    for c in range(kc):
        m = sizes[c]
        if m:
            noise = rng.normal(size=(m, d)).astype(np.float32) * (0.45 * s)
            out[off : off + m] = centers[c] + noise @ v.T
            off += m
    out += np.abs(out.min(axis=0, keepdims=True))
    return out[rng.permutation(n)]


def time_ms(fn, warm: int = 3, reps: int = 10) -> float:
    """Median of `reps` CUDA-event timings after `warm` warm-up runs."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def clocks_under(fn, launches: int = 1200) -> str:
    """SM clock and board power sampled by nvidia-smi every 100 ms while
    `fn` runs `launches` times back to back."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
         "-lms", "100"], stdout=subprocess.PIPE, text=True)
    try:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate()[0]
    rows = [ln.split(",") for ln in out.strip().splitlines()]
    rows = [r for r in rows
            if len(r) == 2 and all(re.fullmatch(r"\s*[0-9.]+\s*", v) for v in r)]
    if not rows:
        return "no nvidia-smi samples"
    clk = [float(c) for c, _ in rows]
    pw = [float(w) for _, w in rows]
    return (f"SM clock median {np.median(clk):.0f} MHz (min {min(clk):.0f}), board power "
            f"median {np.median(pw):.1f} W (max {max(pw):.1f}) over {len(rows)} samples")


def compare_scan(WS, q16, x16, ss, what: str) -> float:
    """Kernel vs plain on the same inputs; returns the max abs score error
    over unmasked entries, raises on disagreement."""
    wd, wi = WS.window_scan(q16, x16, ss)
    pd, pi = WS.window_scan_plain(q16, x16, ss)
    torch.cuda.synchronize()
    ids = (wi == pi).double().mean().item()
    close = bool(torch.isclose(wd, pd, rtol=1e-4, atol=1e-3).all())
    live = pd < float(WS.BIG) * 0.5
    err = float((wd - pd).abs()[live].max()) if bool(live.any()) else 0.0
    log(f"scan vs plain [{what}]: ids agree {ids:.6f}, scores within "
        f"rtol 1e-4/atol 1e-3: {close}, max abs err {err:.3g}")
    if ids < 0.999 or not close:
        raise AssertionError(f"window scan disagrees with its plain version ({what})")
    return err


def library_scan(q16, x16, ss, chunk: int = 65536):
    """Yardstick: torch.matmul of the bf16 tile, then the window min of the
    f32 scores (blocked over the corpus).  The port never calls it."""
    b = q16.shape[0]
    outs = []
    for s in range(0, x16.shape[0], chunk):
        sc = ss[None, s : s + chunk] - 2.0 * torch.matmul(q16, x16[s : s + chunk].T).float()
        outs.append(sc.view(b, -1, 128).min(-1))
    return outs


def drive(base: np.ndarray, held: np.ndarray, dev, kind: str, scan_ms: float) -> int:
    """Phases 5-8 on `dev`: the main path (create, bulk build, search) and
    its checks.  Returns the window-scan launches of the main path."""
    import ngt_tpu_torch
    from ngt_tpu_torch.graph import build as TB
    from ngt_tpu_torch.ops import bruteforce as BF
    from ngt_tpu_torch.ops import window_scan as WS

    n_base, n_held = len(base), len(held)
    tmp = tempfile.mkdtemp(prefix="ngt_tpu_torch_smoke_")
    try:
        path = os.path.join(tmp, "index")
        # 5. the main path: build ...
        os.environ["NGT_TPU_BUILD_PROFILE"] = "1"
        WS.window_scan.launches = 0
        t0 = time.time()
        idx = ngt_tpu_torch.create(path, dimension=base.shape[1],
                                   search_mode="exact", device=dev)
        idx.batch_insert(base, build=True)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        build_launches = WS.window_scan.launches
        del os.environ["NGT_TPU_BUILD_PROFILE"]
        log(f"build of {n_base} x {base.shape[1]}: {time.time() - t0:.1f} s on "
            f"{kind}; window_scan launches {build_launches}")
        if dev.type == "cuda" and build_launches == 0:
            raise AssertionError("the build never launched the window-scan kernel")
        phases = dict(TB.last_profile)
        log("build phases (s): " + ", ".join(
            f"{label} {sec:.3f}" for label, sec in TB.last_profile))
        log(f"window_scan share of the scan phase: {build_launches} x {scan_ms:.3f} ms "
            f"= {build_launches * scan_ms / 1e3:.3f} s of {phases['scan']:.3f} s "
            f"({100 * build_launches * scan_ms / 1e3 / phases['scan']:.1f}%)")

        # 6. build quality: the first k edges against exact k-NN
        k = idx.prop.edge_size_for_creation
        qsel = np.random.default_rng(2).choice(n_base, min(2000, n_base), replace=False)
        gt_q, _ = idx.batch_linear_search(base[qsel], size=k + 1)
        rows = idx.graph.nbr_ids[qsel + 1, :k] - 1
        agree = float(np.mean([
            len(set(r.tolist()) & set(g[g != s].tolist()[:k])) / k
            for r, g, s in zip(rows, gt_q, qsel)
        ]))
        log(f"build quality: {agree:.5f} of the first {k} edges of {len(qsel)} "
            "rows are exact k-NN edges")
        if agree < 0.99:
            raise AssertionError(f"edge agreement {agree:.5f} below 0.99")
        problems = idx.verify()
        if problems:
            raise AssertionError(f"verify: {problems}")

        # 7. ... and search
        sel = np.random.default_rng(1).choice(n_base, min(1000, n_base), replace=False)
        self_ids, _ = idx.batch_search(base[sel], size=10)
        hits = int((self_ids[:, 0] == sel).sum())
        log(f"self-queries: {hits} of {len(sel)} return themselves first "
            f"(floor {SELF_HIT_FLOOR})")
        if hits < SELF_HIT_FLOOR * len(sel):
            raise AssertionError(f"only {hits} of {len(sel)} corpus rows found themselves")
        t0 = time.time()
        found, _ = idx.batch_search(held, size=10, epsilon=0.1)
        search_s = time.time() - t0
        launches = WS.window_scan.launches
        gt = np.concatenate([
            idx.batch_linear_search(held[i : i + 2000], size=10)[0]
            for i in range(0, n_held, 2000)
        ])
        rec = BF.recall_at_k(found, gt, 10)
        log(f"search: recall@10 {rec:.4f} (floor {RECALL_FLOOR}) at epsilon 0.1, "
            f"{n_held / search_s:.0f} queries/s ({n_held} in {search_s:.2f} s) on {kind}")
        if rec < RECALL_FLOOR:
            raise AssertionError(f"recall@10 {rec:.4f} below {RECALL_FLOOR}")

        # 8. save and open
        t0 = time.time()
        idx.save()
        idx.close()
        idx2 = ngt_tpu_torch.open_index(path, device=dev)
        again, _ = idx2.batch_search(base[sel], size=10)
        same = bool(np.array_equal(again, self_ids))
        log(f"save + open + search: {time.time() - t0:.1f} s; identical ids: {same}")
        if not same:
            raise AssertionError("results changed across save/open")
        idx2.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one card", file=sys.stderr)
        return 1
    from ngt_tpu_torch.ops import _build
    from ngt_tpu_torch.ops import bruteforce as BF
    from ngt_tpu_torch.ops import distances as D
    from ngt_tpu_torch.ops import window_scan as WS

    t_start = time.time()
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} ({smi}); torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. kernel build
    t0 = time.time()
    _build.load()
    log(f"kernel library ready in {time.time() - t0:.1f} s "
        f"(nvcc build {_build.build_info.get('seconds', 0.0):.1f} s)")
    ptxas = _build.build_info.get("ptxas", [])
    for line in ptxas:
        log(f"  ptxas: {line}")
    spills = [ln for ln in ptxas
              if any(int(v) for v in re.findall(r"(\d+) bytes spill", ln))]
    if spills:
        raise AssertionError(f"ptxas reports spills: {spills}")
    for d in (128, 256, 384, 512):
        smem = ctypes.c_int(0)
        stages = _build.load().ngt_window_scan_plan(d, ctypes.byref(smem))
        log(f"  window_scan plan at d={d}: {stages} ring stages, "
            f"{smem.value} bytes of shared memory")

    # 3. kernel vs plain, small shapes
    rng = np.random.default_rng(7)
    xs = torch.from_numpy(rng.standard_normal((65536, DIM)).astype(np.float32)).to(dev)
    qs = xs[:1024] + 0.1 * torch.from_numpy(
        rng.standard_normal((1024, DIM)).astype(np.float32)).to(dev)
    ss = (xs * xs).sum(1)
    compare_scan(WS, qs.bfloat16(), xs.bfloat16(), ss, "65536 x 128, 1024 queries")
    compare_scan(WS, qs[:100].bfloat16(), xs[:128 * 37].bfloat16(), ss[:128 * 37],
                 "ragged: 100 queries, 37 windows")
    ss[:128] = float(WS.BIG)
    ss[130] = float(WS.BIG)
    wd, wi = WS.window_scan(qs.bfloat16(), xs.bfloat16(), ss)
    if not (bool((wd[:, 0] >= float(WS.BIG) * 0.5).all()) and bool((wi[:, 1] != 130).all())):
        raise AssertionError("masked rows leaked into the window scan")
    compare_scan(WS, qs.bfloat16(), xs.bfloat16(), ss, "masked window + row")
    del xs, qs, ss, wd, wi

    # data: 1M base rows + 10k held-out rows of one generator
    t0 = time.time()
    allx = sift_proxy(N_BASE + N_HELD_OUT)
    base, held = allx[:N_BASE], allx[N_BASE:]
    log(f"data: {N_BASE} x {DIM} base + {N_HELD_OUT} held-out rows in {time.time() - t0:.1f} s")

    # 4. kernel at the main path's shape: the store holds 2^20 slots (1-based
    # ids, slot 0 the dummy, the tail invalid), one 4096-query tile
    cap = 1 << 20
    xh = np.zeros((cap, DIM), np.float32)
    xh[1 : N_BASE + 1] = base
    vh = np.zeros(cap, bool)
    vh[1 : N_BASE + 1] = True
    x = torch.from_numpy(xh).to(dev)
    v = torch.from_numpy(vh).to(dev)
    _, x16, sp = BF.center_rows(x, v, D.sq_norms(x))
    sp = torch.where(v, sp, float(WS.BIG))
    q16 = x16[1:4097].contiguous()
    err = compare_scan(WS, q16, x16, sp, f"main path shape 4096 x {cap} x {DIM}")
    ms = time_ms(lambda: WS.window_scan(q16, x16, sp))
    plain_ms = time_ms(lambda: WS.window_scan_plain(q16, x16, sp))
    library_ms = time_ms(lambda: library_scan(q16, x16, sp))
    b, n = q16.shape[0], x16.shape[0]
    flops = 2.0 * b * n * DIM
    nbytes = b * DIM * 2 + n * DIM * 2 + n * 4 + b * (n // 128) * 8
    bound_ms = max(flops / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3
    bound_by = "operations" if flops / PEAK_BF16 >= nbytes / PEAK_BYTES else "bytes"
    log(f"window_scan at 4096 x {cap} x {DIM} on {kind}: {ms:.3f} ms "
        f"({flops / ms / 1e9:.1f} TFLOP/s), bound {bound_ms:.3f} ms by {bound_by}, "
        f"plain {plain_ms:.3f} ms, library {library_ms:.3f} ms")
    log("window_scan back to back: " + clocks_under(lambda: WS.window_scan(q16, x16, sp)))
    del x, v, x16, sp, q16
    torch.cuda.empty_cache()

    launches = drive(base, held, dev, kind, ms)

    # 9. kernels, device, result
    log(json.dumps({"kernels": [{
        "name": "window_scan",
        "route": "cuda",
        "source": "ngt_tpu_torch/csrc/window_scan.cu",
        "replaces": "ngt_tpu/ops/pallas_scan.py:88",
        "launches": launches,
        "matched": True,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }]}))
    log(f"total {time.time() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
