"""Window-min candidate scan of the bulk build (the port's counterpart of
``ngt_tpu/ops/pallas_scan.py``).

For every query and every 128-row window of the corpus: the best score
``ss - 2*q.x`` (bf16 inputs, f32 products) and the global row id reaching
it, lowest row on ties.  Invalid rows carry ``ss = BIG``.  Scores are
ranking-equivalent to squared L2 per query row; the caller narrows the
[B, N/128] candidates with a top-k and re-ranks them exactly in f32.

``window_scan`` launches the hand-written CUDA kernel
(``csrc/window_scan.cu``) on CUDA tensors and takes the plain torch version
``window_scan_plain`` only for tensors on the CPU.  A CUDA tensor the
kernel cannot take raises; nothing falls back.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ngt_tpu_torch import trace
from ngt_tpu_torch.ops import _build

BIG = np.float32(1e30)
WINDOW = 128
#: row-width limit of the kernel's shared-memory plan (csrc/window_scan.cu)
D_MAX = 512
#: byte alignment TMA requires of every tensor the kernel reads
ALIGN = 16


def window_scan_plain(q16: torch.Tensor, x16: torch.Tensor, ss: torch.Tensor,
                      chunk: int = 65536):
    """The same function in plain torch: bf16 -> f32 matmul, ``ss - 2*dot``,
    windows of 128 rows, then min/argmin (first index on ties).  Blocked
    over the corpus so a 1M-row scan never holds the whole score matrix."""
    b, n = q16.shape[0], x16.shape[0]
    nwin = n // WINDOW
    qf = q16.to(torch.float32)
    out_d = torch.empty((b, nwin), dtype=torch.float32, device=q16.device)
    out_i = torch.empty((b, nwin), dtype=torch.int32, device=q16.device)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        w0, w1 = s // WINDOW, e // WINDOW
        dot = qf @ x16[s:e].to(torch.float32).T
        sc = (ss[None, s:e] - 2.0 * dot).view(b, w1 - w0, WINDOW)
        wi = sc.argmin(-1)
        out_d[:, w0:w1] = sc.gather(-1, wi[..., None])[..., 0]
        base = torch.arange(w0, w1, device=q16.device) * WINDOW
        out_i[:, w0:w1] = (wi + base[None, :]).to(torch.int32)
    return out_d, out_i


def _check(q16, x16, ss) -> None:
    if q16.dtype != torch.bfloat16 or x16.dtype != torch.bfloat16:
        raise TypeError("window_scan: q and x must be bfloat16")
    if ss.dtype != torch.float32:
        raise TypeError("window_scan: ss must be float32")
    if q16.dim() != 2 or x16.dim() != 2 or ss.dim() != 1:
        raise ValueError("window_scan: q [B, D], x [N, D], ss [N]")
    n, d = x16.shape
    if q16.shape[1] != d or ss.shape[0] != n:
        raise ValueError(
            f"window_scan: shapes q {tuple(q16.shape)}, x {tuple(x16.shape)}, "
            f"ss {tuple(ss.shape)} disagree"
        )
    if n % WINDOW:
        raise ValueError(f"window_scan: N={n} is not a multiple of {WINDOW}")
    if not (q16.device == x16.device == ss.device):
        raise ValueError("window_scan: tensors on different devices")


def window_scan(q16: torch.Tensor, x16: torch.Tensor, ss: torch.Tensor):
    """(scores [B, N/128] f32, ids [B, N/128] int32) of q [B, D] bf16
    against x [N, D] bf16 with centered sqnorms ss [N] f32.  With the
    tracer's build family on, each kernel launch is the device span
    ``k1``."""
    _check(q16, x16, ss)
    if q16.device.type == "cpu":
        return window_scan_plain(q16, x16, ss)
    if q16.device.type != "cuda":
        raise ValueError(f"window_scan: unsupported device {q16.device}")
    d = x16.shape[1]
    if d % 128 or d > D_MAX:
        raise ValueError(
            f"window_scan: row width {d} must be a multiple of 128 and at "
            f"most {D_MAX}"
        )
    if not (q16.is_contiguous() and x16.is_contiguous() and ss.is_contiguous()):
        raise ValueError("window_scan: inputs must be contiguous")
    for name, t in (("q", q16), ("x", x16), ("ss", ss)):
        if t.data_ptr() % ALIGN:
            raise ValueError(
                f"window_scan: {name} is not {ALIGN}-byte aligned (TMA needs it)"
            )
    lib = _build.load()
    b, n = q16.shape[0], x16.shape[0]
    out_d = torch.empty((b, n // WINDOW), dtype=torch.float32, device=q16.device)
    out_i = torch.empty((b, n // WINDOW), dtype=torch.int32, device=q16.device)
    stream = torch.cuda.current_stream(q16.device).cuda_stream
    with trace.span("k1", trace.BUILD, q16.device):
        err = lib.ngt_window_scan(
            q16.data_ptr(), x16.data_ptr(), ss.data_ptr(), out_d.data_ptr(),
            out_i.data_ptr(), b, n, d, q16.device.index, stream,
        )
    _build.check(err, "window_scan launch")
    with _COUNT_LOCK:   # builds on several cards launch from several threads
        window_scan.launches += 1
    return out_d, out_i


#: kernel launches since the count was last set to 0
window_scan.launches = 0
_COUNT_LOCK = threading.Lock()
