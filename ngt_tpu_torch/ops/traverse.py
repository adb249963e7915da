"""The sq8 block traversal as one kernel launch (``csrc/traverse.cu``).

``traverse`` runs every query of a block-mode ``graph_search`` call with
``expand`` 1 (L2 over int8 or uint8 block rows, f32 queries) to done or
``max_iters`` steps in one launch, in place on the call's state buffers
(``graph/search.py::_Loop``).  Its plain version is that module's ``_step``
loop, which ``graph/search.py::_run`` takes for every call the kernel route
does not (on the CPU among them); a CUDA call the kernel cannot take raises
here, nothing falls back.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ngt_tpu_torch.ops import _build

#: edges a row the kernel reads at most (csrc/traverse.cu ``E_MAX``)
E_MAX = 256
#: byte alignment of the block rows and the queries (16-byte loads)
ALIGN = 16
#: shared memory a block may hold on Hopper (csrc/traverse.cu ``SMEM_LIMIT``)
SMEM_LIMIT = 227 * 1024


def smem_bytes(w: int, e: int, m: int) -> int:
    """Shared memory of one query's warp: csrc/traverse.cu ``layout(w, e,
    m).bytes`` (``ngt_traverse_smem``), the query, the pool and one block
    row of ``e`` x ``m`` codes with its neighbours' keys."""
    def up(v, a):
        return (v + a - 1) // a * a

    w4 = up(w, 4)
    row = up((m // 16 + 7) // 8 * 512 + 4 * w4 + 8 * w + 8 * e, 16)
    return up(row + e * m + 4 * w4 + 12 * e + 2 * w4, 16)


def takes(w: int, e: int, m: int, hash_bits: int) -> bool:
    """Whether the kernel's limits admit a traversal of pool width ``w``,
    ``e`` edges a row, query width ``m`` and a 2^``hash_bits``-bit visited
    table: at most ``E_MAX`` edges, ``m`` a multiple of 16, 5 to 31 bits,
    and one query's shared memory within ``SMEM_LIMIT``."""
    return (0 < e <= E_MAX and m > 0 and m % 16 == 0 and 5 <= hash_bits <= 31
            and smem_bytes(w, e, m) <= SMEM_LIMIT)

_COUNT_LOCK = threading.Lock()


def _need(cond: bool, exc, msg: str) -> None:
    if not cond:
        raise exc(f"traverse: {msg}")


def check(x, nbr, valid, queries, radius0, pool_d, pool_i, pool_e, visited, done, vc, dc,
          own, steps, *, e_max: int, k: int, kr: int, hash_bits: int,
          exact_hash: bool) -> None:
    """Raises on what the kernel does not take: types, shapes, strides,
    devices and the constants' ranges."""
    _need(x.dtype in (torch.int8, torch.uint8), TypeError,
          f"block rows must be int8 or uint8, not {x.dtype}")
    _need(nbr.dtype == torch.int32, TypeError, f"nbr must be int32, not {nbr.dtype}")
    _need(valid.dtype == torch.bool, TypeError, f"valid must be bool, not {valid.dtype}")
    _need(queries.dtype == torch.float32, TypeError,
          f"queries must be float32, not {queries.dtype}")
    _need(queries.dim() == 2 and queries.is_contiguous(), ValueError,
          "queries must be a contiguous [B, M]")
    b, m = queries.shape
    _need(m % 16 == 0, ValueError, f"query width {m} is not a multiple of 16")
    _need(nbr.dim() == 2 and nbr.stride(1) == 1, ValueError,
          "nbr must be [N, E] with unit column stride")
    n, e = nbr.shape
    _need(0 < e <= min(e_max, E_MAX), ValueError,
          f"{e} edges a row: the kernel reads 1 to min(e_max {e_max}, {E_MAX})")
    _need(x.dim() in (2, 3) and x.shape[0] >= n, ValueError,
          f"block rows {tuple(x.shape)} must be [N, e_max * M] or [N, e_max, M], N >= {n}")
    width = x.shape[1] if x.dim() == 2 else x.shape[1] * x.shape[2]
    _need(width == e_max * m, ValueError,
          f"block row width {width} is not e_max x M = {e_max} x {m}")
    inner = x.stride(1) == 1 if x.dim() == 2 else (x.stride(2) == 1 and x.stride(1) == m)
    _need(inner and x.stride(0) % ALIGN == 0, ValueError,
          "block rows must be contiguous within a row, rows 16-byte aligned")
    _need(valid.dim() == 1 and valid.shape[0] >= n and valid.stride(0) == 1, ValueError,
          f"valid must be a contiguous [>= {n}]")
    w = pool_d.shape[1] if pool_d.dim() == 2 else 0
    _need(1 <= kr <= k <= w, ValueError, f"need 1 <= kr {kr} <= k {k} <= w {w}")
    _need(smem_bytes(w, e, m) <= SMEM_LIMIT, ValueError,
          f"one query's shared memory at w {w}, e {e}, M {m} is {smem_bytes(w, e, m)} "
          f"bytes, past {SMEM_LIMIT}")
    _need(5 <= hash_bits <= 31, ValueError, f"hash_bits {hash_bits} outside 5..31")
    _need(not exact_hash or n <= (1 << hash_bits), ValueError,
          f"an exact visited table of 2^{hash_bits} bits cannot hold {n} ids")
    for name, t, dtype, shape in (
        ("radius0", radius0, torch.float32, (b,)),
        ("pool_d", pool_d, torch.float32, (b, w)),
        ("pool_i", pool_i, torch.int32, (b, w)),
        ("pool_e", pool_e, torch.bool, (b, w)),
        ("visited", visited, torch.int32, (b, (1 << hash_bits) // 32)),
        ("done", done, torch.bool, (b,)),
        ("vc", vc, torch.int32, (b,)),
        ("dc", dc, torch.int32, (b,)),
        ("own", own, torch.int32, (b,)),
        ("steps", steps, torch.int64, ()),
    ):
        _need(t.dtype == dtype and tuple(t.shape) == shape and t.is_contiguous(), ValueError,
              f"{name} must be a contiguous {dtype} {shape}, not {t.dtype} {tuple(t.shape)}")
    devs = {t.device for t in (x, nbr, valid, queries, pool_d, visited, steps)}
    _need(len(devs) == 1, ValueError, f"tensors on several devices: {sorted(map(str, devs))}")


def traverse(x, nbr, valid, queries, radius0, pool_d, pool_i, pool_e, visited, done, vc,
             dc, own, steps, *, e_max: int, k: int, kr: int, eps_coeff: float,
             hash_bits: int, exact_hash: bool, max_iters: int) -> None:
    """Steps every query not done to done or ``max_iters`` of its own
    steps, in place on the state: ``pool_*`` [B, w], ``visited`` [B,
    2^hash_bits / 32], ``done``, ``vc``, ``dc``, ``own`` [B], and ``steps``
    (raised to the largest ``own``).  ``x`` holds one block row of
    ``e_max`` x M codes a node; ``nbr`` is the adjacency cut to the e
    edges read; ``eps_coeff`` is 1 + epsilon in float32.  Launches on the
    current stream of the queries' card and does not synchronize."""
    check(x, nbr, valid, queries, radius0, pool_d, pool_i, pool_e, visited, done, vc, dc,
          own, steps, e_max=e_max, k=k, kr=kr, hash_bits=hash_bits, exact_hash=exact_hash)
    dev = queries.device
    _need(dev.type == "cuda", ValueError,
          f"the kernel runs on a CUDA device, not {dev} (graph/search.py steps the CPU)")
    _need(x.data_ptr() % ALIGN == 0, ValueError, "block rows are not 16-byte aligned")
    b, m = queries.shape
    n, e = nbr.shape
    if b == 0:
        return
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ngt_traverse(
        x.data_ptr(), x.stride(0), nbr.data_ptr(), nbr.stride(0), valid.data_ptr(),
        queries.data_ptr(), radius0.data_ptr(), pool_d.data_ptr(), pool_i.data_ptr(),
        pool_e.data_ptr(), visited.data_ptr(), visited.shape[1], done.data_ptr(),
        vc.data_ptr(), dc.data_ptr(), own.data_ptr(), steps.data_ptr(),
        b, n, e, m, pool_d.shape[1], k, kr, hash_bits, int(exact_hash), max_iters,
        ctypes.c_float(eps_coeff), int(x.dtype == torch.uint8), dev.index, stream,
    )
    _build.check(err, "traverse launch")
    with _COUNT_LOCK:   # the sharded fan-out launches from one thread a card
        traverse.launches += 1


#: kernel launches since the count was last set to 0
traverse.launches = 0
