"""The port's host library (the counterpart of ``ngt_tpu/native``: the
union-find, edge merge, constrained reverse edges, TSV ingestion and the
text export stream's formatters and parsers): ``csrc/host_graph.cpp`` built
by ``g++ -O3 -shared -fPIC`` at first use and called through ctypes.  The
C ABI, ``csrc/ngt_tpu_torch_capi.c`` (NGT's ``ngt_*`` functions over an
embedded interpreter), is built by ``build_capi`` against libpython, for C
programs to link.

The library lands in ``build/ngt_tpu_torch/<hash of the source and
flags>/`` at the repository root (git-ignored), written under a temporary
name and moved into place with ``os.replace``, so concurrent first uses and
a build cut off part way never leave a library that a later run would load.
A failed build raises with the compiler's output; nothing falls back to
numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sysconfig
import threading

import numpy as np

from ngt_tpu_torch.ops._build import BUILD_ROOT, CSRC

SOURCE = os.path.join(CSRC, "host_graph.cpp")
FLAGS = ["-O3", "-shared", "-fPIC", "-pthread", "-std=c++17"]
LIB_NAME = "libngt_tpu_torch_host.so"
CAPI_SOURCE = os.path.join(CSRC, "ngt_tpu_torch_capi.c")
CAPI_LIB_NAME = "libngt_tpu_torch_c.so"

_lock = threading.Lock()
_lib = None

_I32 = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.POINTER(ctypes.c_int64)
_F32 = ctypes.POINTER(ctypes.c_float)
_U8 = ctypes.POINTER(ctypes.c_uint8)


def _lib_path(source: str, flags: list[str], name: str) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    with open(source, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], name)


def library_path() -> str:
    return _lib_path(SOURCE, FLAGS, LIB_NAME)


def _build(out: str, source: str | None = None, flags: list[str] | None = None,
           libs: list[str] = ()) -> None:
    """``g++ flags -o out source libs`` (the host library's SOURCE and FLAGS
    by default) through a temporary name and ``os.replace``; a failed
    compile raises with the compiler's output."""
    source = source or SOURCE
    flags = FLAGS if flags is None else flags
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        res = subprocess.run(
            ["g++", *flags, "-o", tmp, source, *libs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed on {source}:\n{res.stdout}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def python_link() -> tuple[list[str], list[str]]:
    """(compile flags, link arguments) of this interpreter's libpython: what
    the C ABI library and the C programs that link it are built with."""
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ver = sysconfig.get_config_var("LDVERSION") or sysconfig.get_config_var("VERSION")
    return ([f"-I{sysconfig.get_paths()['include']}"],
            [f"-L{libdir}", f"-lpython{ver}", f"-Wl,-rpath,{libdir}"])


def build_capi() -> str:
    """Build the C ABI library (``csrc/ngt_tpu_torch_capi.c``: NGT's C API,
    Capi.h:60-212, forwarding to this package through an embedded
    interpreter) at first use and return its path.  C programs link it and
    libpython, and pick the device with ``NGT_TPU_TORCH_DEVICE``."""
    inc, libs = python_link()
    flags = ["-O2", "-shared", "-fPIC", *inc]
    out = _lib_path(CAPI_SOURCE, flags + libs, CAPI_LIB_NAME)
    with _lock:
        if not os.path.exists(out):
            _build(out, CAPI_SOURCE, flags, libs)
    return out


def load() -> ctypes.CDLL:
    """The host graph library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            out = library_path()
            if not os.path.exists(out):
                _build(out)
            lib = ctypes.CDLL(out)
            lib.merge_edges.restype = None
            lib.merge_edges.argtypes = [
                _I32, _F32, _I32, _U8, ctypes.c_int64, _I64, _I32, _F32,
                ctypes.c_int64,
            ]
            lib.connected_components.restype = ctypes.c_int64
            lib.connected_components.argtypes = [
                _I32, _U8, ctypes.c_int64, ctypes.c_int64, _I32,
            ]
            lib.union_pairs.restype = ctypes.c_int64
            lib.union_pairs.argtypes = [_I32, ctypes.c_int64, _I32, _I32, ctypes.c_int64]
            lib.constrained_reverse.restype = ctypes.c_int64
            lib.constrained_reverse.argtypes = [
                _I32, _F32, _I32, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, _I32, _I32, _F32,
            ]
            lib.tsv_parse.restype = ctypes.c_long
            lib.tsv_parse.argtypes = [ctypes.c_char_p, _F32, ctypes.c_long, ctypes.c_long]
            lib.tsv_count_rows.restype = ctypes.c_long
            lib.tsv_count_rows.argtypes = [ctypes.c_char_p]
            lib.format_obj_rows.restype = ctypes.c_int64
            lib.format_obj_rows.argtypes = [
                _F32, _U8, ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
            ]
            lib.format_graph_rows.restype = ctypes.c_int64
            lib.format_graph_rows.argtypes = [
                _I32, _F32, _I32, _U8, ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p,
                ctypes.c_int64,
            ]
            lib.parse_obj_rows.restype = ctypes.c_int64
            lib.parse_obj_rows.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _F32, _U8,
            ]
            lib.parse_graph_rows.restype = ctypes.c_int64
            lib.parse_graph_rows.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _I32, _F32,
                _I32, _U8,
            ]
            _lib = lib
    return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctype)


def merge_edges(nbr_ids: np.ndarray, nbr_dist: np.ndarray, degree: np.ndarray,
                has_node: np.ndarray, targets: np.ndarray, srcs: np.ndarray,
                dists: np.ndarray) -> None:
    """In-place bulk merge of the edges ``targets[i] -> srcs[i]`` into the
    fixed-width rows (``nbr_ids``/``nbr_dist`` [cap, e_max], ``degree``
    [cap] int32, ``has_node`` [cap] uint8 view): sorted insert, duplicate
    (target, src) pairs skipped, the farthest edge dropped from a full row
    (ngt_tpu/native/__init__.py:526-551)."""
    for name, arr, dtype in (("nbr_ids", nbr_ids, np.int32),
                             ("nbr_dist", nbr_dist, np.float32),
                             ("degree", degree, np.int32),
                             ("has_node", has_node, np.uint8)):
        if arr.dtype != dtype or not arr.flags.c_contiguous:
            raise ValueError(f"merge_edges: {name} must be C-contiguous {np.dtype(dtype)}")
    cap = nbr_ids.shape[0]
    if nbr_dist.shape != nbr_ids.shape or degree.shape != (cap,) or has_node.shape != (cap,):
        raise ValueError("merge_edges: graph arrays of mismatched shapes")
    targets = np.ascontiguousarray(targets, np.int64)
    srcs = np.ascontiguousarray(srcs, np.int32)
    dists = np.ascontiguousarray(dists, np.float32)
    if not len(targets) == len(srcs) == len(dists):
        raise ValueError("merge_edges: targets, srcs and dists differ in length")
    if len(targets) and (targets.min() < 0 or targets.max() >= cap):
        raise ValueError(f"merge_edges: a target lies outside rows [0, {cap})")
    load().merge_edges(
        _ptr(nbr_ids, _I32), _ptr(nbr_dist, _F32), _ptr(degree, _I32),
        _ptr(has_node, _U8), np.int64(nbr_ids.shape[1]), _ptr(targets, _I64),
        _ptr(srcs, _I32), _ptr(dists, _F32), np.int64(len(targets)),
    )


def connected_components(nbr_ids: np.ndarray, has_node: np.ndarray) -> tuple[np.ndarray, int]:
    """Component label (the union-find root id) per node, -1 for
    non-nodes; returns (labels, component count)
    (ngt_tpu/native/__init__.py:183-225)."""
    n, e_max = nbr_ids.shape
    if len(has_node) != n:
        raise ValueError("connected_components: has_node and nbr_ids differ in rows")
    nbr_c = np.ascontiguousarray(nbr_ids, np.int32)
    has_c = np.ascontiguousarray(np.asarray(has_node, bool).view(np.uint8))
    labels = np.empty(n, np.int32)
    roots = load().connected_components(
        _ptr(nbr_c, _I32), _ptr(has_c, _U8), np.int64(n), np.int64(e_max),
        _ptr(labels, _I32),
    )
    return labels, int(roots)


def union_pairs(labels: np.ndarray, a: np.ndarray, b: np.ndarray) -> tuple[np.ndarray, int]:
    """Union the representative-id pairs ``(a[i], b[i])`` into a component
    labeling (a representative node id per node, -1 for non-nodes); returns
    (min-id labels, component count) (ngt_tpu/native/__init__.py:228-276)."""
    out = np.ascontiguousarray(labels, np.int32).copy()
    a = np.ascontiguousarray(a, np.int32)
    b = np.ascontiguousarray(b, np.int32)
    if len(a) != len(b):
        raise ValueError("union_pairs: a and b differ in length")
    if len(out) and (out.min() < -1 or out.max() >= len(out)):
        raise ValueError("union_pairs: a label lies outside [-1, n)")
    comps = load().union_pairs(
        _ptr(out, _I32), np.int64(len(out)), _ptr(a, _I32), _ptr(b, _I32),
        np.int64(len(a)),
    )
    return out, int(comps)


def constrained_reverse(nbr_ids: np.ndarray, nbr_dist: np.ndarray, degree: np.ndarray,
                        out_edges: int, in_edges: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The reversed edges (rid -> src, dist) that the indegree-balanced
    ONNG reconstruction keeps: reverse lists smallest first, at most
    ``in_edges`` reversed edges per source and ``out_edges`` per row once
    the source has one (ngt_tpu/native/__init__.py:278-305).  Returns
    (rid int32, src int32, dist float32)."""
    n, e_w = nbr_ids.shape
    if nbr_dist.shape != nbr_ids.shape or len(degree) != n:
        raise ValueError("constrained_reverse: graph arrays of mismatched shapes")
    nbr_c = np.ascontiguousarray(nbr_ids, np.int32)
    dist_c = np.ascontiguousarray(nbr_dist, np.float32)
    deg_c = np.ascontiguousarray(degree, np.int32)
    if len(deg_c) and (deg_c.min() < 0 or deg_c.max() > e_w):
        raise ValueError(f"constrained_reverse: a degree lies outside [0, {e_w}]")
    cap = max(int(deg_c.sum()), 1)
    rid = np.empty(cap, np.int32)
    src = np.empty(cap, np.int32)
    d = np.empty(cap, np.float32)
    m = load().constrained_reverse(
        _ptr(nbr_c, _I32), _ptr(dist_c, _F32), _ptr(deg_c, _I32), np.int64(n),
        np.int64(e_w), np.int64(out_edges), np.int64(in_edges), _ptr(rid, _I32),
        _ptr(src, _I32), _ptr(d, _F32),
    )
    return rid[:m], src[:m], d[:m]


def parse_tsv(path: str, dimension: int) -> np.ndarray:
    """Rows of float32 from a TSV file: the first ``dimension`` columns of
    each line (tabs, spaces or commas), extra columns ignored, short lines
    zero-padded, lines without a number skipped (the reference's
    appendText contract, ObjectRepository.h:108-145;
    ngt_tpu/native/__init__.py:158-181)."""
    if dimension <= 0:
        raise ValueError(f"parse_tsv: dimension must be positive, got {dimension}")
    lib = load()
    raw = os.fsencode(path)
    n = lib.tsv_count_rows(raw)
    if n < 0:
        raise OSError(f"cannot read {path}")
    out = np.zeros((n, int(dimension)), np.float32)
    got = lib.tsv_parse(raw, _ptr(out, _F32), n, int(dimension))
    if got < 0:
        raise OSError(f"cannot read {path}")
    return out[:got]


def _check_rows(name: str, n: int, **arrays) -> None:
    for key, a in arrays.items():
        if len(a) < n:
            raise ValueError(f"{name}: {key} has {len(a)} rows, fewer than {n}")


def format_obj_rows(x: np.ndarray, valid: np.ndarray) -> bytes:
    """The export stream's object lines: ``+v\tv...\n`` for a valid row,
    ``-\n`` for a hole; integral values by a digit loop, the rest as
    ``%.9g`` (lossless for float32) (ngt_tpu/native/__init__.py:431-454)."""
    if x.ndim != 2:
        raise ValueError("format_obj_rows: x must be 2-D")
    n, d = x.shape
    _check_rows("format_obj_rows", n, valid=valid)
    x = np.ascontiguousarray(x, np.float32)
    v = np.ascontiguousarray(np.asarray(valid[:n], bool).view(np.uint8))
    cap = int(n * (d * 20 + 3) + 16)
    buf = np.empty(cap, np.uint8)
    m = load().format_obj_rows(_ptr(x, _F32), _ptr(v, _U8), np.int64(n), np.int64(d),
                               ctypes.cast(buf.ctypes.data, ctypes.c_char_p), np.int64(cap))
    if m < 0:
        raise RuntimeError("format_obj_rows: output buffer too small")
    return buf[:m].tobytes()


def format_graph_rows(nbr: np.ndarray, dist: np.ndarray, deg: np.ndarray,
                      has: np.ndarray) -> bytes:
    """The export stream's graph lines: ``id:dist\t...\n`` for a node (an
    empty line at degree 0), ``-\n`` for a slot without one
    (ngt_tpu/native/__init__.py:457-481)."""
    if nbr.ndim != 2 or dist.shape != nbr.shape:
        raise ValueError("format_graph_rows: nbr and dist must be 2-D of one shape")
    n, e = nbr.shape
    _check_rows("format_graph_rows", n, deg=deg, has=has)
    nbr = np.ascontiguousarray(nbr, np.int32)
    dist = np.ascontiguousarray(dist, np.float32)
    deg = np.ascontiguousarray(deg[:n], np.int32)
    has = np.ascontiguousarray(np.asarray(has[:n], bool).view(np.uint8))
    live = deg[has.astype(bool)]
    if len(live) and (live.min() < 0 or live.max() > e):
        raise ValueError(f"format_graph_rows: a node's degree lies outside [0, {e}]")
    cap = int(int(np.minimum(deg, e).sum()) * 34 + n * 3 + 16)
    buf = np.empty(cap, np.uint8)
    m = load().format_graph_rows(_ptr(nbr, _I32), _ptr(dist, _F32), _ptr(deg, _I32),
                                 _ptr(has, _U8), np.int64(n), np.int64(e),
                                 ctypes.cast(buf.ctypes.data, ctypes.c_char_p), np.int64(cap))
    if m < 0:
        raise RuntimeError("format_graph_rows: output buffer too small")
    return buf[:m].tobytes()


def parse_obj_rows(data: bytes, n: int, d: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Parse ``n`` object lines of an export stream into (x [n, d] float32,
    valid [n] bool, bytes consumed); ``%.9g`` and Python-repr floats alike
    (ngt_tpu/native/__init__.py:484-503).  Malformed input raises."""
    data = bytes(data)
    x = np.empty((n, d), np.float32)   # the parser writes every slot
    valid = np.empty((n,), np.uint8)
    used = load().parse_obj_rows(data, np.int64(len(data)), np.int64(n), np.int64(d),
                                 _ptr(x, _F32), _ptr(valid, _U8))
    if used < 0:
        raise ValueError(f"malformed export: object rows (expected {n} rows of {d} values)")
    return x, valid.view(bool), int(used)


def parse_graph_rows(data: bytes, n: int, e: int
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """Parse ``n`` graph lines into fixed-width rows (nbr [n, e] -1 padded,
    dist [n, e] +inf padded, deg, has, bytes consumed)
    (ngt_tpu/native/__init__.py:506-525).  Malformed input raises."""
    data = bytes(data)
    nbr = np.empty((n, e), np.int32)   # the parser writes every slot
    dist = np.empty((n, e), np.float32)
    deg = np.empty((n,), np.int32)
    has = np.empty((n,), np.uint8)
    used = load().parse_graph_rows(data, np.int64(len(data)), np.int64(n), np.int64(e),
                                   _ptr(nbr, _I32), _ptr(dist, _F32), _ptr(deg, _I32),
                                   _ptr(has, _U8))
    if used < 0:
        raise ValueError(f"malformed export: graph rows (expected {n} rows)")
    return nbr, dist, deg, has.view(bool), int(used)
