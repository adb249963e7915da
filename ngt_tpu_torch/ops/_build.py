"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by plain ``nvcc`` for Hopper (``sm_90a``)
into one shared library with a C interface, loaded with ``ctypes``.  The
build runs at first use, one ``nvcc`` per source started together, then one
link; it takes seconds, needs neither ``ninja`` nor PyTorch's headers, and
leaves no lock file.  The library lands in
``build/ngt_tpu_torch/<hash of the sources and flags>/`` at the repository
root (git-ignored), written under a temporary name and moved into place
with ``os.replace``, so a build cut off part way never leaves a library
that a later run would load.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

from ngt_tpu_torch.utils import logger

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "ngt_tpu_torch")
FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas", "-v", "-Xcompiler", "-fPIC",
]
LIB_NAME = "libngt_tpu_torch_kernels.so"

_lib = None
_lock = threading.Lock()
#: the library's build: {"seconds" (0.0 when it was already built), "ptxas"
#: (the register, spill and warning lines nvcc printed, kept beside the
#: library), "path"}
build_info: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources() -> list[str]:
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for path in _sources() + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], LIB_NAME)


def _ptxas_path(lib: str) -> str:
    return os.path.join(os.path.dirname(lib), "ptxas.txt")


def _build(out: str) -> None:
    nvcc = _nvcc()
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tag = f".{os.getpid()}.tmp"  # nvcc reads the type from the suffix: keep .o last
    t0 = time.time()
    objs, procs = [], []
    for src in _sources():
        obj = os.path.join(
            os.path.dirname(out), os.path.basename(src) + tag + ".o"
        )
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *FLAGS, "-c", src, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    logs = [p.communicate()[0] for p in procs]
    try:
        for src, p, log in zip(_sources(), procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        link = subprocess.run(
            [nvcc, *FLAGS[:2], "-shared", "-o", out + tag, *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        ptxas = [
            ln.strip() for log in logs for ln in log.splitlines()
            if any(w in ln for w in ("registers", "Compiling entry", "spill", "warning"))
        ]
        with open(_ptxas_path(out), "w") as fh:
            fh.write("\n".join(ptxas))
        os.replace(out + tag, out)
    finally:
        for path in objs + [out + tag]:
            if os.path.exists(path):
                os.remove(path)
    build_info.update(seconds=time.time() - t0, ptxas=ptxas, path=out)
    logger.info("built %s in %.1f s", out, build_info["seconds"])


def load() -> ctypes.CDLL:
    """The kernel library, built at first use (by one thread; the others
    wait for it)."""
    global _lib
    with _lock:
        if _lib is None:
            out = library_path()
            # the ptxas report is written before the library is moved into
            # place: a library without one predates the report and is rebuilt
            if not (os.path.exists(out) and os.path.exists(_ptxas_path(out))):
                _build(out)
            else:
                with open(_ptxas_path(out)) as fh:
                    build_info.update(seconds=0.0, ptxas=fh.read().splitlines(), path=out)
            lib = ctypes.CDLL(out)
            # pointers and the stream as c_void_p: a plain int would be cut to 32 bits
            lib.ngt_window_scan.argtypes = (
                [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            )
            lib.ngt_window_scan.restype = ctypes.c_int
            vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.ngt_traverse.argtypes = (
                [vp, ll, vp, ll] + [vp] * 7 + [ll] + [vp] * 5 + [ci] * 10
                + [ctypes.c_float, ci, ci, vp]
            )
            lib.ngt_traverse.restype = ctypes.c_int
            lib.ngt_traverse_smem.argtypes = [ci] * 3
            lib.ngt_traverse_smem.restype = ci
            lib.ngt_window_scan_plan.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            lib.ngt_window_scan_plan.restype = ctypes.c_int
            lib.ngt_cuda_error_string.argtypes = [ctypes.c_int]
            lib.ngt_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = load().ngt_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
