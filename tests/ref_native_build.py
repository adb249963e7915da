"""Build the JAX package's native library once, whole, before a test loads it.

``ngt_tpu.native`` compiles ``ngt_tpu/native/src/_ngt_tpu_native.so`` at
first use straight onto its final path, with no lock.  Under pytest-xdist
several workers do that at once on a fresh tree, and a worker that loads a
half-written file falls back to numpy, whose stand-ins differ from the C++
(``edge_dist_lookup`` returns +inf where the C++ returns the distance).

Importing this module takes an exclusive ``fcntl.flock`` on a lock file
under ``build/ngt_tpu_torch/`` (git-ignored) and, if the library is missing
or older than its source, runs the package's own compiler command line into
a temporary name in that directory and moves it into place with
``os.replace``.  A failed compile raises.

A file collected earlier can still reach the unlocked build first:
tests/test_capi.py asks ``native.available()`` in a ``skipif`` while it is
collected, so on a fresh tree every worker may run its own g++ onto the
final path at once, and a worker that loaded a half-written file keeps the
numpy fallback for the rest of its life.  So after the locked build the
helper clears such a cached fallback and loads the library again, waiting
out another worker's build that is still writing the file and rebuilding
under the lock from the second try; if it still does not load, it raises.
The port's parity test files import it at module level: every xdist worker
collects every file before it runs a test, so each worker holds the library
before any test runs.
"""

from __future__ import annotations

import fcntl
import os
import subprocess
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "ngt_tpu", "native", "src", "ngt_tpu_native.cpp")
SO = os.path.join(ROOT, "ngt_tpu", "native", "src", "_ngt_tpu_native.so")
LOCK_DIR = os.path.join(ROOT, "build", "ngt_tpu_torch")


def ensure_built(force: bool = False) -> str:
    """The reference's library path, built under the lock if it is missing
    or stale, or with ``force`` (the compiler flags of
    ngt_tpu/native/__init__.py:36-39)."""
    os.makedirs(LOCK_DIR, exist_ok=True)
    with open(os.path.join(LOCK_DIR, "ref_native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        fresh = os.path.exists(SO) and os.path.getmtime(SO) >= os.path.getmtime(SRC)
        if fresh and not force:
            return SO
        tmp = os.path.join(LOCK_DIR, f"_ngt_tpu_native.{os.getpid()}.so")
        try:
            res = subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", tmp, SRC],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                timeout=300,
            )
            if res.returncode != 0:
                raise RuntimeError(f"g++ failed on {SRC}:\n{res.stdout}")
            os.replace(tmp, SO)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return SO


def ensure_loaded(tries: int = 5, wait_s: float = 2.0) -> None:
    """Build the library, then make this process's ``ngt_tpu.native`` hold
    it: a fallback it cached from an unlocked build is cleared and the load
    is tried again; raises if the library never loads."""
    from ngt_tpu import native

    for attempt in range(tries):
        ensure_built(force=attempt > 0)
        if native._lib is None:
            native._tried = False
        if native.available():
            return
        time.sleep(wait_s)
    raise RuntimeError(f"the reference's native library {SO} does not load")


ensure_loaded()
