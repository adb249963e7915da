"""Logging and host helpers for the PyTorch port (the counterpart of
``ngt_tpu/utils.py``).

The engine logs through the ``ngt_tpu_torch`` logger; ``enable_log`` and
``disable_log`` flip its level, the analogue of the reference's
``Index::enableLog/disableLog`` (Index.h:493-494).  ``narrow_host`` picks
the narrowest lossless dtype of an object matrix.  The process-memory
probes ``get_process_vm_size``, ``get_process_vm_peak`` and
``get_process_vm_rss`` read /proc as ``Common::getProcessVmSize/VmPeak/
VmRSS`` do (Common.h:279-283); ``Timer`` is the reference's wall-clock
phase timer (Common.h:2121-2162).
"""

from __future__ import annotations

import logging
import time

logger = logging.getLogger("ngt_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("ngt_tpu_torch: %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.WARNING)


def enable_log() -> None:
    logger.setLevel(logging.INFO)


def disable_log() -> None:
    logger.setLevel(logging.CRITICAL)


def _proc_status_kb(key: str) -> int:
    """The field ``key`` of /proc/self/status in KiB, 0 where the file or
    the field is missing."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith(key + ":"):
                    return int(line.split()[1])
    except OSError:
        pass
    return 0


def get_process_vm_size() -> int:
    """The process's virtual memory in KiB (VmSize)."""
    return _proc_status_kb("VmSize")


def get_process_vm_peak() -> int:
    """The peak of the process's virtual memory in KiB (VmPeak)."""
    return _proc_status_kb("VmPeak")


def get_process_vm_rss() -> int:
    """The process's resident memory in KiB (VmRSS)."""
    return _proc_status_kb("VmRSS")


class Timer:
    """A start/stop wall-clock timer that sums its intervals in ``time``
    (seconds) until ``reset``."""

    def __init__(self):
        self.time = 0.0
        self._t0 = None

    def start(self):
        self._t0 = time.time()
        return self

    def stop(self):
        if self._t0 is not None:
            self.time += time.time() - self._t0
            self._t0 = None
        return self

    def reset(self):
        self.time = 0.0
        self._t0 = None
        return self


def narrow_host(xh: np.ndarray) -> np.ndarray:
    """The narrowest LOSSLESS representation of an f32 matrix: uint8, then
    int16, then float16, else ``xh`` unchanged.  Never lossy, so an
    integral (SIFT-like) corpus sits on the device at 1 B/dim while every
    distance still computes in f32 (ngt_tpu/utils.py:80-104).  Each
    candidate dtype is first tried on a strided sample of about 4,096
    values, so a matrix it cannot hold costs no full conversion."""
    import numpy as np

    if xh.dtype != np.float32 or not xh.size:
        return xh
    flat = xh.reshape(-1)
    sample = flat[:: max(1, flat.size // 4096)]

    def exact(dtype) -> bool:
        return bool(
            np.array_equal(sample.astype(dtype).astype(np.float32), sample)
            and np.array_equal(xh.astype(dtype).astype(np.float32), xh)
        )

    with np.errstate(invalid="ignore", over="ignore"):
        try:
            mn = float(xh.min())
            mx = float(xh.max())
            if 0 <= mn and mx <= 255:
                if exact(np.uint8):
                    return xh.astype(np.uint8)
            elif -32768 <= mn and mx <= 32767:
                if exact(np.int16):
                    return xh.astype(np.int16)
            if exact(np.float16):
                return xh.astype(np.float16)
        except (ValueError, OverflowError):  # non-finite min/max
            pass
    return xh
