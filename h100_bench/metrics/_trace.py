"""What the readers of the program's own tracer share
(``ngt_tpu_torch/trace.py``): a span's seconds or a counter summed over
the records that lie inside part B's requests (the tracer's clock is
``perf_counter_ns``, the requests' ``perf_counter``).  A program without
the tracer, or one that recorded no such name there, reads None, and the
harness leaves the metric out; so does a buffer that dropped records,
where a sum would come out short without saying so."""

from __future__ import annotations

import bisect
import sys


def total(run, name: str, part: str = "B") -> float | None:
    """Sum of the values of the records named ``name`` whose start and end
    lie inside one request of ``part``; None where there is none, or where
    the tracer's buffer dropped records."""
    tracer = sys.modules.get("ngt_tpu_torch.trace")
    reqs = sorted((r.t0, r.t1) for r in run.part(part))
    if tracer is None or not reqs or getattr(tracer, "dropped", 0):
        return None
    starts = [t0 for t0, _ in reqs]
    found, out = False, 0.0
    for rec in tracer.records():
        if rec.name != name or rec.value is None:
            continue
        t0, t1 = rec.t0 / 1e9, rec.t1 / 1e9
        i = bisect.bisect_right(starts, t0) - 1
        if i >= 0 and t1 <= reqs[i][1]:
            found, out = True, out + float(rec.value)
    return out if found else None


def ratio(run, num: str, den: str, scale: float = 1.0) -> float | None:
    """``scale`` times ``total(num)`` over ``total(den)``; None where either
    is missing or the denominator is 0."""
    a, b = total(run, num), total(run, den)
    return scale * a / b if a is not None and b else None
