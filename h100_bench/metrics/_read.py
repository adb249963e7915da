"""What the per-layer readers share.  Each reads the traced run: part "A"
(the device profile, stage timers off), part "U" (part A's requests again,
unprofiled) or part "B" (the program's stage timers and build marks on,
each stage closed by a synchronize).  A reader with nothing to read
returns None, and the harness leaves its metric out."""

from __future__ import annotations

import numpy as np

#: the quantized-graph route's per-chunk stages after the first call's
#: one-time quantize and block gather (quant/qgraph.py ``last_profile``)
QG_STAGES = ("seeds", "traverse", "rerank", "refine")


def total(run, key: str, part: str = "B") -> float:
    return float(sum(r.counters.get(key, 0.0) for r in run.part(part)))


def units(run, part: str = "B") -> int:
    return sum(r.units for r in run.part(part))


def ms_per_query(run, stages) -> float | None:
    n = units(run)
    sec = sum(total(run, "qg." + s) for s in stages)
    return sec * 1e3 / n if n and sec > 0 else None


def steps_per_request(run) -> float | None:
    reqs = run.part("B")
    steps = total(run, "steps")
    return steps / len(reqs) if reqs and steps > 0 else None


def ms_per_step(run) -> float | None:
    steps = total(run, "steps")
    sec = total(run, "qg.traverse")
    return sec * 1e3 / steps if steps > 0 and sec > 0 else None


def idle_pct(run) -> float | None:
    """One less part A's device busy seconds over the seconds that the same
    requests took in part U, with the profiler off (under it the host runs
    slower, and the card would read idler than in a run)."""
    tr = run.trace
    if not tr or tr["busy_s"] <= 0 or tr.get("replay_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["replay_s"])


def call_overhead_ms(run) -> float | None:
    """Mean per request of its wall time less the qg stages it ran."""
    reqs = run.part("B")
    if not reqs or not any(r.counters.get("qg.traverse", 0) for r in reqs):
        return None
    return float(np.mean([(r.t1 - r.t0 - sum(r.counters.get("qg." + s, 0.0)
                                              for s in QG_STAGES)) * 1e3 for r in reqs]))
