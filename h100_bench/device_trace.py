"""The device's side of a traced run, from ``torch.profiler``'s CUDA
activity (CUPTI): the seconds in which a kernel, copy or fill ran, the
device operations that took most time, and the idle gaps between them,
each named by the operation that ended it (what the host was preparing).

Only the device activity is recorded: host operator events would cost more
host time per operation than the qg traversal's small steps take, and host
time is what the idle share measures.  Kineto's raw events are read; the
profiler's per-operator tables are never built.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch

#: entries kept in each list of a breakdown, and characters of a name
TOP = 10
NAME_CHARS = 120


def _ns(ev, what: str) -> int:
    """An event's start or duration in nanoseconds, across profiler
    versions."""
    if hasattr(ev, what + "_ns"):
        return int(getattr(ev, what + "_ns")())
    return int(getattr(ev, what + "_us")() * 1000)


def _device_intervals(events) -> dict[int, list[tuple[int, int, str]]]:
    """The CUDA activity's intervals, by card index, each list sorted."""
    out: dict[int, list] = defaultdict(list)
    for ev in events:
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        start = _ns(ev, "start")
        out[int(ev.device_index())].append(
            (start, start + _ns(ev, "duration"), ev.name()[:NAME_CHARS]))
    for v in out.values():
        v.sort()
    return out


def summarize(intervals: list[tuple[int, int, str]], window_s: float,
              bounds: tuple[int, int] | None = None) -> dict:
    """busy_s (the union of the intervals), the top operations by summed
    time, and the idle gaps between merged intervals summed by the name of
    the operation that ends each gap, over a window of ``window_s``;
    ``bounds`` (the window's first and last nanosecond on the trace's
    clock) adds the gaps before the first and after the last operation."""
    ops: dict[str, float] = defaultdict(float)
    gaps: dict[str, float] = defaultdict(float)
    n_gaps: dict[str, int] = defaultdict(int)
    if bounds and intervals:
        gaps[f"the window's start, before the first device op ({intervals[0][2]})"] = max(
            intervals[0][0] - bounds[0], 0) / 1e9
        tail = max(bounds[1] - max(end for _, end, _ in intervals), 0) / 1e9
        gaps["the window's end (after the last device op)"] = tail
    busy = 0
    cur_start = cur_end = None
    for start, end, name in intervals:
        ops[name] += (end - start) / 1e9
        if cur_end is None:
            cur_start, cur_end = start, end
            continue
        if start > cur_end:
            busy += cur_end - cur_start
            gaps[name] += (start - cur_end) / 1e9
            n_gaps[name] += 1
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy += cur_end - cur_start
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "busy_s": busy / 1e9,
        "window_s": window_s,
        "device_ops": [[name, sec] for name, sec in top],
        "idle_gaps": [[(f"before {name} (x{n_gaps[name]})" if n_gaps[name] else name)
                       [:NAME_CHARS], sec] for name, sec in top_gaps],
        "device_events": len(intervals),
    }


class DeviceTrace:
    """``with DeviceTrace(devices) as t: ...`` then ``t.summary(window_s)``:
    ``busy_s`` averaged over the cards, the operations and gaps of the
    first; records nothing where the first device is not a CUDA card."""

    def __init__(self, devices):
        self.devices = list(devices)
        self.prof = None

    def __enter__(self):
        if self.devices[0].type == "cuda":
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t_ns = [time.time_ns()]
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            for device in self.devices:
                torch.cuda.synchronize(device)
            self.t_ns.append(time.time_ns())
            t0 = time.perf_counter()
            self.prof.__exit__(*exc)
            self.stop_s = time.perf_counter() - t0
        return False

    def summary(self, window_s: float) -> dict | None:
        if self.prof is None:
            return None
        t0 = time.perf_counter()
        events = self.prof.profiler.kineto_results.events()
        t1 = time.perf_counter()
        per_card = _device_intervals(events)
        cards = [d.index if d.index is not None else torch.cuda.current_device()
                 for d in self.devices]
        out = summarize(per_card.get(cards[0], []), window_s, tuple(self.t_ns))
        out["busy_s"] = sum(summarize(per_card.get(c, []), window_s)["busy_s"]
                            for c in cards) / len(cards)
        out["device_events"] = sum(len(per_card.get(c, [])) for c in cards)
        out["read_s"] = {"stop": self.stop_s, "events": t1 - t0,
                         "summarize": time.perf_counter() - t1, "raw_events": len(events)}
        return out
