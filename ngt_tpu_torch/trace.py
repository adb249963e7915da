"""The port's tracer: spans and counters kept in memory and read when a run
ends.

Two families, each switched on by the reference's variable set to "1":
``SEARCH`` (NGT_TPU_QG_PROFILE: the quantized-graph stages and the
traversal's counters) and ``BUILD`` (NGT_TPU_BUILD_PROFILE: the build and
reconstruct marks, the store fill and the window-scan kernel).  A public
call (marked by ``public``: ``Index.batch_search``, ``.batch_insert``,
``.build_index``, ``GraphOptimizer.execute``, ...) reads both switches when
it starts, so a caller may flip them between calls; outside any public
call a site reads its switch itself.  With a family off a site records
nothing, makes no CUDA event and never synchronizes.

A record holds its name, the name of the span open around it (its parent, else None),
the id of its public call (0 outside one), its host start and end on
``time.perf_counter_ns()`` and a value: a span's seconds or a counter's
count.  A span on a CUDA device holds two ``torch.cuda.Event``s on the
current stream, and its seconds are the device timeline between them; they
are read once the card has passed the second (``resolve``): when the
outermost public call ends, or when the records are read.  Host spans and
counters hold their value at once.  ``kineto_offset_ns()`` added to a host
time places it on the clock of ``torch.profiler``'s Kineto events.

The records sit in a buffer of ``CAPACITY`` entries that drops the oldest
(counted in ``dropped``), shared by every thread.  The open spans, the
switches a public call read and its id belong to the thread that made the
call, so calls from several threads at once keep their own parents and
ids; work a call hands to other threads (``carry`` then ``adopt``) records
as part of that call, under the span open where it was handed over.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import threading
import time

import torch

#: the families, named by their switches
SEARCH = "NGT_TPU_QG_PROFILE"
BUILD = "NGT_TPU_BUILD_PROFILE"

#: records the buffer holds: a 51 s traced window of one-query calls at
#: ~150 calls/s, ~15 records a call, or of 10,000-query calls at ~8 calls/s,
#: ~220 records a call, fits about twice (about 50 MB when full)
CAPACITY = 1 << 18


_NULL = contextlib.nullcontext()


class Record:
    """One span or counter.  ``clock`` is "device" or "host" for a span,
    None for a counter; ``value`` is None while a device span waits for its
    events."""

    __slots__ = ("name", "parent", "call", "t0", "t1", "value", "clock", "_events", "_into")

    def __init__(self, name, t0, t1=None, value=None, clock=None):
        self.name, self.t0, self.t1, self.value, self.clock = name, t0, t1, value, clock
        t = _local
        self.parent = t.open[-1].name if t.open else None
        self.call = t.call if t.depth else 0
        self._events = self._into = None

    def __repr__(self):
        return (f"Record({self.name!r}, parent={self.parent!r}, call={self.call}, "
                f"value={self.value!r}, clock={self.clock!r})")


class _Thread(threading.local):
    """A thread's place in the tracer."""

    def __init__(self):
        self.open: list[Record] = []   # spans open now, innermost last
        self.on = {SEARCH: False, BUILD: False}
        self.depth = 0                 # public calls open now
        self.call = 0                  # id of the outermost open public call


_records: collections.deque = collections.deque(maxlen=CAPACITY)
#: records dropped from the full buffer since it was last cleared
dropped = 0
_pending: list[Record] = []   # device spans whose events are not read yet
_lock = threading.Lock()      # held to change the buffer or the pending list
_local = _Thread()
_calls = itertools.count(1)   # public call ids, unique across threads


def on(family: str) -> bool:
    """Whether ``family`` records: its switch as the outermost open public
    call read it, else as the environment has it now."""
    t = _local
    return t.on[family] if t.depth else os.environ.get(family, "") == "1"


def carry():
    """This thread's place in the tracer, for ``adopt`` in a thread it
    hands work to."""
    t = _local
    return t.depth, t.call, dict(t.on), t.open[-1] if t.open else None


@contextlib.contextmanager
def adopt(place):
    """Runs the block in this thread as part of the call that ``carry``
    read ``place`` in, under the span that was open there."""
    t = _local
    saved = t.depth, t.call, t.on, t.open
    t.depth, t.call, on_, parent = place
    t.on, t.open = dict(on_), [parent] if parent is not None else []
    try:
        yield
    finally:
        t.depth, t.call, t.on, t.open = saved


def kineto_offset_ns() -> int:
    """Kineto's clock (the wall clock, ``time.time_ns``) less
    ``perf_counter_ns``, read now.  Read it close to the events it serves:
    the wall clock may be slewed against the monotonic one."""
    best = None
    for _ in range(3):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


def _keep(rec: Record, pending: bool = False) -> None:
    """Appends ``rec`` to the buffer; a device span also waits in the
    pending list, a host span adds its seconds to its view at once."""
    global dropped
    with _lock:
        if len(_records) == _records.maxlen:
            dropped += 1
        _records.append(rec)
        if pending:
            _pending.append(rec)
        elif rec._into is not None:
            _add_into(rec)


def _add_into(rec: Record) -> None:
    into, key = rec._into
    into[key] = into.get(key, 0.0) + rec.value


def _event(dev: torch.device):
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(dev))
    return ev


class _Span:
    """The context of one span; ``span`` makes it."""

    __slots__ = ("rec", "dev", "into")

    def __init__(self, name, dev, into):
        self.rec = Record(name, 0)
        self.dev, self.into = dev, into

    def __enter__(self):
        rec = self.rec
        if self.dev is not None and self.dev.type == "cuda":
            rec._events = (_event(self.dev), None)
        _local.open.append(rec)
        rec.t0 = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        rec.t1 = time.perf_counter_ns()
        _local.open.pop()
        rec._into = self.into
        if rec._events is not None:
            rec._events = (rec._events[0], _event(self.dev))
            rec.clock = "device"
        else:
            rec.clock = "host"
            rec.value = (rec.t1 - rec.t0) / 1e9
        _keep(rec, rec._events is not None)
        return False


def span(name: str, family: str, dev: torch.device | None = None, into=None):
    """``with span(name, family, dev):`` records the block as a span when
    ``family`` is on; on a CUDA ``dev`` its seconds are the device's.
    ``into`` = (dict, key): its seconds are added to ``dict[key]`` once
    known (the views ``quant/qgraph.py`` keeps)."""
    if not on(family):
        return _NULL
    return _Span(name, dev, into)


def add(name: str, value, t0: int | None = None) -> Record:
    """Records ``value`` under ``name`` now: a counter, or with ``t0`` (a
    ``perf_counter_ns`` time) host seconds summed since then.  The caller
    checks its family."""
    t1 = time.perf_counter_ns()
    rec = Record(name, t1 if t0 is None else t0, t1, value, None if t0 is None else "host")
    _keep(rec)
    return rec


def stamp(dev: torch.device):
    """A point of a sequence of marks: (host time, its CUDA event or None)."""
    return time.perf_counter_ns(), (_event(dev) if dev.type == "cuda" else None)


def interval(name: str, start, dev: torch.device):
    """Records the span from the stamp ``start`` to now; returns the record
    and the stamp that ends it (the next interval's start)."""
    end = stamp(dev)
    rec = Record(name, start[0], end[0])
    if start[1] is not None:
        rec._events, rec.clock = (start[1], end[1]), "device"
    else:
        rec.value, rec.clock = (end[0] - start[0]) / 1e9, "host"
    _keep(rec, start[1] is not None)
    return rec, end


def resolve() -> None:
    """Reads the device seconds of every pending span, waiting for the card
    to pass each one's end event (only spans that a family on made)."""
    with _lock:
        for rec in _pending:
            start, end = rec._events
            end.synchronize()
            rec.value = start.elapsed_time(end) / 1e3
            rec._events = None
            if rec._into is not None:
                _add_into(rec)
        _pending.clear()


def records() -> list[Record]:
    """The buffer's records, oldest first, every device span resolved."""
    resolve()
    with _lock:
        return list(_records)


def clear() -> None:
    """Empties the buffer (pending spans included)."""
    global _records, dropped
    with _lock:
        _records = collections.deque(maxlen=CAPACITY)
        _pending.clear()
        dropped = 0


def public(fn):
    """Decorator: ``fn`` is a public call.  The outermost public call reads
    both switches, takes a new call id, and when it ends resolves the device
    spans made inside it.  A public call inside another belongs to the outer
    one's call."""

    @functools.wraps(fn)
    def inner(*args, **kwargs):
        t = _local
        if t.depth:
            return fn(*args, **kwargs)
        t.on = {SEARCH: on(SEARCH), BUILD: on(BUILD)}
        t.call = next(_calls)
        t.depth = 1
        try:
            out = fn(*args, **kwargs)
            if _pending:
                resolve()
            return out
        finally:
            t.depth = 0
            t.on = {SEARCH: False, BUILD: False}

    return inner
