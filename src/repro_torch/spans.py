"""Host spans: named, nested intervals of the port's host code, stamped on
``time.perf_counter_ns``, the clock a benchmark's device trace is mapped
onto, so that the device's idle time can be put down to the host code that
held it (``idle_by_span``).

    with spans.span("decode.dispatch", rows=64) as s:
        ...
        if s:                       # recording: attributes known at the end
            s.note(h2d_bytes=n)

A span records while ``enable()`` is in force or while a ``torch.profiler``
records (torch's own flag, set between the profiler's start and its stop).
Otherwise ``span()`` costs one test of those two flags and returns ``NOOP``,
one shared object that does nothing and is false: no clock is read and no
record is made.  A span decides when it is made: one made while off never
records, even if a profiler starts before it ends.

Each record has an id, the id of its parent (the span open on the same
thread when it was entered: the one that caused it), its name, the path of
names from the outermost span down (``tick/decode/decode.dispatch``), start
and end in ``perf_counter_ns`` and its attributes.  ``begin()`` opens a
span that outlives the code that opened it (a request, from its submission
to its end): it has a parent but is no one's parent, and ``idle_by_span``
passes over it.

The records are kept in memory, in one log per process of at most ``LIMIT``
records; those made past it are counted (``dropped()``) and not kept.
``log()`` reads the log and ``clear()`` empties it.
"""
from __future__ import annotations

import bisect
import itertools
import threading
import time

from torch.autograd import profiler as _profiler

LIMIT = 1 << 18
NO_SPAN = "(no span)"

_enabled = False
_log: list = []
_dropped = 0
_ids = itertools.count(1)
_lock = threading.Lock()
_local = threading.local()


class Span:
    """One record, and the context manager that makes it."""
    __slots__ = ("id", "parent", "name", "path", "t0", "t1", "attrs",
                 "nested")

    def __init__(self, name: str, attrs: dict, parent=None, t0: int = 0,
                 t1: int = 0, nested: bool = True):
        self.id = next(_ids)
        self.name = name
        self.attrs = attrs
        self.nested = nested
        self.t0, self.t1 = t0, t1
        self._parent(parent)

    def _parent(self, parent) -> None:
        self.parent = None if parent is None else parent.id
        self.path = self.name if parent is None \
            else parent.path + "/" + self.name

    def note(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _stack()
        self._parent(stack[-1] if stack else None)
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter_ns()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        else:
            stack.remove(self)
        _keep(self)

    def end(self, **attrs) -> None:
        """Close a span opened by ``begin()``."""
        self.t1 = time.perf_counter_ns()
        self.attrs.update(attrs)
        _keep(self)


class _Noop:
    """What ``span()`` and ``begin()`` return while nothing records."""
    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None

    def note(self, **attrs) -> None:
        return None

    def end(self, **attrs) -> None:
        return None


NOOP = _Noop()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _keep(rec: Span) -> None:
    global _dropped
    with _lock:
        if len(_log) < LIMIT:
            _log.append(rec)
        else:
            _dropped += 1


def recording() -> bool:
    return _enabled or _profiler._is_profiler_enabled


def span(name: str, **attrs):
    """A span around a ``with`` block; ``NOOP`` while nothing records."""
    if _enabled or _profiler._is_profiler_enabled:
        return Span(name, attrs)
    return NOOP


def begin(name: str, **attrs):
    """A span opened now and closed by its ``end()``, from any code;
    ``NOOP`` while nothing records."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return NOOP
    stack = _stack()
    rec = Span(name, attrs, stack[-1] if stack else None, nested=False)
    rec.t0 = time.perf_counter_ns()
    return rec


def enable(on: bool = True) -> None:
    """Record whether or not a profiler runs (``enable(False)`` stops)."""
    global _enabled
    _enabled = on


def log() -> list:
    """The records, oldest end first: the live list (copy it to keep it
    past ``clear()``)."""
    return _log


def dropped() -> int:
    return _dropped


def clear() -> None:
    global _dropped
    with _lock:
        _log.clear()
        _dropped = 0


def idle_by_span(device_intervals, t0: float, t1: float, records=None,
                 origin: float = 0.0) -> dict:
    """The device's idle seconds in [t0, t1], each put down to the
    innermost span open on the host at that instant and keyed by that
    span's path, with the idle time under no span under ``NO_SPAN``.

    ``device_intervals``: (start, end) or (name, start, end) of the
    device's operations, in seconds on the clock ``perf_counter() -
    origin``; ``records`` (default: the log) are put on that clock too.
    Spans from ``begin()`` are passed over."""
    busy = sorted((max(iv[-2], t0), min(iv[-1], t1))
                  for iv in device_intervals)
    gaps, cur = [], t0
    for a, b in busy:
        if b <= a:
            continue
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if cur < t1:
        gaps.append((cur, t1))
    # the innermost open span, as a step function of time: (time, path)
    edges = []
    for r in (_log if records is None else records):
        a, b = r.t0 / 1e9 - origin, r.t1 / 1e9 - origin
        if r.nested and b > t0 and a < t1 and b > a:
            edges.append((a, 1, r))
            edges.append((b, 0, r))
    edges.sort(key=lambda e: (e[0], e[1]))
    times, paths, open_ = [t0], [NO_SPAN], []
    for at, starts, r in edges:
        if starts:
            open_.append(r)
        elif open_ and open_[-1] is r:
            open_.pop()
        else:
            open_.remove(r)
        path = open_[-1].path if open_ else NO_SPAN
        if at <= times[-1]:
            paths[-1] = path
        else:
            times.append(at)
            paths.append(path)
    out: dict = {}
    for a, b in gaps:
        i = bisect.bisect_right(times, a) - 1
        while a < b:
            nxt = times[i + 1] if i + 1 < len(times) else b
            end = min(b, nxt)
            if end > a:
                out[paths[i]] = out.get(paths[i], 0.0) + end - a
            a = end
            i += 1
    return out
