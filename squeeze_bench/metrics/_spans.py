"""What the span readers share: the port's host spans
(``repro_torch.spans``, recorded while the profiler of a ``--trace 1`` run
records) and the device trace's operations, inside the traced window and
on the harness clock (seconds since ``Cell.origin``; the spans' stamps are
``perf_counter_ns``, the clock that origin was read on).  A program
without spans gives nothing to read."""
from __future__ import annotations

import importlib.util

import numpy as np

# operations on each side whose least lag behind their launch gives the
# device stamps' error at an operation
NEIGHBOURS = 32


def program_spans():
    """The port's span module, or None where the program has none."""
    if importlib.util.find_spec("repro_torch.spans") is None:
        return None
    import repro_torch.spans as spans
    return spans


def window(run):
    """(start, end) of the traced window, or None without a trace."""
    tr = run["runner"].trace
    if run["trace"] is None or tr is None:
        return None
    return tr.t0, tr.t1


def in_window(run, name: str) -> list:
    """(record, start, end) of every ``name`` span that lies inside the
    traced window, start and end on the harness clock."""
    w, spans = window(run), program_spans()
    if w is None or spans is None:
        return []
    origin = run["cell"].origin
    out = []
    for r in spans.log():
        if r.name != name:
            continue
        a, b = r.t0 / 1e9 - origin, r.t1 / 1e9 - origin
        if w[0] <= a and b <= w[1]:
            out.append((r, a, b))
    return out


def device_ops(tr) -> list:
    """(name, start, end) of the device operations of a ``DeviceTrace``, on
    the harness clock, clipped to its window, each moved by the error of
    kineto's device stamps at it.

    ``DeviceTrace`` maps kineto's host and device stamps with one offset,
    and its host stamps hold to the spans within microseconds; but on the
    H100 its device stamps drift from the host's by up to milliseconds
    within a window, and jump back, so that an operation would start before
    the call that launched it.  The device idles most of a host-bound step,
    so among any run of operations some start as soon as they are launched:
    the least lag behind its launching call among an operation's
    ``NEIGHBOURS`` on each side is taken as the error there, and taken
    off.  A run of more operations queued on a busy device would be moved
    back by its queueing too (a host-bound decode step has none), and at a
    jump up to ``NEIGHBOURS`` operations take the error of its other
    side."""
    launch, ops = {}, []
    for ev in tr.prof.profiler.kineto_results.events():
        a = ev.start_ns() / 1e9 - tr.epoch_minus_clock
        c = ev.correlation_id()
        if "CUDA" in str(ev.device_type()):
            ops.append((a, a + ev.duration_ns() / 1e9, c, ev.name()))
        elif c:
            launch.setdefault(c, a)
    if not ops:
        return []
    ops.sort()
    lag = np.array([a - launch[c] if c in launch else np.inf
                    for a, _b, c, _n in ops])
    padded = np.pad(lag, NEIGHBOURS, constant_values=np.inf)
    err = np.lib.stride_tricks.sliding_window_view(
        padded, 2 * NEIGHBOURS + 1).min(axis=1)
    err[~np.isfinite(err)] = 0.0
    out = []
    for (a, b, _c, name), e in zip(ops, err):
        a, b = max(a - e, tr.t0), min(b - e, tr.t1)
        if b > a:
            out.append((name, a, b))
    return out
