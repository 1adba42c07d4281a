"""The span readers on the synthetic run of ``test_sqb_metrics``, given a
traced window's program spans and device operations, whose answers are
known.  ``EXPECT`` joins that module's table of every reader's answer (the
repository's ``conftest.py``), so that its check that every metric of
``BENCHMARK.json`` has a reader sees these too."""
import math
import types

import pytest

from repro_torch import spans
from squeeze_bench.run import load_reader
from squeeze_bench.tests.test_sqb_metrics import synthetic

ORIGIN = 1000.0


class _Event:
    """A kineto event as ``DeviceTrace`` and the span readers read it."""

    def __init__(self, device, name, a, b, corr):
        self.device, self.nm, self.corr = device, name, corr
        self.a, self.b = round(a * 1e9), round(b * 1e9)

    def device_type(self):
        return self.device

    def name(self):
        return self.nm

    def start_ns(self):
        return self.a

    def duration_ns(self):
        return self.b - self.a

    def correlation_id(self):
        return self.corr


def kineto_trace(ops, t0, t1, drift=0.0, epoch=5000.0):
    """A ``DeviceTrace`` over [t0, t1] whose profiler holds each of ``ops``
    (name, start, end on the harness clock) as a device event, stamped
    ``drift`` seconds off, and its launching call, stamped true; kineto's
    stamps are ``epoch`` seconds ahead of the harness clock."""
    evs = []
    for i, (name, a, b) in enumerate(ops, 1):
        evs.append(_Event("DeviceType.CPU", "cudaLaunchKernel", epoch + a,
                          epoch + a + 2e-6, i))
        evs.append(_Event("DeviceType.CUDA", name, epoch + a + drift,
                          epoch + b + drift, i))
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: evs)))
    return types.SimpleNamespace(t0=t0, t1=t1, prof=prof,
                                 epoch_minus_clock=epoch)


def traced_synthetic():
    """``synthetic()`` with the program's spans and the device's operations
    of its traced window [10, 12] on the harness clock (the process clock
    less ``ORIGIN``)."""
    run = synthetic()
    run["cell"].origin = ORIGIN
    ops = [("k", 10.2, 10.25), ("k", 10.3, 10.38), ("copy", 11.25, 11.28),
           ("k", 11.4, 11.45), ("k", 11.7, 11.8)]
    run["runner"].trace = kineto_trace(ops, 10.0, 12.0, drift=-0.003)

    def rec(name, a, b, parent=None):
        return spans.Span(name, {}, parent, t0=round((a + ORIGIN) * 1e9),
                          t1=round((b + ORIGIN) * 1e9))
    spans.clear()
    for a, d, p, e in ((10.0, 10.1, 10.15, 10.5), (11.0, 11.1, 11.2, 11.6),
                       (12.5, 12.6, 12.7, 13.0)):     # the last after it
        tick = rec("tick", a, e)
        decode = rec("decode", d, e - 0.1, tick)
        disp = rec("decode.dispatch", p, e - 0.15 if a < 11 else p + 0.1,
                   decode)
        spans.log().extend([disp, decode, tick])
    return run


EXPECT = {
    # dispatch spans of 0.2 and 0.1 s; ticks 0.2 s longer than their decode
    "model.decode_dispatch_ms": 150.0,
    "engine.tick_overhead_ms": 200.0,
    # idle inside a dispatch: 0.05 + 0.05 and 0.05 + 0.02 s of 2 s
    "device.idle_in_dispatch_pct": 100 * 0.17 / 2.0,
    # four operations start inside the two decode spans
    "model.decode_launches": 2.0,
}


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_span_reader(name):
    got = load_reader(name)(traced_synthetic())
    assert math.isclose(got, EXPECT[name], rel_tol=1e-9)


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_span_reader_finds_nothing(name):
    # no trace, as in an untraced run
    run = traced_synthetic()
    run["trace"] = None
    assert load_reader(name)(run) is None
    # a trace, but a program that recorded no spans in it
    run = traced_synthetic()
    spans.clear()
    assert load_reader(name)(run) is None
