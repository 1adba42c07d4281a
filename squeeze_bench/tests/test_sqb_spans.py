"""The port's host spans and the benchmark's device trace share one clock.
On the card: a span records while a profiler of CUDA activity alone records
(``DeviceTrace``), a kernel launched and synchronised inside a span lies
inside it on the harness clock, and every decode step's device operations
(their stamps' drift taken off, ``metrics/_spans.device_ops``) lie inside
its ``decode`` span; run on the chip with
``python -m pytest -q -m card squeeze_bench/tests``.  On the CPU: the drift
correction on device stamps that drift and jump."""
import time
from collections import deque

import pytest

from squeeze_bench.metrics._spans import NEIGHBOURS, device_ops
from squeeze_bench.tests.test_sqb_span_metrics import kineto_trace

SLACK_S = 50e-6


def _traced(fn):
    """``fn()`` under a ``DeviceTrace``; (trace, origin of its clock)."""
    from squeeze_bench.trace import DeviceTrace
    origin = time.perf_counter()
    tr = DeviceTrace(lambda: time.perf_counter() - origin)
    tr.start()
    fn()
    tr.stop()
    return tr, origin


def _on_clock(rec, origin):
    return rec.t0 / 1e9 - origin, rec.t1 / 1e9 - origin


@pytest.mark.card
def test_a_kernel_lies_inside_its_span(card):
    import torch
    from repro_torch import spans
    spans.clear()
    torch.cuda._sleep(1000)                      # load the kernel first
    torch.cuda.synchronize()
    made = []

    def body():
        with spans.span("sleep") as s:
            torch.cuda._sleep(20_000_000)        # about 10 ms
            torch.cuda.synchronize()
        made.append(s)
    tr, origin = _traced(body)
    assert made[0], "no span recorded under a CUDA-only profiler"
    assert not spans.recording() and not spans.span("after")
    (rec,) = [r for r in spans.log() if r.name == "sleep"]
    a, b = _on_clock(rec, origin)
    name, ka, kb = max(tr.device_events(), key=lambda e: e[2] - e[1])
    assert kb - ka > 1e-3, name
    assert a - SLACK_S <= ka and kb <= b + SLACK_S, (a, ka, kb, b)
    spans.clear()


@pytest.mark.card
def test_decode_spans_hold_their_device_operations(card):
    import torch
    from repro_torch import spans
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.core.arena import ArenaSpec
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.request import PROFILES, Request
    cfg = reduced(get_config("qwen2-7b"))
    params = M.init_params(cfg, 0, device=card)
    spec = ArenaSpec.from_model(cfg, partition_tokens=128, n_partitions=8,
                                block_tokens=32)
    eng = ServeEngine(cfg, params, spec, mode="hotmem", keep_alive=1000.0)
    # as the harness does in its set-up: the profiler's first start, with
    # the kernels loaded and warmed, before the traced window
    _traced(lambda: torch.ones(1, device=card).add_(1))
    spans.clear()

    def serve():
        for rid, prof in (("a", "cnn"), ("b", "bert")):
            eng.submit(Request(rid=rid, profile=PROFILES[prof],
                               submit_s=eng.now))
        while eng.active or eng.pending:
            eng._tick(deque())
        torch.cuda.synchronize()
    tr, origin = _traced(serve)
    ops = device_ops(tr)
    decodes = [_on_clock(r, origin) for r in spans.log()
               if r.name == "decode"]
    assert len(decodes) == sum(e.kind == "decode" for e in eng.events) > 0
    for a, b in decodes:
        held = [(n, x, y) for n, x, y in ops if a <= x <= b]
        assert sum("partition_attention" in n for n, _x, _y in held) \
            == cfg.num_layers, (a, b, tr.t0, held)
        assert all(y <= b + SLACK_S for _n, _x, y in held), (a, b, held)
    spans.clear()


def test_device_ops_take_off_a_drift_and_a_jump():
    """Operations launched every 25 us run 5 us after their launch; their
    device stamps drift by -1 % of the time (-3 ms at the start) and jump
    back to true half way.  Corrected, every start lies within 20 us of its
    true start but for at most ``NEIGHBOURS`` operations after the jump;
    the launch lag itself (5 us) is taken off with the drift."""
    n, gap = 4000, 25e-6
    true = [(f"k{i}", 1.0 + i * gap, 1.0 + i * gap + 10e-6)
            for i in range(n)]
    tr = kineto_trace(true, 0.5, 2.0)
    events = tr.prof.profiler.kineto_results.events()
    for ev in events[1::2]:                      # the device events
        t = ev.a / 1e9 - tr.epoch_minus_clock
        err = 0.0 if t >= 1.05 else -0.003 - 0.01 * (t - 1.0)
        ev.a, ev.b = ev.a + round(err * 1e9), ev.b + round(err * 1e9)
    for ev, (_n, a, _b) in zip(events[0::2], true):
        ev.a -= 5000                             # launched 5 us before
    got = device_ops(tr)
    assert [g[0] for g in got] == [t[0] for t in true]
    off = [abs(g[1] - t[1]) for g, t in zip(got, true)]
    assert sum(o > 20e-6 for o in off) <= NEIGHBOURS
    assert max(off[:n // 2 - NEIGHBOURS]) < 20e-6
    assert max(off[n // 2 + NEIGHBOURS:]) < 20e-6
