"""The port's host spans (``repro_torch.spans``) on the CPU, with the reduced
qwen2-7b engine: they record only while enabled or while a profiler
records, nest the scheduler tick, the decode step and the model's blocks,
put idle device time down to the innermost span, and change nothing the
engine computes."""
from collections import deque

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs.base import get_config, reduced
from repro_torch.core.arena import ArenaSpec
from repro_torch.models import model as M
from repro_torch.models.layers import tree_leaves
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.request import PROFILES, Request

torch.set_num_threads(1)
DECODE_CHILDREN = ["decode.inputs", "decode.dispatch", "decode.sync",
                   "decode.account"]
BLOCK_CHILDREN = ["attn.qkv", "attn.core", "attn.out", "mlp"]


@pytest.fixture(scope="module")
def setup():
    cfg = reduced(get_config("qwen2-7b"))
    params = M.init_params(cfg, 0, device="cpu")
    spec = ArenaSpec.from_model(cfg, partition_tokens=128, n_partitions=8,
                                block_tokens=32)
    return cfg, params, spec


@pytest.fixture(autouse=True)
def fresh():
    spans.enable(False)
    spans.clear()
    yield
    spans.enable(False)
    spans.clear()


def _engine(setup, **kw):
    cfg, params, spec = setup
    return ServeEngine(cfg, params, spec, mode="hotmem", keep_alive=1000.0,
                       **kw)


def _serve(eng, rids=("a", "b"), profs=("cnn", "bert")) -> int:
    """Submit one invocation per rid and tick until all are done; returns
    the number of iterations."""
    for rid, prof in zip(rids, profs):
        eng.submit(Request(rid=rid, profile=PROFILES[prof],
                           submit_s=eng.now))
    n, empty = 0, deque()
    while eng.active or eng.pending:
        eng._tick(empty)
        n += 1
    return n


def _named(name):
    return [r for r in spans.log() if r.name == name]


def test_nothing_records_while_off():
    assert not spans.recording()
    s = spans.span("tick", replica="r0")
    assert s is spans.NOOP and not s
    with s as inner:
        assert inner is spans.NOOP
        inner.note(x=1)
    assert spans.begin("request", rid="a") is spans.NOOP
    assert spans.log() == [] and spans.dropped() == 0


def test_nothing_records_from_an_engine_while_off(setup):
    eng = _engine(setup)
    _serve(eng)
    assert spans.log() == [] and eng._req_spans == {}


def test_tick_decode_and_blocks_nest(setup):
    cfg = setup[0]
    eng = _engine(setup)
    spans.enable()
    n = _serve(eng)
    by_id = {r.id: r for r in spans.log()}
    ticks = _named("tick")
    assert len(ticks) == n
    assert all(t.parent is None and t.attrs["replica"] == "r0"
               for t in ticks)
    decodes = _named("decode")
    assert len(decodes) == sum(e.kind == "decode" for e in eng.events) > 0
    for d in decodes:
        assert by_id[d.parent].name == "tick"
        kids = sorted((r for r in spans.log() if r.parent == d.id),
                      key=lambda r: r.t0)
        assert [k.name for k in kids] == DECODE_CHILDREN
        assert d.t0 <= kids[0].t0 and kids[-1].t1 <= d.t1
        assert all(a.t1 <= b.t0 for a, b in zip(kids, kids[1:]))
        assert all(k.path == "tick/decode/" + k.name for k in kids)
    for disp in _named("decode.dispatch"):
        blocks = [r for r in spans.log()
                  if r.parent == disp.id and r.name == "model.block"]
        assert [b.attrs["layer"] for b in blocks] == \
            list(range(cfg.num_layers))
        assert {b.attrs["kind"] for b in blocks} == {"attn"}
        for b in blocks:
            assert disp.t0 <= b.t0 and b.t1 <= disp.t1
            assert sorted(r.name for r in spans.log()
                          if r.parent == b.id) == sorted(BLOCK_CHILDREN)
        assert {r.name for r in spans.log() if r.parent == disp.id} == \
            {"model.embed", "model.block", "model.logits"}
    cold = _named("start.cold")
    assert sorted(c.attrs["rid"] for c in cold) == ["a", "b"]
    assert all(by_id[c.parent].name == "admit" for c in cold)
    assert {c.attrs["prompt_tokens"] for c in cold} == \
        {PROFILES["cnn"].prompt_tokens, PROFILES["bert"].prompt_tokens}
    # prefill records its model spans under the cold start
    assert {by_id[r.parent].name for r in _named("model.embed")} == \
        {"start.cold", "decode.dispatch"}


def test_request_spans_share_the_rid(setup):
    eng = _engine(setup)
    spans.enable()
    _serve(eng)
    queue, req = _named("request.queue"), _named("request")
    assert sorted(r.attrs["rid"] for r in queue) == ["a", "b"]
    assert sorted(r.attrs["rid"] for r in req) == ["a", "b"]
    for r in req:
        q = next(x for x in queue if x.attrs["rid"] == r.attrs["rid"])
        assert r.t0 <= q.t0 and q.t1 <= r.t1 and not r.nested
        assert r.attrs["start"] == "cold" and r.attrs["state"] == "DONE"
        assert r.attrs["tokens"] == PROFILES[
            "cnn" if r.attrs["rid"] == "a" else "bert"].decode_tokens
    assert eng._req_spans == {}


def test_warm_start_span_carries_rid_and_row(setup):
    eng = _engine(setup)
    _serve(eng, ("a",), ("cnn",))
    spans.enable()
    _serve(eng, ("w",), ("cnn",))
    (warm,) = _named("start.warm")
    assert warm.attrs == {"rid": "w", "row": eng.done[-1].partition}
    (req,) = _named("request")
    assert req.attrs["start"] == "warm"


def test_a_profiler_switches_recording(setup):
    before = spans.span("made before the profiler")
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.recording()
        with before:
            pass
        with spans.span("inside", k=1) as s:
            assert s
    assert not spans.recording()
    with spans.span("after") as s:
        assert not s
    assert [(r.name, r.attrs) for r in spans.log()] == [("inside",
                                                         {"k": 1})]


def test_the_log_is_bounded(monkeypatch):
    monkeypatch.setattr(spans, "LIMIT", 3)
    spans.enable()
    for i in range(5):
        with spans.span("s", i=i):
            pass
    assert [r.attrs["i"] for r in spans.log()] == [0, 1, 2]
    assert spans.dropped() == 2
    spans.clear()
    assert spans.log() == [] and spans.dropped() == 0


def test_idle_by_span_on_known_intervals():
    origin = 100.0

    def rec(name, a, b, parent=None, nested=True):
        return spans.Span(name, {}, parent, t0=round((a + origin) * 1e9),
                          t1=round((b + origin) * 1e9), nested=nested)
    tick = rec("tick", 0.0, 10.0)
    decode = rec("decode", 1.0, 9.0, tick)
    disp = rec("decode.dispatch", 2.0, 6.0, decode)
    request = rec("request", 0.5, 11.0, nested=False)
    device = [("k", 3.0, 4.0), ("k", 3.5, 3.8), ("copy", 7.0, 8.0),
              ("late", 11.5, 13.0)]
    out = spans.idle_by_span(device, 0.0, 12.0, [request, disp, tick,
                                                 decode], origin=origin)
    want = {"tick": 2.0, "tick/decode": 3.0,
            "tick/decode/decode.dispatch": 3.0, spans.NO_SPAN: 1.5}
    assert out.keys() == want.keys()
    for k, v in want.items():
        assert out[k] == pytest.approx(v, abs=1e-6), k
    # (start, end) pairs, and no span at all
    assert spans.idle_by_span([(3.0, 4.0)], 0.0, 12.0, []) == \
        {spans.NO_SPAN: 11.0}


def test_spans_change_nothing_the_engine_computes(setup):
    off = _engine(setup)
    _serve(off)
    spans.enable()
    on = _engine(setup)
    _serve(on)
    assert len(spans.log()) > 0
    for a, b in zip(tree_leaves(off.caches), tree_leaves(on.caches),
                    strict=True):
        assert torch.equal(a, b)
    assert [(r.rid, r.position, r.partition) for r in off.done] == \
        [(r.rid, r.position, r.partition) for r in on.done]
    assert [e.kind for e in off.events] == [e.kind for e in on.events]


def test_unplug_span_reports_its_reclaim_event(setup):
    eng = _engine(setup)
    spans.enable()
    eng._grow_and_sync(6, via_gate=True)
    ev = eng._unplug_now(4)
    (plug,) = _named("plug")
    (unplug,) = _named("unplug")
    assert plug.attrs["added"] == 6 and plug.attrs["rows_after"] == 8
    assert unplug.attrs["reclaimed_bytes"] == ev.reclaimed_bytes > 0
    assert unplug.attrs["migrated_bytes"] == ev.migrated_bytes == 0
    assert (unplug.attrs["rows"], unplug.attrs["rows_after"]) == (8, 4)
    assert unplug.attrs["stolen"] is False
    # the card's allocator counters are read on the card only
    assert "reserved_before" not in unplug.attrs
