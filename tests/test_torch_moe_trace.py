"""What the port records of its expert blocks (``models.moe``): the
``moe`` span and its four children under ``model.block``, and the device
readings of a ``moe.Probe`` that each decode step run by ``DecodeGraph``
writes, read by the engine's ``decode.moe`` span.

On the CPU, with a tiny Mixtral (8 experts, top 2, the widths of
``squeeze_bench/tests/small.py``): the spans and their sizes; the counts
against a bincount of ``route``'s choices on the same hidden states, layer
by layer; the drops at capacity factors 4.0 and 1.25; caches bit-equal with
the probe written; the engine's ``decode.moe`` span.  On the card
(``card`` marker), at Mixtral-8x7B's widths on 2 layers: replayed steps
with the counters and events against eager steps, bit for bit, and the
events' time inside the step's.  This file imports no JAX, so the card
test runs on the chip with ``PYTHONPATH=src python -m pytest -q
--noconftest -m card tests/test_torch_moe_trace.py``.
"""
import dataclasses
from collections import deque

import pytest
import torch

from repro_torch import spans
from repro_torch.configs.base import get_config, reduced
from repro_torch.core.arena import ArenaSpec
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models.decode_graph import DecodeGraph
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.request import PROFILES, Request

torch.set_num_threads(1)
SMALL = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             head_dim=16, d_ff=128, vocab_size=512)
CHILDREN = ["moe.route", "moe.dispatch", "moe.experts", "moe.combine"]
ROWS, T = 16, 32


def tiny(cf=4.0):
    return dataclasses.replace(reduced(get_config("mixtral-8x7b")),
                               num_experts=8, num_experts_per_tok=2,
                               sliding_window=0, moe_capacity_factor=cf,
                               **SMALL)


@pytest.fixture(autouse=True)
def fresh():
    spans.enable(False)
    spans.clear()
    yield
    spans.enable(False)
    spans.clear()


def _same(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def _caches(cfg, seed=1, device="cpu"):
    caches = M.init_caches(cfg, ROWS, T, device=device)
    gen = torch.Generator().manual_seed(seed)
    for x in tree_leaves(caches):
        x.copy_(torch.randn(x.shape, generator=gen).to(x.dtype))
    return caches


def _inputs(cfg, seed=2):
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (ROWS, 1), generator=gen,
                         dtype=torch.int32)
    pos = torch.randint(0, T, (ROWS,), generator=gen, dtype=torch.int32)
    return toks, pos


def _step(cfg, params, caches, toks, pos):
    """One step run by a ``DecodeGraph`` (eager on the CPU): its graph."""
    graph = DecodeGraph(cfg, params, "cpu")
    graph.load(toks, pos)
    assert graph.step(caches) == "eager"
    return graph


def _blocks_inputs(monkeypatch):
    """Record each expert block's (weights, hidden states) as it runs."""
    seen, block = [], moe.moe_block

    def record(cfg, p, x):
        seen.append((p, x.clone()))
        return block(cfg, p, x)
    monkeypatch.setattr(moe, "moe_block", record)
    return seen


def _routed(cfg, p, x) -> torch.Tensor:
    _w, top_e = moe.route(cfg, p, x.reshape(-1, cfg.d_model))
    return torch.bincount(top_e.reshape(-1), minlength=cfg.num_experts)


def test_spans_of_an_expert_block():
    cfg = tiny()
    params = M.init_params(cfg, 0, device="cpu")
    spans.enable()
    _step(cfg, params, _caches(cfg), *_inputs(cfg))
    blocks = [r for r in spans.log() if r.name == "model.block"]
    assert [r.attrs["layer"] for r in blocks] == [0, 1]
    for b in blocks:
        kids = [r for r in spans.log() if r.parent == b.id]
        assert [r.name for r in kids] == ["attn.qkv", "attn.core",
                                          "attn.out", "moe"]
        m = kids[-1]
        assert m.attrs == {"tokens": ROWS, "experts": 8, "top_k": 2,
                           "capacity": moe.capacity(cfg, ROWS)}
        assert [r.name for r in spans.log() if r.parent == m.id] \
            == CHILDREN
        assert all(r.path == "model.block/moe/" + r.name
                   for r in spans.log() if r.parent == m.id)
    assert not [r for r in spans.log() if r.name == "mlp"]


def test_a_dense_block_keeps_mlp():
    cfg = dataclasses.replace(reduced(get_config("qwen2-7b")), **SMALL)
    params = M.init_params(cfg, 0, device="cpu")
    spans.enable()
    graph = _step(cfg, params, _caches(cfg), *_inputs(cfg))
    assert graph.probe is None
    names = {r.name for r in spans.log()}
    assert "mlp" in names and not names & {"moe", *CHILDREN}


def test_counts_are_the_routes(monkeypatch):
    cfg = tiny()
    params = M.init_params(cfg, 0, device="cpu")
    seen = _blocks_inputs(monkeypatch)
    graph = _step(cfg, params, _caches(cfg), *_inputs(cfg))
    assert len(seen) == cfg.num_layers
    counts = graph.probe.routed()
    assert counts.shape == (cfg.num_layers, 8)
    for layer, (p, x) in enumerate(seen):
        assert torch.equal(counts[layer], _routed(cfg, p, x))
    got = graph.probe.read()
    c = moe.capacity(cfg, ROWS)
    assert got == {"layers": 2, "tokens": ROWS, "slots": 2 * ROWS * 2,
                   "dropped": 0,
                   "experts_hit": sum(int((_routed(cfg, p, x) > 0).sum())
                                      for p, x in seen),
                   "rows": 8 * c * 2}
    assert "expert_ms" not in got                        # no events here


def test_drops_over_capacity(monkeypatch):
    """Every row the same token at the same position over zero caches, so
    the rows route alike and a few experts take nearly every slot: at 1.25
    the capacity (8) drops what is over it, and the probe counts each
    drop."""
    cfg = tiny(1.25)
    params = M.init_params(cfg, 0, device="cpu")
    seen = _blocks_inputs(monkeypatch)
    toks = torch.full((ROWS, 1), 7, dtype=torch.int32)
    pos = torch.full((ROWS,), 3, dtype=torch.int32)
    graph = _step(cfg, params, M.init_caches(cfg, ROWS, T, device="cpu"),
                  toks, pos)
    c = moe.capacity(cfg, ROWS)
    assert c == 8
    over = 0
    for layer, (p, x) in enumerate(seen):
        routed = _routed(cfg, p, x)
        assert torch.equal(graph.probe.routed()[layer], routed)
        assert int(routed.max()) == ROWS
        _w, top_e = moe.route(cfg, p, x.reshape(-1, cfg.d_model))
        _e, _r, keep = moe.dispatch_slots(cfg, top_e, c)
        assert int((~keep).sum()) == int((routed - c).clamp(min=0).sum())
        over += int((~keep).sum())
    got = graph.probe.read()
    assert got["dropped"] == over >= 2 * (ROWS - c)
    assert got["slots"] == 2 * ROWS * 2 - over


def test_probed_caches_are_the_steps():
    """The counters written and not read: the caches and logits are those
    of the plain step, bit for bit."""
    cfg = tiny()
    params = M.init_params(cfg, 0, device="cpu")
    toks, pos = _inputs(cfg)
    plain = _caches(cfg)
    probed = tree_map(lambda x: x.clone(), plain)
    want, _ = M.decode_step(cfg, params, toks, pos, plain)
    probe = moe.Probe(cfg, "cpu")
    with moe.probing(probe):
        got, _ = M.decode_step(cfg, params, toks, pos, probed)
    assert len(probe.blocks) == cfg.num_layers
    assert _same(got, want)
    assert all(_same(a, b) for a, b in zip(tree_leaves(plain),
                                           tree_leaves(probed), strict=True))


def test_probing_is_scoped():
    cfg = tiny()
    params = M.init_params(cfg, 0, device="cpu")
    toks, pos = _inputs(cfg)
    probe = moe.Probe(cfg, "cpu")
    with moe.probing(probe):
        M.decode_step(cfg, params, toks, pos, _caches(cfg))
    M.decode_step(cfg, params, toks, pos, _caches(cfg))   # not probed
    assert len(probe.blocks) == cfg.num_layers
    assert moe.Probe(cfg, "cpu").read() is None


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen2-7b"])
def test_the_engine_reads_each_step(arch):
    """A reduced engine serving two invocations with spans on: a model
    with experts has one ``decode.moe`` span in each decode step, after
    ``decode.sync``; a model without has none."""
    cfg = tiny() if arch == "mixtral-8x7b" else \
        dataclasses.replace(reduced(get_config(arch)), **SMALL)
    params = M.init_params(cfg, 0, device="cpu")
    spec = ArenaSpec.from_model(cfg, partition_tokens=128, n_partitions=8,
                                block_tokens=32)
    eng = ServeEngine(cfg, params, spec, mode="hotmem", keep_alive=1000.0)
    spans.enable()
    for rid, prof in (("a", "cnn"), ("b", "bert")):
        eng.submit(Request(rid=rid, profile=PROFILES[prof],
                           submit_s=eng.now))
    while eng.active or eng.pending:
        eng._tick(deque())
    decodes = [r for r in spans.log() if r.name == "decode"]
    reads = [r for r in spans.log() if r.name == "decode.moe"]
    assert decodes
    if not cfg.num_experts:
        assert reads == []
        return
    assert [r.parent for r in reads] == [r.id for r in decodes]
    for d, r in zip(decodes, reads):
        kids = [k.name for k in spans.log() if k.parent == d.id]
        assert kids == ["decode.inputs", "decode.dispatch", "decode.sync",
                        "decode.moe", "decode.account"]
        rows = eng._rows()
        assert r.attrs["layers"] == cfg.num_layers
        assert r.attrs["dropped"] == 0
        assert r.attrs["slots"] == r.attrs["tokens"] * 2 * cfg.num_layers
        assert 0 < r.attrs["experts_hit"] <= 8 * cfg.num_layers
        assert r.attrs["tokens"] <= rows


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.card
def test_replayed_probed_steps_are_eager_steps(card):
    """Mixtral-8x7B's widths on 2 layers, 64 rows of 2,048 slots, dropless:
    the steps of a ``DecodeGraph`` (eager, capture, then replays, every one
    writing the probe's counters and events) leave the caches an eager
    step without a probe leaves, bit for bit; a replay's ``expert_ms`` lies
    above 0 and below the replay's device time by CUDA events; nothing is
    dropped."""
    cfg = dataclasses.replace(get_config("mixtral-8x7b"), num_layers=2,
                              sliding_window=0, moe_capacity_factor=4.0)
    params = M.init_params(cfg, 0, device=card)
    rows, t = 64, 2048
    eager = M.init_caches(cfg, rows, t, device=card)
    gen = torch.Generator(device=card).manual_seed(3)
    for x in tree_leaves(eager):
        x.copy_(torch.randn(x.shape, generator=gen, device=card,
                            dtype=x.dtype))
    graphed = tree_map(lambda x: x.clone(), eager)
    graph = DecodeGraph(cfg, params, card)
    cpu = torch.Generator().manual_seed(4)
    modes, readings = [], []
    for s in range(6):
        toks = torch.randint(0, cfg.vocab_size, (rows, 1), generator=cpu,
                             dtype=torch.int32)
        pos = (torch.arange(rows, dtype=torch.int32) * 29 + 31 + s) % 1800
        M.decode_step(cfg, params, toks.to(card), pos.to(card), eager)
        graph.load(toks, pos)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        modes.append(graph.step(graphed))
        end.record()
        torch.cuda.synchronize()
        readings.append((start.elapsed_time(end), graph.probe.read()))
        assert all(_same(a, b) for a, b in zip(
            tree_leaves(eager), tree_leaves(graphed), strict=True))
    assert modes == ["eager", "capture"] + ["replay"] * 4
    for step_ms, got in readings[2:]:
        assert got["layers"] == 2 and got["tokens"] == rows
        assert got["dropped"] == 0 and got["slots"] == rows * 2 * 2
        assert 0 < got["expert_ms"] < step_ms
