"""The decode step replayed from a CUDA graph (``repro_torch.models.
decode_graph``).  On the CPU: the reader ``model.decode_graph_pct`` on the
synthetic traced run of ``test_sqb_span_metrics``, whose answer is known;
``EXPECT`` joins the readers' table (the repository's ``conftest.py``).  On
the card: replayed steps give the caches of eager steps bit for bit, and an
engine that plugs and unplugs between steps captures afresh, writes the
right rows, frees what its unplugs report and counts its replays; run on the
chip with ``python -m pytest -q -m card squeeze_bench/tests``."""
import math

import pytest

from repro_torch import spans
from squeeze_bench.run import load_reader
from squeeze_bench.tests.test_sqb_span_metrics import traced_synthetic

NAME = "model.decode_graph_pct"


def _graph_synthetic(modes):
    """The synthetic traced run, its dispatch spans given ``graph``
    attributes in order (``None``: none, as the parent's spans)."""
    run = traced_synthetic()
    disp = [r for r in spans.log() if r.name == "decode.dispatch"]
    for r, how in zip(disp, modes):
        if how is not None:
            r.attrs["graph"] = how
    return run


EXPECT = {
    # two dispatch spans in the window, one a replay; the third, a replay
    # after the window, does not count
    NAME: 50.0,
}


def test_reader():
    run = _graph_synthetic(["replay", "capture", "replay"])
    assert math.isclose(load_reader(NAME)(run), EXPECT[NAME], rel_tol=1e-9)
    run = _graph_synthetic(["replay", "replay", "eager"])
    assert load_reader(NAME)(run) == 100.0


def test_reader_finds_nothing():
    # dispatch spans without the attribute, as the parent records them
    assert load_reader(NAME)(_graph_synthetic([None, None, None])) is None
    # no trace, as in an untraced run
    run = _graph_synthetic(["replay", "replay", "replay"])
    run["trace"] = None
    assert load_reader(NAME)(run) is None
    # a trace, but a program that recorded no spans in it
    run = _graph_synthetic(["replay", "replay", "replay"])
    spans.clear()
    assert load_reader(NAME)(run) is None


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _same(a, b) -> bool:
    import torch
    from repro_torch.models.layers import tree_leaves
    return all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))
               for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True))


def _clone(caches):
    from repro_torch.models.layers import tree_map
    return tree_map(lambda x: x.clone(), caches)


def _attention_layers(cfg) -> int:
    from repro_torch.models.transformer import ATTN_KINDS
    kinds = list(cfg.block_pattern) * cfg.n_groups + list(cfg.tail_pattern)
    return sum(k in ATTN_KINDS for k in kinds)


@pytest.mark.card
@pytest.mark.parametrize("arch", ["qwen2-7b", "gemma2-9b", "mixtral-8x7b"])
def test_replayed_steps_equal_eager_steps(card, arch):
    """64 rows of a reduced model, each at its own position: the graph's
    steps (eager, capture, then replays) leave the caches bit-equal to
    eager steps on the same inputs, and ``ops.LAUNCHES`` counts every
    attention launch the device ran, replayed ones included."""
    import torch
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models.decode_graph import DecodeGraph, eligible
    from repro_torch.models.layers import tree_leaves

    cfg = reduced(get_config(arch))
    assert eligible(cfg, card)
    params = M.init_params(cfg, 0, device=card)
    rows, steps = 64, 7
    eager = M.init_caches(cfg, rows, 128, device=card)
    gen = torch.Generator(device=card).manual_seed(3)
    for x in tree_leaves(eager):
        x.copy_(torch.randn(x.shape, generator=gen, device=card,
                            dtype=x.dtype))
    graphed = _clone(eager)
    graph = DecodeGraph(cfg, params, card)
    cpu = torch.Generator().manual_seed(4)
    launches0 = ops.LAUNCHES["partition_attention"]
    modes = []
    for s in range(steps):
        toks = torch.randint(0, cfg.vocab_size, (rows, 1), generator=cpu,
                             dtype=torch.int32)
        pos = (torch.arange(rows, dtype=torch.int32) * 3 + 20 + s) % 300
        M.decode_step(cfg, params, toks.to(card), pos.to(card), eager)
        graph.load(toks, pos)
        modes.append(graph.step(graphed))
    torch.cuda.synchronize()
    assert modes == ["eager", "capture"] + ["replay"] * (steps - 2)
    assert _same(eager, graphed)
    assert ops.LAUNCHES["partition_attention"] - launches0 \
        == 2 * steps * _attention_layers(cfg)


@pytest.mark.card
def test_the_embedding_scale_is_the_device_one(card):
    """gemma2's embedding scale, a CPU scalar so that the step can be
    captured, gives the products the scale made on the card gave."""
    import torch
    gen = torch.Generator(device=card).manual_seed(5)
    x = torch.randn((64, 1, 3584), generator=gen, device=card,
                    dtype=torch.bfloat16)
    for d in (2560, 3584):
        on_card = torch.sqrt(torch.tensor(float(d), dtype=x.dtype,
                                          device=card))
        on_host = torch.sqrt(torch.tensor(float(d), dtype=x.dtype))
        assert torch.equal(x * on_card, x * on_host)


def _expected_modes(events) -> list:
    """What each decode step should have been, from the engine's events: a
    step after a plug or an unplug (or the first) eager, the one after an
    eager step with no resize between a capture, every other a replay."""
    out, resized = [], True
    for e in events:
        if e.kind in ("plug", "unplug"):
            resized = True
        elif e.kind == "decode":
            out.append("eager" if resized else
                       "capture" if out[-1] == "eager" else "replay")
            resized = False
    return out


@pytest.mark.card
def test_an_engine_captures_afresh_after_each_resize(card):
    """A reduced qwen2 engine up the ladder to 64 rows and, when most of
    its requests end, down to 8 while four decode on: every step leaves
    the caches an eager step leaves, a plug or an unplug makes the next
    step eager and the one after a capture, each unplug frees on the card
    the bytes it reports, and the counters count the captures and
    replays."""
    import torch
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.core.arena import ArenaSpec
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.request import FunctionProfile, Request

    cfg = reduced(get_config("qwen2-7b"))
    params = M.init_params(cfg, 0, device=card)
    spec = ArenaSpec.from_model(cfg, partition_tokens=128, n_partitions=64,
                                block_tokens=32)
    launches0 = ops.LAUNCHES["partition_attention"]
    eng = ServeEngine(cfg, params, spec, mode="hotmem", keep_alive=0.0)
    long_ = FunctionProfile("long", 8, 40, 128)
    short = FunctionProfile("short", 16, 10, 128)
    reqs = [Request(f"l{i}", long_, 0.0) for i in range(4)] \
        + [Request(f"s{i}", short, 0.0) for i in range(40)]

    decode, unplug = eng._decode, eng._unplug_now
    mismatched, freed = [], []

    def checked_decode():
        rows = eng._rows()
        pos = torch.zeros((rows,), dtype=torch.int32)
        for row, req in eng._row_req.items():
            pos[row] = req.position
        shadow = _clone(eng.caches)
        decode()
        M.decode_step(cfg, params, torch.zeros((rows, 1), dtype=torch.int32,
                                               device=card),
                      pos.to(card), shadow)
        if not _same(shadow, eng.caches):
            mismatched.append(len(eng.events))

    def measured_unplug(units, *, stolen=False):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(card)
        ev = unplug(units, stolen=stolen)
        freed.append((before - torch.cuda.memory_allocated(card),
                      ev.reclaimed_bytes))
        return ev

    eng._decode, eng._unplug_now = checked_decode, measured_unplug
    spans.clear()
    spans.enable()
    try:
        m = eng.run(reqs, max_virtual_s=1e6)
    finally:
        spans.enable(False)
    modes = [r.attrs["graph"] for r in spans.log()
             if r.name == "decode.dispatch"]
    spans.clear()
    assert m["completed"] == len(reqs) and m["killed"] == 0
    assert not mismatched, mismatched
    assert modes == _expected_modes(eng.events)
    assert len(modes) == m["decode_steps"]
    assert eng.graph_captures == modes.count("capture") >= 2
    assert eng.graph_replays == modes.count("replay") > 0
    assert freed and all(f == r > 0 for f, r in freed), freed
    # the warm-up step, the engine's steps and the shadow's eager steps
    assert ops.LAUNCHES["partition_attention"] - launches0 == \
        (2 * m["decode_steps"] + 1) * _attention_layers(cfg)
