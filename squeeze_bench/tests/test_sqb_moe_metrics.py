"""The expert path's readers (``moe.expert_ms``, ``moe.expert_roofline``)
on the traced synthetic run of ``test_sqb_span_metrics`` with ``decode.moe``
spans added, some inside its traced window [10, 12] and some outside, and
``moe_costs`` at Mixtral-8x7B's widths.  ``EXPECT`` is each reader's
answer, so that ``test_every_benchmark_metric_has_a_reader`` sees both."""
import math

import pytest

from repro_torch import spans
from squeeze_bench import costs, moe_costs
from squeeze_bench.harness import ROOT, load_json
from squeeze_bench.run import load_reader
from squeeze_bench.tests.test_sqb_span_metrics import (ORIGIN,
                                                       traced_synthetic)

MODEL = load_json(ROOT / "configs" / "mixtral-8x7b-16l.json")["model"]

# (start, end, attributes) on the harness clock: two steps inside the
# window, one before it, one across its end, one after it
STEPS = [(9.5, 9.6, dict(expert_ms=99.0, experts_hit=1)),
         (10.6, 10.61, dict(expert_ms=12.0, experts_hit=128)),
         (11.6, 11.61, dict(expert_ms=14.0, experts_hit=120)),
         (11.99, 12.01, dict(expert_ms=77.0, experts_hit=2)),
         (12.8, 12.81, dict(expert_ms=55.0, experts_hit=3))]


def moe_run(steps=STEPS):
    """``traced_synthetic()`` at Mixtral's sizes, with a ``decode.moe``
    span (16 blocks of 64 tokens) for each of ``steps``."""
    run = traced_synthetic()
    run["model"] = MODEL
    for a, b, attrs in steps:
        spans.log().append(spans.Span(
            "decode.moe", dict(attrs, layers=16, tokens=64),
            t0=round((a + ORIGIN) * 1e9), t1=round((b + ORIGIN) * 1e9)))
    return run


EXPECT = {
    "moe.expert_ms": 13.0,
    "moe.expert_roofline":
        100 * (moe_costs.expert_path_bytes(MODEL, 128, 16, 64)
               + moe_costs.expert_path_bytes(MODEL, 120, 16, 64))
        / costs.HBM_BW / 26e-3,
}


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_moe_reader(name):
    assert math.isclose(load_reader(name)(moe_run()), EXPECT[name],
                        rel_tol=1e-9)


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_moe_reader_finds_nothing(name):
    # a traced run with no decode.moe span, as the parent's program or a
    # model without experts gives
    assert load_reader(name)(traced_synthetic()) is None
    # spans only outside the window
    assert load_reader(name)(moe_run([STEPS[0], STEPS[4]])) is None
    # spans without device times (the CPU's probe has no events)
    bare = [(a, b, dict(experts_hit=8)) for a, b, _ in STEPS]
    assert load_reader(name)(moe_run(bare)) is None
    # no trace, as in an untraced run
    run = moe_run()
    run["trace"] = None
    assert load_reader(name)(run) is None


def test_expert_bytes_at_mixtral_widths():
    full = 3 * 8 * 4096 * 14336 * 2
    assert full == 2_818_572_288
    assert moe_costs.expert_weight_bytes(MODEL, 8) == full
    assert moe_costs.expert_weight_bytes(MODEL, 3) * 8 == 3 * full
    # one block: its weights, the f32 router, 64 tokens in and out
    assert moe_costs.expert_path_bytes(MODEL, 8, 1, 64) \
        == full + 4096 * 8 * 4 + 2 * 64 * 4096 * 2


def test_the_bound_is_below_the_step():
    # 16 blocks of all 8 experts in 13.5 ms at most: 45.1 GB at 3.35 TB/s
    nbytes = moe_costs.expert_path_bytes(MODEL, 16 * 8, 16, 64)
    assert 45.0e9 < nbytes < 45.3e9
    assert 13.4e-3 < nbytes / costs.HBM_BW < 13.55e-3
