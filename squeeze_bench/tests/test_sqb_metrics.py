"""Every metric reader, and the end-to-end metrics, on a synthetic run whose
answers are known."""
import importlib
import json
import math
import types
from pathlib import Path

import numpy as np
import pytest

from repro_torch.serving.engine import StepEvent
from squeeze_bench import costs, e2e
from squeeze_bench.harness import ROOT, Rec, load_json
from squeeze_bench.run import load_reader

MODEL = load_json(ROOT / "configs" / "qwen2-7b.json")["model"]
ROW = 117_440_512
GIB = 2 ** 30


def _req(rid, prompt, state="DONE"):
    prof = types.SimpleNamespace(prompt_tokens=prompt, name="fn0")
    return types.SimpleNamespace(rid=rid, profile=prof,
                                 state=types.SimpleNamespace(name=state))


def synthetic():
    ev = [StepEvent(10.5, "prefill", 0.1, {"rid": "a"}),
          StepEvent(10.6, "prefill", 0.3, {"rid": "b"}),
          StepEvent(11.0, "decode", 0.04, {"batch": 2}),
          StepEvent(11.1, "decode", 0.06, {"batch": 2}),
          StepEvent(11.2, "plug", 0.002, {"units": 2}),
          StepEvent(11.3, "unplug", 0.004, {"reclaimed_bytes": 2 * ROW}),
          StepEvent(11.4, "restore", 0.02, {"bytes": ROW}),
          StepEvent(11.5, "snapshot", 0.06, {"bytes": 2 * ROW}),
          StepEvent(99.0, "decode", 5.0, {"batch": 2})]   # after the close
    recs = [Rec(_req("a", 1000), 0, 10.0, first=10.6, last=10.9,
                tokens=3, gaps=[(10.7, 0.1), (10.9, 0.2)], done=True),
            Rec(_req("b", 500, "RUNNING"), 0, 10.2, first=11.0, last=11.0,
                tokens=1),
            Rec(_req("c", 500, "PENDING"), 0, 11.5)]
    ns = "(anonymous namespace)::"
    trace = {"window_s": 2.0, "busy_s": 0.5,
             "kernels": {ns + "snapshot_kernel<uint4, false>": (2, 2e-4),
                         ns + "snapshot_kernel<uint4, true>": (1, 9.0),
                         ns + "partition_attention_kernel<__nv_bfloat16, "
                         "128>": (56, 56 * 0.02e-3)}}
    decodes = [{"t": 11.0, "wall_s": 0.04, "rows": 4,
                "positions": [1000, 500], "profiled": True},
               {"t": 11.1, "wall_s": 0.06, "rows": 4,
                "positions": [1001, 501], "profiled": False}]
    cell = types.SimpleNamespace(reps=[types.SimpleNamespace(
        decodes=decodes)])
    return {"t_open": 10.0, "end": 12.0, "seconds": 2.0, "setup_s": 3.5,
            "events": [ev], "counters": [{"cold": 2, "warm": 1,
                                          "restore": 1}],
            "unplugs": [[{"t": 11.3, "wall_s": 0.005,
                          "reclaimed_bytes": 2 * ROW},
                         {"t": 13.0, "wall_s": 9.0,
                          "reclaimed_bytes": ROW}]],
            "runner": types.SimpleNamespace(recs=recs), "trace": trace,
            "model": MODEL, "row_bytes": ROW, "cell": cell}


def close(a, b):
    return math.isclose(a, b, rel_tol=1e-9)


def test_end_to_end():
    run = synthetic()
    # ttft: 0.6, 0.8, and c still waiting at the close: 0.5
    assert sorted(e2e.ttft_ms(run)) == pytest.approx([500.0, 600.0, 800.0])
    # gaps 100, 200; b's open gap at the close: 1000
    assert sorted(e2e.itl_ms(run)) == pytest.approx([100.0, 200.0, 1000.0])
    assert e2e.tokens_in_window(run) == 4
    assert close(e2e.read(run, "tokens_per_s"), 2.0)
    assert close(e2e.reclaim_ms_per_gib(run), 5.0 / (2 * ROW / GIB))
    assert e2e.read(run, "setup_s") == 3.5
    assert close(e2e.read(run, "itl_p99_ms"),
                 float(np.percentile([100.0, 200.0, 1000.0], 99)))
    assert close(e2e.read(run, "ttft_p95_ms"),
                 float(np.percentile([500.0, 600.0, 800.0], 95)))
    with pytest.raises(KeyError):
        e2e.read(run, "no_such_metric")


EXPECT = {
    "arena.reclaim_ms_per_gib": 5.0 / (2 * ROW / GIB),
    "engine.cold_start_pct": 50.0,
    "model.prefill_ms_per_ktok": 400.0 / 1.5,
    "arena.plug_ms_mean": 2.0,
    "arena.unplug_ms_mean": 4.0,
    "snapshot.restore_ms_per_gib": 20.0 / (ROW / GIB),
    "snapshot.capture_ms_per_gib": 60.0 / (2 * ROW / GIB),
    "model.decode_step_ms.burst": 50.0,
    "model.decode_step_ms.sat": 50.0,
    "snapshot_restore_roofline":
        100 * 2 * 2 * ROW / costs.HBM_BW / 0.2e-3,
    "partition_attention_roofline":
        100 * 28 * costs.partition_attention_bytes(MODEL, [1000, 500], 4)
        / costs.HBM_BW / (56 * 0.02e-3),
    "step.prefill_mfu":
        100 * (costs.prefill_flops(MODEL, 1000)
               + costs.prefill_flops(MODEL, 500)) / (0.4 * costs.PEAK_BF16),
    "step.decode_mfu":
        100 * (costs.decode_flops(MODEL, [1000, 500])
               + costs.decode_flops(MODEL, [1001, 501]))
        / (0.1 * costs.PEAK_BF16),
    "device.idle_pct": 75.0,
}


def reader_answers() -> dict:
    """Every reader's answer on a synthetic run: ``EXPECT`` here and that of
    each test module beside this one that has one (a reader added later
    keeps its answer, and the tests of it, in a file of its own)."""
    answers = dict(EXPECT)
    for path in sorted(Path(__file__).parent.glob("test_sqb_*.py")):
        mod = importlib.import_module(f"squeeze_bench.tests.{path.stem}")
        answers.update(getattr(mod, "EXPECT", {}))
    return answers


def test_every_benchmark_metric_has_a_reader():
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    assert {m["name"] for m in bench["per_layer"]} <= set(reader_answers())


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader(name):
    assert close(load_reader(name)(synthetic()), EXPECT[name])


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader_finds_nothing(name):
    run = synthetic()
    run["events"] = [[]]
    run["unplugs"] = [[]]
    run["runner"].recs = []
    run["trace"] = None
    run["counters"] = [{"cold": 0, "warm": 0, "restore": 0}]
    run["cell"].reps[0].decodes = []
    assert load_reader(name)(run) is None


def test_costs():
    # qwen2-7b: 6.53e9 weights a token multiplies through in its layers
    assert costs.matmul_params(MODEL) == 28 * (
        3584 * 3584 * 2 + 3584 * 512 * 2 + 3 * 3584 * 18944)
    assert costs.prefill_flops(MODEL, 1) == 2 * costs.matmul_params(MODEL) \
        + costs.attn_flops(MODEL, 1) + 2 * costs.head_params(MODEL)
    assert costs.partition_attention_bytes(MODEL, [0], 1) \
        == 4 * 128 * 2 * 2 + 2 * 28 * 128 * 2 + 4


def test_trace_reduction():
    from squeeze_bench.trace import DeviceTrace, short_name
    assert short_name("void (anonymous namespace)::snapshot_kernel<uint4, "
                      "false>(Leaves, uint4*, int const*, long long)") \
        == "(anonymous namespace)::snapshot_kernel<uint4, false>"
    tr = DeviceTrace(clock=lambda: 0.0)
    tr.t0, tr.t1 = 10.0, 20.0
    evs = [("void k<1>(int)", 11.0, 12.0), ("void k<1>(int)", 11.5, 13.0),
           ("Memcpy HtoD ", 15.0, 16.0)]
    tr.device_events = lambda: evs
    out = tr.reduce([(10.5, 14.0, "tick: decode")])
    assert out["window_s"] == 10.0 and close(out["busy_s"], 3.0)
    assert out["kernels"]["k<1>"] == (2, 2.5)
    # gaps 10-11 and 13-15 fall in the tick by their midpoints, 16-20 after
    assert dict(out["idle_gaps"]) == pytest.approx(
        {"tick: decode": 3.0, "harness: between ticks": 4.0})
