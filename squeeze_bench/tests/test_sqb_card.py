"""On the card: a short run of each cell comes out correct, and the control
(the port's int8 weight path in place of bf16) comes out not correct.  Run
on the chip with ``python -m pytest -q -m card squeeze_bench/tests``."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _run(workload, seed, seconds, *extra):
    p = subprocess.run(
        [sys.executable, "squeeze_bench/run.py", "--workload", workload,
         "--seed", str(seed), "--seconds", str(seconds), "--trace", "0",
         *extra], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_short_run_is_correct(card, workload):
    out = _run(workload, 4242424242, 12)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"


@pytest.mark.card
def test_control_is_not_correct(card):
    out = _run("qwen2-7b.saturated", 4242424243, 12, "--control", "int8")
    assert not out["correct"], out["checks"]
