"""Nothing the benchmark runs imports JAX or the JAX package ``repro``
(top-level module names compared whole: ``repro_torch`` is the port), and
the command refuses to run where it cannot measure."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(BENCH)) for p in BENCH.rglob("*.py")))
def test_no_source_imports_jax_or_the_jax_package(path):
    names = {n.split(".")[0] for n in _imports(BENCH / path)}
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for p in (BENCH / "reference").rglob("*.py"):
        names = {n.split(".")[0] for n in _imports(p)}
        assert names <= {"torch", "contextlib", "__future__", "math"}, names


def test_a_run_loads_no_jax():
    """A whole small run on the CPU in a fresh process, then its modules."""
    code = (
        "import sys, time, json\n"
        "from squeeze_bench.tests import small\n"
        "from squeeze_bench import harness, e2e, check\n"
        "import torch; torch.set_num_threads(1)\n"
        "run = harness.execute(small.config(), small.mix('burst_snapshot'),"
        " seed=2, seconds=0.8, traced=False, device='cpu',"
        " t_process=time.perf_counter())\n"
        "e2e.read(run, 'itl_p99_ms')\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    mods = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in mods and not mods & FORBIDDEN


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "squeeze_bench/run.py", "--workload",
         "qwen2-7b.saturated", "--seed", "1", "--seconds", "1", "--trace",
         "0", *extra], cwd=cwd, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})


def test_refuses_a_checkout_of_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "squeeze_bench")
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is here; the run would measure")
    p = _run(ROOT)
    assert p.returncode == 3 and p.stdout.strip() == ""
