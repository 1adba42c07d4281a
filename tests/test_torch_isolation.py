"""Ground rules of the port, checked on its source:

  * ``repro_torch`` and ``chip_smoke.py`` import neither JAX nor anything of
    the JAX package ``repro`` (the card's machine has no JAX);
  * the plain-Python modules the port keeps as copies equal their JAX
    package sources once ``repro.`` is renamed ``repro_torch.``, and the
    functions ``launch/distributed.py`` keeps equal theirs;
  * no kernel wrapper catches an error around a launch (no quiet fallback
    from the kernel to its plain version)."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"

VERBATIM = ["configs/base.py"] + [
    f"configs/{n}.py" for n in (
        "dbrx_132b", "gemma2_9b", "mamba2_780m", "mixtral_8x7b",
        "qwen2_1_5b", "qwen2_7b", "qwen2_vl_72b", "recurrentgemma_2b",
        "seamless_m4t_medium", "tinyllama_1_1b")] + [
    "core/hotmem.py", "core/vanilla.py", "serving/request.py",
    "serving/tracegen.py",
    "cluster/topology.py", "cluster/ledger.py", "cluster/snapshots.py",
    "cluster/host.py", "cluster/router.py", "cluster/fleet.py",
    "cluster/sim.py", "cluster/scenarios.py", "cluster/__init__.py"]


def _forbidden(name: str) -> bool:
    return name in ("jax", "repro", "jaxlib") or name.startswith(
        ("jax.", "repro.", "jaxlib."))


def _imports(path: Path) -> list[str]:
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.append(node.module)
    return out


def test_importing_every_module_loads_no_jax_and_no_repro():
    modules = sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = (
        "import importlib, json, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    loaded = json.loads(res.stdout.strip().splitlines()[-1])
    assert len(modules) >= 30
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")) + ["chip_smoke.py"])
def test_no_jax_or_repro_import_in_source(path):
    assert [m for m in _imports(ROOT / path) if _forbidden(m)] == []


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copy_equals_its_source(rel):
    src = (SRC / "repro" / rel).read_text()
    assert (PORT / rel).read_text() == src.replace("repro.", "repro_torch.")


def _functions(path: Path) -> dict[str, str]:
    text = path.read_text()
    return {n.name: ast.get_source_segment(text, n)
            for n in ast.parse(text).body if isinstance(n, ast.FunctionDef)}


@pytest.mark.parametrize("name", ["run_with_restarts", "hedged_dispatch"])
def test_distributed_keeps_its_functions_verbatim(name):
    """``launch/distributed.py`` is an adapted copy: the two functions it
    keeps equal their JAX package source, and ``initialize`` (which
    imports JAX) stays out until it moves onto ``torch.distributed``."""
    rel = "launch/distributed.py"
    port = _functions(PORT / rel)
    assert set(port) == {"run_with_restarts", "hedged_dispatch"}
    assert port[name] == _functions(SRC / "repro" / rel)[name]


@pytest.mark.parametrize("rel", ["kernels/ops.py",
                                 "kernels/partition_attention.py",
                                 "kernels/paged_attention.py",
                                 "kernels/kv_snapshot.py",
                                 "kernels/kv_compact.py"])
def test_no_except_around_a_kernel_launch(rel):
    tree = ast.parse((PORT / rel).read_text())
    handlers = [n.lineno for n in ast.walk(tree)
                if isinstance(n, ast.Try) and n.handlers]
    assert handlers == [], f"{rel} catches errors at lines {handlers}"

