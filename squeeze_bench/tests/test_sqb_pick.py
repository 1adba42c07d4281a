"""A configuration names the plain reference that judges it: the bare name
of a module under ``reference/`` in its ``"reference"`` key, ``decoder``
where it names none.  ``run.py`` refuses, before set-up and before its
look for a card, a configuration whose reference is unknown or does not
cover its ``model``, or whose file leaves out, or states wrongly, a limit
of a number its reference asks for; a module added beside ``decoder``
judges the configurations that name it."""
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from squeeze_bench import check
from squeeze_bench.reference import decoder

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
QWEN = BENCH / "configs" / "qwen2-7b.json"
MIXTRAL = BENCH / "configs" / "mixtral-8x7b-16l.json"


def _config(**changes) -> dict:
    c = json.loads(QWEN.read_text())
    c.update(changes)
    return c


def _mixtral(*drop, **changes) -> dict:
    c = json.loads(MIXTRAL.read_text())
    for k in drop:
        del c[k]
    c.update(changes)
    return c


@pytest.mark.parametrize("changes", [{}, {"reference": "decoder"}])
def test_the_default_is_the_dense_reference(changes):
    assert check.reference(_config(**changes)) is decoder


@pytest.mark.parametrize("name,reason", [
    ("moe_nowhere", "no reference module"),
    ("decoder.kv_cache", "not the bare name"),
    ("reference.decoder", "not the bare name"),
    ("../reference/decoder", "not the bare name"),
    ("reference/decoder", "not the bare name"),
    ("decoder.py", "not the bare name"),
    ("", "not the bare name"),
    (3, "not the bare name"),
    ("__init__", "lacks covers, kv_cache"),
])
def test_a_name_that_picks_no_reference_is_refused(name, reason):
    with pytest.raises(ValueError, match=reason):
        check.reference(_config(reference=name))


def test_a_model_the_reference_does_not_cover_is_refused():
    c = _config()
    c["model"]["num_experts"] = 8
    with pytest.raises(ValueError, match="does not cover.*dense block"):
        check.reference(c)


@pytest.mark.parametrize("config,reason", [
    (_mixtral("limits"), "reference 'moe' asks for expert_kv_err, whose "
     "limit the configuration does not state under limits"),
    (_mixtral(limits={}), "asks for expert_kv_err"),
    (_mixtral(limits={"expert_kv_err": 0}), "not a positive number"),
    (_mixtral(limits={"expert_kv_err": -0.004}), "not a positive number"),
    (_mixtral(limits={"expert_kv_err": "0.004"}), "not a positive number"),
    (_mixtral(limits={"expert_kv_err": True}), "not a positive number"),
    (_mixtral(limits={"expert_kv_err": float("nan")}),
     "not a positive number"),
    (_mixtral(limits={"expert_kv_err": float("inf")}),
     "not a positive number"),
    (_mixtral(limits=[0.004]), "not an object"),
    (_mixtral(limits={"expert_kv_err": 0.004, "kv_err": 0.05}),
     "limits states kv_err, which reference 'moe' asks for no number of"),
    (_mixtral("limits_set_from"), "limits_set_from does not say"),
    (_mixtral(limits_set_from=" "), "limits_set_from does not say"),
    (_config(limits={"kv_head_err": 0.5}, limits_set_from="a guess"),
     "limits states kv_head_err, which reference 'decoder' asks for no"),
    (_config(limits={"expert_kv_err": 0.004}, limits_set_from="a guess"),
     "limits states expert_kv_err, which reference 'decoder' asks for no"),
])
def test_a_limit_the_file_leaves_out_or_states_wrongly_is_refused(
        config, reason):
    """A configuration states the limit of each number its reference asks
    for, a positive number, and the readings it was set from; it states
    no other, so no file loosens a shared limit."""
    with pytest.raises(ValueError, match=reason):
        check.reference(config)


def _tree(tmp_path: Path, config: dict, reference: str = "") -> Path:
    """A checkout of the benchmark at ``tmp_path`` whose ``qwen2-7b``
    configuration is ``config`` (the port linked in from this one), with
    ``reference/spy.py`` written there when ``reference`` is given."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "squeeze_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "src").symlink_to(ROOT / "src")
    (tmp_path / "squeeze_bench" / "configs" / "qwen2-7b.json").write_text(
        json.dumps(config))
    if reference:
        (tmp_path / "squeeze_bench" / "reference" / "spy.py").write_text(
            textwrap.dedent(reference))
    return tmp_path


def _run(cwd: Path):
    return subprocess.run(
        [sys.executable, "squeeze_bench/run.py", "--workload",
         "qwen2-7b.saturated", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=cwd, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})


EXPERTS = dict(json.loads(QWEN.read_text())["model"], num_experts=8,
               num_experts_per_tok=2)


@pytest.mark.parametrize("config,reason", [
    (_config(model=EXPERTS), "does not cover this configuration's model: "
     "this reference is the dense block"),
    # a name that picks no module (the id is the one the case had when no
    # module answered to "moe")
    pytest.param(_config(reference="moe_nowhere"),
                 "no reference module 'moe_nowhere'",
                 id="config1-no reference module 'moe'"),
    (_config(reference="reference/moe"), "not the bare name"),
    pytest.param(_config(reference="moe"), "reference 'moe' does not cover "
                 "this configuration's model: this reference is the "
                 "sparse-expert block", id="moe refuses a dense model"),
    pytest.param(_mixtral("limits"), "reference 'moe' asks for "
                 "expert_kv_err, whose limit the configuration does not "
                 "state under limits",
                 id="moe without its expert_kv_err limit"),
    pytest.param(_config(limits={"kv_err": 0.05}, limits_set_from="a guess"),
                 "limits states kv_err, which reference 'decoder' asks for "
                 "no number of",
                 id="a dense file that loosens a shared limit"),
])
def test_run_refuses_before_it_looks_for_a_card(tmp_path, config, reason):
    """Exit 2 with one line on standard error and nothing on standard
    output, where a machine without a card would otherwise exit 3 (and one
    with a card would draw the weights and run the window)."""
    p = _run(_tree(tmp_path, config))
    assert p.returncode == 2, p.stderr[-2000:]
    assert p.stdout == ""
    lines = p.stderr.strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith("qwen2-7b.saturated: ")
    assert reason in lines[0]


SPY = """\
    from .decoder import kv_cache as dense

    CALLS = []


    def covers(model):
        pass


    def kv_cache(model, params, tokens, dtype=None):
        CALLS.append(int(tokens.shape[0]))
        k, v = dense(model, params, tokens, dtype=dtype)
        return 2 * k, v
    """

JUDGE = """\
import json, sys, time
sys.path[:0] = [sys.argv[1] + "/src", sys.argv[1]]
import torch
torch.set_num_threads(1)
from squeeze_bench import check, harness
from squeeze_bench.tests import small
cfg = small.config()
cfg["reference"] = sys.argv[2]
ref = check.reference(cfg)
run = harness.execute(cfg, small.mix("saturated"), seed=3, seconds=1.6,
                      traced=False, device="cpu",
                      t_process=time.perf_counter())
items = check.collect(run)
params = run["cell"].params
n = check.judge(run, items, lambda tok: ref.kv_cache(
    cfg["model"], params, tok, dtype=torch.bfloat16))
print(json.dumps({"module": ref.__name__, "n": n,
                  "calls": getattr(ref, "CALLS", None),
                  "functions": len({it["name"] for it in items})}))
"""


def test_a_reference_added_beside_decoder_judges_what_names_it(tmp_path):
    """A module written into a checkout's ``reference/`` (taking the dense
    block's pieces by a relative import) is the one whose ``kv_cache``
    judges a configuration that names it: its doubled keys fail a small
    sound run that ``decoder`` passes."""
    tree = _tree(tmp_path, _config(), reference=SPY)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = {}
    for name in ("spy", "decoder"):
        p = subprocess.run([sys.executable, "-c", JUDGE, str(tree), name],
                           cwd=tree, env=env, capture_output=True,
                           text=True, timeout=300)
        assert p.returncode == 0, p.stderr[-2000:]
        out[name] = json.loads(p.stdout.strip().splitlines()[-1])
    spy, dense = out["spy"], out["decoder"]
    assert spy["module"] == "squeeze_bench.reference.spy"
    assert len(spy["calls"]) == spy["functions"] >= 1
    assert dense["n"]["rows_judged"] >= 1 and spy["n"]["rows_judged"] >= 1
    assert dense["n"]["kv_head_err"] < check.LIMITS["kv_head_err"]
    assert spy["n"]["kv_head_err"] > 0.3
