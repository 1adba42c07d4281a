"""The hotmem and vanilla ``ServeEngine`` of the port on reduced gemma2-9b
(local rings beside global rows, post-norms, softcaps) and mixtral-8x7b
(top-2 MoE, a sliding-window ring), against the JAX package's engine, and
the serving launcher on the three families this slice adds.

Engine schedules are compared under the fake clock of
``tests/test_torch_recurrent_serving.py`` patched into the engine,
elastic, hotmem and vanilla modules of both packages: the two engines read
the clock at the same points, so every ``StepEvent`` must agree exactly."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

import repro.serving.engine as jax_engine_mod
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.core.arena import ArenaSpec as JaxArenaSpec
from repro.models import model as JM
from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import tree_from_numpy
from repro_torch.core.arena import ArenaSpec
from repro_torch.kernels import kv_snapshot
from repro_torch.models import model as M
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.request import PROFILES, Request
from test_torch_recurrent_serving import (JAX_MODULES, TORCH_MODULES,
                                          _bytes, _expire, _fake_time,
                                          _pooled, _run_one,
                                          _snapshot_schedule, _trace)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
ENGINE_FAMILIES = ["gemma2-9b", "mixtral-8x7b"]
METRICS = ("completed", "killed", "reclaim_events", "reclaimed_bytes",
           "migrated_bytes", "decode_steps", "cold_starts", "warm_starts",
           "restore_starts", "latency_p50", "latency_p99")


@pytest.fixture(scope="module", params=ENGINE_FAMILIES)
def setup(request):
    """Reduced config, the JAX parameters from ``PRNGKey(0)`` and the
    same weights moved into the port; 8 partitions of 128 tokens."""
    jcfg = jax_reduced(jax_get_config(request.param))
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = reduced(get_config(request.param))
    params = tree_from_numpy(jax.device_get(jparams), "cpu")
    spec = ArenaSpec.from_model(cfg, partition_tokens=128, n_partitions=8,
                                block_tokens=32)
    jspec = JaxArenaSpec.from_model(jcfg, partition_tokens=128,
                                    n_partitions=8, block_tokens=32)
    assert dataclasses.astuple(jspec) == dataclasses.astuple(spec)
    return cfg, params, spec, (jcfg, jparams, jspec)


def _burst_run(setup, monkeypatch, pkg, mode):
    cfg, params, spec, (jcfg, jparams, jspec) = setup
    if pkg == "jax":
        _fake_time(monkeypatch, JAX_MODULES)
        eng = jax_engine_mod.ServeEngine(jcfg, jparams, jspec, mode=mode,
                                         keep_alive=3.0)
    else:
        _fake_time(monkeypatch, TORCH_MODULES)
        eng = ServeEngine(cfg, params, spec, mode=mode, keep_alive=3.0)
    reqs = _trace(pkg)
    m = eng.run(reqs, max_virtual_s=2000)
    eng.arena.manager.check_invariants()
    return {"n": len(reqs), "metrics": {k: m[k] for k in METRICS},
            "events": [(e.t, e.kind, e.wall_s, e.detail) for e in eng.events]}


def test_bursty_trace_matches_jax(setup, monkeypatch):
    """Up the ladder and back down: the same ``StepEvent`` sequence (kinds,
    order, times, details), start paths and reclaimed bytes as the JAX
    engine, with zero migration and nothing killed."""
    want = _burst_run(setup, monkeypatch, "jax", "hotmem")
    got = _burst_run(setup, monkeypatch, "torch", "hotmem")
    assert got["metrics"] == want["metrics"]
    assert got["metrics"]["completed"] == got["n"] == 23
    assert got["metrics"]["killed"] == got["metrics"]["migrated_bytes"] == 0
    assert got["metrics"]["reclaimed_bytes"] > 0
    assert {"plug", "unplug", "prefill", "decode"} <= \
        {e[1] for e in got["events"]}
    assert got["events"] == want["events"]


def test_vanilla_bursty_trace_matches_jax(monkeypatch):
    """The paged baseline on gemma2: only the global blocks' K/V is
    token-extensive (a full 128-slot row), so the block pool is built from
    those leaves alone and the local rings stay in the rows.  Same events
    as the JAX engine, and the pool must migrate on its way down."""
    cfg = reduced(get_config("gemma2-9b"))
    jcfg = jax_reduced(jax_get_config("gemma2-9b"))
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    setup = (cfg, tree_from_numpy(jax.device_get(jparams), "cpu"),
             ArenaSpec.from_model(cfg, 128, 8, 32),
             (jcfg, jparams, JaxArenaSpec.from_model(jcfg, 128, 8, 32)))
    want = _burst_run(setup, monkeypatch, "jax", "vanilla")
    got = _burst_run(setup, monkeypatch, "torch", "vanilla")
    assert got["metrics"] == want["metrics"]
    assert got["metrics"]["completed"] == got["n"] == 23
    assert got["metrics"]["killed"] == 0
    assert got["metrics"]["migrated_bytes"] > 0
    assert got["events"] == want["events"]
    eng = ServeEngine(cfg, setup[1], setup[2], mode="vanilla")
    assert len(eng.pool) == 2            # the global K and V leaves
    assert all(x.shape[2] == cfg.n_groups for x in eng.pool)


def _jax_view(e):
    """A port ``StepEvent`` as the JAX engine gives it: without the
    restore's ``h2d_bytes`` and ``remap``, which only the port's has."""
    return (e.t, e.kind, e.wall_s,
            {k: v for k, v in e.detail.items()
             if k not in ("h2d_bytes", "remap")})


def test_snapshot_schedule_matches_jax(setup, monkeypatch):
    """Cold, warm, capture on expiry, restore, restore: the restore path is
    taken twice, as in the JAX engine, every ``StepEvent`` agrees, and the
    captured bytes are the spec's row bytes (rings and rows alike)."""
    cfg, _params, spec, _ = setup
    want = _snapshot_schedule(setup, monkeypatch, "jax")
    got = _snapshot_schedule(setup, monkeypatch, "torch")
    starts = (got.cold_starts, got.warm_starts, got.restore_starts)
    assert starts == (want.cold_starts, want.warm_starts,
                      want.restore_starts) == (1, 1, 2)
    assert [_jax_view(e) for e in got.events] == \
        [(e.t, e.kind, e.wall_s, e.detail) for e in want.events]
    # the port's restores also give their host->device bytes: the row's
    rest = [e.detail for e in got.events if e.kind == "restore"]
    assert len(rest) == 2 and all(
        d["h2d_bytes"] == d["bytes"] and d["remap"] is False for d in rest)
    snap = [e for e in got.events if e.kind == "snapshot"]
    assert len(snap) == 1 and snap[0].detail["bytes"] == \
        kv_snapshot.expected_row_bytes(cfg, spec.partition_tokens) == \
        spec.bytes_per_partition


def test_restored_row_equals_its_captured_blob(setup):
    broker, eng = _pooled(setup, "torch")
    _run_one(eng, "c0")
    _expire(eng)
    blob = broker.snapshot_lookup("cnn").payload.blob
    eng.submit(Request(rid="s0", profile=PROFILES["cnn"], submit_s=eng.now))
    eng._try_admit()
    assert eng.restore_starts == 1
    back = M.cache_read_rows(eng.caches, [eng.active["s0"].partition])
    assert _bytes(back) == blob.tobytes()


@pytest.mark.parametrize("arch", ["gemma2-9b", "mixtral-8x7b",
                                  "qwen2-vl-72b"])
def test_serve_launcher_runs_on_cpu(arch):
    """``python -m repro_torch.launch.serve --arch ... --reduced --device
    cpu`` serves the whole bursty trace: every request completes, none is
    killed and hotmem migrates nothing."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--reduced", "--device", "cpu", "--duration", "4"],
        env=env, capture_output=True, text=True, timeout=300, check=True)
    m = json.loads(res.stdout)
    assert m["completed"] == m["submitted"] > 0
    assert m["killed"] == 0 and m["migrated_bytes"] == 0
