"""The port's cluster layer (``repro_torch.cluster``) against the JAX
package's on the CPU: the scenario bank row for row and through the
committed ``--check`` gate, the stub-replica ``ClusterSim`` schedule, the
two-replica steal of ``tests/test_cluster.py`` through both packages under
one deterministic clock, the engine twins of ``tests/test_cluster.py``
with the port's ``ServeEngine`` (reduced qwen2-7b, the kernels' plain
versions), and the survivors of a steal, hotmem and vanilla, bit for bit.

Timing: the engines' virtual clocks are built from ``time.perf_counter``;
where a test compares schedules, ``_FakeClock`` (each reading advances
1e-4 s) stands in for ``time`` in the engine, elastic, hotmem and vanilla
modules of the package under test, as the JAX tests do."""
import dataclasses
import json
import os
import sys
from collections import deque
from pathlib import Path

import jax
import pytest
import torch

import repro.cluster as jax_cluster
import repro.cluster.scenarios as jax_scenarios
import repro.core.elastic as jax_elastic_mod
import repro.core.hotmem as jax_hotmem_mod
import repro.core.vanilla as jax_vanilla_mod
import repro.serving.engine as jax_engine_mod
import repro.serving.request as jax_request
import repro.serving.tracegen as jax_tracegen
import repro_torch.core.elastic as elastic_mod
import repro_torch.core.hotmem as hotmem_mod
import repro_torch.core.vanilla as vanilla_mod
import repro_torch.serving.engine as engine_mod
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.core.arena import ArenaSpec as JaxArenaSpec
from repro.models import model as JM
from repro_torch.cluster import ClusterSim, HostMemoryBroker, Router
from repro_torch.cluster import scenarios
from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import tree_from_numpy
from repro_torch.core.arena import ArenaSpec
from repro_torch.core.elastic import gather_blocks
from repro_torch.models import model as M
from repro_torch.models.layers import tree_leaves
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.request import (PROFILES, FunctionProfile, Request,
                                         State)
from repro_torch.serving.tracegen import assign_profiles, bursty_trace

from conftest import StubReplica, fake_clock

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import run as bench_run  # noqa: E402

torch.set_num_threads(1)

TORCH_MODULES = (engine_mod, elastic_mod, hotmem_mod, vanilla_mod)
JAX_MODULES = (jax_engine_mod, jax_elastic_mod, jax_hotmem_mod,
               jax_vanilla_mod)


class _FakeClock:
    """Deterministic stand-in for ``time`` (``tests/test_cluster.py``'s):
    each perf_counter() call advances a fixed step."""

    def __init__(self, step=1e-4):
        self._t = 0.0
        self._step = step

    def perf_counter(self):
        self._t += self._step
        return self._t


def _fake_time(monkeypatch, modules=TORCH_MODULES):
    clock = _FakeClock()
    for mod in modules:
        monkeypatch.setattr(mod, "time", clock)
    return clock


# ------------------------------------------------------- scenario bank


@pytest.fixture(scope="module")
def banks():
    return jax_scenarios.run_bank(), scenarios.run_bank()


@pytest.mark.parametrize("name", sorted(jax_scenarios.SCENARIOS))
def test_scenario_row_matches_jax(banks, name):
    """Every scenario's row from the port's bank equals the JAX bank's
    (the ``ModelReplica`` twin's costs are constants, so rows are
    bit-deterministic)."""
    want, got = banks
    assert set(got) == set(want) == set(scenarios.SCENARIOS)
    assert list(got[name]) == list(scenarios.ROW_SCHEMA)
    assert got[name] == want[name]


def test_bank_passes_the_committed_baseline_gate(banks):
    """``benchmarks/run.py --scenarios --check`` applied to the port's
    bank: every committed scenario (BENCH_6-9) is present and no time
    field exceeds 1.2x its baseline."""
    _want, rows = banks
    args = type("Args", (), {"baseline": bench_run.DEFAULT_BASELINE})()
    files = bench_run._baseline_files(args)
    assert [os.path.basename(f) for f in files] == [
        "BENCH_6.json", "BENCH_7.json", "BENCH_8.json", "BENCH_9.json"]
    base = {}
    for path in files:
        with open(path) as f:
            part = json.load(f)
        assert not set(base) & set(part)
        base.update(part)
    assert scenarios.TIME_FIELDS == jax_scenarios.TIME_FIELDS
    failures = []
    for name, old in sorted(base.items()):
        assert name in rows, f"{name} missing from the port's bank"
        news = bench_run._time_values(rows[name])
        for field, ov in bench_run._time_values(old).items():
            nv = news.get(field)
            if nv is None or (ov > 0
                              and nv > ov * bench_run.REGRESSION_SLACK):
                failures.append((name, field, ov, nv))
    assert len(base) == 14 and failures == []


# ----------------------------------------- stub-replica ClusterSim replay


class _TorchStub(StubReplica):
    """``tests/conftest.py``'s stub replica, marking requests with the
    port's ``State`` so that the port's sim counts them."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._State = State


def _stub_overlap_schedule(pkg):
    """``tests/test_async_broker.py::
    test_decode_overlaps_order_drain_on_fake_clock`` through one package's
    broker and sim; returns the stubs' events, the metrics and the grant."""
    if pkg == "jax":
        broker_cls, sim_cls, router_cls = (jax_cluster.HostMemoryBroker,
                                           jax_cluster.ClusterSim,
                                           jax_cluster.Router)
        stub, req_cls, profiles = (StubReplica, jax_request.Request,
                                   jax_request.PROFILES)
    else:
        broker_cls, sim_cls, router_cls = HostMemoryBroker, ClusterSim, \
            Router
        stub, req_cls, profiles = _TorchStub, Request, PROFILES
    broker = broker_cls(16, async_reclaim=True, clock=fake_clock())
    a = stub("a", broker, units=4, decode_steps=10)
    b = stub("b", broker, units=12)
    g = a.request(8)
    assert g.granted == 0 and g.pending == 8
    broker.check_invariants()
    req = req_cls(rid="r0", profile=profiles["cnn"], submit_s=0.0)
    m = sim_cls({"a": a, "b": b}, router_cls(route_fn=lambda r, e: "a"),
                broker).run([req], max_virtual_s=100)
    broker.check_invariants()
    m.pop("per_replica")
    return {"a": a.events, "b": b.events}, m, g, (a, b)


def test_stub_overlap_schedule_replays_the_jax_schedule():
    ev_j, m_j, _g, _ = _stub_overlap_schedule("jax")
    ev_t, m_t, g, (a, b) = _stub_overlap_schedule("torch")
    assert ev_t == ev_j
    assert m_t == m_j
    # the source test's assertions, on the port's run
    assert m_t["completed"] == 1
    assert g.done and g.claimed == 8
    assert a.units == 4 + 8 and b.units == 4
    decodes = [e for e in a.events if e[1] == "decode"]
    drains = [e for e in b.events if e[1] == "drain"]
    assert len(decodes) == 10 and len(drains) == 8
    assert [e for e in decodes if e[2] > 0]
    assert len([e for e in a.events if e[1] == "fill"]) >= 2
    assert decodes[0][0] == pytest.approx(1.0)
    assert drains[0][0] == pytest.approx(0.25)


# ------------------------------------------------ engine integration


@pytest.fixture(scope="module")
def setup():
    """Reduced qwen2-7b: the JAX parameters from ``PRNGKey(0)`` and the
    same weights moved into the port."""
    jcfg = jax_reduced(jax_get_config("qwen2-7b"))
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = reduced(get_config("qwen2-7b"))
    params = tree_from_numpy(jax.device_get(jparams), "cpu")
    spec = ArenaSpec.from_model(cfg, partition_tokens=128, n_partitions=8,
                                block_tokens=32)
    jspec = JaxArenaSpec.from_model(jcfg, partition_tokens=128,
                                    n_partitions=8, block_tokens=32)
    assert dataclasses.astuple(jspec) == dataclasses.astuple(spec)
    return cfg, params, spec, (jcfg, jparams, jspec)


def _cluster_reqs(req_cls=Request, profiles=PROFILES,
                  assign=assign_profiles, trace=bursty_trace):
    quiet = trace(6.0, 0.9, burst_x=1.0, burst_len=0.0, seed=2)
    burst = [4.0 + t for t in trace(4.0, 3.0, burst_x=3.0, burst_at=(0.0,),
                                    burst_len=2.0, seed=3)]
    reqs = [req_cls(rid=f"b{i}", profile=p, submit_s=t)
            for i, (t, p) in enumerate(assign(quiet, profiles, 2))]
    reqs += [req_cls(rid=f"a{i}", profile=p, submit_s=t)
             for i, (t, p) in enumerate(assign(burst, profiles, 3))]
    return reqs


def _pinned():
    return lambda r, e: "B" if r.rid.startswith("b") else "A"


@pytest.mark.parametrize("mode", ["hotmem", "vanilla"])
def test_cluster_steal_end_to_end(setup, mode):
    """Two replicas, shared budget below 2 full arenas: replica A's burst
    forces the broker to steal replica B's quiet-tail memory."""
    cfg, params, spec, _ = setup
    bpp = spec.blocks_per_partition
    broker = HostMemoryBroker(budget_units=10 * bpp)
    engines = {rid: ServeEngine(cfg, params, spec, mode=mode,
                                keep_alive=3.0, seed=i, broker=broker,
                                replica_id=rid)
               for i, rid in enumerate(("A", "B"))}
    broker.check_invariants()
    reqs = _cluster_reqs()
    sim = ClusterSim(engines, Router(route_fn=_pinned()), broker)
    m = sim.run(reqs, max_virtual_s=2000)
    broker.check_invariants()
    for e in engines.values():
        e.arena.manager.check_invariants()
    assert m["completed"] == len(reqs)
    assert m["killed"] == 0
    rep = m["broker"]
    assert rep["steals"] > 0
    if mode == "hotmem":
        assert rep["by_mode"][mode]["migrated_bytes"] == 0
    else:
        assert rep["by_mode"][mode]["migrated_bytes"] > 0


def test_router_spreads_shared_trace(setup):
    """Least-loaded routing over a shared trace uses both replicas."""
    cfg, params, spec, _ = setup
    bpp = spec.blocks_per_partition
    broker = HostMemoryBroker(budget_units=16 * bpp)
    engines = {rid: ServeEngine(cfg, params, spec, mode="hotmem",
                                keep_alive=2.0, seed=i, broker=broker,
                                replica_id=rid)
               for i, rid in enumerate(("A", "B"))}
    reqs = _cluster_reqs()
    m = ClusterSim(engines, Router("least_loaded"), broker).run(
        reqs, max_virtual_s=2000)
    assert m["completed"] == len(reqs)
    assert set(m["routed"]) == {"A", "B"}
    assert min(m["routed"].values()) > 0


def test_hotmem_steal_evicts_warm_suffix(setup):
    """A hotmem victim extends the free *suffix* by recycling the warm
    containers on its high rows and stops at an active row."""
    cfg, params, spec, _ = setup
    eng = ServeEngine(cfg, params, spec, mode="hotmem", keep_alive=100.0,
                      seed=0, prewarm=False)
    mgr = eng.arena.manager
    mgr.plug(2)                                  # ladder start 2 -> 4 rows
    for i in range(4):
        assert eng.arena.admit(f"r{i}") == i
    eng.arena.finish("r0")                       # free = {0}: low row only
    eng.warm["cnn"] = [(0.0, "r1", 1), (0.0, "r2", 2), (0.0, "r3", 3)]
    bpp = spec.blocks_per_partition
    got, ev = eng.reclaim_for_broker(2 * bpp)
    assert got == 2 * bpp
    assert ev.migrated_bytes == 0
    assert mgr.plugged == 2
    assert [row for (_, _, row) in eng.warm["cnn"]] == [1]
    mgr.check_invariants()


def _single_replica_run(setup, monkeypatch, broker):
    cfg, params, spec, _ = setup
    _fake_time(monkeypatch)
    arr = bursty_trace(8.0, 0.8, burst_x=5.0, burst_at=(0.0,),
                       burst_len=2.0, quiet_after=4.0, seed=11)
    reqs = [Request(rid=f"s{i}", profile=p, submit_s=t)
            for i, (t, p) in enumerate(assign_profiles(arr, PROFILES, 11))]
    eng = ServeEngine(cfg, params, spec, mode="hotmem", keep_alive=2.0,
                      seed=0, broker=broker)
    return eng, eng.run(reqs, max_virtual_s=2000)


def test_single_replica_regression(setup, monkeypatch):
    """Identical metrics with the default (unmetered) broker and with an
    uncontended ``HostMemoryBroker``, under the deterministic clock."""
    spec = setup[2]
    _, base = _single_replica_run(setup, monkeypatch, None)
    solo = HostMemoryBroker(
        budget_units=spec.n_partitions * spec.blocks_per_partition)
    _, m = _single_replica_run(setup, monkeypatch, solo)
    for key in ("completed", "killed", "reclaim_events", "reclaimed_bytes",
                "migrated_bytes", "decode_steps", "latency_p50",
                "latency_p99"):
        assert m[key] == base[key], key
    assert not solo.steal_log
    solo.check_invariants()


def test_single_replica_stepevent_trace_bit_identical(setup, monkeypatch):
    """The full ``StepEvent`` trace is bit-identical on
    ``AlwaysGrantBroker``, an uncontended sync ``HostMemoryBroker`` and an
    uncontended async one."""
    spec = setup[2]
    budget = spec.n_partitions * spec.blocks_per_partition

    def trace(broker):
        eng, _ = _single_replica_run(setup, monkeypatch, broker)
        return [(e.t, e.kind, e.wall_s, e.detail) for e in eng.events]

    base = trace(None)
    assert trace(HostMemoryBroker(budget_units=budget)) == base
    assert trace(HostMemoryBroker(budget_units=budget,
                                  async_reclaim=True)) == base
    assert not any(kind == "stall" for _, kind, _, _ in base)


@pytest.mark.parametrize("mode", ["hotmem", "vanilla"])
def test_async_cluster_end_to_end(setup, mode):
    """Two real replicas on an async broker: the trace completes, the
    requester never blocks on a victim reclaim, the victim drains orders
    between its ticks, and the requester decodes while orders are open."""
    cfg, params, spec, _ = setup
    bpp = spec.blocks_per_partition
    broker = HostMemoryBroker(budget_units=10 * bpp, async_reclaim=True)
    engines = {rid: ServeEngine(cfg, params, spec, mode=mode,
                                keep_alive=3.0, seed=i, broker=broker,
                                replica_id=rid)
               for i, rid in enumerate(("A", "B"))}

    def a_decodes():
        return sum(1 for e in engines["A"].events if e.kind == "decode")

    issue_counts, fill_counts = [], []
    orig_issue = broker._issue_orders
    orig_fill = broker._apply_fill

    def spy_issue(requester, deficit, grant):
        issue_counts.append(a_decodes())
        return orig_issue(requester, deficit, grant)

    def spy_fill(o, k, **kw):
        fill_counts.append(a_decodes())
        return orig_fill(o, k, **kw)

    broker._issue_orders = spy_issue
    broker._apply_fill = spy_fill
    reqs = _cluster_reqs()
    m = ClusterSim(engines, Router(route_fn=_pinned()), broker).run(
        reqs, max_virtual_s=2000)
    broker.check_invariants()
    for e in engines.values():
        e.arena.manager.check_invariants()
    assert m["completed"] == len(reqs)
    assert m["killed"] == 0
    rep = m["broker"]
    assert rep["steals"] > 0
    assert rep["pending_units"] == 0
    assert all(s == 0.0 for s in broker.request_stalls)
    assert issue_counts and fill_counts
    assert max(fill_counts) > min(issue_counts)
    if mode == "hotmem":
        assert rep["by_mode"][mode]["migrated_bytes"] == 0
    else:
        assert rep["by_mode"][mode]["migrated_bytes"] > 0


# ------------------------------------------- cross-package steal parity


def _pinned_steal(setup, monkeypatch, pkg, mode, async_reclaim):
    """The two-replica pinned steal of ``tests/test_cluster.py`` through
    one package under the deterministic clock."""
    cfg, params, spec, (jcfg, jparams, jspec) = setup
    if pkg == "jax":
        _fake_time(monkeypatch, JAX_MODULES)
        broker_cls, engine_cls = (jax_cluster.HostMemoryBroker,
                                  jax_engine_mod.ServeEngine)
        sim_cls, router_cls = jax_cluster.ClusterSim, jax_cluster.Router
        cfg, params, spec = jcfg, jparams, jspec
        reqs = _cluster_reqs(jax_request.Request, jax_request.PROFILES,
                             jax_tracegen.assign_profiles,
                             jax_tracegen.bursty_trace)
    else:
        _fake_time(monkeypatch)
        broker_cls, engine_cls = HostMemoryBroker, ServeEngine
        sim_cls, router_cls = ClusterSim, Router
        reqs = _cluster_reqs()
    bpp = spec.blocks_per_partition
    broker = broker_cls(budget_units=10 * bpp, async_reclaim=async_reclaim)
    engines = {rid: engine_cls(cfg, params, spec, mode=mode, keep_alive=3.0,
                               seed=i, broker=broker, replica_id=rid)
               for i, rid in enumerate(("A", "B"))}
    m = sim_cls(engines, router_cls(route_fn=_pinned()), broker).run(
        reqs, max_virtual_s=2000)
    broker.check_invariants()
    return {
        "steals": [(r.requester, r.victim, r.units, r.reclaimed_bytes,
                    r.migrated_bytes, r.mode) for r in broker.steal_log],
        "steal_walls": [r.wall_seconds for r in broker.steal_log],
        "completed": m["completed"], "killed": m["killed"],
        "starts": {rid: (e.cold_starts, e.warm_starts, e.restore_starts,
                         e.remote_restore_starts)
                   for rid, e in engines.items()},
        "events": {rid: [(e.t, e.kind, e.wall_s, e.detail)
                         for e in eng.events]
                   for rid, eng in engines.items()}}


@pytest.mark.parametrize("async_reclaim", [False, True],
                         ids=["sync", "async"])
@pytest.mark.parametrize("mode", ["hotmem", "vanilla"])
def test_steal_schedule_matches_jax(setup, monkeypatch, mode,
                                    async_reclaim):
    """The same pinned two-replica trace through ``repro`` and
    ``repro_torch`` under one deterministic clock: the steal log, the
    outcomes, the start paths and every ``StepEvent`` agree exactly (the
    two engines read the clock at the same points)."""
    want = _pinned_steal(setup, monkeypatch, "jax", mode, async_reclaim)
    got = _pinned_steal(setup, monkeypatch, "torch", mode, async_reclaim)
    assert got["steals"] == want["steals"] and len(got["steals"]) > 0
    assert got["steal_walls"] == want["steal_walls"]
    assert (got["completed"], got["killed"]) \
        == (want["completed"], want["killed"]) == (38, 0)
    assert got["starts"] == want["starts"]
    assert got["events"] == want["events"]


# ------------------------------------------- survivors of a steal


def _drive(eng, reqs):
    for r in reqs:
        eng.submit(r)
    empty = deque()
    while eng.active or eng.pending:
        eng._tick(empty)


def _long(tokens, decode):
    return FunctionProfile("long", prompt_tokens=tokens,
                           decode_tokens=decode, max_tokens=128)


def test_hotmem_steal_leaves_survivors_untouched(setup):
    """A full hotmem victim (one long request active on row 0, seven warm
    containers above it) gives up six partitions: the warm suffix goes,
    the kept rows keep every cache byte, the dropped rows' storage is
    released (new, smaller tensors) and no byte migrates."""
    cfg, params, spec, _ = setup
    bpp = spec.blocks_per_partition
    broker = HostMemoryBroker(budget_units=10 * bpp)
    eng = ServeEngine(cfg, params, spec, mode="hotmem", keep_alive=1000.0,
                      broker=broker, replica_id="B")
    eng.submit(Request(rid="L", profile=_long(64, 60), submit_s=0.0))
    eng._tick(deque())
    assert eng._row_req[0].rid == "L"
    empty = deque()
    for i in range(7):
        eng.submit(Request(rid=f"s{i}", profile=PROFILES["cnn"],
                           submit_s=eng.now))
    while len(eng.active) > 1 or eng.pending:
        eng._tick(empty)
    assert eng._rows() == 8 and list(eng.active) == ["L"]
    leaves, axes, _ = M.cache_flat_axes(eng.caches)
    leaves = [x.clone() for x in leaves]
    old_ptrs = {x.untyped_storage().data_ptr()
                for x in tree_leaves(eng.caches)}
    got, ev = eng.reclaim_for_broker(6 * bpp)
    assert got == 6 * bpp and ev.migrated_bytes == 0
    assert ev.reclaimed_bytes == 6 * spec.bytes_per_partition
    assert eng._rows() == 2
    for x, y, ax in zip(M.cache_flat_axes(eng.caches)[0], leaves, axes):
        assert x.untyped_storage().data_ptr() not in old_ptrs
        assert x.shape[ax] == 2
        assert torch.equal(x.view(torch.int16),
                           y.narrow(ax, 0, 2).view(torch.int16))
    assert sorted(r for es in eng.warm.values() for _, _, r in es) == [1]
    while eng.active:
        eng._tick(empty)
    assert eng.metrics()["completed"] == 8
    eng.arena.manager.check_invariants()


def test_vanilla_steal_leaves_survivors_untouched(setup):
    """A full vanilla victim (seven warm containers grew the pool, then a
    long request took blocks all over it) gives up six partitions' blocks:
    the steal migrates, and every surviving request's K/V read through its
    new block table equals its K/V read through the old one before."""
    cfg, params, spec, _ = setup
    bpp = spec.blocks_per_partition
    broker = HostMemoryBroker(budget_units=10 * bpp)
    eng = ServeEngine(cfg, params, spec, mode="vanilla", keep_alive=1000.0,
                      seed=1, broker=broker, replica_id="B")
    mgr = eng.arena.manager
    _drive(eng, [Request(rid=f"s{i}", profile=PROFILES["html"],
                         submit_s=0.0) for i in range(7)])
    assert eng._units() == 8
    eng.submit(Request(rid="L", profile=_long(64, 60), submit_s=eng.now))
    eng._tick(deque())
    assert list(eng.active) == ["L"]
    gen = torch.Generator().manual_seed(0)
    for x in eng.pool:
        x.copy_(torch.randn(x.shape, generator=gen))
    tables = {rid: list(mgr.block_table(rid)) for rid in mgr._tables}
    before = {rid: gather_blocks(eng.pool, torch.tensor([t]))
              for rid, t in tables.items()}
    got, ev = eng.reclaim_for_broker(6 * bpp)
    assert got == 6 * bpp and ev.migrated_blocks > 0
    assert ev.migrated_bytes == ev.migrated_blocks * spec.bytes_per_block
    assert mgr.pool_blocks == 2 * bpp
    assert "L" in mgr._tables
    assert any(tables[rid] != mgr.block_table(rid) for rid in mgr._tables)
    for rid in mgr._tables:
        new = gather_blocks(eng.pool, torch.tensor([mgr.block_table(rid)]))
        for x, y in zip(new, before[rid]):
            assert torch.equal(x.view(torch.int16), y.view(torch.int16))
    while eng.active:
        eng._tick(deque())
    assert eng.metrics()["completed"] == 8 and eng.metrics()["killed"] == 0
    mgr.check_invariants()
    broker.check_invariants()
