"""The port's fleet layer on the CPU, with the port's ``ServeEngine``
(reduced qwen2-7b, the kernels' plain versions): the twins of the engine
tests of ``tests/test_fleet.py``, ``tests/test_dedup.py`` and
``tests/test_scenarios.py``, the stub-replica ``FleetSim``/``ClusterSim``
seam against the JAX package's, and the new entry point
``repro_torch.launch.cluster_demo``."""
import contextlib
import io
import json
from collections import deque

import jax
import pytest
import torch

import repro.cluster as jax_cluster
import repro.cluster.scenarios as jax_scenarios
import repro.serving.engine as jax_engine_mod
import repro.serving.request as jax_request
import repro.serving.tracegen as jax_tracegen
from repro.cluster.topology import DeviceTopology as JaxDeviceTopology
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.core.arena import ArenaSpec as JaxArenaSpec
from repro.models import model as JM
from repro_torch.cluster import (ClusterSim, FleetScheduler, FleetSim,
                                 HostMemoryBroker, Router)
from repro_torch.cluster.scenarios import ModelReplica, _build, _row
from repro_torch.cluster.topology import DeviceTopology
from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import tree_from_numpy
from repro_torch.core.arena import ArenaSpec
from repro_torch.launch import cluster_demo
from repro_torch.models import model as M
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.request import PROFILES, Request
from repro_torch.serving.tracegen import assign_profiles, bursty_trace

from conftest import StubReplica, fake_clock
from test_torch_cluster import (JAX_MODULES, _cluster_reqs, _fake_time,
                                _TorchStub)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    cfg = reduced(get_config("qwen2-7b"))
    params = M.init_params(cfg, 0, device="cpu")
    spec = ArenaSpec.from_model(cfg, partition_tokens=128, n_partitions=8,
                                block_tokens=32)
    return cfg, params, spec


def _run_one(eng, rid, prof="cnn"):
    eng.submit(Request(rid=rid, profile=PROFILES[prof], submit_s=eng.now))
    empty = deque()
    while eng.active or eng.pending:
        eng._tick(empty)
    return next(r for r in eng.done if r.rid == rid)


def _expire(eng):
    eng.now += eng.keep_alive + 1.0
    eng._recycle_idle()


# ------------------------------------------- stub FleetSim/ClusterSim seam


def _stub_script(pkg, fleet: bool):
    """``tests/test_fleet.py::_stub_script`` through one package, as a
    ``ClusterSim`` or as a one-host ``FleetSim``."""
    c = jax_cluster if pkg == "jax" else None
    broker_cls = c.HostMemoryBroker if c else HostMemoryBroker
    stub = StubReplica if c else _TorchStub
    req_cls = jax_request.Request if c else Request
    profiles = jax_request.PROFILES if c else PROFILES
    broker = broker_cls(16, async_reclaim=True, clock=fake_clock())
    a = stub("a", broker, units=4, decode_steps=10)
    b = stub("b", broker, units=12)
    assert a.request(8).pending == 8
    reqs = [req_cls(rid="r0", profile=profiles["cnn"], submit_s=0.0),
            req_cls(rid="r1", profile=profiles["bert"], submit_s=2.0)]
    router = (c.Router if c else Router)("least_loaded")
    if fleet:
        sim = (c.FleetSim if c else FleetSim)(
            {"host0": {"a": a, "b": b}}, router, brokers={"host0": broker})
    else:
        sim = (c.ClusterSim if c else ClusterSim)({"a": a, "b": b}, router,
                                                  broker)
    m = sim.run(reqs, max_virtual_s=100)
    broker.check_invariants()
    m.pop("per_replica")
    return {"a": a.events, "b": b.events}, m


def test_fleetsim_single_host_replays_clustersim_stub_schedule():
    """The port's FleetSim with one host replays its ClusterSim, and both
    replay the JAX package's, event for event."""
    ev_c, m_c = _stub_script("torch", fleet=False)
    ev_f, m_f = _stub_script("torch", fleet=True)
    ev_j, m_j = _stub_script("jax", fleet=False)
    assert ev_c == ev_f == ev_j
    assert m_c == m_j
    m_c.pop("broker"), m_f.pop("broker")
    assert m_c == m_f


# ---------------------------------------------------- fleet engine twins


def _fleet_reqs():
    quiet = bursty_trace(6.0, 0.9, burst_x=1.0, burst_len=0.0, seed=2)
    burst = [4.0 + t for t in bursty_trace(4.0, 3.0, burst_x=3.0,
                                           burst_at=(0.0,), burst_len=2.0,
                                           seed=3)]
    reqs = [Request(rid=f"b{i}", profile=p, submit_s=t)
            for i, (t, p) in enumerate(assign_profiles(quiet, PROFILES, 2))]
    reqs += [Request(rid=f"a{i}", profile=p, submit_s=t)
             for i, (t, p) in enumerate(assign_profiles(burst, PROFILES, 3))]
    return reqs


def test_fleetsim_one_host_stepevent_trace_bit_identical(setup, monkeypatch):
    """A contended two-replica trace (steals, async orders, routing) gives
    a bit-identical StepEvent trace on every replica through ClusterSim
    and through FleetSim with that one host."""
    cfg, params, spec = setup
    bpp = spec.blocks_per_partition

    def run(mk_sim):
        _fake_time(monkeypatch)
        broker = HostMemoryBroker(budget_units=10 * bpp, async_reclaim=True)
        engines = {rid: ServeEngine(cfg, params, spec, mode="hotmem",
                                    keep_alive=3.0, seed=i, broker=broker,
                                    replica_id=rid)
                   for i, rid in enumerate(("A", "B"))}
        m = mk_sim(engines, broker).run(_fleet_reqs(), max_virtual_s=2000)
        broker.check_invariants()
        return {rid: [(e.t, e.kind, e.wall_s, e.detail) for e in eng.events]
                for rid, eng in engines.items()}, m

    t_c, m_c = run(lambda engines, broker:
                   ClusterSim(engines, Router("power_of_two"), broker))
    t_f, m_f = run(lambda engines, broker:
                   FleetSim({"host0": engines}, Router("power_of_two"),
                            brokers={"host0": broker}))
    assert t_c == t_f
    assert m_c["completed"] == m_f["completed"] > 0
    assert m_c["routed"] == m_f["routed"]
    assert m_c["broker"]["steals"] == m_f["broker"]["steals"] > 0


def test_fleet_remote_restore_end_to_end(setup):
    """Capture on host B, migrate, restore on host A: the restore event is
    tagged ``source="remote"`` with the origin host and the modeled copy
    charge, the engine counts it, per-host conservation holds, and the
    copy is paid exactly once."""
    cfg, params, spec = setup
    bpp = spec.blocks_per_partition
    sched = FleetScheduler()
    bA = HostMemoryBroker(budget_units=12 * bpp, snapshot_pool_units=4 * bpp)
    bB = HostMemoryBroker(budget_units=12 * bpp, snapshot_pool_units=4 * bpp)
    sched.add_host("h0", bA)
    sched.add_host("h1", bB)
    A = ServeEngine(cfg, params, spec, mode="hotmem", keep_alive=2.0,
                    seed=0, broker=bA, replica_id="A")
    B = ServeEngine(cfg, params, spec, mode="hotmem", keep_alive=2.0,
                    seed=1, broker=bB, replica_id="B")
    sched.placements.update({"A": "h0", "B": "h1"})

    _run_one(A, "jit0")
    for prof, entries in list(A.warm.items()):
        for (_, rid, _row) in entries:
            A.arena.finish(rid)
        A.warm[prof] = []
    _run_one(A, "c0")
    _expire(A)                                 # capture cnn on h0
    sched.check_invariants()
    _run_one(A, "s0")
    assert A.restore_starts == 1 and A.remote_restore_starts == 0
    assert [e for e in A.events if e.kind == "restore"][-1] \
        .detail["source"] == "local"
    bA.snapshot_drop("cnn")
    sched.check_invariants()

    _run_one(B, "jitB", prof="bert")
    _expire(B)
    sched.check_invariants()
    assert bB.snapshot_restorable("bert")
    assert not bA.snapshot_available("bert")
    captured = bB.snapshots.peek("bert").payload

    rec = sched.ensure_local("bert", "h0")     # the fleet migration
    sched.check_invariants()
    assert rec is not None and rec.copy_seconds > 0
    assert not bB.snapshot_available("bert")
    assert bA.snapshots.peek("bert").payload is captured   # by reference
    assert rec.nbytes == captured.nbytes

    _expire(A)
    _run_one(A, "r0", prof="bert")
    sched.check_invariants()
    assert A.remote_restore_starts == 1 and A.restore_starts == 2
    ev = [e for e in A.events if e.kind == "restore"][-1]
    assert ev.detail["source"] == "remote"
    assert ev.detail["origin"] == "h1"
    assert ev.detail["copy_s"] == pytest.approx(rec.copy_seconds)
    assert ev.wall_s >= rec.copy_seconds
    _expire(A)
    _run_one(A, "r1", prof="bert")
    assert A.remote_restore_starts == 1 and A.restore_starts == 3
    assert [e for e in A.events if e.kind == "restore"][-1] \
        .detail["source"] == "local"


# ----------------------------------------------------- dedup engine twins


def test_engine_paged_capture_and_cow_restore(setup):
    """Capture splits the partition into content pages; a replica that
    already maps every page restores by a pure remap, strictly below a
    replica materializing the pages for the first time."""
    cfg, params, spec = setup
    bpp = spec.blocks_per_partition
    broker = HostMemoryBroker(budget_units=12 * bpp,
                              snapshot_pool_units=4 * bpp)
    a = ServeEngine(cfg, params, spec, keep_alive=2.0, seed=0,
                    broker=broker, replica_id="A", snapshot_page_bytes=4096)
    b = ServeEngine(cfg, params, spec, keep_alive=2.0, seed=1,
                    broker=broker, replica_id="B", snapshot_page_bytes=4096)
    _run_one(a, "c0")
    _expire(a)
    broker.check_invariants()
    snap = broker.snapshots.peek("cnn")
    assert snap is not None and snap.pages is not None
    assert len(snap.pages) > 1
    specs = broker.snapshot_page_specs("cnn")
    assert [d for d, _u, _nb, _pl in specs] == list(snap.pages)
    assert sum(u for _d, u, _nb, _pl in specs) == snap.units == bpp
    _run_one(b, "r0")
    ev_b = next(e for e in b.events if e.kind == "restore")
    assert ev_b.detail["pages_total"] == len(specs)
    assert ev_b.detail["pages_shared"] == 0
    _run_one(a, "r1")
    ev_a = next(e for e in a.events if e.kind == "restore")
    assert ev_a.detail["pages_shared"] == ev_a.detail["pages_total"]
    assert 0.0 <= ev_a.wall_s < ev_b.wall_s
    assert a.restore_starts == 1 and b.restore_starts == 1
    broker.check_invariants()


def test_engine_without_page_size_captures_legacy_entries(setup):
    """``snapshot_page_bytes=None`` never touches the page store."""
    cfg, params, spec = setup
    bpp = spec.blocks_per_partition
    broker = HostMemoryBroker(budget_units=12 * bpp,
                              snapshot_pool_units=4 * bpp)
    eng = ServeEngine(cfg, params, spec, keep_alive=2.0, seed=0,
                      broker=broker, replica_id="A")
    _run_one(eng, "c0")
    _expire(eng)
    snap = broker.snapshots.peek("cnn")
    assert snap is not None and snap.pages is None
    assert len(broker.snapshots.pages) == 0
    assert broker.snapshot_units() == bpp
    _run_one(eng, "r0")
    ev = next(e for e in eng.events if e.kind == "restore")
    assert "pages_total" not in ev.detail
    broker.check_invariants()


# ------------------------------------------- scenario twin vs real engine


def test_model_replica_twin_matches_real_engine(setup, monkeypatch):
    """On a workload whose admission path is unambiguous (spaced arrivals,
    keep-alive zero, no snapshot pool), the ``ModelReplica`` twin's row
    counts equal the port engine's exactly, and the twin's cold TTFT lands
    within the JAX test's band of the deterministically clocked engine's."""
    cfg, params, spec = setup

    def mk_reqs():
        return [Request(rid=f"p{i}", profile=PROFILES["cnn"],
                        submit_s=0.5 * i) for i in range(5)]

    monkeypatch.setattr(ModelReplica, "KEEPALIVE_S", 0.0)
    sim, sched = _build({"h0": [("h0/r0", 2, None, 1.0, 1)]}, budget=8,
                        pool_units=None, tenants=None, seed=0)
    twin_reqs = mk_reqs()
    sim.run(list(twin_reqs))
    row = _row("twin_parity", "scaledown", 0, "drain_weighted", sim, sched,
               twin_reqs)

    _fake_time(monkeypatch)
    broker = HostMemoryBroker(budget_units=8 * spec.blocks_per_partition,
                              async_reclaim=True)
    eng = ServeEngine(cfg, params, spec, mode="hotmem", keep_alive=0.0,
                      seed=0, broker=broker, replica_id="h0/r0",
                      prewarm=False)
    real_reqs = mk_reqs()
    m = ClusterSim({"h0/r0": eng}, Router("least_loaded"), broker).run(
        list(real_reqs), max_virtual_s=2000)
    broker.check_invariants()
    assert row["requests"] == len(real_reqs) == 5
    assert (row["completed"], row["killed"]) \
        == (m["completed"], m["killed"]) == (5, 0)
    assert row["cold_starts"] == eng.cold_starts == 5
    assert row["warm_starts"] == eng.warm_starts == 0
    assert row["restore_starts"] == eng.restore_starts == 0
    assert row["remote_restore_starts"] == eng.remote_restore_starts == 0
    real_cold_ms = sorted(r.first_token_s - r.submit_s
                          for r in eng.done)[2] * 1e3
    assert row["cold_ttft_ms"] is not None and row["cold_ttft_ms"] > 0
    assert real_cold_ms > 0
    assert row["cold_ttft_ms"] / 100.0 <= real_cold_ms \
        <= row["cold_ttft_ms"] * 100.0, (row["cold_ttft_ms"], real_cold_ms)


# ------------------------------------------------ the new entry point


def _demo(argv) -> list[str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cluster_demo.main(argv)
    return out.getvalue().splitlines()


def _table(lines) -> dict:
    head = next(i for i, ln in enumerate(lines) if ln.startswith("mode"))
    cols = lines[head].split()
    rows = {}
    for ln in lines[head + 1:]:
        vals = ln.split()
        if len(vals) == len(cols):
            rows[(vals[0], vals[1])] = dict(zip(cols, vals))
    return rows


def test_cluster_demo_completes_with_zero_copy_hotmem_steals():
    """``--device cpu --reduced --modes hotmem,vanilla``: every request
    completes in all four runs; hotmem steals move 0 KiB, vanilla's move
    more than 0."""
    rows = _table(_demo(["--device", "cpu", "--reduced",
                         "--modes", "hotmem,vanilla"]))
    assert set(rows) == {(m, b) for m in ("hotmem", "vanilla")
                         for b in ("sync", "async")}
    want = len(cluster_demo.demo_requests(False))
    for (mode, _b), r in rows.items():
        assert int(r["completed"]) == want
        assert int(r["steals"]) > 0
        if mode == "hotmem":
            assert r["migratedKiB"] == "0.0"
        else:
            assert float(r["migratedKiB"]) > 0
    assert float(rows[("hotmem", "async")]["stall_p99_ms"]) == 0.0
    assert float(rows[("vanilla", "async")]["stall_p99_ms"]) == 0.0


def test_cluster_demo_two_hosts_restore_remotely(monkeypatch):
    """``--hosts 2``: B's expired containers are captured on B's host and
    the late tail pinned to A restores at least one of them remotely.
    Under the deterministic clock: with wall-measured engine events the
    schedule, and whether a capture lands before the tail, varies with
    the machine's load."""
    _fake_time(monkeypatch)
    rows = _table(_demo(["--device", "cpu", "--reduced", "--hosts", "2",
                         "--modes", "hotmem"]))
    want = len(cluster_demo.demo_requests(True))
    for r in rows.values():
        assert int(r["completed"]) == want
        assert int(r["remote"]) >= 1 and int(r["mig"]) >= 1


def test_cluster_demo_two_hosts_complete_on_the_wall_clock():
    """``--hosts 2`` as a user runs it, on the wall clock: every request
    completes in both broker rows, and no restore is counted remote that
    was not counted a restore.  Whether a remote restore happens at all
    depends on the machine's load here (see the test above)."""
    rows = _table(_demo(["--device", "cpu", "--reduced", "--hosts", "2",
                         "--modes", "hotmem"]))
    want = len(cluster_demo.demo_requests(True))
    assert len(rows) == 2
    for r in rows.values():
        assert int(r["completed"]) == want
        assert 0 <= int(r["remote"]) <= int(r["restore"])


def test_cluster_demo_scenario_row_equals_the_jax_row():
    row = json.loads("\n".join(_demo(["--scenario", "slo_tiered"])))
    assert row == jax_scenarios.run_scenario("slo_tiered", seed=0)


# ------------------------------------------- sharded hosts (--devices N)


@pytest.fixture(scope="module")
def jax_pair():
    """Reduced qwen2-7b with the JAX parameters from ``PRNGKey(0)``, in
    both packages."""
    jcfg = jax_reduced(jax_get_config("qwen2-7b"))
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = reduced(get_config("qwen2-7b"))
    spec = ArenaSpec.from_model(cfg, partition_tokens=128, n_partitions=8,
                                block_tokens=32)
    return (cfg, tree_from_numpy(jax.device_get(jparams), "cpu"), spec), \
        (jcfg, jparams, JaxArenaSpec.from_model(
            jcfg, partition_tokens=128, n_partitions=8, block_tokens=32))


def _sharded_host(pair, monkeypatch, pkg, async_mode):
    """The demo's pinned two-replica trace on a host whose broker keeps
    two device columns: the port through ``cluster_demo.build_cluster``,
    the JAX package through the same classes as
    ``examples/cluster_demo.py --devices 2``; one deterministic clock."""
    (cfg, params, spec), (jcfg, jparams, jspec) = pair
    budget = cluster_demo.host_budget(spec, 1)
    if pkg == "jax":
        _fake_time(monkeypatch, JAX_MODULES)
        broker = jax_cluster.HostMemoryBroker(
            budget_units=budget, async_reclaim=async_mode,
            topology=JaxDeviceTopology.uniform(budget, 2))
        engines = {rid: jax_engine_mod.ServeEngine(
            jcfg, jparams, jspec, mode="hotmem", keep_alive=3.0, seed=i,
            broker=broker, replica_id=rid)
            for i, rid in enumerate(("A", "B"))}
        sim = jax_cluster.ClusterSim(engines, jax_cluster.Router(
            route_fn=lambda r, e: "B" if r.rid.startswith("b") else "A"),
            broker)
        reqs = _cluster_reqs(jax_request.Request, jax_request.PROFILES,
                             jax_tracegen.assign_profiles,
                             jax_tracegen.bursty_trace)
    else:
        _fake_time(monkeypatch)
        sched, hosts, sim = cluster_demo.build_cluster(
            cfg, params, spec, mode="hotmem", async_mode=async_mode,
            topology=DeviceTopology.uniform(budget, 2))
        broker, engines = sched.brokers["h0"], hosts["h0"]
        reqs = cluster_demo.demo_requests(False)
    m = sim.run(reqs, max_virtual_s=2000)
    broker.check_invariants()
    return {
        "steals": [(r.requester, r.victim, r.units, r.reclaimed_bytes,
                    r.migrated_bytes, r.mode) for r in broker.steal_log],
        "completed": m["completed"], "killed": m["killed"],
        "devices": broker.ledger.device_report(),
        "events": {rid: [(e.t, e.kind, e.wall_s, e.detail)
                         for e in eng.events]
                   for rid, eng in sorted(engines.items())}}


@pytest.mark.parametrize("async_mode", [False, True], ids=["sync", "async"])
def test_sharded_host_matches_jax(jax_pair, monkeypatch, async_mode):
    """``--devices 2``: the port's demo engines on a two-device host
    topology equal the JAX engines on the same topology event for event,
    with the same steals and the same per-device ledger."""
    want = _sharded_host(jax_pair, monkeypatch, "jax", async_mode)
    got = _sharded_host(jax_pair, monkeypatch, "torch", async_mode)
    assert (got["completed"], got["killed"]) \
        == (want["completed"], want["killed"]) == (38, 0)
    assert got["steals"] == want["steals"] and len(got["steals"]) > 0
    assert all(s[4] == 0 for s in got["steals"])      # hotmem: no copy
    assert got["devices"] == want["devices"] and len(got["devices"]) == 2
    assert got["events"] == want["events"]


def test_cluster_demo_on_a_sharded_host(monkeypatch):
    """``--devices 2 --modes hotmem``: both broker rows complete every
    request, and each host's per-device occupancy line shows two
    balanced columns (under the deterministic clock)."""
    _fake_time(monkeypatch)
    lines = _demo(["--device", "cpu", "--reduced", "--devices", "2",
                   "--modes", "hotmem"])
    rows = _table(lines)
    assert set(rows) == {("hotmem", "sync"), ("hotmem", "async")}
    for r in rows.values():
        assert int(r["completed"]) == 38 and int(r["steals"]) > 0
        assert r["migratedKiB"] == "0.0"
    occ = [ln.split("h0: ")[1] for ln in lines if "h0: d0[" in ln]
    assert len(occ) == 2
    for ln in occ:
        d0, d1 = ln.split("  ")
        assert d0.startswith("d0[") and d1.startswith("d1[")
        assert d0[2:] == d1[2:]


def test_cluster_demo_refuses_vanilla_on_a_sharded_host():
    with pytest.raises(AssertionError, match="without vanilla"):
        cluster_demo.main(["--devices", "2", "--device", "cpu",
                           "--reduced"])
