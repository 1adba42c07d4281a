"""Multi-replica host demo on the card: one memory budget per host, VM
replicas, a broker per host — and, with ``--hosts N``, a fleet of hosts.

Port of ``examples/cluster_demo.py``.  Replica B handles early steady load
then idles (kept-alive containers); replica A's later burst outgrows the
host's free pool, so the broker reclaims B's memory — zero-copy under
HotMem (B's arena drops a row suffix), migration copies under the vanilla
paged baseline (one ``kv_compact`` launch on the card).

Each mode runs twice: with the synchronous broker (A's plug request
serializes behind B's unplug — the ``stall_p99`` column is what A waits)
and with the async reclaim pipeline (B receives a ``ReclaimOrder`` and
drains it between its own ticks while A keeps decoding; A's stall is 0).

``--policy``, ``--hosts``, ``--page-size``, ``--scenario``,
``--autoscale``, ``--dedup`` and ``--seed`` are the JAX demo's (see its
docstring).  The model is full-width qwen2-7b (random bf16 weights from
seed 0, an arena of 8 partitions of 2048 tokens) on the CUDA device;
``--reduced`` takes the reduced config and 128-token partitions, and
``--device cpu`` runs the kernels' plain versions.  All replicas of a run
share one ``params`` dict, so the weights are on the device once.
``--devices > 1`` is refused: one card is one device, and sharding a
replica over several waits for ROADMAP item 13.

  python -m repro_torch.launch.cluster_demo
  PYTHONPATH=src python -m repro_torch.launch.cluster_demo --reduced \\
      --device cpu --modes hotmem,vanilla
  PYTHONPATH=src python -m repro_torch.launch.cluster_demo --reduced \\
      --device cpu --hosts 2 --modes hotmem
  PYTHONPATH=src python -m repro_torch.launch.cluster_demo --scenario \\
      slo_tiered
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

from repro_torch.cluster import (ClusterSim, FleetScheduler, FleetSim,
                                 HostMemoryBroker, Router)
from repro_torch.cluster.router import POLICIES
from repro_torch.configs.base import get_config, reduced
from repro_torch.core.arena import ArenaSpec
from repro_torch.models import model as M
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.request import PROFILES, Request
from repro_torch.serving.tracegen import assign_profiles, bursty_trace

ARCH = "qwen2-7b"
FULL_PARTITION_TOKENS = 2048
REDUCED_PARTITION_TOKENS = 128


def demo_requests(pooled: bool) -> list[Request]:
    """The JAX demo's trace: B's quiet load, A's burst from 4 s and, when
    ``pooled``, a late tail that arrives after every warm container has
    expired (and been captured), so it restores from the pool."""
    quiet = bursty_trace(6.0, 0.9, burst_x=1.0, burst_len=0.0, seed=2)
    burst = [4.0 + t for t in bursty_trace(4.0, 3.0, burst_x=3.0,
                                           burst_at=(0.0,), burst_len=2.0,
                                           seed=3)]
    reqs = [Request(rid=f"b{i}", profile=p, submit_s=t)
            for i, (t, p) in enumerate(assign_profiles(quiet, PROFILES, 2))]
    reqs += [Request(rid=f"a{i}", profile=p, submit_s=t)
             for i, (t, p) in enumerate(assign_profiles(burst, PROFILES, 3))]
    if pooled:
        reqs += [Request(rid=f"t{i}", profile=PROFILES[p],
                         submit_s=12.0 + 0.5 * i)
                 for i, p in enumerate(("cnn", "bert", "bfs", "html"))]
    return reqs


def load_model(*, use_reduced: bool, device="cuda"):
    """(cfg, params, spec): qwen2-7b with random weights from seed 0, and
    an arena of 8 partitions (2048 tokens each at full width, 128
    reduced) in blocks of 32 tokens."""
    cfg = get_config(ARCH)
    if use_reduced:
        cfg = reduced(cfg)
    params = M.init_params(cfg, 0, device=device)
    spec = ArenaSpec.from_model(
        cfg, partition_tokens=REDUCED_PARTITION_TOKENS if use_reduced
        else FULL_PARTITION_TOKENS, n_partitions=8, block_tokens=32)
    return cfg, params, spec


def pooled_policy(policy: str, hosts: int) -> bool:
    """The snapshot pool is paid for by the policies that exploit it, and
    always on a fleet, where it is what migration moves."""
    return policy in ("snapshot_affinity", "drain_weighted",
                      "slo_tiered") or hosts > 1


def build_cluster(cfg, params, spec, *, mode: str, async_mode: bool,
                  hosts: int = 1, policy: str = "pinned",
                  page_size=None):
    """The demo's hosts and replicas, ready to run: one broker per host
    (10 partitions' worth on a single host — less than two full arenas,
    so A's burst cannot grow without shrinking B; a full arena's worth
    per host on a fleet), replicas placed by ``FleetScheduler`` spread
    placement, every replica on the one ``params``.  Returns (scheduler,
    {host: {replica: engine}}, sim)."""
    bpp = spec.blocks_per_partition
    pool_units = 4 * bpp if pooled_policy(policy, hosts) else None
    rids = [chr(ord("A") + k) for k in range(max(2, hosts))]
    budget = (10 if hosts == 1 else 12) * bpp
    sched = FleetScheduler()
    for k in range(hosts):
        sched.add_host(f"h{k}", HostMemoryBroker(
            budget_units=budget, async_reclaim=async_mode,
            snapshot_pool_units=pool_units))
    start_units = min(2, spec.n_partitions) * bpp
    hosts_map = {h: {} for h in sched.brokers}
    for i, rid in enumerate(rids):
        host = sched.place(rid, start_units, policy="spread")
        hosts_map[host][rid] = ServeEngine(
            cfg, params, spec, mode=mode, keep_alive=3.0, seed=i,
            broker=sched.brokers[host], replica_id=rid,
            snapshot_page_bytes=page_size)
    if policy == "pinned":
        router = Router(route_fn=lambda r, e:
                        "B" if r.rid.startswith("b") else "A")
    else:
        router = Router(policy)
    if hosts == 1:
        sim = ClusterSim(hosts_map["h0"], router, sched.brokers["h0"])
    else:
        sim = FleetSim(hosts_map, router, scheduler=sched)
    return sched, hosts_map, sim


def summarize(mode: str, sched, m: dict) -> dict:
    """One row of the demo's table from a finished run."""
    reps = [b.report() for b in sched.brokers.values()]
    by_mode = [r["by_mode"].get(mode, {}) for r in reps]
    stalls = sum((b.request_stalls for b in sched.brokers.values()),
                 []) or [0.0]
    return {
        "completed": m["completed"], "killed": m["killed"],
        "steals": sum(r["steals"] for r in reps),
        "stolen_units": sum(r["stolen_units"] for r in reps),
        "stall_p99_ms": float(np.percentile(stalls, 99)) * 1e3,
        "steal_ms": sum(d.get("wall_seconds", 0.0) for d in by_mode) * 1e3,
        "reclaimed_bytes": sum(d.get("reclaimed_bytes", 0)
                               for d in by_mode),
        "migrated_bytes": sum(d.get("migrated_bytes", 0) for d in by_mode),
        "latency_p99_s": m["latency_p99"],
        "warm": m["warm_hits"], "restore": m["restore_starts"],
        "remote": m["remote_restore_starts"],
        "mig": m["snapshot_migrations"],
        "squeezed": sum(r["squeezed_units"] for r in reps)}


def _dedup_demo(args, cfg, params, spec) -> None:
    """Content-addressed pool on real engines: N functions whose cold
    prompts are byte-identical produce byte-identical prefix KV, so their
    page manifests share every digest — the pool charges ONE copy and a
    second replica's restores find the shared pages already mapped."""
    bpp = spec.blocks_per_partition
    page_bytes = args.page_size or 4096
    broker = HostMemoryBroker(budget_units=12 * bpp,
                              snapshot_pool_units=6 * bpp)
    cap = ServeEngine(cfg, params, spec, keep_alive=0.4, seed=0,
                      broker=broker, replica_id="A",
                      snapshot_page_bytes=page_bytes)
    rst = ServeEngine(cfg, params, spec, keep_alive=0.4, seed=1,
                      broker=broker, replica_id="B",
                      snapshot_page_bytes=page_bytes)
    # the engine's cold prompt is full(prompt_tokens, hash(name) % 97 + 1):
    # same residue + same token count = byte-identical prefix KV.  hash()
    # is salted per process, so search for colliding names.
    base = PROFILES["cnn"]
    names, i = ["dup0"], 1
    while len(names) < 4 and i < 100_000:
        if hash(f"dup{i}") % 97 == hash("dup0") % 97:
            names.append(f"dup{i}")
        i += 1
    assert len(names) == 4
    profs = {n: dataclasses.replace(base, name=n) for n in names}
    cap.run([Request(rid=f"c{j}", profile=profs[n], submit_s=0.2 * j)
             for j, n in enumerate(names)], max_virtual_s=200)
    assert all(broker.snapshot_restorable(n) for n in names), \
        "captures did not land in the pool"
    broker.check_invariants()
    ref, uniq = broker.snapshots.referenced_units, broker.snapshot_units()
    rst.run([Request(rid=f"r{j}", profile=profs[n], submit_s=0.0)
             for j, n in enumerate(names)], max_virtual_s=200)
    broker.check_invariants()
    restores = [e for e in rst.events if e.kind == "restore"]
    total = sum(e.detail["pages_total"] for e in restores)
    shared = sum(e.detail["pages_shared"] for e in restores)
    print(f"page_size={page_bytes}B  functions={len(names)} "
          f"(byte-identical {base.prompt_tokens}-token prompts)")
    print(f"{'referenced_units':>16s} {'unique_units':>12s} "
          f"{'dedup_ratio':>11s} {'restores':>8s} {'pages':>6s} "
          f"{'shared':>6s} {'cow_ratio':>9s}")
    print(f"{ref:16d} {uniq:12d} {(uniq / ref if ref else 1.0):11.3f} "
          f"{len(restores):8d} {total:6d} {shared:6d} "
          f"{(shared / total if total else 0.0):9.3f}")


def _autoscale_table(seed: int) -> None:
    from repro_torch.cluster.scenarios import SCENARIOS, run_scenario
    names = sorted(n for n, (fam, _) in SCENARIOS.items()
                   if fam == "autoscale")
    print(f"{'scenario':16s} {'reqs':>5s} {'hosts':>5s} {'boots':>5s} "
          f"{'retires':>7s} {'mig':>4s} {'warm':>5s} {'restore':>7s} "
          f"{'cold':>5s} {'host_s':>8s} {'p99_ms':>8s}")
    for name in names:
        row = run_scenario(name, seed=seed)
        p99 = max(v for v in row["ttft_p99_ms_by_tier"].values())
        print(f"{name:16s} {row['requests']:5d} {row['hosts']:5d} "
              f"{row['host_boots']:5d} {row['host_retires']:7d} "
              f"{row['snapshot_migrations']:4d} "
              f"{row['warm_starts']:5d} {row['restore_starts']:7d} "
              f"{row['cold_starts']:5d} {row['host_seconds']:8.3f} "
              f"{p99:8.2f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", default="pinned",
                    choices=("pinned",) + POLICIES,
                    help="router policy (pinned = quiet load on B, burst "
                         "on A — the classic steal scenario)")
    ap.add_argument("--modes", default="hotmem,vanilla",
                    help="comma-separated engine modes to run")
    ap.add_argument("--hosts", type=int, default=1,
                    help="number of hosts; > 1 places replicas across "
                         "per-host brokers and enables cross-host "
                         "snapshot migration (FleetSim)")
    ap.add_argument("--devices", type=int, default=1,
                    help="devices per host; only 1 (sharding a replica "
                         "over several devices is ROADMAP item 13)")
    ap.add_argument("--scenario", default=None,
                    help="run one scenario-bank entry and print its row")
    ap.add_argument("--autoscale", action="store_true",
                    help="run the host-lifecycle scenarios")
    ap.add_argument("--dedup", action="store_true",
                    help="demo the content-addressed snapshot store")
    ap.add_argument("--page-size", type=int, default=None,
                    help="content-addressed snapshot page size in bytes")
    ap.add_argument("--seed", type=int, default=0,
                    help="scenario seed (--scenario/--autoscale only)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (cpu for the tests)")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced qwen2-7b with 128-token partitions")
    args = ap.parse_args(argv)
    assert args.hosts >= 1
    assert args.page_size is None or args.page_size > 0
    if args.devices != 1:
        raise SystemExit(
            f"--devices {args.devices}: the port runs a replica on one "
            f"device; sharding it over a mesh waits for ROADMAP item 13 "
            f"(launch and sharding onto torch.distributed)")

    if args.autoscale:
        _autoscale_table(args.seed)
        return
    if args.scenario is not None:
        from repro_torch.cluster.scenarios import SCENARIOS, run_scenario
        assert args.scenario in SCENARIOS, \
            f"unknown scenario {args.scenario!r} " \
            f"(have {', '.join(sorted(SCENARIOS))})"
        print(json.dumps(run_scenario(args.scenario, seed=args.seed),
                         indent=1))
        return

    cfg, params, spec = load_model(use_reduced=args.reduced,
                                   device=args.device)
    if args.dedup:
        _dedup_demo(args, cfg, params, spec)
        return
    pooled = pooled_policy(args.policy, args.hosts)
    print(f"policy={args.policy} hosts={args.hosts} model={cfg.name} "
          f"partition_tokens={spec.partition_tokens} device={args.device}")
    print(f"{'mode':10s} {'broker':6s} {'completed':>9s} {'steals':>6s} "
          f"{'stall_p99_ms':>12s} {'steal_ms':>9s} {'migratedKiB':>11s} "
          f"{'lat_p99_s':>9s} {'warm':>5s} {'restore':>7s} {'remote':>6s} "
          f"{'mig':>4s} {'squeezed':>8s}")
    for mode in args.modes.split(","):
        for async_mode in (False, True):
            sched, _hosts, sim = build_cluster(
                cfg, params, spec, mode=mode, async_mode=async_mode,
                hosts=args.hosts, policy=args.policy,
                page_size=args.page_size)
            m = sim.run(demo_requests(pooled), max_virtual_s=2000)
            sched.check_invariants()
            r = summarize(mode, sched, m)
            print(f"{mode:10s} {'async' if async_mode else 'sync':6s} "
                  f"{r['completed']:9d} {r['steals']:6d} "
                  f"{r['stall_p99_ms']:12.2f} {r['steal_ms']:9.2f} "
                  f"{r['migrated_bytes'] / 1024:11.1f} "
                  f"{(r['latency_p99_s'] or 0):9.2f} {r['warm']:5d} "
                  f"{r['restore']:7d} {r['remote']:6d} {r['mig']:4d} "
                  f"{r['squeezed']:8d}")


if __name__ == "__main__":
    main()
