"""Fleet co-simulation: N ``ServeEngine`` replicas across M hosts.

Each engine keeps its own virtual clock (advanced by measured wall time of
its device ops).  The sim interleaves them deterministically: always tick
the busy replica whose clock is furthest behind, and route each arrival
only once every busy replica has caught up to its submit time — so routing
decisions see the cluster state "at" the arrival instant, and a fixed
(trace, seed) pair replays identically.

``FleetSim`` is the general form: replicas are grouped into hosts, each
host owns a ``HostMemoryBroker`` (its budget ledger couples only the
replicas placed on it), and a ``FleetScheduler`` moves warm snapshot
state BETWEEN hosts as arrivals are routed (``_localize_snapshot``: when
the chosen replica's host lacks a restorable snapshot that a peer holds,
the scheduler migrates it — debiting the peer's pool, charging the
modeled inter-host copy, crediting the local pool — so the admission
restores remotely-captured state instead of cold-prefilling).

Timebase: each host's broker is stamped with that host's virtual clock
(the sum of its replicas' ``now`` — monotonic, advanced only by ticks),
and the scheduler's fleet clock is the sum over every host.  With one
host this is exactly the old single-host timebase, so ``ClusterSim`` —
now the single-host specialization — replays its traces bit-identically.

The broker couples a host's replicas.  Synchronous mode: a loaded
replica's plug request shrinks an idle one inline
(``_reclaim_from_idlest`` -> the victim's ``reclaim_for_broker``),
charging BOTH clocks with the reclaim stall (the victim does the work,
the requester serializes behind it).  Async mode: the request returns a
``Grant`` immediately and the sim's tick interleaving is what pipelines
the reclaim — order issuance (at the requester's plug), partial
fulfillment (the victim drains a chunk per tick, between its decodes),
and grant completion (the requester claims escrowed fills at its own
tick) all advance on the same deterministic virtual timebase, so the
requester's decode overlaps the victim's drain.
"""
from __future__ import annotations

import warnings
from collections import deque
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.cluster.fleet import AutoscalePolicy
from repro_torch.cluster.router import Router
from repro_torch.serving.request import State, slo_tier_of, tenant_of


class FleetSim:
    """N hosts of engines on one deterministic virtual timebase.

    ``hosts`` maps host id -> {replica id -> engine}; replica ids are
    fleet-unique.  ``brokers`` (host id -> broker) defaults to the
    scheduler's when one is given; each broker's clock is re-stamped with
    its host's virtual time so steal/order/squeeze records replay
    deterministically.  ``scheduler`` (a ``FleetScheduler``) enables
    cross-host snapshot migration at route time."""

    def __init__(self, hosts: dict[str, dict[str, Any]],
                 router: Optional[Router] = None,
                 brokers: Optional[dict[str, Any]] = None,
                 scheduler=None):
        assert hosts and all(hosts.values())
        self.hosts = {h: dict(es) for h, es in hosts.items()}
        self.engines: dict[str, Any] = {}
        self._host_of: dict[str, str] = {}
        for h, es in self.hosts.items():
            for rid, e in es.items():
                assert rid not in self.engines, \
                    f"replica id {rid} appears on two hosts"
                self.engines[rid] = e
                self._host_of[rid] = h
        self.scheduler = scheduler
        if brokers is None:
            # a scheduler may own hosts this sim does not drive
            brokers = {h: b for h, b in scheduler.brokers.items()
                       if h in self.hosts} if scheduler is not None else {}
        else:
            assert all(h in self.hosts for h in brokers), \
                f"brokers keyed off-host: " \
                f"{sorted(set(brokers) - set(hosts))}"
        self._brokers = {h: b for h, b in brokers.items() if b is not None}
        # single-host back-compat: THE broker (metrics expose its report)
        self.broker = next(iter(self._brokers.values())) \
            if len(self._brokers) == 1 else None
        for h, b in self._brokers.items():
            if hasattr(b, "set_clock"):
                b.set_clock(lambda h=h: self.host_now(h))
        if scheduler is not None:
            scheduler.set_clock(self.virtual_now)
            for rid, h in self._host_of.items():
                scheduler.placements.setdefault(rid, h)
        self.router = router or Router()
        if self.router.broker is None and self.broker is not None:
            self.router.broker = self.broker
        if self.router.fleet is None and scheduler is not None:
            self.router.fleet = scheduler
        # autoscaling (set_autoscaler): boot/retire hosts from the run loop
        self._autoscale: Optional[AutoscalePolicy] = None
        self._host_factory: Optional[Callable[[str], tuple]] = None
        self._boot_seq = 0
        self._quiet_evals = 0
        self._decommissioned: set[str] = set()
        self._todos: dict[str, deque] = {}
        self._max_virtual_s = float("inf")
        self._truncated = False

    def set_autoscaler(self, policy: AutoscalePolicy,
                       host_factory: Callable[[str], tuple]) -> None:
        """Arm the threshold autoscaler: evaluated once per run-loop
        iteration.  ``host_factory(host_id) -> (broker, {rid: engine})``
        provisions a new host — its engines must already be registered
        with the returned broker (the ``_build`` pattern); the sim wires
        clocks, placements, and routing.  Requires a scheduler."""
        assert self.scheduler is not None, "autoscaling needs a scheduler"
        self._autoscale = policy
        self._host_factory = host_factory

    # ------------------------------------------------------------- clocks
    def host_now(self, host_id: str) -> float:
        """One host's deterministic timebase: total virtual busy time of
        its replicas.  Each tick advances exactly one replica's clock, so
        deltas of this sum measure the victim-side work between any two
        of that host's broker events."""
        return sum(e.now for e in self.hosts[host_id].values())

    def virtual_now(self) -> float:
        """The fleet clock: total virtual busy time across every host
        (stamps ``MigrationRecord``s and single-host broker events)."""
        return sum(e.now for e in self.engines.values())

    # ------------------------------------------------------------------ run
    def run(self, requests: list, max_virtual_s: float = 1e9,
            max_ticks: int = 500_000) -> dict[str, Any]:
        arrivals = deque(sorted(requests, key=lambda r: r.submit_s))
        self._todos = {rid: deque() for rid in self.engines}
        self._max_virtual_s = max_virtual_s
        todos = self._todos
        ticks = 0
        busy = self._busy

        while ticks < max_ticks:
            if self._autoscale is not None:
                self._autoscale_step()
            busy_ids = [rid for rid in self.engines if busy(rid)]
            if arrivals:
                t_arr = arrivals[0].submit_s
                lagging = [r for r in busy_ids
                           if self.engines[r].now < t_arr]
                if lagging:
                    rid = min(lagging,
                              key=lambda r: (self.engines[r].now, r))
                    self.engines[rid]._tick(todos[rid])
                    ticks += 1
                    continue
                req = arrivals.popleft()
                backlog = {r: len(todos[r]) for r in self.engines}
                target = self.router.route(req, self.engines, backlog)
                self._localize_snapshot(req, target)
                todos[target].append(req)
                continue
            if not busy_ids:
                if self._autoscale is not None:
                    self._finalize_retirements()
                break
            rid = min(busy_ids, key=lambda r: (self.engines[r].now, r))
            self.engines[rid]._tick(todos[rid])
            ticks += 1
        # a run that exhausted ``max_ticks`` with work still queued is NOT
        # a completed run — flag it loudly instead of returning metrics
        # indistinguishable from a finished trace
        self._truncated = bool(arrivals
                               or any(busy(r) for r in self.engines))
        if self._truncated:
            warnings.warn(
                f"FleetSim.run truncated at max_ticks={max_ticks}: "
                f"{len(arrivals)} arrivals unrouted, "
                f"{sum(busy(r) for r in self.engines)} replicas still "
                f"busy — metrics are partial", RuntimeWarning,
                stacklevel=2)
        return self.metrics()

    def _busy(self, rid: str) -> bool:
        e = self.engines[rid]
        host_work = getattr(e, "host_work", None)
        return bool(self._todos[rid] or e.pending or e.active
                    or any(e.warm.values())
                    or (host_work is not None and host_work())) \
            and e.now < self._max_virtual_s

    # ------------------------------------------------------- autoscaling
    def _autoscale_step(self) -> None:
        """One autoscaler evaluation (every run-loop iteration): pump
        in-progress retirements, then apply the threshold policy to the
        active fleet's free-unit slack — boot below the low-water mark,
        begin retiring the emptiest host after a sustained quiet streak
        at/above the high-water mark.  Purely a function of fleet state,
        so a fixed (trace, seed) pair autoscales identically."""
        sched, pol = self.scheduler, self._autoscale
        self._pump_retiring(force=False)
        active = [h for h in sched.brokers if h not in sched.retiring]
        slack = sum(sched.brokers[h].free_units for h in active)
        if slack < pol.low_water and len(active) < pol.max_hosts:
            self._boot_host()
            self._quiet_evals = 0
            return
        if slack >= pol.high_water:
            self._quiet_evals += 1
        else:
            self._quiet_evals = 0
        if self._quiet_evals >= pol.quiet_ticks \
                and len(active) > pol.min_hosts:
            # retire the emptiest DRIVEN host (most free units, tie -> id)
            cands = [h for h in active if h in self.hosts]
            if cands:
                victim = min(cands,
                             key=lambda h: (-sched.brokers[h].free_units, h))
                sched.begin_retire(victim)
            self._quiet_evals = 0

    def _boot_host(self) -> None:
        """Scale-up: provision a host via the factory and wire it into
        the running sim (clock, todos, placements, routing)."""
        sched = self.scheduler
        hid = f"as{self._boot_seq}"
        while hid in self.hosts or hid in sched.brokers \
                or hid in sched.retired:
            self._boot_seq += 1
            hid = f"as{self._boot_seq}"
        broker, engines = self._host_factory(hid)
        assert engines, f"host factory produced no replicas for {hid}"
        sched.boot_host(hid, broker,
                        ready_delay=self._autoscale.boot_latency_s)
        self.hosts[hid] = dict(engines)
        self._brokers[hid] = broker
        if hasattr(broker, "set_clock"):
            broker.set_clock(lambda h=hid: self.host_now(h))
        for rid, e in engines.items():
            assert rid not in self.engines, \
                f"replica id {rid} already exists in the fleet"
            self.engines[rid] = e
            self._host_of[rid] = hid
            self._todos[rid] = deque()
            sched.placements[rid] = hid
        sched.check_invariants()

    def _pump_retiring(self, *, force: bool) -> None:
        """Advance retirements of driven hosts: once a retiring host's
        replicas are all idle, decommission them (``deregister`` settles
        grants/orders and returns their units), drain the snapshot pool
        to peers, and remove the host when its ledger is clean.  The
        host's engines stay in ``self.engines`` forever — the fleet
        clock is the sum of engine clocks, so removing one would jump
        time backwards; the router masks them via the scheduler."""
        sched = self.scheduler
        for h in sorted(sched.retiring & set(self.hosts)
                        - self._decommissioned):
            if any(self._busy(r) for r in self.hosts[h]):
                continue
            b = sched.brokers[h]
            for rid in sorted(self.hosts[h]):
                if rid in b.granted:
                    b.deregister(rid)
            sched.drain_host(h, force=force)
            if sched.finish_retire(h):
                self._decommissioned.add(h)

    def _finalize_retirements(self) -> None:
        """End-of-trace pass: no arrivals and nothing busy, so complete
        every in-progress retirement deterministically — the drain
        budget protects foreground traffic that no longer exists, so the
        force pump ignores it (and drops entries with no peer room
        rather than stranding the retirement forever)."""
        self._pump_retiring(force=True)

    def _localize_snapshot(self, req, target: str) -> None:
        """Fleet migration hook, at route time: if the chosen replica's
        host lacks a restorable snapshot for the function but a peer
        holds one, migrate it now so the admission restores instead of
        cold-prefilling.  Skipped when the replica holds a warm row (an
        adopt beats any restore — the copy would be wasted), for
        batch-tier traffic (it starts cold by design — paying an
        inter-host copy for it would spend exactly the capacity the tier
        split protects), and on single-host sims (nowhere to migrate
        from)."""
        if self.scheduler is None or len(self._brokers) < 2:
            return
        if slo_tier_of(req) == "batch":
            return
        if self.engines[target].warm.get(req.profile.name):
            return
        host = self._host_of[target]
        # a retiring host is draining its pool — don't migrate INTO it
        # (the router only lands here when the whole fleet is retiring)
        if host in getattr(self.scheduler, "retiring", ()):
            return
        self.scheduler.ensure_local(req.profile.name, host)

    # -------------------------------------------------------------- metrics
    def metrics(self) -> dict[str, Any]:
        per = {rid: e.metrics() for rid, e in self.engines.items()}
        done = [r for e in self.engines.values() for r in e.done]
        lat = [r.latency for r in done
               if r.latency is not None and r.state is State.DONE]
        engines = self.engines.values()
        out: dict[str, Any] = {
            "completed": sum(r.state is State.DONE for r in done),
            "killed": sum(r.state is State.KILLED for r in done),
            "truncated": self._truncated,
            "latency_p50": float(np.percentile(lat, 50)) if lat else None,
            # a 1-sample "percentile" is just that sample — meaningless as
            # a tail statistic, so report None until there are >= 2
            "latency_p99": float(np.percentile(lat, 99))
            if len(lat) >= 2 else None,
            "reclaimed_bytes": sum(m["reclaimed_bytes"]
                                   for m in per.values()),
            "migrated_bytes": sum(m["migrated_bytes"] for m in per.values()),
            "reclaim_events": sum(m["reclaim_events"] for m in per.values()),
            "per_replica": per,
            "routed": dict(self.router.routed),
            # authoritative start-path counters (engine-side: the path that
            # actually ran) vs the router's route-time predictions
            "warm_hits": sum(getattr(e, "warm_starts", 0) for e in engines),
            "restore_starts": sum(getattr(e, "restore_starts", 0)
                                  for e in engines),
            "remote_restore_starts": sum(
                getattr(e, "remote_restore_starts", 0) for e in engines),
            "cold_starts": sum(getattr(e, "cold_starts", 0)
                               for e in engines),
            "warm_routes": self.router.warm_routes,
            "snapshot_routes": self.router.snapshot_routes,
            "remote_routes": self.router.remote_routes,
            "snapshot_migrations": len(self.scheduler.migrations)
            if self.scheduler is not None else 0,
            # per-device occupancy surface (observability only: routing
            # keys never read this, so devices=1 traces stay identical)
            "device_occupancy": {h: b.ledger.device_report()
                                 for h, b in self._brokers.items()
                                 if hasattr(b, "ledger")},
        }
        by_tenant: dict[str, dict[str, int]] = {}
        for r in done:
            t = tenant_of(r) or "default"
            d = by_tenant.setdefault(t, {"completed": 0, "killed": 0})
            if r.state is State.DONE:
                d["completed"] += 1
            elif r.state is State.KILLED:
                d["killed"] += 1
        out["by_tenant"] = by_tenant
        if self.broker is not None:
            out["broker"] = self.broker.report()
        if self.scheduler is not None:
            out["fleet"] = self.scheduler.report()
        return out


class ClusterSim(FleetSim):
    """Single-host specialization (the pre-fleet interface): N replicas,
    one broker, no cross-host migration.  ``FleetSim`` with one host
    replays these traces bit-identically — the regression tests pin that
    seam."""

    def __init__(self, engines: dict[str, Any], router: Optional[Router]
                 = None, broker=None):
        assert engines
        super().__init__({"host0": dict(engines)}, router,
                         brokers={"host0": broker})
