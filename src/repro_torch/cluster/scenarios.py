"""SLO-tiered multi-tenant scenario bank: named, seeded, deterministic.

The repo's benchmarks drove one trace shape through one tenant; nothing
could detect a regression in fairness, tail behavior, or the
warm/restore/cold balance between PRs.  Following the vHive
snapshot-benchmarking methodology — many workload shapes, ONE comparable
report row each — this module defines a bank of ``FleetSim`` scenarios:

  family      scenarios                      what it stresses
  ---------   ---------------------------    ----------------------------
  diurnal     diurnal_smoke, diurnal_mix     two tenants' day/night peaks
                                             out of phase: one tenant's
                                             peak leans on the slack the
                                             other's trough frees
  fairness    fairness_smoke, fairness_burst one tenant's burst squeezing
                                             another's snapshots — only
                                             down to its sub-budget
  slo         slo_smoke, slo_tiered          latency-tiered traffic under
                                             the ``slo_tiered`` policy:
                                             tight tier spends warm state,
                                             batch routes cold
  scaledown   scaledown_burst                burst -> quiet -> burst:
                                             scale-down under load, then
                                             reclaim orders to re-grow
  hedge       hedged_fleet                   a straggler host: hedged
                                             dispatch fires the backup on
                                             the other host
  mesh        mesh_reclaim                   the scaledown workload on a
                                             4-device host mesh: sharded
                                             replicas, per-device budget
                                             conservation, shard-coherent
                                             reclaim-order drains
  autoscale   autoscale_smoke,               burst -> quiet tail driving
              autoscale_burst, retire_drain  the threshold autoscaler:
                                             hosts boot below the low-
                                             water slack mark, the
                                             emptiest retires after a
                                             quiet streak and DRAINS its
                                             snapshot pool to peers over
                                             the contended interconnect
  dedup       dedup_prefix,                  many functions sharing one
              dedup_baseline                 long common KV prefix:
                                             content-addressed manifests
                                             charge each shared page once
                                             (refcounted, cross-tenant)
                                             and migrations move only
                                             missing pages — vs the
                                             duplicated opaque baseline

Every scenario is a pure function of ``(name, seed)``: arrivals come
from per-tenant ``tracegen`` streams (independent child rngs), replicas
are ``ModelReplica`` — a deterministic modeled twin of ``ServeEngine``
with FIXED virtual costs (no wall-clock measurement anywhere) driving
the real broker/ledger/snapshot/router/fleet stack — so rerunning a
scenario with the same seed is bit-identical, and the bank's rows are a
pinnable regression surface (``benchmarks/run.py --scenarios`` persists
them to ``BENCH_6.json``; CI diffs against the committed baseline).

Each run emits ONE report row with the frozen ``ROW_SCHEMA`` key set —
warm/restore/cold TTFT medians, per-tier TTFT p99, admission-stall p99,
per-tenant squeeze counts, reclaim orders, routes, host-seconds — so a
changed row is a loud diff, not silent drift.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.cluster.fleet import AutoscalePolicy, FleetScheduler
from repro_torch.cluster.host import HostMemoryBroker
from repro_torch.cluster.router import Router
from repro_torch.cluster.sim import FleetSim
from repro_torch.cluster.topology import DeviceTopology
from repro_torch.launch.distributed import hedged_dispatch
from repro_torch.serving.request import (PROFILES, FunctionProfile, Request,
                                   State, slo_tier_of, tenant_of)
from repro_torch.serving.tracegen import (assign_profiles, bursty_trace,
                                    diurnal_trace)

# every scenario row carries exactly these keys, in this order — the
# golden regression test (tests/test_scenarios.py) pins the set, and
# benchmarks/run.py persists rows in this shape to BENCH_6.json
ROW_SCHEMA = (
    "scenario", "family", "seed", "policy", "hosts", "replicas",
    "tenants", "requests", "completed", "killed",
    "warm_ttft_ms", "restore_ttft_ms", "cold_ttft_ms",
    "ttft_p99_ms_by_tier", "stall_p99_ms",
    "warm_starts", "restore_starts", "remote_restore_starts",
    "cold_starts", "squeezes_by_tenant", "reclaim_orders", "order_units",
    "snapshot_migrations", "host_boots", "host_retires",
    "hedges", "routes", "host_seconds",
    "free_units_end", "device_units_end",
    # content-addressed pool surface (PR 9): units the pools actually
    # CHARGE at end of run (unique pages once) vs what the manifests
    # reference, and the bytes migrations actually moved (missing pages
    # only) — 1.0 / equal-to-referenced for unpaged scenarios
    "unique_snapshot_units", "dedup_ratio", "migrated_snapshot_bytes",
)

# fields holding milliseconds/seconds — the CI regression gate treats
# "new > old * (1 + tolerance)" on any of these as a perf regression
TIME_FIELDS = ("warm_ttft_ms", "restore_ttft_ms", "cold_ttft_ms",
               "stall_p99_ms", "host_seconds")


class ModelReplica:
    """Deterministic modeled twin of ``ServeEngine`` for the scenario
    bank: same broker protocol (grants, order drains, snapshot
    capture/restore, warm keep-alive, scale-down release), but every cost
    is a FIXED virtual-seconds constant — so a scenario's entire schedule
    is a pure function of (trace, seed) and replays bit-identically.

    Interface-compatible with ``FleetSim``/``Router``: ``now`` /
    ``pending`` / ``active`` / ``warm`` / ``done`` / ``load()`` /
    ``host_work()`` / ``_tick()`` / ``metrics()`` plus the start-path
    counters the sim metrics aggregate.  One request row is backed by
    ``devices`` memory units — one KV shard per device of the host mesh
    — so every broker flow is ``rows × devices`` units, order drains go
    one unit per shard in lockstep, and snapshot entries carry one
    fragment per device.  ``devices=1`` (one unit per row) is the exact
    pre-mesh twin, bit-identical trace included."""

    DECODE_S = 1e-3              # one batched decode step
    COLD_S_TOK = 2e-4            # cold prefill, per prompt token
    RESTORE_S = 2e-3             # snapshot copy-back (local)
    CAPTURE_S = 1e-3             # snapshot copy-out on keep-alive expiry
    DRAIN_S = 2.5e-4             # one order-drain chunk (1 unit)
    IDLE_S = 2e-3                # idle clock advance
    KEEPALIVE_S = 0.05           # warm container lifetime
    KILL_AFTER_S = 5.0           # admission deadline (OOM-kill analogue)
    BYTES_PER_TOKEN = 1 << 10    # snapshot payload size basis

    def __init__(self, rid: str, broker: HostMemoryBroker, host_id: str,
                 *, units: int, min_rows: int = 1,
                 tenant: Optional[str] = None, straggle: float = 1.0,
                 devices: int = 1, pager: Optional[Callable] = None):
        assert units >= min_rows >= 1
        assert devices >= 1 and broker.topology.n_devices == devices, \
            f"{rid}: {devices} KV shards on a " \
            f"{broker.topology.n_devices}-device host"
        self.rid = rid
        self.broker = broker
        self.host = host_id
        self.tenant = tenant or ""
        self.straggle = straggle         # work-cost multiplier (hedge scn)
        self.devices = devices           # units (KV shards) per row
        # content-addressed capture: ``pager(prof, toks, devices)`` maps
        # a profile's KV to symbolic page specs (dedup scenarios); the
        # replica tracks which digests it has materialized so a later
        # restore of shared pages is copy-on-write (cheaper)
        self.pager = pager
        self._mapped: set = set()
        self.rows = units
        self.min_rows = min_rows
        self.now = 0.0
        self.pending: deque = deque()
        self.active: dict[str, int] = {}          # req rid -> steps left
        self._active_req: dict[str, Request] = {}
        self.warm: dict[str, list] = {}           # prof -> [(expire, rid, 0)]
        self.done: list[Request] = []
        self.warm_starts = 0
        self.restore_starts = 0
        self.remote_restore_starts = 0
        self.cold_starts = 0
        self.captures = 0
        self.drains = 0
        self.ttft_samples: list[tuple[str, str, str, float]] = []
        self.admit_waits: list[float] = []        # admitted_s - submit_s
        self._prof_tokens: dict[str, int] = {}
        self._orders: deque = deque()
        self._grants: list = []
        broker.register(rid, units * devices, load=self.load,
                        order_sink=self._orders.append, mode="model",
                        tenant=tenant, shards=devices)

    # ----------------------------------------------------------- queries
    def load(self) -> int:
        return len(self.active) + len(self.pending)

    def host_work(self) -> bool:
        return bool(self._orders) or bool(self._grants)

    def _warm_count(self) -> int:
        return sum(len(v) for v in self.warm.values())

    def _free_rows(self) -> int:
        return self.rows - len(self.active) - self._warm_count()

    def predicted_ttft(self, req: Request) -> float:
        """The hedged-dispatch probe: queue depth plus the likely start
        cost, scaled by this replica's straggle factor."""
        start = 0.0 if self.warm.get(req.profile.name) \
            else self.COLD_S_TOK * req.profile.prompt_tokens
        return ((self.load() + 1) * self.DECODE_S + start) * self.straggle

    # -------------------------------------------------------------- tick
    def _tick(self, todo: deque) -> None:
        while todo and todo[0].submit_s <= self.now:
            self.pending.append(todo.popleft())
        # requester side: claim escrowed grant fills; abandon a pending
        # grant whose demand has evaporated
        for g in list(self._grants):
            got = self.broker.claim_grant(g)
            if got:
                assert got % self.devices == 0, (got, self.devices)
                self.rows += got // self.devices
            if not g.done and not (self.pending or self.active):
                self.broker.abandon_grant(g)
            if g.done and g.available == 0 and g.incoherent == 0:
                self._grants.remove(g)
        # victim side: serve one chunk of the front order per tick —
        # free rows first, then the oldest warm container; never shrink
        # below min_rows (cancel the unfulfillable remainder instead)
        while self._orders and not self._orders[0].open:
            self._orders.popleft()
        if self._orders:
            o = self._orders[0]
            if self._free_rows() <= 0 and self._warm_count() > 0 \
                    and self.rows > self.min_rows:
                self._drop_oldest_warm()
            if self._free_rows() > 0 and self.rows > self.min_rows:
                self.now += self.DRAIN_S * self.straggle
                if self.devices == 1:
                    acc = self.broker.fulfill_order(o.order_id, 1)
                else:
                    # one row per tick = one unit per shard, in lockstep
                    # — the coherent stripe the requester can claim grows
                    # by exactly one row once the LAST shard lands
                    acc = sum(self.broker.fulfill_order(o.order_id, 1,
                                                        shard=d)
                              for d in range(self.devices))
                assert acc % self.devices == 0, (acc, self.devices)
                self.rows -= acc // self.devices
                self.drains += 1
            else:
                self.broker.cancel_order(o.order_id)
                self._orders.popleft()
            self.broker.ledger.check()
            return
        admitted = self._try_admit()
        if self.active:
            self._decode()
        elif not admitted:
            self.now += self.IDLE_S
        self._recycle_idle()
        self._request_capacity()
        # the conservation law after EVERY tick; the broker's full
        # structural cross-checks (O(all orders ever issued)) run once
        # per scenario at report time — see _row
        self.broker.ledger.check()

    def _drop_oldest_warm(self) -> None:
        oldest = min(((es[0], prof) for prof, es in self.warm.items()
                      if es), default=None)
        if oldest is not None:
            _, prof = oldest
            self.warm[prof].pop(0)

    # ------------------------------------------------------------- admit
    def _try_admit(self) -> bool:
        admitted = False
        still: deque = deque()
        while self.pending:
            req = self.pending.popleft()
            if req.submit_s > self.now:
                still.append(req)
                continue
            if self.now - req.submit_s > self.KILL_AFTER_S:
                req.state = State.KILLED
                req.done_s = self.now
                self.done.append(req)
                continue
            key = req.profile.name
            self._prof_tokens[key] = req.profile.prompt_tokens
            batch = slo_tier_of(req) == "batch"
            entries = None if batch else self.warm.get(key)
            if entries:
                entries.pop()                 # adopt the newest container
                self._start(req, "warm", 0.0)
                admitted = True
                continue
            if self._free_rows() <= 0:
                still.append(req)
                continue
            snap = self.broker.snapshot_lookup(key) \
                if not batch and self.broker.snapshot_restorable(key) \
                else None
            if snap is not None:
                owed = snap.claim_copy()      # first remote restore pays
                cost = self.RESTORE_S
                if getattr(snap, "pages", None) is not None:
                    # CoW restore: already-materialized pages remap for
                    # free; the floor keeps restore strictly above warm
                    specs = self.broker.snapshot_page_specs(key)
                    new = sum(1 for d, _u, _b, _p in specs
                              if d not in self._mapped)
                    cost *= max(new / len(specs), 0.25)
                    self._mapped.update(d for d, _u, _b, _p in specs)
                path = "remote_restore" if owed > 0.0 else "restore"
                self._start(req, path, cost + owed)
            else:
                self._start(req, "cold",
                            self.COLD_S_TOK * req.profile.prompt_tokens)
            admitted = True
        self.pending = still
        return admitted

    def _start(self, req: Request, path: str, cost: float) -> None:
        self.now += cost * self.straggle
        req.admitted_s = self.now
        self.admit_waits.append(self.now - req.submit_s)
        req.state = State.RUNNING
        self.active[req.rid] = req.profile.decode_tokens
        self._active_req[req.rid] = req
        setattr(req, "_start_path", path)
        if path == "warm":
            self.warm_starts += 1
        elif path == "restore":
            self.restore_starts += 1
        elif path == "remote_restore":
            self.remote_restore_starts += 1
        else:
            self.cold_starts += 1

    # ------------------------------------------------------------ decode
    def _decode(self) -> None:
        self.now += self.DECODE_S * self.straggle
        for rid in list(self.active):
            self.active[rid] -= 1
            req = self._active_req[rid]
            if req.first_token_s is None:
                req.first_token_s = self.now
                self.ttft_samples.append(
                    (getattr(req, "_start_path", "cold"),
                     slo_tier_of(req), tenant_of(req) or "default",
                     req.first_token_s - req.submit_s))
            if self.active[rid] <= 0:
                del self.active[rid]
                del self._active_req[rid]
                req.state = State.DONE
                req.done_s = self.now
                self.done.append(req)
                # batch rows go straight back free — batch traffic must
                # not mint the warm capacity the tight tier depends on
                if slo_tier_of(req) != "batch":
                    self.warm.setdefault(req.profile.name, []).append(
                        (self.now + self.KEEPALIVE_S, req.rid, 0))

    # --------------------------------------------------- keep-alive pool
    def _recycle_idle(self) -> None:
        for prof, entries in list(self.warm.items()):
            fresh = []
            for t, rid, row in entries:
                if t <= self.now:
                    self._capture(prof)       # snapshot before recycling
                else:
                    fresh.append((t, rid, row))
            self.warm[prof] = fresh
        # scale-down: release rows above live demand (never below
        # min_rows) — the squeezed-VM behavior the broker re-grows later
        keep = max(self.min_rows, len(self.active) + self._warm_count()
                   + len(self.pending))
        release = self.rows - keep
        if release > 0:
            self.broker.release_units(self.rid, release * self.devices)
            self.rows -= release

    def _capture(self, prof: str) -> None:
        if self.broker.snapshot_available(prof):
            return
        toks = self._prof_tokens.get(prof, 0)
        # sharded KV: one fragment per device (all present — a partial
        # capture would be unrestorable and is never offered to the pool)
        frags = tuple(("kv", prof, d) for d in range(self.devices)) \
            if self.devices > 1 else None
        pages = self.pager(prof, toks, self.devices) if self.pager \
            else None
        if self.broker.snapshot_put(prof, units=self.devices,
                                    payload=("kv", prof),
                                    tokens=toks,
                                    nbytes=toks * self.BYTES_PER_TOKEN,
                                    replica_id=self.rid,
                                    tenant=self.tenant, fragments=frags,
                                    pages=pages):
            if pages is not None:
                self._mapped.update(d for d, _u, _b, _p in pages)
            self.captures += 1
            self.now += self.CAPTURE_S * self.straggle

    # ---------------------------------------------------------- capacity
    def _request_capacity(self) -> None:
        if self._orders:
            return                  # mid-drain: don't tug both directions
        ready = sum(1 for r in self.pending if r.submit_s <= self.now)
        # outstanding is in UNITS (incoherent shard fills included — they
        # are still owed to us); demand is in rows
        outstanding = sum(g.pending + g.available + g.incoherent
                          for g in self._grants)
        want = ready - self._free_rows() - outstanding // self.devices
        if want > 0:
            g = self.broker.request_grant(self.rid, want * self.devices)
            assert g.granted % self.devices == 0, g
            self.rows += g.granted // self.devices
            if not g.done or g.available or g.incoherent:
                self._grants.append(g)

    # ----------------------------------------------------------- metrics
    def metrics(self) -> dict[str, Any]:
        return {"reclaimed_bytes": 0, "migrated_bytes": 0,
                "reclaim_events": self.drains}


class HedgedRoutePolicy:
    """Router ``route_fn`` built on the seed's ``hedged_dispatch``
    contract: submit to the least-loaded replica's predicted TTFT, hedge
    to the second if it misses ``deadline_s``, and route the request to
    the LAST chosen replica (the backup when the hedge fired) — so
    exactly one replica runs it and exactly one result is charged."""

    def __init__(self, deadline_s: float):
        self.deadline_s = deadline_s
        self.hedges = 0
        self.chosen_log: list[tuple[str, list[str]]] = []

    def __call__(self, req: Request, engines: dict) -> str:
        ids = sorted(engines)
        reps = [engines[r] for r in ids]
        chosen = hedged_dispatch(
            reps, lambda i: reps[i].predicted_ttft(req),
            deadline_s=self.deadline_s)
        if len(chosen) > 1:
            self.hedges += 1
        self.chosen_log.append((req.rid, [ids[i] for i in chosen]))
        return ids[chosen[-1]]


# --------------------------------------------------------------- builders
def _tenant_profiles(tenant: str, names: tuple[str, ...],
                     tiers: Optional[dict[str, str]] = None
                     ) -> dict[str, FunctionProfile]:
    """Tenant-namespaced copies of the paper profiles: snapshot keys and
    warm pools become per-tenant automatically."""
    out = {}
    for n in names:
        p = PROFILES[n]
        out[f"{tenant}/{n}"] = dataclasses.replace(
            p, name=f"{tenant}/{n}", tenant=tenant,
            slo_tier=(tiers or {}).get(n, "standard"))
    return out


def _requests(streams: list[tuple[str, list]]) -> list[Request]:
    """Merge per-stream ``(submit_s, profile)`` lists into one arrival
    order (ties break on stream name, then index — deterministic)."""
    reqs = []
    for stream, assigned in streams:
        for i, (t, prof) in enumerate(assigned):
            reqs.append(Request(rid=f"{stream}-{i}", profile=prof,
                                submit_s=t))
    reqs.sort(key=lambda r: (r.submit_s, r.rid))
    return reqs


def _build(hosts: dict[str, list], *, budget: int, pool_units: int,
           tenants: Optional[dict[str, int]] = None,
           policy: str = "drain_weighted", seed: int = 0,
           route_fn: Optional[Callable] = None, devices: int = 1,
           pager: Optional[Callable] = None):
    """One broker per host (shared tenant sub-budget split), replicas
    placed per spec, router wired to the fleet scheduler.  ``hosts``:
    host id -> list of (rid, units, tenant, straggle, min_rows).

    ``budget`` / ``pool_units`` / tenant sub-budgets are in ROWS; with
    ``devices > 1`` every row is ``devices`` units (one KV shard per
    device), so each host gets a uniform ``DeviceTopology`` of
    ``budget × devices`` total units and all ledger flows stripe over
    the mesh.  ``devices=1`` builds the exact legacy scalar broker."""
    topo = None if devices == 1 \
        else DeviceTopology.uniform(budget * devices, devices)
    sched = FleetScheduler()
    engines: dict[str, dict[str, ModelReplica]] = {}
    for h, reps in hosts.items():
        b = HostMemoryBroker(
            budget if devices == 1 else None, async_reclaim=True,
            snapshot_pool_units=(pool_units * devices
                                 if pool_units else pool_units),
            tenants={t: v * devices for t, v in tenants.items()}
            if tenants else None,
            topology=topo)
        sched.add_host(h, b)
        engines[h] = {rid: ModelReplica(rid, b, h, units=units,
                                        tenant=tenant, straggle=straggle,
                                        min_rows=min_rows,
                                        devices=devices, pager=pager)
                      for rid, units, tenant, straggle, min_rows in reps}
    router = Router(policy=policy, seed=seed, route_fn=route_fn,
                    fleet=sched)
    sim = FleetSim(engines, router, scheduler=sched)
    return sim, sched


def _preseed_snapshots(sched: FleetScheduler, profs: dict, *,
                       host: Optional[str] = None,
                       pager: Optional[Callable] = None) -> None:
    """Seed the pool with restorable snapshots for ``profs`` (first host
    by default): the deterministic stand-in for a previous epoch's
    captures — fairness scenarios start with protected warm state, SLO
    scenarios give the tight tier a restore path from arrival one.
    ``pager`` preseeds content-addressed manifests instead of opaque
    payloads (the dedup family)."""
    h = host if host is not None else sorted(sched.brokers)[0]
    b = sched.brokers[h]
    for name, p in sorted(profs.items()):
        ok = b.snapshot_put(name, units=1, payload=("kv", name),
                            tokens=p.prompt_tokens,
                            nbytes=p.prompt_tokens
                            * ModelReplica.BYTES_PER_TOKEN,
                            tenant=p.tenant,
                            pages=pager(name, p.prompt_tokens, 1)
                            if pager else None)
        assert ok, f"preseed snapshot for {name} did not fit"


# common-prefix KV model for the dedup family: every function's prompt
# opens with the same ``_COMMON_TOK``-token system preamble (two shared
# pages — only the first carries the entry's unit charge, so the page
# sum still equals the manifest's units), and the function-specific tail
# rides a per-profile page with the remaining bytes.  Digests are
# symbolic (content IS identity here), parameterized by the device count
# so a sharded variant never collides with the flat one.
_COMMON_TOK = 6          # <= the smallest profile prompt (html: 8)


def _prefix_pager(prof: str, toks: int, devices: int) -> list:
    assert toks >= _COMMON_TOK, (prof, toks)
    bpt = ModelReplica.BYTES_PER_TOKEN
    half = _COMMON_TOK * bpt // 2
    return [(f"pfx0.d{devices}", devices, half, ("pg", "pfx", 0)),
            (f"pfx1.d{devices}", 0, half, ("pg", "pfx", 1)),
            (f"tail.{prof}", 0, (toks - _COMMON_TOK) * bpt,
             ("pg", "tail", prof))]


# ------------------------------------------------------------ report row
def _p(values: list[float], q: float) -> Optional[float]:
    return round(float(np.percentile(values, q)), 6) if values else None


def _ms(values: list[float], q: float) -> Optional[float]:
    vals = [v * 1e3 for v in values]
    return _p(vals, q)


def _row(name: str, family: str, seed: int, policy: str, sim: FleetSim,
         sched: FleetScheduler, requests: list[Request],
         hedges: int = 0) -> dict[str, Any]:
    m = sim.metrics()
    assert m["truncated"] is False, \
        f"{name}: run exhausted max_ticks with work outstanding"
    samples = [s for e in sim.engines.values() for s in e.ttft_samples]
    waits = [w for e in sim.engines.values() for w in e.admit_waits]

    def path_ms(paths: tuple[str, ...]) -> Optional[float]:
        return _ms([t for p, _, _, t in samples if p in paths], 50)

    tiers = sorted({tier for _, tier, _, _ in samples})
    by_tier = {tier: _ms([t for _, tr, _, t in samples if tr == tier], 99)
               for tier in tiers}
    squeezes: dict[str, int] = {}
    orders = 0
    order_units = 0
    free_end = {}
    device_end = {}
    unique_end = 0
    referenced_end = 0
    # retired hosts leave sched.brokers but their (emptied) brokers stay
    # on the sim — fold them back in so squeeze/order accounting covers
    # the whole run and conservation is visible end-to-end
    brokers = {**getattr(sim, "_brokers", {}), **sched.brokers}
    for h in sorted(brokers):
        b = brokers[h]
        b.check_invariants()       # full structural pass, end of run
        for rec in b.squeeze_log:
            squeezes[rec.tenant] = squeezes.get(rec.tenant, 0) + 1
        orders += len(b.orders)
        order_units += sum(o.units for o in b.orders.values())
        free_end[h] = b.free_units
        device_end[h] = [b.ledger.free_dev(d)
                         for d in range(b.ledger.n_devices)]
        unique_end += b.snapshot_units()
        referenced_end += b.snapshots.referenced_units \
            if b.snapshots is not None else 0
    row = {
        "scenario": name,
        "family": family,
        "seed": seed,
        "policy": policy,
        "hosts": len(brokers),
        "replicas": len(sim.engines),
        "tenants": sorted({tenant_of(r) or "default" for r in requests}),
        "requests": len(requests),
        "completed": m["completed"],
        "killed": m["killed"],
        "warm_ttft_ms": path_ms(("warm",)),
        "restore_ttft_ms": path_ms(("restore", "remote_restore")),
        "cold_ttft_ms": path_ms(("cold",)),
        "ttft_p99_ms_by_tier": by_tier,
        "stall_p99_ms": _ms(waits, 99),
        "warm_starts": m["warm_hits"],
        "restore_starts": m["restore_starts"],
        "remote_restore_starts": m["remote_restore_starts"],
        "cold_starts": m["cold_starts"],
        "squeezes_by_tenant": {t: squeezes[t] for t in sorted(squeezes)},
        "reclaim_orders": orders,
        "order_units": order_units,
        "snapshot_migrations": m["snapshot_migrations"],
        "host_boots": sched.host_boots,
        "host_retires": sched.host_retires,
        "hedges": hedges,
        "routes": {r: m["routed"][r] for r in sorted(m["routed"])},
        "host_seconds": round(sim.virtual_now(), 9),
        "free_units_end": free_end,
        "device_units_end": device_end,
        "unique_snapshot_units": unique_end,
        "dedup_ratio": round(unique_end / referenced_end, 6)
        if referenced_end else 1.0,
        "migrated_snapshot_bytes": sum(r.nbytes for r in sched.migrations),
    }
    assert tuple(row) == ROW_SCHEMA
    return row


# ------------------------------------------------------------- scenarios
def _scn_diurnal(name: str, seed: int, *, n_hosts: int,
                 duration_s: float, rate: float,
                 policy: str = "drain_weighted") -> dict[str, Any]:
    """Two tenants with opposite-phase diurnal load on a shared fleet:
    acme peaks while beta troughs, so the broker keeps re-carving the
    same budget between them (grants out of the trough tenant's released
    rows, squeezes of its expired-warm snapshots down to its
    sub-budget).  The multi-host variant routes by load alone, so a
    tenant's arrivals land on hosts that never captured its snapshots —
    exercising cross-host snapshot migration."""
    tenants = {"acme": 5, "beta": 4}
    profs = {t: _tenant_profiles(t, ("cnn", "html"))
             for t in tenants}
    hosts = {f"h{i}": [(f"h{i}/acme0", 2, "acme", 1.0, 1),
                       (f"h{i}/beta0", 2, "beta", 1.0, 1)]
             for i in range(n_hosts)}
    sim, sched = _build(hosts, budget=9, pool_units=4, tenants=tenants,
                        policy=policy, seed=seed)
    streams = []
    for i, t in enumerate(sorted(tenants)):
        arr = diurnal_trace(duration_s, rate, period_s=duration_s,
                            depth=0.8, phase=i * np.pi, seed=seed,
                            stream=t)
        streams.append((t, assign_profiles(arr, profs[t], seed=seed,
                                           stream=t)))
    reqs = _requests(streams)
    sim.run(list(reqs))
    return _row(name, "diurnal", seed, policy, sim, sched, reqs)


def _scn_fairness(name: str, seed: int, *, duration_s: float,
                  burst_x: float) -> dict[str, Any]:
    """A burst tenant's grants squeeze the pool — but the steady tenant's
    pre-seeded snapshots are protected below its sub-budget, so the
    squeeze log shows the burst tenant eating its OWN cache first and
    only skimming the steady tenant's surplus."""
    tenants = {"steady": 4, "burst": 8}
    steady_profs = _tenant_profiles("steady", ("cnn", "html", "bfs"))
    burst_profs = _tenant_profiles("burst", ("bert",))
    hosts = {"h0": [("h0/steady0", 2, "steady", 1.0, 1),
                    ("h0/burst0", 2, "burst", 1.0, 1),
                    ("h0/burst1", 2, "burst", 1.0, 1)]}
    sim, sched = _build(hosts, budget=12, pool_units=4, tenants=tenants,
                        policy="drain_weighted", seed=seed)
    # steady enters with a full cache (3 entries): its usage (2 granted
    # + 3 snapshot) sits ONE unit above its sub-budget of 4, so exactly
    # one entry is squeeze-eligible and two stay protected
    _preseed_snapshots(sched, steady_profs)
    streams = [
        ("steady", assign_profiles(
            bursty_trace(duration_s, 30.0, burst_x=1.0, seed=seed,
                         stream="steady"),
            steady_profs, seed=seed, stream="steady")),
        ("burst", assign_profiles(
            bursty_trace(duration_s, 30.0, burst_x=burst_x,
                         burst_at=(duration_s * 0.25,),
                         burst_len=duration_s * 0.5, seed=seed,
                         stream="burst"),
            burst_profs, seed=seed, stream="burst")),
    ]
    reqs = _requests(streams)
    sim.run(list(reqs))
    return _row(name, "fairness", seed, "drain_weighted", sim, sched, reqs)


def _scn_slo(name: str, seed: int, *, duration_s: float,
             rate: float) -> dict[str, Any]:
    """Latency-tiered traffic under ``slo_tiered``: the tight tier spends
    warm/snapshot capacity (pre-seeded restore path from arrival one),
    the batch tier routes and starts cold.  The acceptance bar: tight
    TTFT p99 < batch TTFT p99."""
    tight = _tenant_profiles("svc", ("cnn", "html"),
                             tiers={"cnn": "tight", "html": "tight"})
    batch = _tenant_profiles("svc", ("bfs", "bert"),
                             tiers={"bfs": "batch", "bert": "batch"})
    profs = {**tight, **batch}
    hosts = {"h0": [("h0/r0", 3, "svc", 1.0, 1),
                    ("h0/r1", 3, "svc", 1.0, 1),
                    ("h0/r2", 3, "svc", 1.0, 1)]}
    sim, sched = _build(hosts, budget=13, pool_units=4,
                        tenants={"svc": 13}, policy="slo_tiered",
                        seed=seed)
    _preseed_snapshots(sched, tight)
    streams = [("svc", assign_profiles(
        bursty_trace(duration_s, rate, burst_x=1.0, seed=seed,
                     stream="svc"),
        profs, seed=seed, stream="svc"))]
    reqs = _requests(streams)
    sim.run(list(reqs))
    return _row(name, "slo", seed, "slo_tiered", sim, sched, reqs)


def _scn_scaledown(name: str, seed: int) -> dict[str, Any]:
    """Burst -> quiet -> burst on one host: the quiet phase scale-downs
    (keep-alive expiry, snapshot capture, row release), the second burst
    re-grows through grants and reclaim orders against the shrunk fleet."""
    profs = _tenant_profiles("app", ("cnn", "bfs", "html"))
    hosts = {"h0": [("h0/r0", 3, None, 1.0, 1),
                    ("h0/r1", 3, None, 1.0, 1)]}
    sim, sched = _build(hosts, budget=10, pool_units=3,
                        tenants=None, policy="drain_weighted", seed=seed)
    arr = bursty_trace(2.0, 30.0, burst_x=5.0, burst_at=(0.0, 1.25),
                       burst_len=0.35, quiet_after=1.7, seed=seed,
                       stream="app")
    reqs = _requests([("app", assign_profiles(arr, profs, seed=seed,
                                              stream="app"))])
    sim.run(list(reqs))
    return _row(name, "scaledown", seed, "drain_weighted", sim, sched,
                reqs)


def _scn_mesh_reclaim(name: str, seed: int, *,
                      devices: int = 4) -> dict[str, Any]:
    """The scaledown workload on a ``devices``-device host mesh: every
    replica's KV stripes one shard per device, grants/releases are
    balanced unit vectors, reclaim orders drain one unit per shard in
    lockstep (shard-coherent: the requester's claimable stripe grows
    only when the LAST shard lands), and snapshot entries carry one
    fragment per device.  Per-device conservation is checked by the
    ledger after every tick; ``device_units_end`` pins the final
    per-device free vectors in the baseline."""
    profs = _tenant_profiles("app", ("cnn", "bfs", "html"))
    hosts = {"h0": [("h0/r0", 3, None, 1.0, 1),
                    ("h0/r1", 3, None, 1.0, 1)]}
    sim, sched = _build(hosts, budget=10, pool_units=3,
                        tenants=None, policy="drain_weighted", seed=seed,
                        devices=devices)
    arr = bursty_trace(2.0, 30.0, burst_x=5.0, burst_at=(0.0, 1.25),
                       burst_len=0.35, quiet_after=1.7, seed=seed,
                       stream="app")
    reqs = _requests([("app", assign_profiles(arr, profs, seed=seed,
                                              stream="app"))])
    sim.run(list(reqs))
    return _row(name, "mesh", seed, "drain_weighted", sim, sched, reqs)


def _scn_dedup(name: str, seed: int, *, paged: bool, duration_s: float,
               rate: float) -> dict[str, Any]:
    """Two tenants' function sets all sharing the ``_prefix_pager``
    common preamble, on two hosts with load-only routing (so arrivals
    keep landing on hosts that never captured the snapshot — exercising
    cross-host migration).  ``paged=True`` stores content-addressed
    manifests: the pools charge each shared prefix page ONCE (unique
    units well below the referenced total, cross-tenant — the first
    dropped owner reattributes, never strands, its charge) and a
    migration moves only pages the destination store lacks.
    ``paged=False`` is the duplicated baseline the acceptance criteria
    compare against: same trace, every entry opaque and full-price."""
    tenants = {"acme": 5, "beta": 4}
    profs = {t: _tenant_profiles(t, ("cnn", "html")) for t in tenants}
    hosts = {f"h{i}": [(f"h{i}/acme0", 2, "acme", 1.0, 1),
                       (f"h{i}/beta0", 2, "beta", 1.0, 1)]
             for i in range(2)}
    pager = _prefix_pager if paged else None
    sim, sched = _build(hosts, budget=9, pool_units=4, tenants=tenants,
                        policy="least_loaded", seed=seed, pager=pager)
    allp: dict[str, FunctionProfile] = {}
    for t in sorted(profs):
        allp.update(profs[t])
    _preseed_snapshots(sched, allp, pager=pager)
    streams = []
    for i, t in enumerate(sorted(tenants)):
        arr = diurnal_trace(duration_s, rate, period_s=duration_s,
                            depth=0.8, phase=i * np.pi, seed=seed,
                            stream=t)
        streams.append((t, assign_profiles(arr, profs[t], seed=seed,
                                           stream=t)))
    reqs = _requests(streams)
    sim.run(list(reqs))
    return _row(name, "dedup", seed, "least_loaded", sim, sched, reqs)


def _scn_hedged(name: str, seed: int) -> dict[str, Any]:
    """Two hosts, one a straggler (every virtual cost x40): hedged
    dispatch predicts the primary misses the deadline and fires the
    backup on the OTHER host — each request still runs on exactly one
    replica, so exactly one result is charged."""
    profs = _tenant_profiles("app", ("cnn", "html"))
    hosts = {"hA": [("hA/r0", 3, None, 40.0, 1)],      # the straggler
             "hB": [("hB/r0", 3, None, 1.0, 1)]}
    policy = HedgedRoutePolicy(deadline_s=0.02)
    sim, sched = _build(hosts, budget=8, pool_units=2, tenants=None,
                        seed=seed, route_fn=policy)
    arr = bursty_trace(0.5, 60.0, burst_x=2.0, seed=seed, stream="app")
    reqs = _requests([("app", assign_profiles(arr, profs, seed=seed,
                                              stream="app"))])
    sim.run(list(reqs))
    row = _row(name, "hedge", seed, "hedged", sim, sched, reqs,
               hedges=policy.hedges)
    return row


def _replica_factory(*, budget: int, pool_units: int, units: int,
                     min_rows: int = 1,
                     tenants: Optional[dict[str, int]] = None,
                     tenant: Optional[str] = None) -> Callable:
    """Host factory for the autoscaler: a fresh async broker with the
    same budget/pool shape as the starting fleet, one replica registered
    at construction.  ``clock`` is a frozen zero until the sim re-stamps
    it with the host's virtual timebase — a boot never reads wall time,
    so autoscaled runs stay bit-deterministic."""
    def factory(host_id: str):
        b = HostMemoryBroker(budget, async_reclaim=True,
                             snapshot_pool_units=pool_units,
                             tenants=dict(tenants) if tenants else None,
                             clock=lambda: 0.0)
        rid = f"{host_id}/r0"
        return b, {rid: ModelReplica(rid, b, host_id, units=units,
                                     min_rows=min_rows, tenant=tenant)}
    return factory


def _scn_autoscale(name: str, seed: int, *, duration_s: float,
                   rate: float, burst_x: float, low_water: int,
                   high_water: int, quiet_ticks: int,
                   max_hosts: int) -> dict[str, Any]:
    """One starting host under a burst: grant demand eats the fleet's
    free-unit slack through the low-water mark, so the autoscaler boots
    hosts (up to ``max_hosts``); the quiet tail releases rows back,
    slack holds at/above the high-water mark for a sustained streak,
    and the emptiest host retires — draining its captured snapshots to
    the survivors over the contended interconnect."""
    profs = _tenant_profiles("app", ("cnn", "html"))
    hosts = {"h0": [("h0/r0", 2, None, 1.0, 1)]}
    sim, sched = _build(hosts, budget=8, pool_units=3, tenants=None,
                        policy="drain_weighted", seed=seed)
    sim.set_autoscaler(
        AutoscalePolicy(low_water=low_water, high_water=high_water,
                        quiet_ticks=quiet_ticks, min_hosts=1,
                        max_hosts=max_hosts),
        _replica_factory(budget=8, pool_units=3, units=2))
    arr = bursty_trace(duration_s, rate, burst_x=burst_x,
                       burst_at=(duration_s * 0.1,),
                       burst_len=duration_s * 0.4,
                       quiet_after=duration_s * 0.7, seed=seed,
                       stream="app")
    reqs = _requests([("app", assign_profiles(arr, profs, seed=seed,
                                              stream="app"))])
    sim.run(list(reqs))
    assert sched.host_boots >= 1, \
        f"{name}: the burst never tripped the low-water mark"
    return _row(name, "autoscale", seed, "drain_weighted", sim, sched,
                reqs)


def _scn_retire_drain(name: str, seed: int) -> dict[str, Any]:
    """Drain-via-migration, deterministic by construction: every request
    is pinned to h0 (whose replica holds 6 of 10 rows, so h0's free
    units can never exceed 4), while idle h1 sits at a constant 6 free
    units with two preseeded restorable snapshots the trace never
    requests.  The quiet streak is therefore always accumulating, h1 is
    PROVABLY the emptiest host when it trips, and h0 is guaranteed room
    (>= 2 free units, pool 2 captures + 2 migrations <= cap 4).
    Acceptance: h1 retires mid-run, every restorable entry it held
    lands on h0 (migrated, NOT discarded), and per-host conservation
    holds after every lifecycle event."""
    tenants = {"app": 10}
    profs = _tenant_profiles("app", ("cnn", "html"))
    # preseed-only keys: profiles the trace never requests, so they sit
    # untouched in h1's pool until the drain moves them
    cold = _tenant_profiles("app", ("bfs", "bert"))
    hosts = {"h0": [("h0/r0", 6, "app", 1.0, 6)],   # 6 pinned rows
             "h1": [("h1/r0", 2, "app", 1.0, 1)]}
    sim, sched = _build(hosts, budget=10, pool_units=4, tenants=tenants,
                        policy="drain_weighted", seed=seed,
                        route_fn=lambda req, engines: "h0/r0")
    _preseed_snapshots(sched, cold, host="h1")
    sim.set_autoscaler(
        # low_water=0: slack can never go negative, so no boots — this
        # scenario isolates the retire/drain half of the lifecycle;
        # slack = h0 (2..4) + h1 (6) >= high_water always, so the streak
        # trips at exactly eval ``quiet_ticks``
        AutoscalePolicy(low_water=0, high_water=8, quiet_ticks=60,
                        min_hosts=1, max_hosts=2),
        _replica_factory(budget=10, pool_units=4, units=2,
                         tenants=tenants, tenant="app"))
    arr = bursty_trace(0.6, 50.0, burst_x=3.0, burst_at=(0.05,),
                       burst_len=0.2, seed=seed, stream="app")
    reqs = _requests([("app", assign_profiles(arr, profs, seed=seed,
                                              stream="app"))])
    sim.run(list(reqs))
    assert sched.host_retires == 1 and "h1" in sched.retired, \
        f"{name}: h1 did not retire (retired={sorted(sched.retired)})"
    assert sched.drain_discarded == 0, \
        f"{name}: drain discarded {sched.drain_discarded} snapshots"
    for key in sorted(cold):
        assert sched.brokers["h0"].snapshot_restorable(key), \
            f"{name}: preseeded snapshot {key!r} was not migrated to h0"
    return _row(name, "autoscale", seed, "pinned", sim, sched, reqs)


# ------------------------------------------------------------- registry
SCENARIOS: dict[str, tuple[str, Callable[[int], dict[str, Any]]]] = {
    "diurnal_smoke": ("diurnal", lambda s: _scn_diurnal(
        "diurnal_smoke", s, n_hosts=1, duration_s=0.5, rate=80.0)),
    "diurnal_mix": ("diurnal", lambda s: _scn_diurnal(
        "diurnal_mix", s, n_hosts=2, duration_s=1.0, rate=120.0,
        policy="least_loaded")),
    "fairness_smoke": ("fairness", lambda s: _scn_fairness(
        "fairness_smoke", s, duration_s=0.5, burst_x=4.0)),
    "fairness_burst": ("fairness", lambda s: _scn_fairness(
        "fairness_burst", s, duration_s=1.25, burst_x=6.0)),
    "slo_smoke": ("slo", lambda s: _scn_slo(
        "slo_smoke", s, duration_s=0.5, rate=100.0)),
    "slo_tiered": ("slo", lambda s: _scn_slo(
        "slo_tiered", s, duration_s=1.5, rate=150.0)),
    "scaledown_burst": ("scaledown", lambda s: _scn_scaledown(
        "scaledown_burst", s)),
    "hedged_fleet": ("hedge", lambda s: _scn_hedged("hedged_fleet", s)),
    "mesh_reclaim": ("mesh", lambda s: _scn_mesh_reclaim(
        "mesh_reclaim", s)),
    "autoscale_smoke": ("autoscale", lambda s: _scn_autoscale(
        "autoscale_smoke", s, duration_s=0.8, rate=100.0, burst_x=5.0,
        low_water=4, high_water=12, quiet_ticks=60, max_hosts=3)),
    "autoscale_burst": ("autoscale", lambda s: _scn_autoscale(
        "autoscale_burst", s, duration_s=1.5, rate=140.0, burst_x=6.0,
        low_water=4, high_water=12, quiet_ticks=60, max_hosts=3)),
    "retire_drain": ("autoscale", lambda s: _scn_retire_drain(
        "retire_drain", s)),
    "dedup_prefix": ("dedup", lambda s: _scn_dedup(
        "dedup_prefix", s, paged=True, duration_s=0.8, rate=100.0)),
    "dedup_baseline": ("dedup", lambda s: _scn_dedup(
        "dedup_baseline", s, paged=False, duration_s=0.8, rate=100.0)),
}

# the smallest scenario per family — the CI fast tier's smoke set
SMOKE = ("diurnal_smoke", "fairness_smoke", "slo_smoke",
         "scaledown_burst", "hedged_fleet", "mesh_reclaim",
         "autoscale_smoke", "dedup_prefix")


def run_scenario(name: str, seed: int = 0) -> dict[str, Any]:
    """Run one bank entry; the returned row carries exactly
    ``ROW_SCHEMA``'s keys and is bit-identical for a fixed seed."""
    assert name in SCENARIOS, \
        f"unknown scenario {name!r} (have {sorted(SCENARIOS)})"
    family, fn = SCENARIOS[name]
    row = fn(seed)
    assert tuple(row) == ROW_SCHEMA and row["family"] == family
    return row


def run_bank(names: Optional[list[str]] = None, seed: int = 0
             ) -> dict[str, dict[str, Any]]:
    """Run (a subset of) the bank; rows keyed by scenario name."""
    return {n: run_scenario(n, seed) for n in (names or sorted(SCENARIOS))}
