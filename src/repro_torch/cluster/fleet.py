"""Fleet layer: N hosts, one scheduler — placement + warm-state migration.

One ``HostMemoryBroker`` arbitrates ONE host's budget; the fleet
scheduler is the level above (the ROADMAP's multi-host item): it owns a
broker per host, places replicas onto hosts, and moves warm-restart
state *between* hosts, TrEnv-X-style — a host that never ran a function
can still restore its prefix KV from a peer's snapshot pool instead of
paying a cold prefill.

Placement (``place``) is capacity-driven and deterministic:

  * ``spread`` — put the replica on the host with the most reclaimable
    capacity (free pool + droppable snapshot charge); classic load
    spreading, maximizes per-host slack.
  * ``pack``   — best-fit: the fitting host with the LEAST capacity, so
    big contiguous budgets stay available for later replicas.

Ties break on host id; a replica that fits nowhere is a placement error
(the caller sees it immediately, not as a later register failure).

Cross-host snapshot migration (``ensure_local`` / ``migrate_snapshot``):
when the destination host lacks a restorable snapshot for a function but
a peer holds one, the scheduler debits the peer's pool (its ledger
credits the units back to its free pool), charges a modeled inter-host
copy — REAL payload bytes over a configurable ``bandwidth_bytes_per_s``
plus a fixed ``link_latency_s`` — and credits the destination pool.
Content-addressed entries migrate dedup-aware: only pages the
destination's ``PageStore`` LACKS cross the wire (a manifest whose pages
the destination already holds moves metadata only), so migration bytes
shrink with fleet-wide prefix sharing while the contention model is
unchanged.  The
copy wall rides the migrated ``Snapshot`` (``copy_seconds``) and is paid
by the first restore that uses it (``ServeEngine._start_restore`` tags
that event ``source="remote"``), so a remote restore lands strictly
between a local restore and a cold prefill.  Unit conservation stays
per-host throughout: a migration is ``snapshot_drop`` on the source
ledger and ``snapshot_put`` on the destination ledger — units never
teleport between budgets, and ``check_invariants`` proves every host's
``free + granted + escrow + snapshot == budget`` after every fleet
event.

A migration is refused (returns ``None``, nothing mutated) when no peer
holds a restorable copy or the destination pool has no room — the
destination then simply cold-starts, exactly as before the fleet
existed.

Interconnect model: transfers CONTEND.  The scheduler tracks in-flight
migrations (each occupies its endpoints' NICs until its modeled end
time); a new transfer's byte wall is ``nbytes / (bandwidth / (1 + n))``
where ``n`` counts in-flight transfers sharing either endpoint — so a
retirement stampede out of one host slows itself down instead of
teleporting N snapshots over one pipe at full rate.  The fixed per-
fragment ``link_latency_s`` is propagation, not bandwidth, and does not
contend.  ``migration_budget_bytes`` additionally caps the *drain*
(scale-down) bytes in flight at once: a drain migration over budget is
deferred (retried at the next retirement pump), while foreground
``ensure_local`` restores are never deferred — scale-down traffic can
slow them (shared NIC) but never starve them behind an unbounded queue.

Host lifecycle (the autoscaling substrate): ``boot_host`` adds a host;
``retire_host`` / ``begin_retire`` mark one retiring — it stops
accepting placements (``place`` skips it; the router masks its
replicas) — then ``drain_host`` hands its restorable snapshot-pool
entries to peers via the SAME ``migrate_snapshot`` path (TrEnv-X:
retiring nodes share execution state instead of discarding it), and
``finish_retire`` removes the host only once its ledger shows
``free == budget``.  Per-host conservation is re-proved after every
lifecycle event.

``FleetSim`` (``repro_torch.cluster.sim``) drives N hosts of engines on one
deterministic virtual timebase, calls ``ensure_local`` as arrivals are
routed, and — given an ``AutoscalePolicy`` — boots and retires hosts
from the run loop; ``Router``'s ``drain_weighted`` policy consumes the
fleet view (``host_of`` / ``snapshot_host`` / ``open_order_units``) for
its placement tiers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from repro_torch.cluster.host import HostMemoryBroker

PLACEMENTS = ("spread", "pack")


@dataclasses.dataclass
class MigrationRecord:
    """One cross-host snapshot migration: ``key``'s warm state moved from
    ``src`` to ``dst``, paying a modeled ``copy_seconds`` transfer for
    ``nbytes`` bytes ACTUALLY moved — for a content-addressed entry only
    the pages the destination lacked, which may be far below the entry's
    full payload size (and zero for a fully-shared manifest)."""
    key: str
    src: str
    dst: str
    units: int
    nbytes: int
    copy_seconds: float
    at: float                    # fleet-clock timestamp


@dataclasses.dataclass
class _Transfer:
    """An in-flight interconnect transfer: occupies its endpoints' NICs
    until ``end`` (fleet clock), contending with overlapping transfers."""
    src: str
    dst: str
    end: float
    nbytes: int
    drain: bool                  # scale-down traffic (budget-capped)


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """Deterministic threshold autoscaler (the paper's Fig. 8 trigger,
    driven from ``FleetSim.run``): boot a host when the active fleet's
    free-unit slack drops below ``low_water``; after ``quiet_ticks``
    consecutive evaluations with slack at/above ``high_water``, begin
    retiring the emptiest host (most free units).  ``min_hosts`` /
    ``max_hosts`` bound the fleet size.

    ``boot_latency_s`` models real provisioning lag: a booted host joins
    the fleet immediately (its capacity is visible, so the trigger does
    not re-fire every tick while one is already coming up) but becomes
    ROUTABLE only after the latency elapses on the fleet clock — which
    makes ``low_water`` a real tuning knob: the margin must cover the
    demand that arrives while the new host is still booting."""
    low_water: int
    high_water: int
    quiet_ticks: int
    min_hosts: int = 1
    max_hosts: int = 8
    boot_latency_s: float = 0.0

    def __post_init__(self):
        assert 0 <= self.low_water <= self.high_water
        assert self.quiet_ticks > 0
        assert 1 <= self.min_hosts <= self.max_hosts
        assert self.boot_latency_s >= 0.0


class FleetScheduler:
    """Owns one ``HostMemoryBroker`` per host: places replicas, serves
    the fleet-wide snapshot view, and migrates warm state across hosts."""

    def __init__(self, *, bandwidth_bytes_per_s: float = float(1 << 30),
                 link_latency_s: float = 5e-4,
                 migration_budget_bytes: Optional[float] = None,
                 clock: Optional[Callable[[], float]] = None):
        assert bandwidth_bytes_per_s > 0 and link_latency_s >= 0
        assert migration_budget_bytes is None or migration_budget_bytes > 0
        self.bandwidth_bytes_per_s = bandwidth_bytes_per_s
        self.link_latency_s = link_latency_s
        self.migration_budget_bytes = migration_budget_bytes
        self._clock = clock if clock is not None else (lambda: 0.0)
        self.brokers: dict[str, HostMemoryBroker] = {}
        self.placements: dict[str, str] = {}     # replica -> host
        self.migrations: list[MigrationRecord] = []
        self.migration_denied = 0    # no source / no room at destination
        self.migration_deferred = 0  # drain over migration budget: retried
        self._inflight: list[_Transfer] = []
        # host lifecycle: retiring hosts accept no placements and drain
        # their pools to peers; retired ids stay known so stale
        # placements remain resolvable (their replicas were decommissioned)
        self.retiring: set[str] = set()
        self.retired: set[str] = set()
        # hosts still provisioning: routable only once the fleet clock
        # passes their ready time (they DO count toward capacity/slack,
        # so the autoscale trigger does not stampede while one boots)
        self._ready_at: dict[str, float] = {}
        self.host_boots = 0
        self.host_retires = 0
        self.drain_discarded = 0     # pool entries dropped, not migrated

    def set_clock(self, clock: Callable[[], float]) -> None:
        """Inject the fleet's deterministic timebase (``FleetSim`` passes
        the sum of every host's virtual clock)."""
        self._clock = clock

    # ------------------------------------------------------------ topology
    def add_host(self, host_id: str, broker: HostMemoryBroker) -> None:
        assert host_id not in self.brokers, host_id
        assert host_id not in self.retired, \
            f"host id {host_id} was retired; ids are never reused"
        self.brokers[host_id] = broker

    def host_of(self, replica_id: str) -> Optional[str]:
        return self.placements.get(replica_id)

    def broker_of(self, replica_id: str) -> Optional[HostMemoryBroker]:
        host = self.placements.get(replica_id)
        return self.brokers.get(host) if host is not None else None

    def active_hosts(self) -> list[str]:
        """Hosts currently accepting placements (not retiring), sorted."""
        return sorted(h for h in self.brokers if h not in self.retiring)

    # ----------------------------------------------------------- placement
    def capacity(self, host_id: str, *, tenant: Optional[str] = None) -> int:
        """Units a new ``tenant`` replica could claim without disturbing
        any VM: the free pool plus the snapshot charge a boot-time
        squeeze could ACTUALLY drop.  The probe walks the pool with the
        tenant-fairness rule (another tenant's entries count only down
        to its sub-budget), so ``place`` never promises capacity that
        ``register`` then fails to deliver — summing the whole pool
        charge here was exactly that bug."""
        b = self.brokers[host_id]
        return b.free_units + b.squeezable_snapshot_units(tenant)

    def place(self, replica_id: str, units: int, *,
              policy: str = "spread", tenant: Optional[str] = None) -> str:
        """Pick the host for a new ``units``-block replica and record the
        placement.  The caller then boots the engine against that host's
        broker (which registers it).  Retiring hosts accept no
        placements; ``tenant`` scopes the capacity probe to what that
        tenant's boot squeeze may drop."""
        assert policy in PLACEMENTS, policy
        assert replica_id not in self.placements, replica_id
        fits = [h for h in self.active_hosts()
                if self.capacity(h, tenant=tenant) >= units]
        assert fits, \
            f"no host can fit {units} units for {replica_id}: " \
            f"capacities " \
            f"{({h: self.capacity(h, tenant=tenant) for h in self.active_hosts()})}"
        if policy == "spread":
            host = min(fits, key=lambda h: (-self.capacity(h, tenant=tenant),
                                            h))
        else:                                    # pack: best fit
            host = min(fits, key=lambda h: (self.capacity(h, tenant=tenant),
                                            h))
        self.placements[replica_id] = host
        return host

    # ------------------------------------------------------ host lifecycle
    def boot_host(self, host_id: str, broker: HostMemoryBroker, *,
                  ready_delay: float = 0.0) -> None:
        """Scale-up: add a freshly provisioned host to the fleet.  With
        ``ready_delay`` the host is booked (capacity visible, placements
        allowed) but not ROUTABLE until the fleet clock advances past
        ``now + ready_delay`` — the router masks its replicas until
        then, modeling real provisioning latency."""
        assert ready_delay >= 0.0, ready_delay
        self.add_host(host_id, broker)
        if ready_delay > 0.0:
            self._ready_at[host_id] = self._clock() + ready_delay
        self.host_boots += 1
        self.check_invariants()

    def host_ready(self, host_id: str) -> bool:
        """Has ``host_id`` finished provisioning (routable)?  Hosts
        booted without a delay are ready immediately."""
        at = self._ready_at.get(host_id)
        if at is None:
            return True
        if self._clock() >= at:
            del self._ready_at[host_id]          # provisioning complete
            return True
        return False

    def begin_retire(self, host_id: str) -> None:
        """Mark ``host_id`` retiring: it stops accepting placements (and
        the router masks its replicas), but keeps serving what it has
        until drained."""
        assert host_id in self.brokers, host_id
        self.retiring.add(host_id)

    def drain_host(self, host_id: str, *, force: bool = False
                   ) -> dict[str, int]:
        """One retirement pump: hand the retiring host's snapshot pool to
        peers via ``migrate_snapshot``.  Restorable entries go to the
        non-retiring peer with the most free units that has room;
        metadata-only entries (restorable nowhere) are dropped.  A
        restorable entry with no peer room — or over the drain budget —
        is left for the next pump, unless ``force`` (the end-of-run
        finalization: no foreground traffic remains to protect, so the
        budget is ignored and roomless entries are dropped rather than
        stranding the retirement)."""
        assert host_id in self.retiring, host_id
        b = self.brokers[host_id]
        stats = {"migrated": 0, "deferred": 0, "discarded": 0}
        if b.snapshots is None:
            return stats
        for key in list(b.snapshots.keys()):     # LRU -> MRU
            snap = b.snapshots.peek(key)
            specs = b.snapshot_page_specs(key)   # None for legacy entries
            dst = None
            if snap.restorable:
                for h in sorted((h for h in self.brokers
                                 if h != host_id and h not in self.retiring),
                                key=lambda h: (-self.brokers[h].free_units,
                                               h)):
                    if self.brokers[h].snapshot_room(key, snap.units,
                                                     tenant=snap.tenant,
                                                     pages=specs):
                        dst = h
                        break
                if dst is None and not force:
                    stats["deferred"] += 1       # room may yet appear
                    continue
            if dst is None:
                b.snapshot_drop(key)
                self.drain_discarded += 1
                stats["discarded"] += 1
                continue
            rec = self.migrate_snapshot(key, dst, src_host=host_id,
                                        drain=not force)
            if rec is None:                      # over the drain budget:
                stats["deferred"] += 1           # retried next pump
            else:
                stats["migrated"] += 1
        self.check_invariants()
        return stats

    def finish_retire(self, host_id: str) -> bool:
        """Complete a retirement — only once the host's ledger shows
        ``free == budget`` (nothing granted, escrowed, or pooled).  The
        id moves to ``retired`` so stale placements of decommissioned
        replicas stay resolvable (to "a host that no longer exists")."""
        assert host_id in self.retiring, host_id
        b = self.brokers[host_id]
        if b.free_units != b.budget_units:
            return False
        b.check_invariants()
        del self.brokers[host_id]
        self._ready_at.pop(host_id, None)
        self.retiring.discard(host_id)
        self.retired.add(host_id)
        self.host_retires += 1
        self.check_invariants()
        return True

    def retire_host(self, host_id: str, *, force: bool = False) -> bool:
        """Scripted retirement: mark retiring, drain the pool, and remove
        the host if its ledger is already clean (no replicas registered).
        Returns True when the host is gone; False leaves it retiring for
        further pumps (``drain_host`` / ``finish_retire``) — e.g. its
        replicas must be decommissioned (``HostMemoryBroker.deregister``)
        first."""
        if host_id not in self.retiring:
            self.begin_retire(host_id)
        self.drain_host(host_id, force=force)
        return self.finish_retire(host_id)

    # -------------------------------------------------- fleet-wide signals
    def open_order_units(self, replica_id: str) -> int:
        """Blocks ``replica_id`` owes its host's open reclaim orders (the
        router's drain-awareness signal, lifted fleet-wide)."""
        b = self.broker_of(replica_id)
        return b.open_order_units(replica_id) if b is not None else 0

    def snapshot_host(self, key: str, *,
                      exclude: Optional[str] = None) -> Optional[str]:
        """First host (by id — deterministic) whose pool holds a
        RESTORABLE snapshot for ``key``; ``exclude`` skips the would-be
        destination when scouting migration sources."""
        for h in sorted(self.brokers):
            if h != exclude and self.brokers[h].snapshot_restorable(key):
                return h
        return None

    # ----------------------------------------------------------- migration
    def ensure_local(self, key: str, dst_host: str
                     ) -> Optional[MigrationRecord]:
        """Make ``key`` restorable on ``dst_host`` if any peer can supply
        it: a no-op when the destination already holds a restorable copy,
        a cross-host migration otherwise.  Returns the migration record,
        or ``None`` when nothing moved."""
        dst = self.brokers[dst_host]
        if dst.snapshot_restorable(key):
            return None
        return self.migrate_snapshot(key, dst_host)

    def _contenders(self, src_host: str, dst_host: str, now: float) -> int:
        """Prune finished transfers, then count in-flight ones sharing
        either endpoint's NIC with a new ``src -> dst`` transfer."""
        self._inflight = [t for t in self._inflight if t.end > now]
        ends = (src_host, dst_host)
        return sum(1 for t in self._inflight
                   if t.src in ends or t.dst in ends)

    def _drain_bytes_inflight(self, now: float) -> int:
        self._inflight = [t for t in self._inflight if t.end > now]
        return sum(t.nbytes for t in self._inflight if t.drain)

    def migrate_snapshot(self, key: str, dst_host: str, *,
                         src_host: Optional[str] = None,
                         drain: bool = False) -> Optional[MigrationRecord]:
        """Move ``key``'s snapshot from whichever peer holds it (or the
        explicit ``src_host``) to ``dst_host``: debit the source pool,
        model the inter-host copy (real bytes over the CONTENDED pipe +
        link latency), credit the destination pool.  Per-host
        conservation holds on both ledgers; the copy wall is owed by the
        migrated entry until its first restore claims it.

        ``drain`` marks scale-down traffic: it is deferred (returns
        ``None``, counted ``migration_deferred``) whenever committing it
        would push the in-flight drain bytes over
        ``migration_budget_bytes`` — foreground restores never are."""
        if src_host is None:
            src_host = self.snapshot_host(key, exclude=dst_host)
        if src_host is None:
            self.migration_denied += 1
            return None
        src, dst = self.brokers[src_host], self.brokers[dst_host]
        assert src_host != dst_host and src.snapshot_restorable(key), \
            (key, src_host, dst_host)
        snap = src.snapshots.peek(key)
        specs = src.snapshot_page_specs(key)     # None for legacy entries
        # the entry keeps its owner tenant across hosts: the destination
        # charges its ledger on the SAME tenant's sub-budget account
        if not dst.snapshot_room(key, snap.units, tenant=snap.tenant,
                                 pages=specs):
            self.migration_denied += 1           # destination under
            return None                          # pressure: cold-start
        units, nbytes = snap.units, snap.nbytes
        payload, tokens = snap.payload, snap.tokens
        fragments = snap.fragments
        # dedup-aware transfer sizing: only pages the destination store
        # LACKS cross the wire — a manifest the destination already
        # fully holds moves metadata only (zero bytes, zero hops).
        # Legacy opaque entries move their whole payload.
        if specs is not None:
            size = {d: b for d, _u, b, _p in specs}
            missing = dst.missing_pages(list(size))
            moved_nbytes = sum(size[d] for d in missing)
            n_xfer = len(missing)
        else:
            moved_nbytes = nbytes
            n_xfer = len(fragments) if fragments is not None else 1
        now = self._clock()                      # read ONCE per migration
        if drain and self.migration_budget_bytes is not None \
                and self._drain_bytes_inflight(now) + moved_nbytes \
                > self.migration_budget_bytes:
            self.migration_deferred += 1
            return None
        # any transfer wall the source itself still owed compounds: a
        # twice-migrated snapshot pays both hops at its first restore.
        # Sharded entries move one fragment per device and paged entries
        # one transfer per MISSING page — each is its own transfer, so
        # the fixed link latency (propagation: it does not contend) is
        # paid per transfer while the byte wall is the moved payload
        # over THIS transfer's share of the pipe: in-flight transfers
        # touching either endpoint split the NIC, so n concurrent
        # migrations out of one retiring host each see
        # bandwidth / (1 + n_others) (unsharded legacy entries are the
        # 1-transfer case; an uncontended transfer is the legacy model
        # bit-for-bit).
        share = self.bandwidth_bytes_per_s \
            / (1 + self._contenders(src_host, dst_host, now))
        hop_s = n_xfer * self.link_latency_s + moved_nbytes / share
        copy_s = snap.copy_seconds + hop_s
        if moved_nbytes > 0:
            self._inflight.append(_Transfer(src=src_host, dst=dst_host,
                                            end=now + hop_s,
                                            nbytes=moved_nbytes,
                                            drain=drain))
        src.snapshot_drop(key)                   # debit: src ledger credits
        ok = dst.snapshot_put(key, units=units, payload=payload,
                              tokens=tokens, nbytes=nbytes,
                              replica_id=snap.replica_id,
                              origin_host=src_host, copy_seconds=copy_s,
                              tenant=snap.tenant, fragments=fragments,
                              pages=specs)
        assert ok, "room check promised space at the destination"
        rec = MigrationRecord(key=key, src=src_host, dst=dst_host,
                              units=units, nbytes=moved_nbytes,
                              copy_seconds=copy_s, at=now)
        self.migrations.append(rec)
        return rec

    # -------------------------------------------------------------- report
    def report(self) -> dict[str, Any]:
        return {
            "hosts": {h: b.report() for h, b in self.brokers.items()},
            "placements": dict(self.placements),
            "migrations": len(self.migrations),
            "migrated_snapshot_bytes": sum(r.nbytes
                                           for r in self.migrations),
            "migration_copy_seconds": sum(r.copy_seconds
                                          for r in self.migrations),
            "migration_denied": self.migration_denied,
            "migration_deferred": self.migration_deferred,
            "retiring": sorted(self.retiring),
            "retired": sorted(self.retired),
            "booting": sorted(self._ready_at),
            "host_boots": self.host_boots,
            "host_retires": self.host_retires,
            "drain_discarded": self.drain_discarded,
        }

    # ---------------------------------------------------------- invariants
    def check_invariants(self) -> None:
        """Per-host conservation, fleet-wide: every host's ledger law
        (and order/grant/pool cross-checks) after any fleet event —
        including every lifecycle event (boot / drain pump / removal)."""
        for b in self.brokers.values():
            b.check_invariants()
        assert self.retiring <= set(self.brokers), \
            (self.retiring, sorted(self.brokers))
        assert set(self._ready_at) <= set(self.brokers), \
            (sorted(self._ready_at), sorted(self.brokers))
        assert not self.retired & set(self.brokers)
        for rid, host in self.placements.items():
            # a decommissioned replica's placement survives its host
            # (resolvable to "retired"), so stale ids never dangle
            assert host in self.brokers or host in self.retired, (rid, host)
