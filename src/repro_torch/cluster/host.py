"""Host memory broker: the hypervisor/virtio-mem role of the paper, §2+§4.

One physical host runs N VM-sandboxed replicas (each a ``ServeEngine``) and
owns a fixed budget of memory units.  The broker is the host-side control
plane that arbitrates that budget; its verbs map onto the paper's terms:

  broker verb               paper mechanism
  -----------------------   --------------------------------------------
  ``register``              VM boot: the guest's initial memory plug
  ``request_grant``         virtio-mem **plug** request (guest asks the
                            hypervisor for more memory blocks); returns a
                            ``Grant`` — immediately-filled pool units plus
                            a *pending* remainder fed by reclaim orders
  ``release_units``         virtio-mem **unplug** completion (guest hands
                            reclaimed blocks back to the host)
  ``ReclaimOrder``          host memory pressure, asynchronously: the
                            hypervisor *asks* the idlest VMs to shrink
                            (Squeezy's sub-second reclaim is what makes
                            draining an order between decode steps cheap)
  ``fulfill_order``         a victim's partial unplug against its order;
                            the freed units land in the grant's escrow
  ``claim_grant``           the requester absorbs escrowed units at its
                            next tick (grant completion)
  unit (= one block)        a Linux 128 MiB memory block — here one
                            ``block_tokens`` slab of arena state

Grant / ReclaimOrder lifecycle (async mode)::

    requester                broker                    victim
    ---------                ------                    ------
    request_grant(want) ->   grant from free pool
                             issue ReclaimOrder(s) --> order_sink(order)
    <- Grant(granted,                                  ... decodes ...
             pending)                                  partial unplug
    ... decodes ...          fulfill_order(k)      <-- (tick boundary)
                             pending -= k
                             available += k  (escrow)
    claim_grant() ------->   available -> granted
    absorb rows              ...                       ... drains rest ...
                             (victim finishing naturally routes its
                              release_units into the open order instead
                              of the free pool — no double release; an
                              unfulfillable remainder is cancel_order'd)

In sync mode (``async_reclaim=False``, the pre-async behavior kept for the
benchmark contrast) ``request_grant`` runs the victims' reclaim callbacks
inline and reports the victim-side wall it serialized behind as
``Grant.stall_seconds`` — the requester-visible stall the async path
eliminates.

A unit is a *block* (``ArenaSpec.block_tokens`` worth of state), the finest
granularity both managers share; HotMem replicas convert partitions to
blocks at the boundary (1 partition = ``blocks_per_partition`` units).

Conservation invariant (the test suite's anchor): at all times
``free_units + sum(granted.values()) + escrow + snapshot_units ==
budget_units`` where ``escrow`` is the pending-delivery pool (units victims
already drained into open grants that their requesters have not claimed
yet) and ``snapshot_units`` is the host snapshot pool's charge (persisted
warm-restart state, see ``repro_torch.cluster.snapshots``) — the host never
double-grants a unit and never leaks one, even mid-order.  All four
accounts live in a per-host ``BudgetLedger`` (``repro_torch.cluster.ledger``):
every unit flow is a ledger verb and the invariant is checked by that one
code path, so the fleet layer (``repro_torch.cluster.fleet``) can run N hosts
and assert per-host conservation after every fleet event — including
cross-host snapshot migrations — without re-deriving the law anywhere.

Sharded hosts (``topology=DeviceTopology(...)``, devices > 1): the ledger
keeps one account column per device and every balanced flow stripes over
the mesh; ``ReclaimOrder``s become **shard-coherent** — a victim's shards
drain in lockstep, per-shard fills sit in ``Grant.incoherent`` escrow
until every sibling shard catches up, and only coherent stripes are ever
claimable.  ``devices=1`` is bit-identical to the pre-topology broker.

Snapshot-squeeze-first reclaim rule: when a plug request outruns the free
pool, the broker first drops LRU snapshots (``_squeeze_snapshots`` —
metadata-only, zero migration, zero victim involvement) and only covers
the *remaining* deficit with reclaim orders (async) or inline steals
(sync).  While the pool can cover the grant, no ``ReclaimOrder`` reaches
any replica.

Pressure signal: ``pressure()`` = outstanding ordered-but-undrained units /
budget; ``open_order_units(rid)`` is the per-victim view the router's
power-of-two policy uses to avoid replicas that are mid-reclaim.

``AlwaysGrantBroker`` is the single-replica degenerate case: an unmetered
host that grants every request, so a lone ``ServeEngine`` behaves exactly
as it did before the broker existed.

The broker's clock is injectable (``clock=``/``set_clock``): standalone it
stamps with ``time.perf_counter``; under ``ClusterSim`` the sim passes its
deterministic virtual clock so ``StealRecord.wall_seconds`` and order
timestamps replay identically for a fixed (trace, seed).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

from repro_torch.core.arena import ReclaimEvent
from repro_torch.cluster.ledger import BudgetLedger
from repro_torch.cluster.snapshots import Snapshot, SnapshotPool, SqueezeRecord
from repro_torch.cluster.topology import DeviceTopology

# victim-side reclaim callback: (k_units) -> (units_reclaimed, event|None)
ReclaimFn = Callable[[int], tuple[int, Optional[ReclaimEvent]]]


@dataclasses.dataclass
class StealRecord:
    """One host-pressure reclaim: the broker shrank ``victim`` to feed
    ``requester`` (the paper's headline metric is how fast this is)."""
    requester: str
    victim: str
    units: int                   # blocks moved from victim to the free pool
    wall_seconds: float          # victim-side reclaim latency
    reclaimed_bytes: int
    migrated_bytes: int          # 0 for hotmem victims by construction
    mode: Optional[str] = None   # victim's manager mode
    natural: bool = False        # filled by the victim's own release, not
    #                              an explicit order drain (zero extra wall)


@dataclasses.dataclass
class ReclaimOrder:
    """An asynchronous shrink request from host to victim VM.  The victim
    drains it incrementally at its own tick boundaries (``fulfill_order``)
    or lets natural releases cover it; an unfulfillable remainder is
    canceled (``cancel_order``).

    Sharded victims (``shards > 1``: one KV shard per device of the host
    mesh) drain **shard-coherently**: the order tracks per-shard fill and
    cancel vectors, and only the *coherent* stripe — the minimum fill
    across shards, times ``shards`` — ever becomes claimable by the
    requesting grant.  A fill on one device may not unfence another
    device's warm suffix: those units sit in ``Grant.incoherent`` escrow
    until every sibling shard catches up (or the order closes and the
    stranded remainder is unwound back to the free pool)."""
    order_id: int
    victim: str
    requester: str
    units: int                   # blocks ordered (all shards together)
    filled: int = 0              # blocks drained so far
    canceled: int = 0            # blocks the victim could not supply
    issued_at: float = 0.0       # broker-clock timestamp
    closed_at: Optional[float] = None
    shards: int = 1              # device shards draining in lockstep
    filled_by_shard: list[int] = dataclasses.field(default_factory=list)
    canceled_by_shard: list[int] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        assert self.units % self.shards == 0, \
            f"order of {self.units} units does not stripe over " \
            f"{self.shards} shards"
        if not self.filled_by_shard:
            self.filled_by_shard = [0] * self.shards
        if not self.canceled_by_shard:
            self.canceled_by_shard = [0] * self.shards

    @property
    def per_shard(self) -> int:
        """Each shard's slice of the order."""
        return self.units // self.shards

    def shard_remaining(self, shard: int) -> int:
        return self.per_shard - self.filled_by_shard[shard] \
            - self.canceled_by_shard[shard]

    @property
    def coherent_filled(self) -> int:
        """Blocks filled on EVERY shard — the only part of the drain the
        requester may claim (the minimum stripe, times shards)."""
        return min(self.filled_by_shard) * self.shards

    @property
    def remaining(self) -> int:
        return self.units - self.filled - self.canceled

    @property
    def open(self) -> bool:
        return self.remaining > 0


@dataclasses.dataclass
class Grant:
    """The result of one plug request.  ``granted`` units are usable
    immediately; ``pending`` arrive later as reclaim orders drain, landing
    in ``available`` (escrow) until the requester ``claim_grant``s them."""
    replica_id: str
    requested: int
    granted: int = 0             # filled from the free pool, already owned
    pending: int = 0             # owed by open reclaim orders
    available: int = 0           # escrow: drained coherently, awaiting claim
    claimed: int = 0             # escrow already delivered
    incoherent: int = 0          # escrow drained on SOME shards of an order
    #                              only — unclaimable until the sibling
    #                              shards catch up (sharded victims)
    order_ids: list[int] = dataclasses.field(default_factory=list)
    stall_seconds: float = 0.0   # sync mode: victim reclaim wall the
    #                              requester serialized behind (async: 0)

    @property
    def done(self) -> bool:
        """No more units will arrive (escrow may still await a claim)."""
        return self.pending == 0

    @property
    def fulfilled(self) -> int:
        return self.granted + self.claimed + self.available \
            + self.incoherent + self.pending


class MemoryBroker:
    """Interface: what a replica needs from its host."""

    def register(self, replica_id: str, initial_units: int, *,
                 reclaim: Optional[ReclaimFn] = None,
                 load: Optional[Callable[[], int]] = None,
                 mode: Optional[str] = None,
                 order_sink: Optional[Callable[[ReclaimOrder], None]] = None,
                 ) -> None:
        raise NotImplementedError

    def request_units(self, replica_id: str, want: int) -> int:
        raise NotImplementedError

    def request_grant(self, replica_id: str, want: int) -> Grant:
        """Grant protocol: brokers without async reclaim wrap the legacy
        blocking call in an already-complete ``Grant``."""
        return Grant(replica_id=replica_id, requested=max(want, 0),
                     granted=self.request_units(replica_id, want))

    def release_units(self, replica_id: str, units: int) -> None:
        raise NotImplementedError

    def claim_grant(self, grant: Grant) -> int:
        """Deliver escrowed units to the requester; 0 for sync brokers."""
        return 0

    def abandon_grant(self, grant: Grant) -> int:
        """Cancel a pending grant's unfilled remainder; no-op for brokers
        without the async order plane."""
        return 0

    # Snapshot pool API: brokers without a host snapshot pool decline every
    # offer and miss every lookup, so engines wired to them behave exactly
    # as before the pool existed (warm state is simply discarded).
    def snapshot_room(self, key: str, units: int, *, tenant: str = "",
                      replica_id: str = "", pages: Any = None) -> bool:
        return False

    def snapshot_put(self, key: str, *, units: int, payload: Any = None,
                     tokens: int = 0, nbytes: int = 0,
                     replica_id: str = "", origin_host: str = "",
                     copy_seconds: float = 0.0, tenant: str = "",
                     fragments: Any = None, pages: Any = None) -> bool:
        return False

    def snapshot_lookup(self, key: str) -> Optional[Snapshot]:
        return None

    def snapshot_available(self, key: str) -> bool:
        return False

    def snapshot_restorable(self, key: str) -> bool:
        return False

    def snapshot_units(self) -> int:
        return 0

    def snapshot_page_specs(self, key: str) -> Optional[list]:
        """Page specs ``(digest, units, nbytes, payload)`` of a paged
        entry's manifest, in manifest order (``None`` for absent or
        legacy opaque entries)."""
        return None

    def missing_pages(self, digests: Any) -> list:
        """Distinct digests the host's page store does NOT hold — what a
        migration must actually move here.  Poolless brokers lack every
        page."""
        out, seen = [], set()
        for d in digests:
            if d not in seen:
                seen.add(d)
                out.append(d)
        return out


class AlwaysGrantBroker(MemoryBroker):
    """Unmetered host: every plug request is granted in full.  Used by a
    standalone ``ServeEngine`` so single-replica behavior is unchanged."""

    def register(self, replica_id: str, initial_units: int, **_: Any) -> None:
        pass

    def request_units(self, replica_id: str, want: int) -> int:
        return max(want, 0)

    def release_units(self, replica_id: str, units: int) -> None:
        pass


class HostMemoryBroker(MemoryBroker):
    """Fixed-budget host arbiter: grant on demand, reclaim-from-idlest
    under pressure — synchronously (legacy) or via async reclaim orders."""

    def __init__(self, budget_units: Optional[int] = None, *,
                 async_reclaim: bool = False,
                 clock: Optional[Callable[[], float]] = None,
                 snapshot_pool_units: Optional[int] = None,
                 tenants: Optional[dict[str, int]] = None,
                 topology: Optional[DeviceTopology] = None):
        # all unit accounts (free / granted / escrow / snapshot charge)
        # live in the ledger; the broker only orchestrates flows.
        # ``tenants``: optional per-tenant sub-budget split (must sum to
        # the budget) — enables the fairness rule in _squeeze_snapshots.
        # ``topology``: the device mesh this host exposes; omitted =
        # single flat pool of ``budget_units`` (the exact legacy broker)
        self.ledger = BudgetLedger(budget_units, tenants=tenants,
                                   topology=topology)
        self.topology = self.ledger.topology
        self.async_reclaim = async_reclaim
        self._clock = clock if clock is not None else time.perf_counter
        # host snapshot pool (None = disabled): warm-restart state charged
        # against this same budget, squeezed FIRST under pressure
        self.snapshots: Optional[SnapshotPool] = None
        if snapshot_pool_units is not None:
            assert snapshot_pool_units <= self.ledger.budget_units
            self.snapshots = SnapshotPool(max_units=snapshot_pool_units)
        self.squeeze_log: list[SqueezeRecord] = []
        self._inline_reclaim = False     # sync steal in flight: pool fenced
        self._reclaim: dict[str, ReclaimFn] = {}
        self._load: dict[str, Callable[[], int]] = {}
        self._mode: dict[str, Optional[str]] = {}
        self._order_sink: dict[str, Callable[[ReclaimOrder], None]] = {}
        self.orders: dict[int, ReclaimOrder] = {}
        self._victim_orders: dict[str, list[int]] = {}   # open orders only
        self._order_grant: dict[int, Grant] = {}
        self.grants: list[Grant] = []                    # open grants
        self._next_order = 0
        self.steal_log: list[StealRecord] = []
        self.grant_calls = 0
        self.denied_units = 0        # requested-but-ungranted (pressure)
        self.request_stalls: list[float] = []   # per pressured request: the
        #                                         requester-visible stall

    # ledger views: the broker's public unit counters ARE the ledger's
    # (one owner for the conservation law; these stay readable as before)
    @property
    def budget_units(self) -> int:
        return self.ledger.budget_units

    @property
    def free_units(self) -> int:
        return self.ledger.free_units

    @property
    def granted(self) -> dict[str, int]:
        return self.ledger.granted

    def set_clock(self, clock: Callable[[], float]) -> None:
        """Inject a (virtual) clock; ``ClusterSim`` passes its deterministic
        timebase so steal records replay identically."""
        self._clock = clock

    # ----------------------------------------------------------- lifecycle
    def register(self, replica_id: str, initial_units: int, *,
                 reclaim: Optional[ReclaimFn] = None,
                 load: Optional[Callable[[], int]] = None,
                 mode: Optional[str] = None,
                 order_sink: Optional[Callable[[ReclaimOrder], None]] = None,
                 tenant: Optional[str] = None,
                 shards: Optional[int] = None) -> None:
        """VM boot: carve the replica's initial plug out of the free pool
        (squeezing snapshots first if the pool holds the needed slack —
        a booting VM outranks cached warm-restart state).  ``tenant``
        binds the replica to its sub-budget (required on multi-tenant
        hosts; the squeeze respects other tenants' sub-budgets).
        ``shards`` is the replica's shard spec: replicas span the full
        mesh (one KV shard per device), so it must equal the topology's
        device count — the broker validates rather than infers so a
        mis-sharded replica fails at boot, not mid-reclaim."""
        assert replica_id not in self.granted, replica_id
        n_dev = self.topology.n_devices
        assert shards is None or shards == n_dev, \
            f"{replica_id} declares {shards} shards on a {n_dev}-device " \
            f"mesh: replicas span the full mesh"
        self.topology.assert_balanced(initial_units,
                                      f"boot plug for {replica_id}")
        tenant = self.ledger.resolve_tenant(tenant)
        if initial_units > self.free_units:
            self._squeeze_snapshots(initial_units - self.free_units,
                                    requester=replica_id, tenant=tenant)
        assert initial_units <= self.free_units, \
            f"host budget exhausted registering {replica_id}: " \
            f"need {initial_units}, free {self.free_units}"
        self.ledger.carve(replica_id, initial_units, tenant=tenant)
        if reclaim is not None:
            self._reclaim[replica_id] = reclaim
        if load is not None:
            self._load[replica_id] = load
        if order_sink is not None:
            self._order_sink[replica_id] = order_sink
        self._mode[replica_id] = mode

    def deregister(self, replica_id: str) -> int:
        """VM teardown (host retirement): settle every open flow the
        replica participates in, return its whole holding to the free
        pool, and forget its account.  Victim-side: open orders against
        it are canceled (their requesters see the denial and may
        re-request elsewhere).  Requester-side: its grants' unfilled
        remainders are abandoned and already-coherent escrow is claimed
        into the holding before the release — so nothing strands in
        escrow and the ledger law holds through the teardown.  Returns
        units returned to the pool."""
        assert replica_id in self.granted, replica_id
        for oid in list(self._victim_orders.get(replica_id, ())):
            self.cancel_order(oid)
        for g in [g for g in self.grants if g.replica_id == replica_id]:
            self.abandon_grant(g)       # closes orders, unwinds incoherent
            self.claim_grant(g)         # coherent escrow -> holding
        units = self.granted[replica_id]
        if units > 0:
            self.ledger.release(replica_id, units)
        self.ledger.forget(replica_id)
        self._victim_orders.pop(replica_id, None)
        self._reclaim.pop(replica_id, None)
        self._load.pop(replica_id, None)
        self._order_sink.pop(replica_id, None)
        self._mode.pop(replica_id, None)
        return units

    # --------------------------------------------------------- plug/unplug
    def request_units(self, replica_id: str, want: int) -> int:
        """Legacy blocking plug: grant up to ``want`` units now.  A legacy
        caller cannot claim async fills, so any orders the request issued
        are canceled immediately — otherwise their proceeds would strand
        in escrow forever, silently shrinking the usable budget."""
        g = self.request_grant(replica_id, want)
        for oid in list(g.order_ids):
            self.cancel_order(oid)
        return g.granted

    def request_grant(self, replica_id: str, want: int) -> Grant:
        """virtio-mem plug: fill from the free pool immediately; cover any
        deficit by squeezing the snapshot pool (metadata-only, no victim
        disturbed), then by reclaim — inline (sync) or via orders
        (async)."""
        assert replica_id in self.granted, replica_id
        g = Grant(replica_id=replica_id, requested=max(want, 0))
        if want <= 0:
            return g
        # plug requests stripe over the replica's shards, so they must be
        # balanced over the mesh (trivially true on a 1-device topology)
        self.topology.assert_balanced(want, f"plug request by {replica_id}")
        self.grant_calls += 1
        g.granted = self.ledger.take_free(replica_id, want)
        deficit = want - g.granted
        if deficit <= 0:
            return g
        # snapshot-squeeze-first: cached warm-restart state is the host's
        # bounded-lifetime region — drop it before disturbing any replica
        if self._squeeze_snapshots(deficit, requester=replica_id):
            take = self.ledger.take_free(replica_id, deficit)
            g.granted += take
            deficit -= take
        if deficit <= 0:
            return g        # covered without a victim: like a free-pool
            #                 fill, it leaves no stall sample (the stall
            #                 series tracks requests that engaged reclaim)
        if self.async_reclaim:
            issued = self._issue_orders(replica_id, deficit, g)
            g.pending = issued
            self.denied_units += deficit - issued
            if g.pending:
                self.grants.append(g)
            self.request_stalls.append(0.0)     # requester never blocks
        else:
            stall = self._reclaim_from_idlest(replica_id, deficit)
            g.stall_seconds = stall
            self.request_stalls.append(stall)
            take2 = self.ledger.take_free(replica_id, deficit)
            g.granted += take2
            self.denied_units += deficit - take2
        return g

    def release_units(self, replica_id: str, units: int) -> None:
        """virtio-mem unplug completion.  A victim with open reclaim orders
        routes its released units into them first (a victim finishing
        naturally *is* the reclaim — crediting the free pool too would
        double-release); only the excess reaches the host pool."""
        if units <= 0:
            return
        assert self.granted.get(replica_id, 0) >= units, \
            f"{replica_id} returning {units} units it was never granted"
        for oid in list(self._victim_orders.get(replica_id, ())):
            if units <= 0:
                break
            o = self.orders[oid]
            # a natural release is balanced over the victim's shards, so
            # it may only cover the order's balanced capacity (the
            # scarcest shard bounds the stripe) — shards == 1 reduces to
            # the plain ``min(units, o.remaining)``
            k = min(units,
                    min(o.shard_remaining(d) for d in range(o.shards))
                    * o.shards)
            k -= k % o.shards
            if k > 0:
                self._apply_fill(o, k, wall=0.0, ev=None, natural=True)
                units -= k
        if units > 0:
            self.ledger.release(replica_id, units)

    # ----------------------------------------------------- snapshot pool
    def _snap_tenant(self, tenant: str, replica_id: str) -> str:
        """Resolve the owning tenant of a snapshot operation: an explicit
        ``tenant`` wins, else the writing replica's tenant, else the
        ledger's sole default tenant (asserts on ambiguity)."""
        if tenant:
            return self.ledger.resolve_tenant(tenant)
        if replica_id in self.ledger.tenant_of:
            return self.ledger.tenant_of[replica_id]
        return self.ledger.resolve_tenant(None)

    def _entry_delta(self, snap: Snapshot, sim=None
                     ) -> tuple[int, dict[str, int]]:
        """What dropping ``snap`` right now would do to the ledger:
        ``(units freed, per-tenant snapshot-account delta)``.  A legacy
        opaque entry frees its face value on its owner; a paged manifest
        frees only pages whose refcount hits zero and hands still-shared
        pages' charge to a surviving tenant (``sim`` carries the walk
        state for multi-drop planning; default is the live store)."""
        if snap.pages is None:
            owner = snap.tenant or self.ledger.resolve_tenant(None)
            return snap.units, {owner: -snap.units}
        if sim is None:
            sim = self.snapshots.pages.simulate()
        return sim.deref_entry(snap)

    def _release_entry_charge(self, snap: Snapshot) -> int:
        """Return an evicted/dropped entry's charge to the free pool: a
        legacy credit on its owner, or per-page deref flows for a
        manifest — freed pages credit their owners, still-shared pages'
        charge is reattributed to a surviving tenant (never stranded).
        Returns units actually freed."""
        if snap.pages is None:
            self.ledger.snapshot_credit(snap.units, snap.tenant or None)
            return snap.units
        store = self.snapshots.pages
        freed = 0
        for digest in snap.pages:
            outcome, u, frm, to = store.deref(digest, snap.tenant)
            if outcome == "freed":
                self.ledger.snapshot_credit(u, frm or None)
                freed += u
            elif outcome == "reattributed":
                self.ledger.snapshot_reattribute(u, frm or None,
                                                 to or None)
        return freed

    def _squeeze_eligible(self, tenant: str
                          ) -> Callable[[Snapshot], bool]:
        """The fairness rule: ``tenant``'s pressure may drop its OWN
        entries freely, but another tenant's entry only while that owner
        stays at or above its sub-budget afterwards — one tenant's grant
        can never squeeze another tenant's snapshots past its
        sub-budget.  For paged entries the rule is evaluated over the
        drop's real per-tenant deltas (unique pages freed, owner
        handoffs), not the manifest's referenced total."""
        led = self.ledger
        def ok(snap: Snapshot) -> bool:
            _, delta = self._entry_delta(snap)
            for owner, du in delta.items():
                if du >= 0 or owner == tenant:
                    continue
                if led.tenant_usage(owner) + du < led.sub_budgets[owner]:
                    return False
            return True
        return ok

    @staticmethod
    def _check_pages(pages, units: int, topology) -> tuple:
        """Normalize and validate a page-spec list ``(digest, units,
        nbytes, payload)``: manifest units must equal the page sum and
        every page's units must stripe balanced over the mesh (so any
        subset of pages charges/credits balanced)."""
        pages = tuple((d, int(u), int(nb), pl) for d, u, nb, pl in pages)
        assert len(pages) >= 1, "empty page manifest"
        assert units == sum(u for _, u, _, _ in pages), \
            f"manifest units {units} != page sum " \
            f"{sum(u for _, u, _, _ in pages)}"
        for d, u, _nb, pl in pages:
            assert u >= 0, (d, u)
            assert pl is not None, f"page {d!r} without payload"
            topology.assert_balanced(u, f"page {d!r}")
        return pages

    def _evict_plan(self, key: str, units: int, tenant: str,
                    pages: Optional[tuple] = None
                    ) -> Optional[list[str]]:
        """Exact eviction plan for inserting a ``units``-block snapshot
        under ``key``: the ordered entry keys to drop (same-key
        predecessor first, then LRU order, skipping tenant-protected
        entries) so the insert fits both the free pool and the pool cap —
        or ``None`` when no eligible plan exists.  ``snapshot_room`` asks
        whether a plan exists; ``snapshot_put`` executes the same plan, so
        the two can never disagree.

        With ``pages`` the arithmetic runs over *unique* pages: the
        incoming charge is only what the store doesn't already hold (a
        fully-shared manifest charges nothing), evicting a manifest frees
        only pages whose refcount would hit zero, and both are tracked on
        one refcount simulation so eviction/recharge interactions (an
        evicted sharer freeing a page the incoming manifest then re-pays)
        are priced exactly as execution will replay them."""
        pool = self.snapshots
        if pool is None or units <= 0 or self._inline_reclaim:
            return None
        # one refcount simulation carries the whole walk, so sequential
        # deref interactions (entry A's drop making entry B's pages
        # unique) are priced exactly as execution will replay them
        sim = pool.pages.simulate()

        def charge_now() -> int:
            return units if pages is None else sim.new_units(pages)

        # cap feasibility: the floor is the charge with everything else
        # evicted — for a manifest, its distinct pages' units
        if pages is None:
            floor = units
        else:
            seen: set = set()
            floor = 0
            for d, u, _nb, _pl in pages:
                if d not in seen:
                    seen.add(d)
                    floor += u
        if not pool.fits(floor):
            return None
        ok = self._squeeze_eligible(tenant)
        plan: list[str] = []
        freed = 0
        same = pool.peek(key)
        if same is not None:
            if not ok(same):
                return None     # cannot replace a protected entry
            plan.append(key)
            f, _ = self._entry_delta(same, sim=sim)
            freed += f

        def fits_now() -> bool:
            # a sharded snapshot charges one fragment per device, so the
            # headroom that matters is the BALANCED free pool (scarcest
            # device × devices) — identical to ``free_units`` at devices=1
            charge = charge_now()
            return charge <= self.ledger.balanced_free() + freed and (
                pool.max_units is None
                or pool.units - freed + charge <= pool.max_units)

        if fits_now():
            return plan
        for k in pool.keys():               # LRU -> MRU order
            if k == key:
                continue                    # already planned (replacement)
            snap = pool.peek(k)
            if not ok(snap):
                continue                    # protected: skip, not reorder
            plan.append(k)
            f, _ = self._entry_delta(snap, sim=sim)
            freed += f
            if fits_now():
                return plan
        return None

    def snapshot_room(self, key: str, units: int, *, tenant: str = "",
                      replica_id: str = "", pages: Any = None) -> bool:
        """Would a ``units``-block snapshot for ``key`` fit right now?  A
        same-key predecessor's charge and every *squeeze-eligible* entry
        count as reclaimable headroom (another tenant's entries only down
        to its sub-budget); insertion never creates pressure (it only
        spends free units), so the answer is also the engine's gate for
        paying the copy-out at all.  With ``pages`` the probe prices only
        the UNIQUE pages the store lacks — a fully-shared manifest always
        has room.  Declines while a sync inline steal is in flight:
        mid-steal free units belong to the open grant (see
        ``_reclaim_from_idlest``)."""
        if self.snapshots is None:
            return False
        t = self._snap_tenant(tenant, replica_id)
        if pages is not None:
            pages = self._check_pages(pages, units, self.topology)
        return self._evict_plan(key, units, t, pages=pages) is not None

    def snapshot_put(self, key: str, *, units: int, payload: Any = None,
                     tokens: int = 0, nbytes: int = 0,
                     replica_id: str = "", origin_host: str = "",
                     copy_seconds: float = 0.0, tenant: str = "",
                     fragments: Any = None, pages: Any = None) -> bool:
        """Persist a copied-out partition into the pool, charging ``units``
        against the free pool on the owner tenant's account.  A same-key
        predecessor is replaced; squeeze-eligible LRU entries are evicted
        for cap/space; returns False (nothing changed) when the snapshot
        cannot fit.  ``origin_host``/``copy_seconds`` mark a cross-host
        migration (``repro_torch.cluster.fleet``): the modeled inter-host copy
        wall is paid by the first restore that uses the entry, so a remote
        restore lands between a local restore and a cold prefill.
        ``fragments`` is the sharded-KV form: one payload fragment per
        device; the entry is restorable only when every fragment is
        present, and its charge stripes balanced over the mesh.

        ``pages`` makes the entry a content-addressed manifest: a list of
        ``(digest, units, nbytes, payload)`` page specs whose units sum
        to ``units``.  Each page is ref'd into the host-wide store; only
        pages the store lacks charge the ledger (owner = this entry's
        tenant), so N profiles sharing a prefix pay for it once."""
        if self.snapshots is None:
            return False
        if fragments is not None:
            fragments = tuple(fragments)
            assert units % len(fragments) == 0, (units, len(fragments))
        t = self._snap_tenant(tenant, replica_id)
        if pages is not None:
            pages = self._check_pages(pages, units, self.topology)
        plan = self._evict_plan(key, units, t, pages=pages)
        if plan is None:
            return False
        pool = self.snapshots
        for k in plan:
            if k == key:                    # same-key replacement
                snap = pool.peek(key)
                pool.drop(key)
                pool.replaced += 1
            else:
                snap = pool.evict(k)
            self._release_entry_charge(snap)
        now = self._clock()
        manifest = None
        if pages is None:
            self.ledger.snapshot_charge(units, t)
        else:
            new_units = 0
            for digest, u, nb, pl in pages:
                if pool.pages.ref(digest, units=u, nbytes=nb,
                                  payload=pl, tenant=t):
                    new_units += u
            if new_units:
                self.ledger.snapshot_charge(new_units, t)
            manifest = tuple(digest for digest, _u, _nb, _pl in pages)
        pool.insert(Snapshot(key=key, units=units, tokens=tokens,
                             nbytes=nbytes, payload=payload,
                             replica_id=replica_id, created_at=now,
                             last_used=now, origin_host=origin_host,
                             copy_seconds=copy_seconds, tenant=t,
                             fragments=fragments, pages=manifest))
        return True

    def snapshot_lookup(self, key: str) -> Optional[Snapshot]:
        """Restore-path fetch (refreshes LRU recency, counts hit/miss).
        The snapshot stays pooled: one capture serves every later
        invocation of the profile until evicted or replaced."""
        if self.snapshots is None:
            return None
        return self.snapshots.lookup(key, now=self._clock())

    def snapshot_available(self, key: str) -> bool:
        """Entry-presence probe: no recency refresh, no accounting."""
        return self.snapshots is not None \
            and self.snapshots.peek(key) is not None

    def snapshot_restorable(self, key: str) -> bool:
        """Restore-feasibility probe (router + engine admission): the
        entry must carry a payload to copy back — and, for sharded
        entries, EVERY per-device fragment (a half-captured replica is
        not a warm start).  Metadata-only entries (non-engine producers:
        broker-level tests, benchmarks) are *present* but not restorable
        — probing them here instead of via ``snapshot_lookup`` keeps
        them off the hit counter and out of the MRU slot, so dead
        entries stay first in squeeze order.  No recency refresh, no
        accounting."""
        if self.snapshots is None:
            return False
        snap = self.snapshots.peek(key)
        return snap is not None and snap.restorable

    def snapshot_drop(self, key: str) -> int:
        """Explicitly invalidate ``key`` (tests / staleness): its charge
        returns to the free pool (owner tenant's account).  Returns units
        freed — for a paged entry, only pages whose refcount hit zero."""
        if self.snapshots is None:
            return 0
        snap = self.snapshots.peek(key)
        if snap is None:
            return 0
        self.snapshots.drop(key)
        return self._release_entry_charge(snap)

    def snapshot_units(self) -> int:
        """The pool's current charge against the host budget (unique
        pages counted once)."""
        return self.snapshots.units if self.snapshots is not None else 0

    def snapshot_page_specs(self, key: str) -> Optional[list]:
        """Page specs ``(digest, units, nbytes, payload)`` of a paged
        entry's manifest, in manifest order — what a migration carries
        and a restore reassembles (``None`` for absent/legacy
        entries)."""
        if self.snapshots is None:
            return None
        snap = self.snapshots.peek(key)
        if snap is None or snap.pages is None:
            return None
        out = []
        for digest in snap.pages:
            p = self.snapshots.pages.get(digest)
            out.append((digest, p.units, p.nbytes, p.payload))
        return out

    def missing_pages(self, digests: Any) -> list:
        """Distinct digests this host's store does NOT hold — what a
        migration must actually move here (dedup-aware transfer
        sizing)."""
        if self.snapshots is None:
            return super().missing_pages(digests)
        return self.snapshots.pages.missing(digests)

    def squeezable_snapshot_units(self, tenant: Optional[str] = None) -> int:
        """Units that pressure under ``tenant`` could squeeze out of the
        pool RIGHT NOW — the placement-capacity probe (``FleetScheduler.
        capacity`` must never promise units ``register`` cannot deliver).

        Walks entries in LRU order simulating sequential drops exactly
        like ``_squeeze_snapshots``: the fairness predicate is
        re-evaluated against the post-drop owner usage, so two entries
        whose owner can only spare one are counted once, and paged
        entries count only pages whose refcount would hit zero under the
        walk's refcount simulation (shared pages free nothing until
        their last manifest drops).  ``tenant=None`` resolves to the
        sole tenant on a single-tenant ledger; on a multi-tenant ledger
        it is the *anonymous* probe — every entry is treated as another
        tenant's (the conservative floor: a real squeeze can only free
        more)."""
        if self.snapshots is None:
            return 0
        led = self.ledger
        if tenant or len(led.sub_budgets) == 1:
            tenant = led.resolve_tenant(tenant)
        usage: dict[str, int] = {}
        freed = 0
        sim = self.snapshots.pages.simulate()
        for key in self.snapshots.keys():          # LRU -> MRU
            snap = self.snapshots.peek(key)
            trial = sim.clone()
            f, delta = self._entry_delta(snap, sim=trial)
            if any(owner != tenant and du < 0
                   and usage.get(owner, led.tenant_usage(owner)) + du
                   < led.sub_budgets[owner]
                   for owner, du in delta.items()):
                continue                           # protected: skipped
            sim = trial
            for owner, du in delta.items():
                if owner != tenant:
                    usage[owner] = usage.get(
                        owner, led.tenant_usage(owner)) + du
            freed += f
        return freed

    def _squeeze_snapshots(self, deficit: int, *, requester: str,
                           tenant: Optional[str] = None) -> int:
        """The squeeze-first reclaim rule: drop LRU snapshots until
        ``deficit`` is covered or no eligible entry remains.  Metadata-only
        — zero bytes migrate, no replica is ordered to shrink, the freed
        units land in the free pool immediately.  Eligibility is the
        tenant fairness rule (``_squeeze_eligible``): the requesting
        tenant drops its own entries freely but can take another tenant's
        only down to that tenant's sub-budget.  A paged entry frees only
        pages whose refcount hits zero (its ``SqueezeRecord`` logs that
        figure, possibly 0 for a fully-shared manifest).  Returns units
        freed."""
        if self.snapshots is None or deficit <= 0:
            return 0
        if tenant is None:
            tenant = self._snap_tenant("", requester)
        ok = self._squeeze_eligible(tenant)
        freed = 0
        now = self._clock()
        while freed < deficit:
            snap = self.snapshots.evict_lru(eligible=ok)
            if snap is None:
                break
            # credit per entry on its OWNER's account so the protection
            # predicate sees up-to-date tenant usage for the next pick
            f = self._release_entry_charge(snap)
            freed += f
            self.squeeze_log.append(SqueezeRecord(
                requester=requester, key=snap.key, units=f,
                nbytes=snap.nbytes, at=now,
                tenant=snap.tenant or self.ledger.resolve_tenant(None)))
        return freed

    # --------------------------------------------------- async order plane
    def _issue_orders(self, requester: str, deficit: int, grant: Grant
                      ) -> int:
        """Spread ``deficit`` across reclaim orders to the idlest victims
        (fewest in-flight invocations), capped by what each victim holds
        beyond units already ordered from it.  On a multi-device mesh
        each order stripes over the victim's shards, so per-victim
        amounts are floored to the shard count (a 1-device mesh floors
        nothing)."""
        n_dev = self.topology.n_devices
        victims = sorted(
            (r for r in self.granted
             if r != requester and r in self._order_sink),
            key=lambda r: (self._load[r]() if r in self._load else 0, r))
        issued = 0
        now = self._clock()
        for v in victims:
            if deficit <= 0:
                break
            cap = self.granted[v] - self.open_order_units(v)
            cap -= cap % n_dev
            k = min(deficit, cap)
            if k <= 0:
                continue
            order = ReclaimOrder(order_id=self._next_order, victim=v,
                                 requester=requester, units=k,
                                 issued_at=now, shards=n_dev)
            self._next_order += 1
            self.orders[order.order_id] = order
            self._victim_orders.setdefault(v, []).append(order.order_id)
            self._order_grant[order.order_id] = grant
            grant.order_ids.append(order.order_id)
            deficit -= k
            issued += k
            self._order_sink[v](order)
        return issued

    def fulfill_order(self, order_id: int, units: int,
                      ev: Optional[ReclaimEvent] = None,
                      shard: Optional[int] = None) -> int:
        """Victim-side partial drain: move up to ``units`` blocks from the
        victim's grant into the order's escrow.  Returns blocks accepted
        (the victim releases any unplugged excess normally).

        ``shard=d`` drains one device shard of the order (sharded
        victims call this once per device as each shard's suffix
        unfences); ``shard=None`` is a balanced drain over every shard
        at once — on a 1-shard order that is exactly the legacy call."""
        o = self.orders[order_id]
        if shard is not None:
            assert 0 <= shard < o.shards, (shard, o.shards)
            k = min(units, o.shard_remaining(shard),
                    self.ledger.granted_dev(o.victim)[shard])
            if k <= 0:
                return 0
            self._apply_fill(o, k, wall=ev.wall_seconds if ev is not None
                             else 0.0, ev=ev, natural=False, shard=shard)
            return k
        k = min(units, o.remaining, self.granted[o.victim])
        if o.shards > 1:
            # balanced drain: the scarcest shard bounds the stripe, both
            # order-side (shard_remaining) and victim-side (granted_dev)
            k = min(k,
                    min(o.shard_remaining(d) for d in range(o.shards))
                    * o.shards,
                    min(self.ledger.granted_dev(o.victim)) * o.shards)
            k -= k % o.shards
        if k <= 0:
            return 0
        self._apply_fill(o, k, wall=ev.wall_seconds if ev is not None
                         else 0.0, ev=ev, natural=False)
        return k

    def _apply_fill(self, o: ReclaimOrder, k: int, *, wall: float,
                    ev: Optional[ReclaimEvent], natural: bool,
                    shard: Optional[int] = None) -> None:
        """Move ``k`` drained blocks into the order's escrow and update
        the grant's coherence split: only the stripe filled on EVERY
        shard becomes ``available`` (claimable); the rest waits in
        ``incoherent`` until sibling shards catch up.  1-shard orders
        are always coherent, so the split degenerates to the legacy
        ``available += k``."""
        g = self._order_grant[o.order_id]
        old_coherent = o.coherent_filled
        if shard is None:
            self.ledger.escrow_fill(o.victim, k, requester=o.requester)
            per = k // o.shards
            for d in range(o.shards):
                o.filled_by_shard[d] += per
        else:
            self.ledger.escrow_fill(o.victim, k, requester=o.requester,
                                    dev=shard)
            o.filled_by_shard[shard] += k
        o.filled += k
        delta_coherent = o.coherent_filled - old_coherent
        g.pending -= k
        g.available += delta_coherent
        g.incoherent += k - delta_coherent
        self.steal_log.append(StealRecord(
            requester=o.requester, victim=o.victim, units=k,
            wall_seconds=wall,
            reclaimed_bytes=ev.reclaimed_bytes if ev is not None else 0,
            migrated_bytes=ev.migrated_bytes if ev is not None else 0,
            mode=self._mode.get(o.victim), natural=natural))
        if not o.open:
            self._close_order(o)

    def cancel_order(self, order_id: int, units: Optional[int] = None,
                     shard: Optional[int] = None) -> int:
        """Victim abandons (part of) an order it cannot fulfill — e.g. its
        arena is fully drained, or it finished naturally and released its
        memory before the order could be serviced.  The requester's pending
        shrinks; it may re-request later.  Returns units canceled.

        ``shard=d`` cancels one device shard's remainder (its siblings
        stay ordered); ``shard=None`` cancels across every shard.  A
        cancel can strand already-drained sibling fills incoherent —
        when the order closes, that stranded escrow is unwound back to
        the free pool (``_close_order``), never silently leaked."""
        o = self.orders[order_id]
        g = self._order_grant[o.order_id]
        n = 0
        if shard is not None:
            assert 0 <= shard < o.shards, (shard, o.shards)
            n = o.shard_remaining(shard) if units is None \
                else min(units, o.shard_remaining(shard))
            o.canceled_by_shard[shard] += n
        else:
            want = o.remaining if units is None else min(units, o.remaining)
            left = want
            for d in range(o.shards):       # drain shard remainders in order
                k = min(left, o.shard_remaining(d))
                o.canceled_by_shard[d] += k
                left -= k
            n = want - left
        if n <= 0:
            return 0
        o.canceled += n
        g.pending -= n
        self.denied_units += n
        if not o.open:
            self._close_order(o)
        self._prune_grant(g)
        return n

    def _close_order(self, o: ReclaimOrder) -> None:
        o.closed_at = self._clock()
        vlist = self._victim_orders.get(o.victim)
        if vlist and o.order_id in vlist:
            vlist.remove(o.order_id)
        # shard-coherence settlement: fills that never got their sibling
        # shards (the victim canceled those) are stranded — they can
        # never become claimable, so unwind them escrow -> free on their
        # exact devices and count them denied.  1-shard orders close with
        # min == filled, so nothing is ever stranded on the legacy path.
        if o.shards > 1:
            g = self._order_grant[o.order_id]
            floor = min(o.filled_by_shard)
            for d in range(o.shards):
                stranded = o.filled_by_shard[d] - floor
                if stranded > 0:
                    self.ledger.escrow_release(stranded,
                                               requester=o.requester,
                                               dev=d)
                    g.incoherent -= stranded
                    self.denied_units += stranded
            self._prune_grant(g)

    def _prune_grant(self, g: Grant) -> None:
        if g.done and g.available == 0 and g.incoherent == 0 \
                and g in self.grants:
            self.grants.remove(g)

    def abandon_grant(self, grant: Grant) -> int:
        """Requester gives up on a pending grant (its demand vanished, or
        it is shutting down): cancel the unfilled remainder of the backing
        orders.  Already-escrowed units stay claimable.  Returns units
        canceled."""
        n = 0
        for oid in list(grant.order_ids):
            if self.orders[oid].open:
                n += self.cancel_order(oid)
        return n

    def claim_grant(self, grant: Grant) -> int:
        """Requester-side grant completion: absorb escrowed units (the
        engine then grows its rows at its own tick boundary)."""
        k = grant.available
        if k <= 0:
            self._prune_grant(grant)
            return 0
        grant.available = 0
        grant.claimed += k
        self.ledger.escrow_claim(grant.replica_id, k)
        self._prune_grant(grant)
        return k

    # ----------------------------------------------------- pressure signal
    def open_order_units(self, replica_id: str) -> int:
        """Blocks this replica still owes to open reclaim orders — the
        router's drain-awareness signal."""
        return sum(self.orders[oid].remaining
                   for oid in self._victim_orders.get(replica_id, ()))

    def pending_units(self) -> int:
        return sum(o.remaining for o in self.orders.values())

    def escrow_units(self) -> int:
        return self.ledger.escrow_units

    def pressure(self) -> float:
        """Outstanding pending units / budget: how far the host is from
        satisfying every open plug request."""
        return self.pending_units() / self.budget_units

    # ------------------------------------------------- sync reclaim (legacy)
    def _reclaim_from_idlest(self, requester: str, deficit: int) -> float:
        """Host pressure, synchronous: shrink other replicas inline, idlest
        first (fewest in-flight invocations — the VM whose reclaim disturbs
        least).  Returns the victim-side wall the requester waited for.

        ``_inline_reclaim`` fences the snapshot pool for the duration:
        every unit a victim surrenders here already belongs to the open
        grant, so a victim's eviction path must not be able to divert
        free units into a snapshot capture mid-steal (``snapshot_room``
        declines, so the victim skips the readout entirely — and the
        capture would be immediate squeeze-bait anyway)."""
        victims = sorted(
            (r for r in self.granted
             if r != requester and r in self._reclaim),
            key=lambda r: (self._load[r]() if r in self._load else 0, r))
        stall = 0.0
        self._inline_reclaim = True
        try:
            for v in victims:
                if deficit <= 0:
                    break
                t0 = self._clock()
                got, ev = self._reclaim[v](deficit)
                wall = ev.wall_seconds if ev is not None \
                    else self._clock() - t0
                if got <= 0:
                    continue
                assert got <= self.granted[v]
                self.ledger.release(v, got)
                deficit -= got
                stall += wall
                self.steal_log.append(StealRecord(
                    requester=requester, victim=v, units=got,
                    wall_seconds=wall,
                    reclaimed_bytes=(ev.reclaimed_bytes
                                     if ev is not None else 0),
                    migrated_bytes=(ev.migrated_bytes
                                    if ev is not None else 0),
                    mode=self._mode.get(v)))
        finally:
            self._inline_reclaim = False
        return stall

    # -------------------------------------------------------------- report
    def report(self) -> dict[str, Any]:
        """Host-level reclaim telemetry (per-mode steal latency — the
        cluster analogue of the paper's Fig. 5)."""
        by_mode: dict[str, dict[str, float]] = {}
        for rec in self.steal_log:
            d = by_mode.setdefault(rec.mode or "?", {
                "steals": 0, "units": 0, "wall_seconds": 0.0,
                "reclaimed_bytes": 0, "migrated_bytes": 0})
            d["steals"] += 1
            d["units"] += rec.units
            d["wall_seconds"] += rec.wall_seconds
            d["reclaimed_bytes"] += rec.reclaimed_bytes
            d["migrated_bytes"] += rec.migrated_bytes
        return {
            "budget_units": self.budget_units,
            "free_units": self.free_units,
            "granted": dict(self.granted),
            "steals": len(self.steal_log),
            "stolen_units": sum(r.units for r in self.steal_log),
            "grant_calls": self.grant_calls,
            "denied_units": self.denied_units,
            "async": self.async_reclaim,
            "orders": len(self.orders),
            "pending_units": self.pending_units(),
            "escrow_units": self.escrow_units(),
            "pressure": self.pressure(),
            "by_mode": by_mode,
            "devices": self.ledger.device_report(),
            "snapshot_units": self.snapshot_units(),
            "referenced_snapshot_units": (
                self.snapshots.referenced_units
                if self.snapshots is not None else 0),
            "snapshot_squeezes": len(self.squeeze_log),
            "squeezed_units": sum(r.units for r in self.squeeze_log),
            "snapshots": (self.snapshots.report()
                          if self.snapshots is not None else None),
            "tenants": self.ledger.tenant_report(),
        }

    # ---------------------------------------------------------- invariants
    def check_invariants(self) -> None:
        # conservation (free + granted + escrow + snapshot == budget) is
        # the ledger's single check; the broker asserts its order/grant/
        # pool structures agree with the ledger's accounts
        self.ledger.check()
        assert self.ledger.escrow_units \
            == sum(g.available + g.incoherent for g in self.grants), \
            "escrow not backed by open grants"
        assert self.ledger.snapshot_units == self.snapshot_units(), \
            "pool charge diverged from the ledger"
        if self.snapshots is not None:
            self.snapshots.check_invariants()
            # per-tenant cross-check: legacy entries grouped by owner plus
            # unique pages grouped by their CHARGED owner must sum to the
            # ledger's tenant snapshot accounts — so an evicted shared
            # page can never strand charge on a departed tenant
            by_tenant: dict[str, int] = {}
            for k in self.snapshots.keys():
                s = self.snapshots.peek(k)
                if s.pages is not None:
                    continue                # charged via the page store
                t = s.tenant or self.ledger.resolve_tenant(None)
                by_tenant[t] = by_tenant.get(t, 0) + s.units
            for t, u in self.snapshots.pages.owner_units().items():
                t = t or self.ledger.resolve_tenant(None)
                by_tenant[t] = by_tenant.get(t, 0) + u
            for t in self.ledger.sub_budgets:
                assert by_tenant.get(t, 0) == self.ledger.tenant_snapshot(t), \
                    f"tenant {t} pool entries diverged from ledger account"
        for o in self.orders.values():
            assert 0 <= o.filled + o.canceled <= o.units, o
            # the shard vectors ARE the order's state: their sums must
            # match the scalar totals and no shard may exceed its slice
            assert sum(o.filled_by_shard) == o.filled, o
            assert sum(o.canceled_by_shard) == o.canceled, o
            for d in range(o.shards):
                assert 0 <= o.filled_by_shard[d] + o.canceled_by_shard[d] \
                    <= o.per_shard, o
            if o.open:
                assert o.order_id in self._victim_orders.get(o.victim, ()), o
        for g in self.grants:
            assert g.pending >= 0 and g.available >= 0, g
            assert g.incoherent >= 0, g
            assert g.fulfilled <= g.requested, g
            # LOUD shard-coherence law: once every backing order has
            # closed, no incoherent escrow may remain — a fill that
            # reached only some shards of a victim must have been either
            # completed by its siblings or unwound at order close.  A
            # grant stuck incoherent here means a drain path skewed
            # shards silently (the sharded analogue of a row-skew bug).
            if all(not self.orders[oid].open for oid in g.order_ids):
                assert g.incoherent == 0, \
                    f"shard-incoherent drain: grant for {g.replica_id} " \
                    f"holds {g.incoherent} escrowed units that can never " \
                    f"become claimable (orders all closed)"
        # every pending unit is backed by exactly one open order
        assert sum(g.pending for g in self.grants) \
            == sum(o.remaining for o in self.orders.values()), \
            "pending units not backed by open orders"
        # incoherent escrow is exactly the open orders' uncovered stripes
        assert sum(g.incoherent for g in self.grants) \
            == sum(o.filled - o.coherent_filled
                   for o in self.orders.values() if o.open), \
            "incoherent escrow diverged from open orders' shard skew"
