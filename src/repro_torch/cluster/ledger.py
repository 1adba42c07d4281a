"""Per-host budget ledger: the conservation law with a single owner.

Every host-level memory flow — boot-time plugs, grant fills, unplug
releases, escrowed reclaim-order proceeds, snapshot-pool charges — moves
units between exactly four ledger accounts:

    free        the host pool (unowned, grantable now)
    granted     per-replica holdings (the VMs' plugged memory)
    escrow      reclaim-order proceeds drained by victims but not yet
                claimed by their requesters (in flight between VMs)
    snapshot    the host snapshot pool's charge (persisted warm-restart
                state, droppable under pressure)

and the invariant the whole test suite anchors on is checked in ONE
place, ``check``::

    free + sum(granted) + escrow + snapshot == budget

Devices: the ledger keeps each account as a **per-device vector** over
the host's ``DeviceTopology`` (``repro_torch.cluster.topology``) — one account
column per device of the mesh the host exposes — and the conservation
law holds per device::

    free_d + sum(granted_d) + escrow_d + snapshot_d == budget_d

for every device ``d``, checked in the same single ``check`` code path
as the host-wide and per-tenant laws (which are its sums).  Flows are
either *balanced* (``dev=None``: units stripe evenly over the mesh —
asserted divisible, so per-device conservation is exact) or
*single-device* (``dev=d``: an escrow fill from one shard of a reclaim
order).  A ``devices=1`` topology makes every flow trivially balanced
and the arithmetic bit-identical to the pre-topology scalar ledger —
the regression tests pin that equivalence.

``HostMemoryBroker`` used to own these counters inline; extracting them
lets the fleet layer (``repro_torch.cluster.fleet``) run N hosts with N
independent ledgers and assert per-host conservation after every fleet
event — including cross-host snapshot migrations, which are a
``snapshot_credit`` on the source ledger and a ``snapshot_charge`` on
the destination one, never a unit teleporting between budgets.

Tenants: the ledger optionally splits the budget into per-tenant
sub-budgets (``tenants={name: units}``, summing exactly to the budget).
Every replica belongs to a tenant (``carve(..., tenant=)``), escrow
fills are attributed to the *requesting* grant's tenant, and snapshot
charges carry their owner tenant — so the host accounts are exactly the
tenant account sums and the conservation law extends to

    sum_over_tenants(free_t + granted_t + escrow_t + snapshot_t) == budget

where ``free_t = sub_budget_t - usage_t`` may go *negative* for a tenant
overdrawn into host slack (grants are work-conserving).  The fairness
rule built on these accounts lives broker-side: one tenant's grant can
squeeze another tenant's snapshots only while the owner stays at or
above its sub-budget afterwards (``HostMemoryBroker._squeeze_snapshots``).
Without an explicit ``tenants=`` map the ledger runs one implicit
``"default"`` tenant owning the whole budget, and every pre-tenant call
site behaves identically.  Tenant accounts stay host-scalar: replicas
span the full mesh, so a tenant's per-device footprint is its host
footprint striped over the devices.

Each verb asserts its own preconditions (no negative balances, no
overdrafts, balanced flows actually balanced), so an illegal flow fails
loudly at the flow, not later at a ``check`` that can no longer say who
leaked.
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.cluster.topology import DeviceTopology

DEFAULT_TENANT = "default"


class BudgetLedger:
    """Unit-conservation ledger for one host's memory budget, kept as
    per-device account vectors over the host's ``DeviceTopology``."""

    def __init__(self, budget_units: Optional[int] = None,
                 tenants: Optional[dict[str, int]] = None,
                 topology: Optional[DeviceTopology] = None):
        if topology is None:
            assert budget_units is not None and budget_units > 0
            topology = DeviceTopology.single(budget_units)
        assert budget_units is None \
            or budget_units == topology.total_units, \
            f"budget {budget_units} != topology total {topology.total_units}"
        self.topology = topology
        self.budget_units = topology.total_units
        if tenants is None:
            tenants = {DEFAULT_TENANT: self.budget_units}
        assert tenants and all(v >= 0 for v in tenants.values()), tenants
        assert sum(tenants.values()) == self.budget_units, \
            f"tenant sub-budgets {tenants} must sum to budget " \
            f"{self.budget_units}"
        self.sub_budgets: dict[str, int] = dict(tenants)
        # per-device account vectors: THE state.  The scalar accounts the
        # broker (and every pre-topology call site) reads are their sums.
        self._free_dev: list[int] = list(topology.budgets)
        self._granted_dev: dict[str, list[int]] = {}
        self._escrow_dev: list[int] = [0] * topology.n_devices
        self._snapshot_dev: list[int] = [0] * topology.n_devices
        # scalar view of granted, maintained alongside the vectors (the
        # broker exposes this dict directly; ``check`` cross-verifies it)
        self.granted: dict[str, int] = {}
        # tenant attribution: replicas map to tenants; escrow and snapshot
        # units carry their owning tenant explicitly (granted is derived
        # from the replica map, so it cannot diverge)
        self.tenant_of: dict[str, str] = {}
        self._tenant_escrow: dict[str, int] = {t: 0 for t in tenants}
        self._tenant_snapshot: dict[str, int] = {t: 0 for t in tenants}

    # ------------------------------------------------------- device views
    @property
    def n_devices(self) -> int:
        return self.topology.n_devices

    @property
    def free_units(self) -> int:
        return sum(self._free_dev)

    @property
    def escrow_units(self) -> int:
        return sum(self._escrow_dev)

    @property
    def snapshot_units(self) -> int:
        return sum(self._snapshot_dev)

    def free_dev(self, dev: int) -> int:
        return self._free_dev[dev]

    def granted_dev(self, replica_id: str) -> tuple[int, ...]:
        return tuple(self._granted_dev[replica_id])

    def balanced_free(self) -> int:
        """Units a *balanced* flow can still take from the pool: the
        scarcest device bounds every shard (== ``free_units`` on a
        single-device topology)."""
        return min(self._free_dev) * self.n_devices

    def device_report(self) -> list[dict[str, int]]:
        """Per-device account snapshot (occupancy surface for reports,
        demos, and the scenario rows)."""
        return [{"budget": self.topology.budgets[d],
                 "free": self._free_dev[d],
                 "granted": sum(v[d] for v in self._granted_dev.values()),
                 "escrow": self._escrow_dev[d],
                 "snapshot": self._snapshot_dev[d]}
                for d in range(self.n_devices)]

    def _per(self, units: int, what: str) -> int:
        return self.topology.assert_balanced(units, what)

    # -------------------------------------------------------------- tenants
    def resolve_tenant(self, tenant: Optional[str] = None) -> str:
        """Validate ``tenant``; ``None``/empty falls back to the sole
        tenant (an explicit name is required on multi-tenant ledgers)."""
        if tenant:
            assert tenant in self.sub_budgets, \
                f"unknown tenant {tenant!r} (have {sorted(self.sub_budgets)})"
            return tenant
        assert len(self.sub_budgets) == 1, \
            "multi-tenant ledger: an explicit tenant is required"
        return next(iter(self.sub_budgets))

    def tenant_granted(self, tenant: str) -> int:
        return sum(u for r, u in self.granted.items()
                   if self.tenant_of[r] == tenant)

    def tenant_escrow(self, tenant: str) -> int:
        return self._tenant_escrow[tenant]

    def tenant_snapshot(self, tenant: str) -> int:
        return self._tenant_snapshot[tenant]

    def tenant_usage(self, tenant: str) -> int:
        """Units the tenant currently holds across granted + escrow +
        snapshot (its footprint against its sub-budget)."""
        return self.tenant_granted(tenant) + self._tenant_escrow[tenant] \
            + self._tenant_snapshot[tenant]

    def tenant_free(self, tenant: str) -> int:
        """Sub-budget headroom; negative = overdrawn into host slack."""
        return self.sub_budgets[tenant] - self.tenant_usage(tenant)

    def tenant_report(self) -> dict[str, Any]:
        return {t: {"sub_budget": self.sub_budgets[t],
                    "granted": self.tenant_granted(t),
                    "escrow": self._tenant_escrow[t],
                    "snapshot": self._tenant_snapshot[t],
                    "free": self.tenant_free(t)}
                for t in sorted(self.sub_budgets)}

    # ------------------------------------------------------------- replicas
    def carve(self, replica_id: str, units: int,
              tenant: Optional[str] = None) -> None:
        """Boot-time plug: carve a new replica's initial holding out of
        the free pool, binding the replica to its tenant.  Balanced: a
        replica spans the whole mesh, one shard per device."""
        assert replica_id not in self.granted, replica_id
        per = self._per(units, f"carve for {replica_id}")
        assert 0 <= units and all(per <= f for f in self._free_dev), \
            f"budget exhausted carving {units} for {replica_id}: " \
            f"free {self._free_dev}"
        self.tenant_of[replica_id] = self.resolve_tenant(tenant)
        for d in range(self.n_devices):
            self._free_dev[d] -= per
        self._granted_dev[replica_id] = [per] * self.n_devices
        self.granted[replica_id] = units

    def take_free(self, replica_id: str, want: int) -> int:
        """Grant fill: move up to ``want`` units free -> granted,
        balanced over the mesh (the scarcest device clips every shard).
        Never overdrafts; returns units moved."""
        assert replica_id in self.granted, replica_id
        take = min(max(want, 0), self.balanced_free())
        take -= take % self.n_devices
        per = take // self.n_devices
        for d in range(self.n_devices):
            self._free_dev[d] -= per
            self._granted_dev[replica_id][d] += per
        self.granted[replica_id] += take
        return take

    def release(self, replica_id: str, units: int) -> None:
        """Unplug completion: granted -> free, balanced."""
        assert 0 < units <= self.granted.get(replica_id, 0), \
            f"{replica_id} returning {units} units it was never granted"
        per = self._per(units, f"release by {replica_id}")
        vec = self._granted_dev[replica_id]
        assert all(per <= v for v in vec), \
            f"{replica_id} releasing {units} units its device shards " \
            f"{vec} cannot cover"
        for d in range(self.n_devices):
            vec[d] -= per
            self._free_dev[d] += per
        self.granted[replica_id] -= units

    def forget(self, replica_id: str) -> None:
        """VM teardown (host retirement): drop an emptied replica's
        account.  The replica must have released its whole holding first
        — forgetting a non-zero grant would leak units — so this only
        removes the (all-zero) account rows and the tenant binding."""
        assert replica_id in self.granted, replica_id
        assert self.granted[replica_id] == 0, \
            f"{replica_id} still holds {self.granted[replica_id]} units"
        assert all(v == 0 for v in self._granted_dev[replica_id])
        del self.granted[replica_id]
        del self._granted_dev[replica_id]
        del self.tenant_of[replica_id]

    # --------------------------------------------------------------- escrow
    def escrow_fill(self, victim: str, units: int, *,
                    requester: Optional[str] = None,
                    dev: Optional[int] = None) -> None:
        """Order drain: a victim's surrendered units enter escrow (owned
        by an open grant, awaiting the requester's claim).  The escrow is
        attributed to the *requester's* tenant — the grant owns those
        units now — falling back to the victim's tenant when no requester
        is named (direct ledger drives).  ``dev`` names the single device
        one shard of a reclaim order drained on; ``None`` is a balanced
        fill over the whole mesh."""
        assert 0 < units <= self.granted.get(victim, 0), (victim, units)
        owner = requester if requester in self.tenant_of else victim
        vec = self._granted_dev[victim]
        if dev is None:
            per = self._per(units, f"escrow fill from {victim}")
            assert all(per <= v for v in vec), (victim, units, vec)
            for d in range(self.n_devices):
                vec[d] -= per
                self._escrow_dev[d] += per
        else:
            assert 0 <= dev < self.n_devices, dev
            assert units <= vec[dev], \
                f"{victim} shard {dev} holds {vec[dev]}, draining {units}"
            vec[dev] -= units
            self._escrow_dev[dev] += units
        self.granted[victim] -= units
        self._tenant_escrow[self.tenant_of[owner]] += units

    def escrow_claim(self, replica_id: str, units: int) -> None:
        """Grant completion: escrow -> the requester's holding.  Claims
        are always balanced — only shard-coherent stripes (every device's
        fill present) ever become claimable."""
        assert 0 < units <= self.escrow_units, (units, self.escrow_units)
        assert replica_id in self.granted, replica_id
        t = self.tenant_of[replica_id]
        assert units <= self._tenant_escrow[t], \
            f"tenant {t} claiming {units} escrowed units it owns " \
            f"{self._tenant_escrow[t]} of"
        per = self._per(units, f"escrow claim by {replica_id}")
        assert all(per <= e for e in self._escrow_dev), \
            f"claim of {units} not covered per-device: {self._escrow_dev}"
        for d in range(self.n_devices):
            self._escrow_dev[d] -= per
            self._granted_dev[replica_id][d] += per
        self._tenant_escrow[t] -= units
        self.granted[replica_id] += units

    def escrow_release(self, units: int, *, requester: str,
                       dev: Optional[int] = None) -> None:
        """Escrow -> free: unwind stranded *incoherent* fills (an order
        closed with some shards drained and their siblings canceled, so
        the stripe can never complete).  The requester's grant owned the
        escrow; its tenant's account is debited.  Single-device by
        nature (the stranded shards are the uneven ones)."""
        if units == 0:
            return
        t = self.tenant_of[requester] if requester in self.tenant_of \
            else self.resolve_tenant(None)
        assert 0 < units <= self._tenant_escrow[t], \
            (units, t, self._tenant_escrow)
        if dev is None:
            per = self._per(units, "escrow release")
            assert all(per <= e for e in self._escrow_dev)
            for d in range(self.n_devices):
                self._escrow_dev[d] -= per
                self._free_dev[d] += per
        else:
            assert 0 <= dev < self.n_devices, dev
            assert units <= self._escrow_dev[dev], \
                (units, dev, self._escrow_dev)
            self._escrow_dev[dev] -= units
            self._free_dev[dev] += units
        self._tenant_escrow[t] -= units

    # ------------------------------------------------------------- snapshot
    def snapshot_charge(self, units: int,
                        tenant: Optional[str] = None) -> None:
        """Pool insert: free -> snapshot charge, owned by ``tenant``.
        Balanced: a sharded snapshot carries one fragment per device."""
        assert 0 < units <= self.free_units, (units, self.free_units)
        per = self._per(units, "snapshot charge")
        assert all(per <= f for f in self._free_dev), \
            f"snapshot charge of {units} not covered per-device: " \
            f"{self._free_dev}"
        for d in range(self.n_devices):
            self._free_dev[d] -= per
            self._snapshot_dev[d] += per
        self._tenant_snapshot[self.resolve_tenant(tenant)] += units

    def snapshot_credit(self, units: int,
                        tenant: Optional[str] = None) -> None:
        """Pool drop/evict/squeeze: snapshot charge -> free.  A zero
        credit is a no-op (callers pass through ``pool.drop`` returns)."""
        if units == 0:
            return
        assert 0 < units <= self.snapshot_units, \
            (units, self.snapshot_units)
        t = self.resolve_tenant(tenant)
        assert units <= self._tenant_snapshot[t], \
            f"tenant {t} crediting {units} snapshot units it owns " \
            f"{self._tenant_snapshot[t]} of"
        per = self._per(units, "snapshot credit")
        assert all(per <= s for s in self._snapshot_dev)
        for d in range(self.n_devices):
            self._snapshot_dev[d] -= per
            self._free_dev[d] += per
        self._tenant_snapshot[t] -= units

    def snapshot_reattribute(self, units: int,
                             frm: Optional[str] = None,
                             to: Optional[str] = None) -> None:
        """Shared-page owner handoff: the owning tenant's last reference
        to a still-referenced page dropped, so its charge moves to a
        surviving referencing tenant.  Pure attribution — the device
        vectors and the host snapshot total are untouched — so evicting
        a shared page never strands charge on a tenant that no longer
        references it."""
        assert units >= 0, units
        f, t = self.resolve_tenant(frm), self.resolve_tenant(to)
        if units == 0 or f == t:
            return
        assert units <= self._tenant_snapshot[f], \
            f"tenant {f} reattributing {units} snapshot units it owns " \
            f"{self._tenant_snapshot[f]} of"
        self._tenant_snapshot[f] -= units
        self._tenant_snapshot[t] += units

    # ------------------------------------------------------------ invariant
    def check(self) -> None:
        """THE conservation law — the one code path per host that proves
        no unit was leaked or double-granted: per-device, host-wide, AND
        per-tenant."""
        assert all(f >= 0 for f in self._free_dev), self._free_dev
        assert all(e >= 0 for e in self._escrow_dev), self._escrow_dev
        assert all(s >= 0 for s in self._snapshot_dev), self._snapshot_dev
        assert all(v >= 0 for vec in self._granted_dev.values()
                   for v in vec)
        # per-device conservation: every device's column balances against
        # ITS budget — the host-wide law below is this law's sum
        for d in range(self.n_devices):
            assert self._free_dev[d] \
                + sum(v[d] for v in self._granted_dev.values()) \
                + self._escrow_dev[d] + self._snapshot_dev[d] \
                == self.topology.budgets[d], \
                f"device {d} units leaked or double-granted"
        # the scalar granted view cannot diverge from the device vectors
        assert set(self.granted) == set(self._granted_dev)
        for r, vec in self._granted_dev.items():
            assert self.granted[r] == sum(vec), \
                f"{r}: scalar granted {self.granted[r]} != shards {vec}"
        assert self.free_units + sum(self.granted.values()) \
            + self.escrow_units + self.snapshot_units \
            == self.budget_units, "host units leaked or double-granted"
        # tenant accounts sum exactly to the host accounts
        assert sum(self.sub_budgets.values()) == self.budget_units
        assert set(self.tenant_of.values()) <= set(self.sub_budgets)
        assert all(v >= 0 for v in self._tenant_escrow.values())
        assert all(v >= 0 for v in self._tenant_snapshot.values())
        assert sum(self._tenant_escrow.values()) == self.escrow_units, \
            "tenant escrow attribution diverged from the host account"
        assert sum(self._tenant_snapshot.values()) == self.snapshot_units, \
            "tenant snapshot attribution diverged from the host account"
        # free_t is derived (sub_budget - usage, may be negative for an
        # overdrawn tenant), so this sum is the real cross-check that the
        # per-tenant accounts partition the host budget exactly
        assert sum(self.tenant_free(t) for t in self.sub_budgets) \
            == self.free_units, "tenant free headroom diverged"
        assert sum(self.tenant_free(t) + self.tenant_granted(t)
                   + self._tenant_escrow[t] + self._tenant_snapshot[t]
                   for t in self.sub_budgets) == self.budget_units, \
            "tenant conservation law violated"
