"""Host-memory snapshot pool: warm-restart state that outlives containers.

An expired or suffix-evicted warm container used to discard its prefix KV,
so the next invocation of the same function paid full prefill.  Following
the serverless snapshot/restore fast path (TrEnv-X remote snapshot pools;
the vHive snapshot study), the host instead keeps a copied-out partition
per function profile in a *host-side* pool and restores it into a freshly
admitted partition — cheaper than prefill, dearer than a warm adopt.

The pool is exactly a Squeezy-style segregated region with bounded
allocation lifetime: every byte in it is immediately droppable metadata
(the authoritative state lives nowhere else), so under host pressure the
broker reclaims snapshot units FIRST — an LRU drop is O(1) bookkeeping
with zero migration and zero victim involvement — before ordering any VM
to shrink.  ``SqueezeRecord`` logs those drops; the absence of
``migrated_bytes``/``ReclaimOrder`` traffic while the pool can cover a
grant is the property the tests pin down.

Unit accounting: the pool is charged against the same host block budget as
the replicas, extending the broker's conservation invariant to

    free + sum(granted) + escrow + snapshot_units == budget

``SnapshotPool`` itself is pure metadata + payload storage; all unit flows
(free pool <-> snapshot charge) are orchestrated by ``HostMemoryBroker``
so the invariant has a single owner.

Content-addressed pages: at millions-of-users scale most function
profiles share prefix structure (system prompts, common templates), so
storing one opaque payload per profile charges the same bytes N times.
Following application-guided dedup (User-guided Page Merging) and the
restore-is-a-mapping observation of the vHive snapshot study, a snapshot
may instead be a **manifest** — an ordered list of page digests into a
host-wide ``PageStore`` that holds each unique page once with a
refcount.  A page's units are charged against the ledger once, on first
reference (owner = the first-referencing tenant), and credited back only
when its refcount hits zero; dropping the owner's last reference while
other tenants still reference the page *reattributes* the charge to a
surviving tenant instead of stranding it.  ``pages=None`` entries are
the exact legacy one-opaque-payload layout, bit-identical to the
pre-page pool.
"""
from __future__ import annotations

import dataclasses
from collections import Counter, OrderedDict
from typing import Any, Callable, Iterable, Optional, Sequence


@dataclasses.dataclass
class Snapshot:
    """One persisted prefix-KV partition, keyed by function profile."""
    key: str                     # function profile name
    units: int                   # host blocks charged against the budget
    tokens: int = 0              # prefix tokens the payload carries
    nbytes: int = 0              # payload bytes (the copy-out cost basis)
    payload: Any = None          # host-side row caches (device_get'd tree)
    replica_id: str = ""         # writer (informational: pool is host-wide)
    created_at: float = 0.0
    last_used: float = 0.0       # LRU recency stamp
    restores: int = 0            # times copied back into a partition
    # cross-host migration (repro_torch.cluster.fleet): the host this entry was
    # copied from, and the modeled inter-host transfer wall still owed.
    # The first restore pays it (claim_copy) and the entry becomes local.
    origin_host: str = ""
    copy_seconds: float = 0.0
    # owning tenant: the sub-budget this entry's charge counts against
    # (empty = the ledger's sole default tenant).  The broker's fairness
    # rule protects another tenant's entries from being squeezed below
    # that tenant's sub-budget.
    tenant: str = ""
    # sharded KV (devices > 1): one payload fragment per device shard.
    # ``None`` = unsharded entry (the devices=1 layout); a sharded entry
    # is restorable only when EVERY fragment is present — a half-captured
    # replica is as useless as a half-drained one, so eviction and
    # migration always move the whole entry atomically.
    fragments: Optional[tuple] = None
    # content-addressed manifest (``None`` = legacy opaque payload): the
    # ordered page digests whose concatenation is this entry's prefix KV.
    # The pages themselves (payload bytes, units, refcount, owner tenant)
    # live in the host-wide ``PageStore``; ``units`` stays the manifest's
    # REFERENCED total (sum of its pages' units) while the ledger charge
    # is refcounted over unique pages.
    pages: Optional[tuple] = None

    @property
    def restorable(self) -> bool:
        """All state present to copy back: a payload, and — for sharded
        entries — every per-device fragment."""
        return self.payload is not None and (
            self.fragments is None
            or all(f is not None for f in self.fragments))

    def claim_copy(self) -> float:
        """Pay the pending inter-host copy: returns the owed wall once
        (0.0 for local entries and on every later restore)."""
        owed, self.copy_seconds = self.copy_seconds, 0.0
        return owed


@dataclasses.dataclass
class SqueezeRecord:
    """One pressure-time snapshot reclaim: the broker dropped ``key`` to
    cover ``requester``'s grant — metadata-only, zero migration, and no
    ``ReclaimOrder`` reached any replica for these units.  For paged
    entries ``units`` is what the drop actually freed (unique pages whose
    refcount hit zero), not the manifest's referenced total."""
    requester: str
    key: str
    units: int
    nbytes: int
    at: float                    # broker-clock timestamp
    tenant: str = ""             # the dropped entry's OWNER tenant


@dataclasses.dataclass
class Page:
    """One unique content-addressed page in the host-wide store.  The
    ledger is charged ``units`` exactly once for it (owner = the first
    tenant to reference it); ``refs`` counts manifest references across
    every snapshot entry on the host, ``ref_tenants`` the same broken
    down per tenant (so owner handoff on deref is deterministic)."""
    digest: str
    units: int
    nbytes: int
    payload: Any
    refs: int = 0
    owner: str = ""                      # charged tenant ("" = default)
    ref_tenants: dict = dataclasses.field(default_factory=dict)


class PageStoreSim:
    """Refcount twin for planning walks: ``_evict_plan`` and
    ``squeezable_snapshot_units`` must predict exactly what a sequence of
    manifest derefs would free (and for which owner), without touching
    the real store.  Mirrors ``PageStore.deref`` arithmetic, including
    deterministic owner reattribution."""

    def __init__(self, store: "PageStore"):
        self._refs = {d: p.refs for d, p in store._pages.items()}
        self._units = {d: p.units for d, p in store._pages.items()}
        self._owner = {d: p.owner for d, p in store._pages.items()}
        self._ref_tenants = {d: dict(p.ref_tenants)
                             for d, p in store._pages.items()}

    def clone(self) -> "PageStoreSim":
        """Independent copy, so a walk can trial-deref an entry and only
        commit the advance when the fairness rule admits the drop."""
        c = object.__new__(PageStoreSim)
        c._refs = dict(self._refs)
        c._units = dict(self._units)
        c._owner = dict(self._owner)
        c._ref_tenants = {d: dict(rt)
                          for d, rt in self._ref_tenants.items()}
        return c

    def new_units(self, pages: Sequence[tuple]) -> int:
        """Units a manifest insert would newly charge under the current
        simulated state: each distinct absent digest counts once."""
        seen: set = set()
        total = 0
        for digest, units, _nb, _payload in pages:
            if digest not in self._refs and digest not in seen:
                seen.add(digest)
                total += units
        return total

    def deref_entry(self, snap: Snapshot) -> tuple[int, dict[str, int]]:
        """Simulate dropping ``snap``'s manifest: returns ``(units
        freed, per-tenant snapshot-account delta)`` — freed pages debit
        their owner, owner handoffs debit the old owner and credit the
        new one — and advances the simulated refcounts, so a later entry
        in the same walk sees the post-drop state."""
        if snap.pages is None:
            return snap.units, {snap.tenant: -snap.units}
        freed = 0
        delta: dict[str, int] = {}
        for digest in snap.pages:
            self._refs[digest] -= 1
            rt = self._ref_tenants[digest]
            rt[snap.tenant] -= 1
            if rt[snap.tenant] == 0:
                del rt[snap.tenant]
            if self._refs[digest] == 0:
                u, owner = self._units[digest], self._owner[digest]
                freed += u
                delta[owner] = delta.get(owner, 0) - u
                del self._refs[digest], self._units[digest]
                del self._owner[digest], self._ref_tenants[digest]
            elif self._owner[digest] == snap.tenant \
                    and snap.tenant not in rt:
                old, new = self._owner[digest], min(rt)
                self._owner[digest] = new
                u = self._units[digest]
                delta[old] = delta.get(old, 0) - u
                delta[new] = delta.get(new, 0) + u
        return freed, delta


class PageStore:
    """Host-wide content-addressed page store: each unique page held
    once, refcounted over every manifest that references it.  All unit
    flows (first-reference charge, zero-refcount credit, owner handoff)
    are orchestrated by ``HostMemoryBroker`` against the ledger; the
    store only reports which flow each ref/deref requires."""

    def __init__(self):
        self._pages: dict[str, Page] = {}
        self.dedup_hits = 0              # refs that found the page present

    # -------------------------------------------------------------- queries
    def __len__(self) -> int:
        return len(self._pages)

    def __contains__(self, digest: str) -> bool:
        return digest in self._pages

    def get(self, digest: str) -> Optional[Page]:
        return self._pages.get(digest)

    @property
    def unique_units(self) -> int:
        return sum(p.units for p in self._pages.values())

    @property
    def unique_nbytes(self) -> int:
        return sum(p.nbytes for p in self._pages.values())

    def missing(self, digests: Iterable[str]) -> list[str]:
        """Distinct digests not present — what a migration must actually
        move to this host (order preserved, duplicates collapsed)."""
        out, seen = [], set()
        for d in digests:
            if d not in self._pages and d not in seen:
                seen.add(d)
                out.append(d)
        return out

    def simulate(self) -> PageStoreSim:
        return PageStoreSim(self)

    # ------------------------------------------------------------ refcounts
    def ref(self, digest: str, *, units: int, nbytes: int, payload: Any,
            tenant: str) -> bool:
        """Add one manifest reference.  Returns True when the page was
        newly created (the caller must ``snapshot_charge`` its units to
        ``tenant``, who becomes the owner); False for a dedup hit (no
        ledger flow — the page is already paid for)."""
        p = self._pages.get(digest)
        if p is None:
            assert units >= 0 and nbytes >= 0 and payload is not None
            self._pages[digest] = Page(digest, units, nbytes, payload,
                                       refs=1, owner=tenant,
                                       ref_tenants={tenant: 1})
            return True
        assert p.units == units and p.nbytes == nbytes, \
            f"digest collision on {digest!r}: ({p.units}u/{p.nbytes}B) " \
            f"vs ({units}u/{nbytes}B)"
        p.refs += 1
        p.ref_tenants[tenant] = p.ref_tenants.get(tenant, 0) + 1
        self.dedup_hits += 1
        return False

    def deref(self, digest: str, tenant: str
              ) -> tuple[str, int, str, str]:
        """Drop one manifest reference.  Returns the ledger flow the
        caller must apply, as ``(outcome, units, frm, to)``:

        * ``("freed", u, owner, "")`` — refcount hit zero, page removed;
          credit ``u`` back to ``owner``.
        * ``("reattributed", u, old, new)`` — the owner's last reference
          dropped but other tenants still hold the page; move the charge
          ``old`` -> ``new`` (deterministic: lexicographic min of the
          surviving referencing tenants).
        * ``("shared", 0, "", "")`` — page still referenced and owned; no
          flow."""
        p = self._pages[digest]
        assert p.refs > 0 and p.ref_tenants.get(tenant, 0) > 0, \
            f"{digest!r}: deref by non-referencing tenant {tenant!r}"
        p.refs -= 1
        p.ref_tenants[tenant] -= 1
        if p.ref_tenants[tenant] == 0:
            del p.ref_tenants[tenant]
        if p.refs == 0:
            del self._pages[digest]
            return ("freed", p.units, p.owner, "")
        if tenant == p.owner and p.owner not in p.ref_tenants:
            old, p.owner = p.owner, min(p.ref_tenants)
            return ("reattributed", p.units, old, p.owner)
        return ("shared", 0, "", "")

    # ---------------------------------------------------------- invariants
    def owner_units(self) -> dict[str, int]:
        """Unique units charged per owner tenant (the per-tenant snapshot
        account cross-check for paged entries)."""
        out: dict[str, int] = {}
        for p in self._pages.values():
            out[p.owner] = out.get(p.owner, 0) + p.units
        return out

    def check_invariants(self) -> None:
        for d, p in self._pages.items():
            assert p.digest == d
            assert p.refs > 0, f"zero-ref page {d!r} not removed"
            assert p.units >= 0 and p.nbytes >= 0
            assert p.payload is not None
            assert all(c > 0 for c in p.ref_tenants.values()), (d, p)
            assert sum(p.ref_tenants.values()) == p.refs, (d, p)
            assert p.owner in p.ref_tenants, \
                f"page {d!r} charge stranded on non-referencing " \
                f"owner {p.owner!r}"

    # -------------------------------------------------------------- report
    def report(self) -> dict[str, Any]:
        return {
            "pages": len(self._pages),
            "unique_units": self.unique_units,
            "unique_nbytes": self.unique_nbytes,
            "referenced_units": sum(p.units * p.refs
                                    for p in self._pages.values()),
            "dedup_hits": self.dedup_hits,
        }


class SnapshotPool:
    """LRU pool of per-profile snapshots.  One snapshot per key (a newer
    capture of the same function replaces the old one); eviction order is
    least-recently-used, where both ``insert`` and ``lookup`` refresh
    recency.  ``max_units`` caps the pool's total budget charge."""

    def __init__(self, max_units: Optional[int] = None):
        assert max_units is None or max_units > 0
        self.max_units = max_units
        self._by_key: "OrderedDict[str, Snapshot]" = OrderedDict()
        # host-wide content-addressed page store for manifest entries;
        # empty (and charge-free) while every entry is the legacy opaque
        # layout, so ``units`` stays bit-identical to the pre-page pool
        self.pages = PageStore()
        # --- counters (reports read these) ---
        self.inserts = 0
        self.replaced = 0
        self.evictions = 0           # LRU/squeeze drops (not replacements)
        self.hits = 0
        self.misses = 0

    # -------------------------------------------------------------- queries
    @property
    def units(self) -> int:
        """The pool's CHARGED units: legacy entries at face value plus
        each unique page once — the figure the ledger's snapshot account
        holds (a paged manifest's referenced total is ``snap.units``)."""
        return sum(s.units for s in self._by_key.values()
                   if s.pages is None) + self.pages.unique_units

    @property
    def referenced_units(self) -> int:
        """Pre-dedup total: every entry's manifest units at face value
        (== ``units`` when no entry is paged)."""
        return sum(s.units for s in self._by_key.values())

    def __len__(self) -> int:
        return len(self._by_key)

    def __contains__(self, key: str) -> bool:
        return key in self._by_key

    def keys(self):
        return list(self._by_key)

    def peek(self, key: str) -> Optional[Snapshot]:
        """Availability probe: no recency refresh, no hit/miss accounting
        (the router calls this per arrival)."""
        return self._by_key.get(key)

    def fits(self, units: int) -> bool:
        """Cap check only: could a ``units``-block snapshot ever fit,
        with every current entry evicted?  (Free-pool headroom is the
        broker's side of the ``snapshot_room`` answer.)"""
        return self.max_units is None or units <= self.max_units

    # ------------------------------------------------------------ mutation
    def lookup(self, key: str, now: float = 0.0) -> Optional[Snapshot]:
        """Restore-path fetch: refresh recency, count the hit.  The
        snapshot stays in the pool (one capture serves every later
        invocation of the profile until evicted)."""
        snap = self._by_key.get(key)
        if snap is None:
            self.misses += 1
            return None
        self.hits += 1
        snap.last_used = now
        snap.restores += 1
        self._by_key.move_to_end(key)
        return snap

    def insert(self, snap: Snapshot) -> None:
        """Store ``snap`` as the most recent entry.  The caller (broker)
        has already dropped any same-key predecessor and charged
        ``snap.units`` against the free pool.  A paged entry's pages are
        already ref'd into the store (so ``self.units`` counts them); the
        manifest itself adds no charge beyond its unique pages."""
        assert snap.key not in self._by_key, snap.key
        assert snap.units > 0, snap
        add = snap.units if snap.pages is None else 0
        assert self.max_units is None or self.units + add \
            <= self.max_units, "pool cap overflow: caller must evict first"
        self.inserts += 1
        self._by_key[snap.key] = snap

    def drop(self, key: str) -> int:
        """Remove ``key``; returns the units to credit back.  Used for
        same-key replacement (not counted as an eviction)."""
        snap = self._by_key.pop(key, None)
        return snap.units if snap is not None else 0

    def evict_lru(self, eligible: Optional[Callable[[Snapshot], bool]] = None
                  ) -> Optional[Snapshot]:
        """Drop the least-recently-used snapshot (squeeze/cap path).  With
        an ``eligible`` predicate, drop the least-recent entry the
        predicate admits — the broker passes its tenant-protection rule
        here, so protected entries are skipped, not reordered."""
        for key, snap in self._by_key.items():
            if eligible is None or eligible(snap):
                del self._by_key[key]
                self.evictions += 1
                return snap
        return None

    def evict(self, key: str) -> Optional[Snapshot]:
        """Drop a specific entry as an *eviction* (counted, unlike
        ``drop``): the broker's planned same-key/LRU eviction path."""
        snap = self._by_key.pop(key, None)
        if snap is not None:
            self.evictions += 1
        return snap

    # ---------------------------------------------------------- invariants
    def check_invariants(self) -> None:
        assert all(s.units > 0 for s in self._by_key.values())
        assert all(s.key == k for k, s in self._by_key.items())
        for s in self._by_key.values():
            if s.fragments is not None:
                assert len(s.fragments) >= 1 and \
                    s.units % len(s.fragments) == 0, \
                    f"{s.key}: {s.units} units over " \
                    f"{len(s.fragments)} fragments"
        # the store's refcounts are EXACTLY the live manifests' references
        # (per digest and per tenant), so no page outlives its manifests
        # and no manifest references an absent page
        refs: Counter = Counter()
        tenant_refs: Counter = Counter()
        for s in self._by_key.values():
            if s.pages is None:
                continue
            assert len(s.pages) >= 1, s.key
            total = 0
            for d in s.pages:
                p = self.pages.get(d)
                assert p is not None, \
                    f"{s.key}: manifest page {d!r} missing from store"
                total += p.units
                refs[d] += 1
                tenant_refs[(d, s.tenant)] += 1
            assert total == s.units, \
                f"{s.key}: manifest units {s.units} != page sum {total}"
        assert refs == Counter({d: self.pages.get(d).refs
                                for d in self.pages._pages}), \
            "page refcounts diverged from live manifests"
        for (d, t), n in tenant_refs.items():
            assert self.pages.get(d).ref_tenants.get(t, 0) == n, \
                f"page {d!r}: tenant {t!r} refcount diverged"
        self.pages.check_invariants()
        if self.max_units is not None:
            assert self.units <= self.max_units, \
                f"pool holds {self.units} units over cap {self.max_units}"

    # -------------------------------------------------------------- report
    def report(self) -> dict[str, Any]:
        return {
            "count": len(self._by_key),
            "units": self.units,
            "referenced_units": self.referenced_units,
            "max_units": self.max_units,
            "inserts": self.inserts,
            "replaced": self.replaced,
            "evictions": self.evictions,
            "hits": self.hits,
            "misses": self.misses,
            "keys": list(self._by_key),
            "pages": self.pages.report(),
        }
