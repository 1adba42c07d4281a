"""Invocation router: spreads a shared trace across replicas.

The FaaS front-end analogue: a host (or fleet of hosts) runs N replicas
and every incoming invocation must be assigned to one.  Policies:

  * ``least_loaded``  — send to the replica with the fewest in-flight +
                        queued invocations (classic load spreading).
  * ``warm_affinity`` — prefer a replica holding a warm (kept-alive)
                        container for the same function profile, so the
                        invocation skips prefill (the paper's warm-start
                        fast path); falls back to least-loaded.
  * ``power_of_two``  — power-of-two-choices: sample two replicas (seeded
                        rng, deterministic for a fixed trace) and take the
                        less loaded — but first avoid the one that is
                        mid-reclaim (open ``ReclaimOrder``s reported by
                        the broker's pressure signal): routing onto a
                        draining victim both slows its drain and lands
                        the invocation on a shrinking arena.
  * ``snapshot_affinity`` — warm row > host snapshot > any replica: a
                        warm container is still the fastest start, but
                        when none exists and the host snapshot pool holds
                        the function's prefix KV (see
                        ``repro_torch.cluster.snapshots``), ANY replica can
                        restore it — the pool is host-wide, à la
                        TrEnv-X's remote snapshot pools — so the pick
                        degrades to least-loaded among non-draining
                        replicas (a restore adds memory demand, which a
                        mid-reclaim victim should not absorb).
  * ``drain_weighted`` — the fleet-aware policy: replicas are ranked by
                        start-path tier, then by a WEIGHTED drain score.
                        Tiers, fastest start first:

                          0. local warm row (adopt, zero copy);
                          1. replica whose own host's pool holds a
                             restorable snapshot (local restore);
                          2. some OTHER host holds it (remote snapshot:
                             the fleet migrates it to the chosen host,
                             paying the modeled inter-host copy — see
                             ``repro_torch.cluster.fleet``);
                          3. nothing cached anywhere (cold prefill).

                        Within a tier the key is ``(open_order_units,
                        load, id)`` — unlike the binary dodge above, a
                        replica owing 1 block outranks one owing 20, so
                        pressure spreads by *magnitude*, not presence.
  * ``slo_tiered``    — latency-tiered spending of cached warm state:
                        a "tight"/"standard" invocation routes exactly
                        like ``drain_weighted`` (warm > local snapshot >
                        remote snapshot > cold), but a "batch" invocation
                        (``slo_tier_of(req) == "batch"``) deliberately
                        AVOIDS replicas holding a warm row for its
                        profile — batch traffic must not consume (or
                        refresh) the warm/snapshot capacity the tight
                        tier's tail depends on — and spreads cold by the
                        weighted drain key.  ``tight_routes`` /
                        ``batch_routes`` count the per-tier assignments.

Ties break on replica id, so routing is deterministic for a fixed trace.
A custom ``route_fn(req, engines) -> replica_id`` overrides the policy
(benchmarks use this to pin tenants to replicas).

``broker`` (optional) supplies the drain-awareness signal
(``open_order_units``) and the restore-feasibility probe
(``snapshot_restorable`` — entry present AND payload to copy back, so
the router never predicts a restore that cannot happen).  ``fleet``
(optional, a ``repro_torch.cluster.fleet.FleetScheduler``) supplies the same
signals fleet-wide — per-replica host brokers via ``broker_of`` and the
cross-host snapshot view via ``snapshot_host``.  ``ClusterSim`` wires
its broker in automatically; ``FleetSim`` wires the scheduler.

Accounting: ``warm_routes`` / ``snapshot_routes`` / ``remote_routes``
count ROUTE-TIME picks — the replica looked warm (resp. a local / remote
pool held a snapshot) when the arrival was assigned.  They are
predictions, not outcomes: keep-alive expiry can recycle the warm
container (or pressure can squeeze the snapshot) before the invocation's
``submit_s`` arrives, in which case the engine silently cold-starts.
The authoritative hit counters live engine-side (``ServeEngine``'s
``warm_starts`` / ``restore_starts`` / ``remote_restore_starts``,
surfaced as ``warm_hits`` etc. in the sim metrics): they count the start
path that actually ran.  ``drain_avoided`` counts picks the drain term
changed (vs. pure load order) under ANY drain-aware policy.
"""
from __future__ import annotations

import random
from typing import Callable, Optional

from repro_torch.serving.request import slo_tier_of

POLICIES = ("least_loaded", "warm_affinity", "power_of_two",
            "snapshot_affinity", "drain_weighted", "slo_tiered")


class Router:
    def __init__(self, policy: str = "least_loaded",
                 route_fn: Optional[Callable] = None,
                 broker=None, fleet=None, seed: int = 0):
        assert route_fn is not None or policy in POLICIES, policy
        self.policy = policy
        self.route_fn = route_fn
        self.broker = broker
        self.fleet = fleet
        self._rng = random.Random(seed)
        self.routed: dict[str, int] = {}      # replica -> #assigned
        self.warm_routes = 0                  # route-time warm picks
        self.snapshot_routes = 0              # route-time local-pool picks
        self.remote_routes = 0                # route-time remote-pool picks
        self.drain_avoided = 0                # picks the drain term changed
        self.tight_routes = 0                 # slo_tiered: non-batch picks
        self.batch_routes = 0                 # slo_tiered: batch picks

    def _score(self, rid: str, engines, backlog) -> tuple[int, str]:
        load = engines[rid].load() + (backlog or {}).get(rid, 0)
        return (load, rid)

    def _draining(self, rid: str) -> int:
        """Blocks ``rid`` still owes to open reclaim orders (0 without a
        broker/fleet or for brokers without the async order plane)."""
        if self.broker is not None:
            fn = getattr(self.broker, "open_order_units", None)
            return fn(rid) if fn is not None else 0
        if self.fleet is not None:
            return self.fleet.open_order_units(rid)
        return 0

    def _key(self, rid: str, engines, backlog, *, weighted: bool
             ) -> tuple[int, tuple[int, str]]:
        """THE drain-aware routing key, shared by every policy that
        dodges mid-reclaim victims: (drain penalty, load, id).  The
        legacy policies use a binary penalty (any open order at all);
        ``drain_weighted`` ranks by how MANY blocks the replica owes."""
        owed = self._draining(rid)
        return (owed if weighted else int(owed > 0),
                self._score(rid, engines, backlog))

    def _pick(self, cands, engines, backlog, *, weighted: bool = False
              ) -> str:
        """Min over the shared key; counts ``drain_avoided`` whenever the
        drain term changed the pick vs. pure load order."""
        rid = min(cands, key=lambda r: self._key(r, engines, backlog,
                                                 weighted=weighted))
        by_load = min(cands, key=lambda r: self._score(r, engines, backlog))
        if rid != by_load:
            self.drain_avoided += 1
        return rid

    # ------------------------------------------------- snapshot visibility
    def _host_broker(self, rid: str):
        """The broker arbitrating ``rid``'s host (single-host: the wired
        broker; fleet: that replica's placement)."""
        if self.broker is not None:
            return self.broker
        if self.fleet is not None:
            return self.fleet.broker_of(rid)
        return None

    def device_headroom(self, rid: str) -> Optional[int]:
        """Observability probe: the BALANCED free headroom of ``rid``'s
        host (scarcest device × device count — what a sharded plug could
        actually take).  Surfaced for reports and demos only; it is
        deliberately NOT part of any routing key, so a ``devices=1``
        topology replays every routing trace bit-identically."""
        b = self._host_broker(rid)
        led = getattr(b, "ledger", None) if b is not None else None
        return led.balanced_free() if led is not None else None

    def _snapshot_restorable(self, profile_name: str) -> bool:
        """Host-wide probe (snapshot_affinity): does THE host's pool —
        or, fleet-wired, any host's — hold a restorable copy?"""
        if self.broker is not None:
            fn = getattr(self.broker, "snapshot_restorable", None)
            return bool(fn(profile_name)) if fn is not None else False
        if self.fleet is not None:
            return self.fleet.snapshot_host(profile_name) is not None
        return False

    def _restorable_on(self, rid: str, profile_name: str) -> bool:
        """Per-replica probe (drain_weighted tier 1): restorable from the
        pool of ``rid``'s OWN host, i.e. without a cross-host copy."""
        b = self._host_broker(rid)
        fn = getattr(b, "snapshot_restorable", None) if b is not None \
            else None
        return bool(fn(profile_name)) if fn is not None else False

    def _tier(self, rid: str, req, engines, remote_exists: bool) -> int:
        """``drain_weighted``'s start-path tier for ``rid`` (see module
        docstring): 0 warm, 1 local snapshot, 2 remote snapshot, 3 cold.
        ``remote_exists`` (does ANY host's pool hold the key?) is replica-
        independent, so the caller probes it once per arrival."""
        key = req.profile.name
        if engines[rid].warm.get(key):
            return 0
        if self._restorable_on(rid, key):
            return 1
        return 2 if remote_exists else 3

    def _route_tiered(self, req, engines: dict, backlog) -> str:
        """The start-path-tiered pick (``drain_weighted``'s core, shared
        with ``slo_tiered``'s non-batch traffic): best tier wins, weighted
        drain key within the tier, per-tier route counters."""
        remote = self.fleet is not None and \
            self.fleet.snapshot_host(req.profile.name) is not None
        tiers = {r: self._tier(r, req, engines, remote)
                 for r in engines}
        best = min(tiers.values())
        rid = self._pick([r for r in engines if tiers[r] == best],
                         engines, backlog, weighted=True)
        if best == 0:
            self.warm_routes += 1
        elif best == 1:
            self.snapshot_routes += 1
        elif best == 2:
            self.remote_routes += 1
        return rid

    def _mask_lifecycle(self, engines: dict) -> dict:
        """Drop replicas on retiring (or already-retired) hosts — and on
        hosts still PROVISIONING (booted but not yet ready) — from the
        candidate set: EVERY tier of every policy skips them, since a
        retiring host accepts no new work and a booting one cannot serve
        it yet.  Falls back to the full set if nothing survives the mask
        (an arrival must route somewhere)."""
        f = self.fleet
        if f is None:
            return engines
        ready = getattr(f, "host_ready", lambda h: True)
        if not (getattr(f, "retiring", None) or getattr(f, "retired", None)
                or getattr(f, "_ready_at", None)):
            return engines
        live = {r: e for r, e in engines.items()
                if (h := f.host_of(r)) is None
                or (h in f.brokers and h not in f.retiring and ready(h))}
        return live or engines

    def route(self, req, engines: dict, backlog: Optional[dict] = None
              ) -> str:
        """Pick the replica for ``req``.  ``backlog`` counts routed-but-
        not-yet-submitted invocations per replica (the router's own queue
        view, so bursts don't all land on one replica)."""
        if self.route_fn is not None:
            rid = self.route_fn(req, engines)
        else:
            engines = self._mask_lifecycle(engines)
            rid = None
            if self.policy in ("warm_affinity", "snapshot_affinity"):
                warm = [r for r, e in engines.items()
                        if e.warm.get(req.profile.name)]
                if warm:
                    rid = min(warm,
                              key=lambda r: self._score(r, engines, backlog))
                    self.warm_routes += 1
            if rid is None and self.policy == "snapshot_affinity" \
                    and self._snapshot_restorable(req.profile.name):
                # the pool is host-wide: any replica restores equally well,
                # so spread by load but dodge mid-reclaim victims
                rid = self._pick(list(engines), engines, backlog)
                self.snapshot_routes += 1
            elif rid is None and self.policy == "drain_weighted":
                rid = self._route_tiered(req, engines, backlog)
            elif rid is None and self.policy == "slo_tiered":
                if slo_tier_of(req) == "batch":
                    # batch must not consume warm capacity: avoid replicas
                    # holding a warm row for this profile (unless every
                    # replica does), spread by the weighted drain key
                    key = req.profile.name
                    cold = [r for r, e in engines.items()
                            if not e.warm.get(key)]
                    rid = self._pick(cold or list(engines), engines,
                                     backlog, weighted=True)
                    self.batch_routes += 1
                else:
                    rid = self._route_tiered(req, engines, backlog)
                    self.tight_routes += 1
            elif rid is None and self.policy == "power_of_two":
                ids = sorted(engines)
                pair = ids if len(ids) <= 2 else self._rng.sample(ids, 2)
                rid = self._pick(pair, engines, backlog)
            if rid is None and self.policy == "snapshot_affinity":
                # the cold fallback must honor the docstring's promise —
                # "least-loaded among NON-DRAINING replicas": pure load
                # order here used to land invocations on mid-reclaim
                # victims exactly when nothing was cached
                rid = self._pick(list(engines), engines, backlog)
            if rid is None:
                rid = min(engines,
                          key=lambda r: self._score(r, engines, backlog))
        self.routed[rid] = self.routed.get(rid, 0) + 1
        return rid
