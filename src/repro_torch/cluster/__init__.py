"""Multi-replica host + fleet layer.

Per host: broker (hypervisor role, unit flows owned by a per-host
``BudgetLedger`` — ONE code path checks ``free + granted + escrow +
snapshot == budget``), the host-memory snapshot pool (warm-restart
state), and the router (FaaS front-end role).  Across hosts: the
``FleetScheduler`` places replicas (pack/spread) and migrates snapshots
between host pools (modeled inter-host copy — real bytes, configurable
bandwidth), so a restore on a host that never ran the function lands
between a local restore and a cold prefill.  ``FleetSim`` couples N
hosts of ``ServeEngine`` replicas on one deterministic virtual timebase;
``ClusterSim`` is its single-host specialization.  Router start-path
tiers (``drain_weighted``): local warm > local snapshot > remote
snapshot > least-loaded, drain-penalized by how many blocks a replica
owes to open reclaim orders.  ``repro_torch.cluster.scenarios`` packages the
whole stack into a bank of named, seeded, deterministic multi-tenant
scenarios, each emitting one schema-stable report row (the regression
surface ``benchmarks/run.py --scenarios`` tracks)."""
from repro_torch.cluster.fleet import (AutoscalePolicy, FleetScheduler,
                                 MigrationRecord)
from repro_torch.cluster.host import (AlwaysGrantBroker, Grant, HostMemoryBroker,
                                MemoryBroker, ReclaimOrder, StealRecord)
from repro_torch.cluster.ledger import DEFAULT_TENANT, BudgetLedger
from repro_torch.cluster.router import Router
from repro_torch.cluster.scenarios import (ROW_SCHEMA, SCENARIOS, SMOKE,
                                     TIME_FIELDS, HedgedRoutePolicy,
                                     ModelReplica, run_bank, run_scenario)
from repro_torch.cluster.sim import ClusterSim, FleetSim
from repro_torch.cluster.snapshots import Snapshot, SnapshotPool, SqueezeRecord
from repro_torch.cluster.topology import DeviceTopology

__all__ = ["AlwaysGrantBroker", "AutoscalePolicy", "BudgetLedger",
           "ClusterSim",
           "DEFAULT_TENANT", "DeviceTopology", "FleetSim",
           "FleetScheduler", "Grant", "HedgedRoutePolicy",
           "HostMemoryBroker", "MemoryBroker", "MigrationRecord",
           "ModelReplica", "ROW_SCHEMA", "ReclaimOrder", "Router",
           "SCENARIOS", "SMOKE", "Snapshot", "SnapshotPool",
           "SqueezeRecord", "StealRecord", "TIME_FIELDS", "run_bank",
           "run_scenario"]
