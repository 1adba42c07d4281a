"""Host control plane used by the port's serving engine: the memory broker
with its snapshot pool, budget ledger and device topology (copies of the
plain-Python JAX-package modules of the same names)."""
from repro_torch.cluster.host import (AlwaysGrantBroker, Grant,
                                      HostMemoryBroker, MemoryBroker,
                                      ReclaimOrder)
from repro_torch.cluster.snapshots import Snapshot, SnapshotPool

__all__ = ["AlwaysGrantBroker", "Grant", "HostMemoryBroker", "MemoryBroker",
           "ReclaimOrder", "Snapshot", "SnapshotPool"]
