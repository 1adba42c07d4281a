"""HotMem partition manager — the paper's contribution (§3–4), TPU-adapted.

Guest-physical memory -> the replica's state arena (leading axis of every
cache array).  One partition == one arena row == one request's entire decode
state, sized by the request-declared token budget.  The manager is the
host-side metadata plane (the kernel's zone structs): it never touches
device data.  Reclamation is therefore O(1) metadata with **zero
migrations** — the paper's key property.

Faithful mechanisms:
  * ``reserve``  — zonelist scan, lowest-index-first (keeps high rows free so
                   shrink rarely blocks); waitqueue when all partitions busy.
  * ``fork``     — children share the parent's partition (refcount
                   ``partition_users``).
  * ``release``  — refcount drop; at zero the partition returns to the free
                   list and the waitqueue head is woken.  Stale state is NOT
                   zeroed (paper: zeroing elided — the arena is re-zeroed
                   once on plug, by the "host").
  * ``plug`` / ``unplug`` — populate / drop whole partitions.  Unplug takes
                   only *empty* partitions (suffix-free, since arena rows are
                   a dense array — see DESIGN.md §5.1) and never migrates.
  * limit enforcement — ``grow`` beyond ``partition_tokens`` kills the
                   request (the paper's OOM-kill on partition overflow).
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from collections import deque
from typing import Optional

from repro_torch.core.arena import ArenaSpec, ReclaimEvent


@dataclasses.dataclass
class _Binding:
    partition: int
    users: int                     # partition_users refcount
    tokens: int                    # occupancy within the budget


class HotMemManager:
    """Host metadata for a HotMem arena (one serving replica)."""

    def __init__(self, spec: ArenaSpec, plugged: Optional[int] = None):
        self.spec = spec
        self.max_partitions = spec.n_partitions     # concurrency factor N
        self.plugged = spec.n_partitions if plugged is None else plugged
        self._free: list[int] = list(range(self.plugged))   # min-heap
        heapq.heapify(self._free)
        self._bindings: dict[str, _Binding] = {}            # req -> binding
        self._owner: dict[int, str] = {}                    # partition -> req
        self.waitqueue: deque[str] = deque()
        # --- counters (benchmarks read these) ---
        self.reclaim_events: list[ReclaimEvent] = []
        self.bytes_zeroed = 0
        self.kills = 0

    # ------------------------------------------------------------- queries
    @property
    def free_partitions(self) -> int:
        return len(self._free)

    @property
    def live_partitions(self) -> int:
        return self.plugged - len(self._free)

    def partition_of(self, req: str) -> Optional[int]:
        b = self._bindings.get(req)
        return b.partition if b else None

    def occupancy(self) -> float:
        return self.live_partitions / max(self.plugged, 1)

    # ------------------------------------------------------------ reserve
    def reserve(self, req: str) -> Optional[int]:
        """Bind ``req`` to the lowest free partition; None -> waitqueued."""
        assert req not in self._bindings, req
        if not self._free:
            if req not in self.waitqueue:
                self.waitqueue.append(req)
            return None
        p = heapq.heappop(self._free)
        self._bindings[req] = _Binding(partition=p, users=1, tokens=0)
        self._owner[p] = req
        return p

    def fork(self, req: str) -> int:
        """clone(): child shares the parent's partition (refcount++)."""
        b = self._bindings[req]
        b.users += 1
        return b.partition

    def adopt(self, old: str, new: str) -> int:
        """Warm reuse: rebind a kept-alive partition to a new request
        (zero data movement; token accounting restarts)."""
        b = self._bindings.pop(old)
        b.tokens = 0
        self._bindings[new] = b
        self._owner[b.partition] = new
        return b.partition

    def grow(self, req: str, n_tokens: int) -> bool:
        """Account token growth; False => budget exceeded, request killed
        (the paper's OOM-kill keeps partition isolation inviolable)."""
        b = self._bindings[req]
        b.tokens += n_tokens
        if b.tokens > self.spec.partition_tokens:
            self.kills += 1
            self.release(req, force=True)
            return False
        return True

    def release(self, req: str, force: bool = False) -> Optional[str]:
        """Refcount drop; at zero the partition frees (NO data movement, NO
        zeroing) and the waitqueue head is woken.  Returns the woken req."""
        b = self._bindings[req]
        b.users -= 1
        if b.users > 0 and not force:
            return None
        del self._bindings[req]
        del self._owner[b.partition]
        heapq.heappush(self._free, b.partition)
        if self.waitqueue:
            return self.waitqueue.popleft()
        return None

    # -------------------------------------------------------- plug/unplug
    def plug(self, k: int) -> int:
        """Populate up to ``k`` partitions (hypervisor plug request).  New
        partitions are zeroed once here (init_on_alloc elided thereafter)."""
        k = min(k, self.max_partitions - self.plugged)
        for p in range(self.plugged, self.plugged + k):
            heapq.heappush(self._free, p)
        self.plugged += k
        self.bytes_zeroed += k * self.spec.bytes_per_partition
        return k

    def shrink_plan(self, k: int) -> list[int]:
        """Partitions an unplug of ``k`` may drop *right now*: the dense-
        array analogue requires a free suffix; lowest-first allocation keeps
        live rows packed at the bottom, so the suffix is normally free."""
        drop = []
        p = self.plugged - 1
        free = set(self._free)
        while p >= 0 and len(drop) < k and p in free:
            drop.append(p)
            p -= 1
        return drop

    def unplug(self, k: int) -> ReclaimEvent:
        """Partition-aware unplug: drop empty partitions, zero migrations.
        Wall time is pure metadata cost — measured, not asserted."""
        t0 = time.perf_counter()
        drop = self.shrink_plan(k)
        for p in drop:
            self._free.remove(p)
        heapq.heapify(self._free)
        self.plugged -= len(drop)
        ev = ReclaimEvent(
            requested_units=k, reclaimed_units=len(drop),
            reclaimed_bytes=len(drop) * self.spec.bytes_per_partition,
            migrated_blocks=0, migrated_bytes=0,
            wall_seconds=time.perf_counter() - t0)
        self.reclaim_events.append(ev)
        return ev

    # ----------------------------------------------------------- invariants
    def check_invariants(self) -> None:
        free = set(self._free)
        live = set(self._owner)
        assert free.isdisjoint(live)
        assert free | live == set(range(self.plugged)) - (
            set() if len(free | live) == self.plugged else set())
        assert len(free) + len(live) == self.plugged
        for req, b in self._bindings.items():
            assert self._owner[b.partition] == req
            assert b.users >= 1
            assert 0 <= b.tokens <= self.spec.partition_tokens
