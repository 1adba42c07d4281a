"""Vanilla paged baseline — the state-of-practice the paper measures against.

Requests allocate KV blocks lazily from a shared pool as their context grows
(the guest OS's lazy page-fault allocation).  The allocator hands out *any*
free block, so concurrent requests' footprints interleave across the pool
(paper Fig. 2).  Releasing a request frees scattered blocks; shrinking the
pool then requires **migrating** live blocks out of the tail being dropped —
real device copies (``kv_compact``) whose cost grows with occupancy and
which steal HBM bandwidth from concurrently decoding requests.  That cost is
exactly what HotMem eliminates.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Optional

from repro_torch.core.arena import ArenaSpec, ReclaimEvent


class VanillaPagedManager:
    """Block-table manager over a shared block pool (host metadata)."""

    def __init__(self, spec: ArenaSpec, seed: int = 0,
                 pool_blocks: Optional[int] = None):
        self.spec = spec
        self.pool_blocks = spec.n_blocks if pool_blocks is None else \
            pool_blocks
        self._rng = random.Random(seed)
        self._free: list[int] = list(range(self.pool_blocks))
        self._rng.shuffle(self._free)          # interleaved hand-out order
        self._tables: dict[str, list[int]] = {}
        self._tokens: dict[str, int] = {}
        self.waitqueue: list[str] = []
        self.reclaim_events: list[ReclaimEvent] = []
        self.kills = 0

    # ------------------------------------------------------------- queries
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def live_blocks(self) -> int:
        return self.pool_blocks - len(self._free)

    def occupancy(self) -> float:
        return self.live_blocks / max(self.pool_blocks, 1)

    def block_table(self, req: str) -> list[int]:
        return self._tables[req]

    # ------------------------------------------------------------ allocate
    def reserve(self, req: str) -> Optional[int]:
        """Admission: start a request (no blocks yet — lazy)."""
        if req in self._tables:
            return 0
        # admission control mirrors HotMem's: capacity for one full budget
        if (self.free_blocks < self.spec.blocks_per_partition
                or len(self._tables) >= self.spec.n_partitions):
            if req not in self.waitqueue:
                self.waitqueue.append(req)
            return None
        self._tables[req] = []
        self._tokens[req] = 0
        return 0

    def grow(self, req: str, n_tokens: int) -> Optional[list[int]]:
        """Lazy block allocation as the context grows (page faults).
        Returns newly allocated block ids, or None when killed (budget)."""
        self._tokens[req] += n_tokens
        if self._tokens[req] > self.spec.partition_tokens:
            self.kills += 1
            self.release(req)
            return None
        need = -(-self._tokens[req] // self.spec.block_tokens)
        new = []
        while len(self._tables[req]) < need:
            if not self._free:
                return new        # pool exhausted; caller must plug
            new.append(self._free.pop())
            self._tables[req].append(new[-1])
        return new

    def adopt(self, old: str, new: str) -> int:
        """Warm reuse: hand a kept-alive request's blocks to a new one."""
        self._tables[new] = self._tables.pop(old)
        self._tokens.pop(old, None)
        self._tokens[new] = 0
        return 0

    def release(self, req: str) -> Optional[str]:
        """Free a request's (scattered) blocks."""
        blocks = self._tables.pop(req, [])
        self._tokens.pop(req, None)
        self._free.extend(blocks)
        self._rng.shuffle(self._free)         # keep hand-out interleaved
        if self.waitqueue:
            return self.waitqueue.pop(0)
        return None

    # -------------------------------------------------------- plug/unplug
    def plug(self, k_blocks: int) -> int:
        k = min(k_blocks, self.spec.n_blocks - self.pool_blocks)
        new = list(range(self.pool_blocks, self.pool_blocks + k))
        self.pool_blocks += k
        self._free.extend(new)
        self._rng.shuffle(self._free)
        return k

    def shrink_plan(self, k_blocks: int) -> tuple[int, list[tuple[int, int]]]:
        """To drop the tail ``k_blocks``, live blocks in the tail must
        migrate into free head slots.  Returns (achievable_k, [(src, dst)])
        — the migration list whose cost HotMem avoids entirely."""
        target = self.pool_blocks - k_blocks
        tail_live = [b for t in self._tables.values() for b in t
                     if b >= target]
        head_free = sorted(b for b in self._free if b < target)
        if len(tail_live) > len(head_free):   # cannot fully evacuate:
            # partial offline — evacuate only the deepest evacuable blocks
            tail_live = sorted(tail_live, reverse=True)[:len(head_free)]
        moves = list(zip(sorted(tail_live, reverse=True), head_free))
        # achievable shrink: largest suffix free after the moves
        occupied = set(b for t in self._tables.values() for b in t)
        occupied -= {s for s, _ in moves}
        occupied |= {d for _, d in moves}
        new_top = self.pool_blocks
        while new_top - 1 >= 0 and (new_top - 1) not in occupied:
            new_top -= 1
        k = min(k_blocks, self.pool_blocks - new_top)
        return k, moves

    def apply_shrink(self, k: int, moves: list[tuple[int, int]],
                     copy_seconds: float = 0.0) -> ReclaimEvent:
        """Commit a shrink after the device copies ran (caller timed them)."""
        t0 = time.perf_counter()
        remap = dict(moves)
        for req, table in self._tables.items():
            self._tables[req] = [remap.get(b, b) for b in table]
        target = self.pool_blocks - k
        dsts = {d for _, d in moves}
        self._free = [b for b in self._free if b not in dsts]
        self._free.extend(s for s, _ in moves)      # vacated sources
        self._free = [b for b in self._free if b < target]
        self.pool_blocks = target
        ev = ReclaimEvent(
            requested_units=k, reclaimed_units=k,
            reclaimed_bytes=k * self.spec.bytes_per_block,
            migrated_blocks=len(moves),
            migrated_bytes=len(moves) * self.spec.bytes_per_block,
            wall_seconds=(time.perf_counter() - t0) + copy_seconds)
        self.reclaim_events.append(ev)
        return ev

    # ----------------------------------------------------------- invariants
    def check_invariants(self) -> None:
        live = [b for t in self._tables.values() for b in t]
        assert len(set(live)) == len(live), "block double-booked"
        assert set(live).isdisjoint(self._free)
        assert set(live) | set(self._free) == set(range(self.pool_blocks))
        for req, tok in self._tokens.items():
            need = -(-tok // self.spec.block_tokens)
            # never over-allocated; may be UNDER-allocated while the pool
            # is exhausted (lazy faults stall until the runtime plugs)
            assert len(self._tables[req]) <= need
