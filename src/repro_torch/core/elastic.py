"""Elastic arena: bucket ladder + the device-side data plane.

Port of ``repro.core.elastic``.  VM resize (virtio-mem plug/unplug) is a
ladder of arena sizes.  Moving *down* the ladder is where the two managers
diverge — the paper's entire point:

  * HotMem: live partitions are whole rows; shrink = O(1) metadata plus a
    prefix copy of the kept rows into fresh storage.  Zero migrations.
  * Vanilla: live blocks are scattered; shrink must first run a migration
    pass (``apply_migrations``: one ``kv_compact`` launch on the card,
    copying live tail blocks into free head slots in place), then truncate
    into fresh storage.  Copy bytes grow with occupancy.

Either way the old tensors are freed, which is what reclaims the memory,
and every timed region ends in a device synchronise.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from repro_torch.core.arena import ArenaSpec, ReclaimEvent
from repro_torch.core.hotmem import HotMemManager
from repro_torch.core.vanilla import VanillaPagedManager
from repro_torch.kernels import ops
from repro_torch.models.layers import tree_leaves, tree_map

# ---------------------------------------------------------------------------
# Bucket ladder
# ---------------------------------------------------------------------------


def bucket_ladder(max_units: int, min_units: int = 1,
                  factor: float = 2.0) -> list[int]:
    """Geometric ladder of arena sizes (in partitions/blocks), ascending."""
    sizes = {max_units}
    u = max_units
    while u > min_units:
        u = max(min_units, int(u / factor))
        sizes.add(u)
    return sorted(sizes)


def target_bucket(ladder: list[int], demand: int) -> int:
    """Smallest bucket covering current demand (with its own headroom)."""
    for b in ladder:
        if b >= demand:
            return b
    return ladder[-1]


# ---------------------------------------------------------------------------
# Device-side data plane (the leading axis of every leaf is the row axis)
# ---------------------------------------------------------------------------


def sync(tree) -> None:
    """Wait for the device work on ``tree``'s tensors: a wall clock read
    after it measures the work, not its launch."""
    dev = next((x.device for x in tree_leaves(tree)), None)
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)


def zero_rows(caches, lo: int, count: int):
    """Zero arena rows [lo, lo+count) in place — plug-time zero-fill
    (zeroing is elided on the reclaim path, per the paper)."""
    for x in tree_leaves(caches):
        x[lo:lo + count].zero_()
    return caches


def slice_rows(caches, new_rows: int):
    """Bucket-shrink: keep the row prefix, in fresh storage."""
    return tree_map(lambda x: x[:new_rows].clone(), caches)


def grow_rows(caches, new_rows: int):
    """Bucket-grow: extend the leading axis with zeroed rows (fresh
    storage)."""
    def g(x):
        out = torch.zeros((new_rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        out[:x.shape[0]] = x
        return out
    return tree_map(g, caches)


def apply_migrations(pool, src, dst, count: int):
    """Vanilla migration pass, in place: ``pool[dst[i]] = pool[src[i]]`` for
    ``i < count`` on every leaf of ``pool`` — one ``kv_compact`` launch for
    all leaves on the card.  ``src``/``dst`` are sequences of ints; a move
    whose ``dst`` is out of range is dropped (the arena pads with
    ``dst = NB``, as the JAX package's fixed-capacity vectors do).  Returns
    ``pool``."""
    ops.kv_compact(tree_leaves(pool), src, dst, count)
    return pool


def pool_rows(pool) -> int:
    return tree_leaves(pool)[0].shape[0]


def gather_blocks(pool, tables: torch.Tensor):
    """Paged read: (NB, BT, ...) pool + (P, max_blocks) tables ->
    (P, max_blocks*BT, ...) row-contiguous copy, zero where a table slot
    is unmapped (-1).  The per-step gather the vanilla layout pays (fused
    by the paged attention kernel); HotMem's contiguous rows skip it."""
    keep = tables >= 0

    def g(x):
        bt = x.shape[1]
        out = x[tables.long().clamp(min=0)]            # (P, MB, BT, ...)
        out = torch.where(
            keep.reshape(tables.shape + (1,) * (x.dim() - 1)), out,
            torch.zeros((), dtype=out.dtype, device=out.device))
        return out.reshape((tables.shape[0], tables.shape[1] * bt)
                           + tuple(x.shape[2:]))
    return tree_map(g, pool)


def scatter_blocks(pool, rows, tables: torch.Tensor):
    """Write row-layout updates back into the pool through the tables, in
    place; unmapped (-1) slots write nothing.  Returns ``pool``."""
    keep = (tables >= 0).reshape(-1)
    idx = tables.long().reshape(-1)[keep]
    for x, r in zip(tree_leaves(pool), tree_leaves(rows), strict=True):
        bt = x.shape[1]
        upd = r.reshape((-1, bt) + tuple(x.shape[2:]))[keep]
        x.index_copy_(0, idx, upd.to(x.dtype))
    return pool


# ---------------------------------------------------------------------------
# Facade
# ---------------------------------------------------------------------------


class ElasticArena:
    """One replica's arena: manager (metadata) + optional device cache tree.

    ``mode``: "hotmem" | "vanilla" | "static" (statically over-provisioned
    — the paper's third comparison point: never resizes).  For "vanilla",
    ``caches`` is the block pool (leading axis = blocks).

    ``grant`` / ``release`` are the host gate (virtio-mem): when set,
    growth is a *request* — ``grant(units)`` returns how many units the
    host actually concedes — and every unit this arena drops flows back
    through ``release``.  Without them the arena resizes unilaterally.

    ``start`` is the arena's first size in partitions (by default all of
    ``spec``'s).
    """

    MOVE_CAPACITY = 256      # padded migration vector (the JAX package's)

    def __init__(self, cfg, spec: ArenaSpec, mode: str, caches=None,
                 seed: int = 0, grant=None, release=None,
                 start: Optional[int] = None):
        self.cfg = cfg
        self.spec = spec
        self.mode = mode
        self.caches = caches
        if mode != "vanilla":
            self.manager = HotMemManager(spec, plugged=start)
        else:
            self.manager = VanillaPagedManager(spec, seed=seed)
            if start is not None:
                # the reference's engine shuffles the full pool, then the
                # start pool again with the same advanced ``Random``: which
                # blocks a shrink migrates depends on both shuffles
                m = self.manager
                m.pool_blocks = start * spec.blocks_per_partition
                m._free = list(range(m.pool_blocks))
                m._rng.shuffle(m._free)
        self._grant: Optional[Callable[[int], int]] = grant
        self._release: Optional[Callable[[int], None]] = release
        self.plug_seconds: list[float] = []

    # ------------------------------------------------------------ lifecycle
    def admit(self, req: str):
        return self.manager.reserve(req)

    def on_tokens(self, req: str, n: int) -> bool:
        r = self.manager.grow(req, n)
        return r is not None and r is not False

    def finish(self, req: str):
        return self.manager.release(req)

    # ------------------------------------------------------------- elastic
    def units(self) -> int:
        if self.mode == "vanilla":
            return self.manager.pool_blocks
        return self.manager.plugged

    def plug(self, units: int) -> float:
        """Grow the arena; returns wall seconds (incl. zero-fill).  With a
        host gate, ``units`` is a request — the host grants what it can
        and any grant the manager can't absorb flows straight back."""
        if self.mode == "static":
            return 0.0
        if self._grant is not None:
            units = self._grant(units)
        return self.absorb(units)

    def absorb(self, units: int, shards: int = 1) -> float:
        """Grant-completion path: absorb ``units`` the host has *already*
        delivered, skipping the host gate.  Same device work as ``plug``:
        grow rows, zero-fill, hand back any units the manager can't
        take.  On a sharded host the delivered units are a whole stripe —
        ``shards`` slabs land one per device, so the count must divide
        evenly (the broker's coherent-claim path guarantees it; a bare
        partial stripe here is a caller bug)."""
        assert shards >= 1 and units % shards == 0, \
            f"absorb of {units} units is not a whole {shards}-shard stripe"
        if units <= 0 or self.mode == "static":
            return 0.0
        t0 = time.perf_counter()
        old = self.units()
        added = self.manager.plug(units)
        if self._release is not None and units > added:
            self._release(units - added)      # manager clamped; hand back
        if added and self.caches is not None:
            self.caches = grow_rows(self.caches, old + added)
            self.caches = zero_rows(self.caches, old, added)
            sync(self.caches)
        dt = time.perf_counter() - t0
        self.plug_seconds.append(dt)
        return dt

    def unplug(self, units: int, notify_host: bool = True) -> ReclaimEvent:
        """Shrink the arena; HotMem = metadata + prefix slice, vanilla =
        migration copies + prefix slice.  Real device timings.  Reclaimed
        units flow back to the host gate unless ``notify_host`` is False
        (the broker-initiated steal path, which does its own accounting)."""
        assert self.mode != "static"
        t0 = time.perf_counter()
        if self.mode == "hotmem":
            ev = self.manager.unplug(units)
            if ev.reclaimed_units and self.caches is not None:
                self.caches = slice_rows(self.caches, self.manager.plugged)
                sync(self.caches)
            ev.wall_seconds = time.perf_counter() - t0
            if notify_host and self._release is not None \
                    and ev.reclaimed_units:
                self._release(ev.reclaimed_units)
            return ev
        # vanilla: plan migrations, run copies, then commit + truncate
        k, moves = self.manager.shrink_plan(units)
        copy_s = 0.0
        if self.caches is not None and moves:
            nmov = len(moves)
            cap = max(self.MOVE_CAPACITY, ((nmov + 255) // 256) * 256)
            src = [0] * cap
            dst = [pool_rows(self.caches)] * cap
            src[:nmov] = [m[0] for m in moves]
            dst[:nmov] = [m[1] for m in moves]
            tc = time.perf_counter()
            self.caches = apply_migrations(self.caches, src, dst, nmov)
            sync(self.caches)
            copy_s = time.perf_counter() - tc
        ev = self.manager.apply_shrink(k, moves, copy_seconds=copy_s)
        if k and self.caches is not None:
            self.caches = slice_rows(self.caches, self.manager.pool_blocks)
            sync(self.caches)
        ev.wall_seconds = time.perf_counter() - t0
        if notify_host and self._release is not None and ev.reclaimed_units:
            self._release(ev.reclaimed_units)
        return ev
