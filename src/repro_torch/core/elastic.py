"""Elastic arena: bucket ladder + the device-side data plane.

Port of ``repro.core.elastic`` for the HotMem and static modes.  VM resize
(virtio-mem plug/unplug) is a ladder of arena sizes; moving down the ladder
is HotMem's zero-migration shrink: live partitions are whole rows, so a
shrink is O(1) metadata plus a prefix copy of the kept rows into fresh
storage (the old tensors are freed, which is what reclaims the memory).
The vanilla paged mode (migration copies before a shrink) comes with the
port's next slice and raises here.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from repro_torch.core.arena import ArenaSpec, ReclaimEvent
from repro_torch.core.hotmem import HotMemManager
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
    """HotMem bucket-shrink: keep the row prefix, in fresh storage."""
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


# ---------------------------------------------------------------------------
# Facade
# ---------------------------------------------------------------------------


class ElasticArena:
    """One replica's arena: manager (metadata) + optional device cache tree.

    ``mode``: "hotmem" | "static" (statically over-provisioned — the
    paper's third comparison point: never resizes).

    ``grant`` / ``release`` are the host gate (virtio-mem): when set,
    growth is a *request* — ``grant(units)`` returns how many units the
    host actually concedes — and every unit this arena drops flows back
    through ``release``.  Without them the arena resizes unilaterally.
    """

    def __init__(self, cfg, spec: ArenaSpec, mode: str, caches=None,
                 grant=None, release=None):
        if mode not in ("hotmem", "static"):
            raise NotImplementedError(
                f"arena mode {mode!r} is not ported yet (hotmem, static)")
        self.cfg = cfg
        self.spec = spec
        self.mode = mode
        self.caches = caches
        self.manager = HotMemManager(spec)
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

    def absorb(self, units: int) -> float:
        """Grant-completion path: absorb ``units`` the host has *already*
        delivered, skipping the host gate.  Same device work as ``plug``:
        grow rows, zero-fill, hand back any units the manager can't
        take.  (A partition stripes wholly over a sharded host, so only
        the vanilla mode's block granules need a stripe check.)"""
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
        """Shrink the arena: metadata + prefix slice.  Real device timings.
        Reclaimed units flow back to the host gate unless ``notify_host``
        is False (the broker-initiated steal path, which does its own
        accounting)."""
        assert self.mode != "static"
        t0 = time.perf_counter()
        ev = self.manager.unplug(units)
        if ev.reclaimed_units and self.caches is not None:
            self.caches = slice_rows(self.caches, self.manager.plugged)
            sync(self.caches)
        ev.wall_seconds = time.perf_counter() - t0
        if notify_host and self._release is not None and ev.reclaimed_units:
            self._release(ev.reclaimed_units)
        return ev
