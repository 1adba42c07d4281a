"""Fused snapshot capture (gather) and restore (scatter) of arena rows.

Port of ``repro.kernels.kv_snapshot``.  The row layout (``LeafSlot``,
``RowLayout``, ``build_layout``), the analytic byte models and the
data-plane counters (``STATS``) are the JAX package's; the two Pallas
kernels become one CUDA source, ``csrc/kv_snapshot.cu``, launched here:

  capture — every leaf's ``rows[i]`` slice into row ``i`` of one
            contiguous ``(N, row_elems)`` blob, one launch for all leaves
            and rows.  The blob's bytes equal the JAX blob's bytes, so page
            digests carry over.
  restore — the inverse scatter, in place into the live leaves (the Pallas
            kernel's ``input_output_aliases``); rows not named keep their
            bytes.

``ops.snapshot_capture`` / ``ops.snapshot_restore`` pick the kernel for
CUDA tensors and ``ref`` for CPU tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import torch

from repro_torch import roofline


# ---------------------------------------------------------------------------
# Row layout: the flat byte image of one arena row
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """One cache leaf's slice of the staging blob."""
    axis: int                    # leaf batch (row) axis
    block_shape: tuple           # leaf shape with the batch extent -> 1
    size: int                    # elements of one row slice
    offset: int                  # element offset into the blob row


@dataclasses.dataclass(frozen=True)
class RowLayout:
    """Static description of a cache tree's per-row staging blob.  Per-row
    slice shapes do not depend on the arena row count, so one layout is
    valid across every bucket of the ladder."""
    slots: tuple                 # tuple[LeafSlot, ...] in tree-flatten order
    dtype: str                   # shared leaf dtype name, e.g. "bfloat16"
    total_elems: int

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def itemsize(self) -> int:
        return self.torch_dtype.itemsize

    @property
    def row_bytes(self) -> int:
        return self.total_elems * self.itemsize


def build_layout(leaves: Sequence[Any], axes: Sequence[int]) -> RowLayout:
    """Layout from (leaf, batch_axis) pairs."""
    assert len(leaves) == len(axes) and leaves
    dtypes = {str(x.dtype).removeprefix("torch.") for x in leaves}
    assert len(dtypes) == 1, \
        f"fused snapshot blob needs one leaf dtype, got {sorted(dtypes)}"
    slots, off = [], 0
    for x, ax in zip(leaves, axes):
        shape = tuple(x.shape)
        block = shape[:ax] + (1,) + shape[ax + 1:]
        size = math.prod(block)
        slots.append(LeafSlot(axis=ax, block_shape=block, size=size,
                              offset=off))
        off += size
    return RowLayout(slots=tuple(slots), dtype=dtypes.pop(),
                     total_elems=off)


# ---------------------------------------------------------------------------
# Kernel launches (CUDA tensors only)
# ---------------------------------------------------------------------------

MAX_LEAVES = 32        # csrc/kv_snapshot.cu::kMaxLeaves (one launch's leaves)


def widest_unit(sizes) -> int:
    """Widest copy unit (16, 8, 4, 2 or 1 bytes) dividing every size and
    address in ``sizes``."""
    for unit in (16, 8, 4, 2, 1):
        if all(s % unit == 0 for s in sizes):
            return unit
    raise AssertionError("unreachable: 1 divides everything")


def _unit_bytes(layout: RowLayout, leaves, blob) -> int:
    """Widest copy unit dividing every chunk size, blob offset, row size
    and base address."""
    item = layout.itemsize
    sizes = [layout.total_elems * item, blob.data_ptr()]
    for leaf, slot in zip(leaves, layout.slots):
        inner = math.prod(slot.block_shape[slot.axis + 1:])
        sizes += [inner * item, slot.offset * item, leaf.data_ptr()]
    return widest_unit(sizes)


def copy_plan(leaves, blob, layout: RowLayout) -> tuple[int, list[int]]:
    """The kernel's copy unit and its per-leaf descriptors, four ints a
    leaf in copy units: ``outer`` (chunks in one row slice: the product of
    the dims before the batch axis, 1 for a batch-axis-0 leaf), ``batch``
    (the batch extent), ``inner`` (units per chunk) and ``offset`` (units
    from the start of a blob row).  Unit ``e`` of chunk ``o`` of row ``r``
    lies at unit ``(o * batch + r) * inner + e`` of the leaf."""
    if len(leaves) != len(layout.slots):
        raise ValueError("leaf count does not match the layout")
    if len(leaves) > MAX_LEAVES:
        raise ValueError(f"{len(leaves)} leaves: one launch takes at most "
                         f"{MAX_LEAVES}")
    unit = _unit_bytes(layout, leaves, blob)
    desc = []
    for leaf, slot in zip(leaves, layout.slots):
        if leaf.device != blob.device or leaf.dtype != layout.torch_dtype \
                or not leaf.is_contiguous():
            raise ValueError("every leaf must be contiguous, on the blob's "
                             "device, in the layout's dtype")
        ax = slot.axis
        want = slot.block_shape[:ax] + slot.block_shape[ax + 1:]
        if tuple(leaf.shape[:ax]) + tuple(leaf.shape[ax + 1:]) != want:
            raise ValueError(f"leaf {tuple(leaf.shape)} does not match "
                             f"slot {slot.block_shape}")
        outer = math.prod(slot.block_shape[:ax])
        inner_b = math.prod(slot.block_shape[ax + 1:]) * layout.itemsize
        desc += [outer, leaf.shape[ax], inner_b // unit,
                 slot.offset * layout.itemsize // unit]
    return unit, desc


def _launch(ext, capture: bool, leaves, blob, rows, layout: RowLayout):
    dev = blob.device
    if dev.type != "cuda":
        raise ValueError(f"snapshot kernels run on CUDA tensors, got {dev}")
    n = rows.shape[0]
    if blob.dtype != layout.torch_dtype or not blob.is_contiguous() \
            or tuple(blob.shape) != (n, layout.total_elems):
        raise ValueError(f"blob {tuple(blob.shape)} {blob.dtype} does not "
                         f"match the layout ({n}, {layout.total_elems})")
    if rows.dtype != torch.int32 or rows.device != dev:
        raise ValueError("rows must be int32 on the blob's device")
    unit, desc = copy_plan(leaves, blob, layout)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ext.snapshot_copy(capture, list(leaves), desc, blob, rows,
                          layout.row_bytes // unit, unit, stream)


def snapshot_capture(ext, leaves, rows, *, layout: RowLayout):
    """Gather ``rows`` (int32, on the device, each checked in range by the
    caller) of every leaf into a new ``(N, total_elems)`` blob: one
    launch."""
    blob = torch.empty((rows.shape[0], layout.total_elems),
                       dtype=layout.torch_dtype, device=rows.device)
    _launch(ext, True, leaves, blob, rows, layout=layout)
    return blob


def snapshot_restore(ext, leaves, blob, rows, *, layout: RowLayout):
    """Scatter blob rows into every leaf at ``rows``, in place: one launch.
    Returns the leaves."""
    _launch(ext, False, leaves, blob, rows, layout=layout)
    return leaves


# ---------------------------------------------------------------------------
# Bytes models (analytic — from specs, never from live tensors)
# ---------------------------------------------------------------------------


def expected_row_bytes(cfg, partition_tokens: int) -> int:
    """Bytes of one arena row's staging blob, derived from the cache
    SPECS (an independent code path from the live layout)."""
    from repro_torch.models.layers import tree_map_specs
    from repro_torch.models.model import cache_specs
    total = 0

    def acc(s):
        nonlocal total
        total += math.prod(s.shape) * s.dtype.itemsize

    tree_map_specs(acc, cache_specs(cfg, 1, partition_tokens))
    return total


def capture_cost(row_bytes: int, n_rows: int) -> dict[str, float]:
    """Bytes one fused capture launch must move: read every leaf slice,
    write the blob (device memory), then one device->host copy."""
    hbm = 2.0 * n_rows * row_bytes
    d2h = float(n_rows * row_bytes)
    return {"hbm_bytes": hbm, "host_bytes": d2h,
            "memory_s": hbm / roofline.HBM_BW}


def restore_cost(row_bytes: int, n_rows: int,
                 new_fraction: float = 1.0) -> dict[str, float]:
    """Bytes one fused restore moves: host->device only for the pages not
    already mapped (CoW), then blob read + leaf scatter write."""
    hbm = 2.0 * n_rows * row_bytes
    h2d = float(n_rows * row_bytes) * new_fraction
    return {"hbm_bytes": hbm, "host_bytes": h2d,
            "memory_s": hbm / roofline.HBM_BW}


# ---------------------------------------------------------------------------
# Data-plane accounting (dispatch / transfer counters the tests assert on)
# ---------------------------------------------------------------------------

STATS = {
    "capture_launches": 0,       # fused capture executions
    "restore_launches": 0,       # fused restore executions
    "d2h_transfers": 0,          # device->host copies (capture readout)
    "d2h_bytes": 0,
    "h2d_transfers": 0,          # host->device copies (restore staging)
    "h2d_bytes": 0,
    "remap_restores": 0,         # fully-mapped CoW restores (zero h2d)
}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


def note_launch(kind: str) -> None:
    STATS[f"{kind}_launches"] += 1


def note_d2h(nbytes: int) -> None:
    STATS["d2h_transfers"] += 1
    STATS["d2h_bytes"] += int(nbytes)


def note_h2d(nbytes: int) -> None:
    STATS["h2d_transfers"] += 1
    STATS["h2d_bytes"] += int(nbytes)


def note_remap() -> None:
    STATS["remap_restores"] += 1
