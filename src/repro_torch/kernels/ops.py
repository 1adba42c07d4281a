"""Dispatch wrappers over the port's kernels, their launch counters and the
kernel loader.

Each wrapper runs the kernel's plain PyTorch version (``ref``) when its
tensors lie on the CPU, and otherwise launches the hand-written CUDA kernel
or raises: there is no fallback from the card to the plain version.  Each
wrapper adds one to its entry of ``LAUNCHES`` where it launches its kernel,
and nowhere else, so a run can show that it went through the kernels.

Kernels are built at first use by ``torch.utils.cpp_extension.load`` from
``csrc/`` (the two CUDA sources, for ``sm_90a``, and ``binding.cpp``, the
one file that includes torch's headers) into ``build/torch_kernels/`` at the
repository root; ``load`` rebuilds when a source or flag changes.
"""
from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels import kv_snapshot as _kvs
from repro_torch.kernels import partition_attention as _pa
from repro_torch.kernels import ref

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("binding.cpp", "partition_attention.cu", "kv_snapshot.cu")
NVCC_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a")

LAUNCHES = {"partition_attention": 0, "snapshot_capture": 0,
            "snapshot_restore": 0}
_EXT = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def load():
    """The kernels' extension module, built first if needed, with every
    kernel's code already loaded onto the current device, so that no first
    launch inside a timed wall pays the module load (engine set-up on the
    card calls it)."""
    global _EXT
    if _EXT is None:
        from torch.utils import cpp_extension
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        ext = cpp_extension.load(
            name="repro_torch_kernels",
            sources=[str(CSRC / name) for name in SOURCES],
            build_directory=str(BUILD_DIR),
            extra_cuda_cflags=list(NVCC_FLAGS), verbose=False)
        ext.prepare()
        _EXT = ext
    return _EXT


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def partition_attention(q, k_cache, v_cache, positions, *, window=0,
                        logit_cap=0.0, scale=None):
    """q (P, Hkv, G, Dh); k/v_cache (P, T, Hkv, Dh); positions (P,) int32.
    Returns (P, Hkv, G, Dh)."""
    if q.device.type == "cpu":
        return ref.partition_attention(q, k_cache, v_cache, positions,
                                       window=window, logit_cap=logit_cap,
                                       scale=scale)
    out = _pa.partition_attention(load(), q,
                                  k_cache, v_cache, positions, window=window,
                                  logit_cap=logit_cap, scale=scale)
    LAUNCHES["partition_attention"] += 1
    return out


def _checked_rows(leaves, rows, layout) -> list[int]:
    """Row ids as Python ints, each in range of every leaf's batch axis
    (the kernels do not bound-check)."""
    rows = [int(r) for r in rows]
    for leaf, slot in zip(leaves, layout.slots):
        n = leaf.shape[slot.axis]
        bad = [r for r in rows if not 0 <= r < n]
        if bad:
            raise IndexError(f"rows {bad} out of range for {n} arena rows")
    if not rows:
        raise ValueError("no rows given")
    return rows


def snapshot_capture(leaves, rows, *, layout):
    """All leaves x ``rows`` (a sequence of ints) -> one (N, row_elems)
    staging blob on the leaves' device."""
    leaves = tuple(leaves)
    rows = _checked_rows(leaves, rows, layout)
    dev = leaves[0].device
    if dev.type == "cpu":
        return ref.snapshot_capture(leaves, torch.tensor(rows), layout)
    blob = _kvs.snapshot_capture(
        load(), leaves,
        torch.tensor(rows, dtype=torch.int32, device=dev), layout=layout)
    LAUNCHES["snapshot_capture"] += 1
    return blob


def snapshot_restore(leaves, blob, rows, *, layout):
    """Inverse scatter, in place: blob rows -> every leaf at ``rows``.
    Returns the leaves."""
    leaves = tuple(leaves)
    rows = _checked_rows(leaves, rows, layout)
    dev = leaves[0].device
    if dev.type == "cpu":
        return tuple(ref.snapshot_restore(leaves, blob, torch.tensor(rows),
                                          layout))
    _kvs.snapshot_restore(load(), leaves, blob,
                          torch.tensor(rows, dtype=torch.int32, device=dev),
                          layout=layout)
    LAUNCHES["snapshot_restore"] += 1
    return leaves
