"""Dispatch wrappers over the port's kernels, their launch counters and the
kernel loader.

Each wrapper launches the hand-written CUDA kernel when its tensors lie on
the card, or raises: there is no fallback from the card to the plain
version.  Elsewhere it runs the kernel's plain PyTorch version (``ref``):
on the CPU, and on ``meta`` tensors, which carry shapes only and run
nothing (the analysis tools trace the model on them).  Each
wrapper adds one to its entry of ``LAUNCHES`` where it launches its kernel,
and nowhere else, so a run can show that it went through the kernels.

Kernels are built at first use by ``torch.utils.cpp_extension.load`` from
``csrc/`` (the five CUDA sources, for ``sm_90a``: ``partition_attention.cu``,
``paged_attention.cu``, ``kv_snapshot.cu``, ``kv_compact.cu`` and
``decode_qkv_rope.cu``; the header ``decode_attention.cuh`` that the two
attention sources share; and ``binding.cpp``, the one file that includes
torch's headers) into ``build/torch_kernels/`` at the repository root;
``load`` rebuilds when a source or flag changes.

The two decode-attention kernels are one split-K design
(``csrc/decode_attention.cuh``): each row's valid range is cut into slices
over the SMs (``partition_attention.splits_for``, from the shapes and the
blocks an SM the card holds, never the positions),
K/V tiles stream through a ``cp.async`` pipeline, bf16 scores and P.V run
on the tensor cores (``mma.sync``), and the blocks of each row group, one
thread-block cluster, merge their f32 partials through distributed shared
memory.  One wrapper call is one launch and one count in ``LAUNCHES``.

``decode_qkv_rope`` is the decode step's attention front end in one launch
a block (``csrc/decode_qkv_rope.cu``): bias adds, RoPE and the cache write,
rounded where torch rounds, so it gives the plain sequence's bits.
"""
from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels import decode_qkv_rope as _qkv
from repro_torch.kernels import kv_compact as _kvc
from repro_torch.kernels import kv_snapshot as _kvs
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import partition_attention as _pa
from repro_torch.kernels import ref

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("binding.cpp", "partition_attention.cu", "paged_attention.cu",
           "kv_snapshot.cu", "kv_compact.cu", "decode_qkv_rope.cu")
NVCC_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a")

LAUNCHES = {"partition_attention": 0, "paged_attention": 0,
            "snapshot_capture": 0, "snapshot_restore": 0, "kv_compact": 0,
            "decode_qkv_rope": 0}
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
                        logit_cap=0.0, scale=None, off=0, t=None,
                        partials=False):
    """q (P, Hkv, G, Dh); k/v_cache (P, T, Hkv, Dh), slots [off, off + T)
    of a ring of ``t`` slots (default T); positions (P,) int32.  Returns
    (P, Hkv, G, Dh) or, with ``partials``, the f32 softmax partials
    (max, normaliser, unnormalised output) of ``ref.partition_attention``."""
    if q.device.type != "cuda":
        return ref.partition_attention(q, k_cache, v_cache, positions,
                                       window=window, logit_cap=logit_cap,
                                       scale=scale, off=off, t=t,
                                       partials=partials)
    out = _pa.partition_attention(load(), q, k_cache, v_cache, positions,
                                  window=window, logit_cap=logit_cap,
                                  scale=scale, off=off, t=t,
                                  partials=partials)
    LAUNCHES["partition_attention"] += 1
    return out


def paged_attention(q, k_pool, v_pool, tables, positions, *,
                    logit_cap=0.0, scale=None):
    """q (P, Hkv, G, Dh); k/v_pool (NB, BT, Hkv, Dh); tables (P, MB) int32
    (-1 = unmapped); positions (P,) int32.  Returns (P, Hkv, G, Dh)."""
    if q.device.type != "cuda":
        return ref.paged_attention(q, k_pool, v_pool, tables, positions,
                                   logit_cap=logit_cap, scale=scale)
    out = _paged.paged_attention(load(), q, k_pool, v_pool, tables,
                                 positions, logit_cap=logit_cap, scale=scale)
    LAUNCHES["paged_attention"] += 1
    return out


def decode_qkv_rope(q, k, v, bq, bk, bv, positions, freqs, k_cache,
                    v_cache):
    """One attention block's decode front end: q (P, Hq*Dh), k and v (P,
    Hkv*Dh) the projections before their biases (``bq``, ``bk``, ``bv``,
    or None), RoPE at ``positions`` (P,) int32 with ``freqs`` (Dh/2,) f32,
    and k, v written into slot ``positions mod t`` of every row of k/v_cache
    (P, t, Hkv, Dh), in place.  Returns q rotated, (P, Hkv, G, Dh)."""
    if q.device.type != "cuda":
        return ref.decode_qkv_rope(q, k, v, bq, bk, bv, positions, freqs,
                                   k_cache, v_cache)
    out = _qkv.decode_qkv_rope(load(), q, k, v, bq, bk, bv, positions,
                               freqs, k_cache, v_cache)
    LAUNCHES["decode_qkv_rope"] += 1
    return out


def _device_i32(values, dev) -> torch.Tensor:
    """Host ints as an int32 tensor on ``dev``, staged through pinned
    memory: the copy is queued on the stream and the host does not wait
    for the stream's earlier work (the caching host allocator keeps the
    staging buffer alive until the copy has run)."""
    return torch.tensor(values, dtype=torch.int32).pin_memory().to(
        dev, non_blocking=True)


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
    if dev.type != "cuda":
        return ref.snapshot_capture(leaves, torch.tensor(rows), layout)
    blob = _kvs.snapshot_capture(load(), leaves, _device_i32(rows, dev),
                                 layout=layout)
    LAUNCHES["snapshot_capture"] += 1
    return blob


def snapshot_restore(leaves, blob, rows, *, layout):
    """Inverse scatter, in place: blob rows -> every leaf at ``rows``.
    Returns the leaves."""
    leaves = tuple(leaves)
    rows = _checked_rows(leaves, rows, layout)
    dev = leaves[0].device
    if dev.type != "cuda":
        return tuple(ref.snapshot_restore(leaves, blob, torch.tensor(rows),
                                          layout))
    _kvs.snapshot_restore(load(), leaves, blob, _device_i32(rows, dev),
                          layout=layout)
    LAUNCHES["snapshot_restore"] += 1
    return leaves


def _live_moves(src, dst, count, nb: int) -> tuple[list[int], list[int]]:
    """The live moves as Python ints: the first ``count`` (all when None),
    less those whose ``dst`` lies at or past ``nb`` (dropped, as the JAX
    oracle's ``mode="drop"``).  Raises where the kernel's parallel copies
    could not give the oracle's gather-then-scatter result (two moves with
    one ``dst``; a ``dst`` that is another move's ``src``) and on indices
    the kernel does not bound-check."""
    src, dst = [int(s) for s in src], [int(d) for d in dst]
    if len(src) != len(dst):
        raise ValueError(f"{len(src)} sources for {len(dst)} destinations")
    n = len(src) if count is None else int(count)
    live = [(s, d) for s, d in zip(src[:n], dst[:n]) if d < nb]
    bad = [(s, d) for s, d in live if not 0 <= s < nb or d < 0]
    if bad:
        raise IndexError(f"moves {bad} out of range for {nb} blocks")
    dsts = [d for _, d in live]
    if len(set(dsts)) != len(dsts):
        raise ValueError("two live moves write the same block")
    readers: dict[int, set[int]] = {}
    for i, (s, _) in enumerate(live):
        readers.setdefault(s, set()).add(i)
    clash = [d for i, (_, d) in enumerate(live) if readers.get(d, set()) - {i}]
    if clash:
        raise ValueError(f"blocks {clash} are written by one live move and "
                         f"read by another")
    return [s for s, _ in live], dsts


def kv_compact(pools, src, dst, count=None):
    """Migration pass over every pool leaf, in place:
    ``pool[dst[i]] = pool[src[i]]`` for the live moves (see ``_live_moves``;
    ``src``/``dst`` are sequences of ints, ``count`` the live prefix).  One
    launch for all leaves on the card; none when no move is live.  Returns
    the pools."""
    pools = tuple(pools)
    s, d = _live_moves(src, dst, count, pools[0].shape[0])
    if not s:
        return pools
    if pools[0].device.type != "cuda":
        si, di = torch.tensor(s), torch.tensor(d)
        for pool in pools:
            ref.kv_compact(pool, si, di, len(s))
        return pools
    _kvc.kv_compact(load(), pools, _device_i32([s, d], pools[0].device))
    LAUNCHES["kv_compact"] += 1
    return pools
