"""Decode attention over contiguous HotMem partitions: launch of the CUDA
kernel in ``csrc/partition_attention.cu``, and the host side of the split-K
design it shares with ``paged_attention`` (``csrc/decode_attention.cuh``).

Port of the Pallas kernel ``repro.kernels.partition_attention``: each
request's KV lives contiguously in its partition row, so the kernel streams
K/V tiles of the row with no block-table indirection (contrast with the
vanilla slice's ``paged_attention``).  Online softmax in f32 over the
tiles; ring-cache masking for windowed layers; optional tanh logit cap.
``ops.partition_attention`` picks this kernel for CUDA tensors and
``ref.partition_attention`` for CPU tensors.

Each row's valid range is cut into ``num_splits`` slices, one block each,
and the blocks of one (row, KV head, query block) form one thread-block
cluster that merges their f32 partials through distributed shared memory:
one launch a call, no workspace.

The rows may be one block of a ring split along "kv_seq" over ranks
(``off``, ``t``): the kernel then reads only the block's valid slots
(``block_runs``) and, with ``partials``, returns its softmax partials for
the ranks to merge (``models/attention.py::_decode_block``).
"""
from __future__ import annotations

import functools

import torch

ROWS_PER_BLOCK = 16    # query heads of one block (the mma's 16 rows)
SPLIT_ALIGN = 16       # a slice's length is a multiple of this many tokens
SPLIT_TOKENS = 512     # a block walks at most this many of n_max's tokens
MAX_SPLITS = 16        # csrc/decode_attention.cuh::kMaxSplits (a cluster)
MAX_BLOCKS = 2 ** 31 - 1


def num_splits(rows: int, hkv: int, g: int, n_max: int, sms: int,
               blocks_per_sm: int) -> int:
    """Slices each row's range is cut into, from the shapes alone (never
    the positions, so the host does not wait for the card, and a CUDA
    graph's replays keep the grid it captured): enough that no block walks
    more than ``SPLIT_TOKENS`` of the longest range ``n_max`` (T, or
    MB * BT), and at least as many as fill ``blocks_per_sm`` blocks on
    each of ``sms`` SMs in one wave; at most one per ``SPLIT_ALIGN``
    tokens of ``n_max``, at most ``MAX_SPLITS`` (one cluster).  On an
    H100 (132 SMs, 5 blocks an SM at Dh = 128 in bf16) at Hkv = 4, G = 7,
    T = 2048: 4 at the engine's 64 rows (each cluster's blocks walk equal
    slices of their row, so the rows' unequal lengths become waves of
    clusters instead of one long block a row), 16 at P = 8 and at P = 1
    (``launch/attention_sweep.py`` times the alternatives: on one H100 at
    64 rows, 2, 3, 4, 5, 6, 8, 12 and 16 splits took 0.085, 0.077, 0.071,
    0.076, 0.072, 0.076, 0.096 and 0.111 ms).  The kernel may use fewer
    where the card cannot hold a cluster of this many blocks."""
    groups = rows * hkv * -(-g // ROWS_PER_BLOCK)
    s = max(1, blocks_per_sm * sms // groups, -(-n_max // SPLIT_TOKENS))
    return max(1, min(s, -(-n_max // SPLIT_ALIGN), MAX_SPLITS))


def split_bounds(n: int, splits: int) -> list[tuple[int, int]]:
    """The token slices ``[j0, j1)`` of a range of ``n`` tokens, one per
    split, as the kernel cuts them (``split_slice`` in
    ``csrc/decode_attention.cuh``); a slice may be empty."""
    length = -(-(-(-n // splits)) // SPLIT_ALIGN) * SPLIT_ALIGN
    return [(min(s * length, n), min((s + 1) * length, n))
            for s in range(splits)]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def blocks_per_sm(ext, index: int, dh: int, bf16: bool) -> int:
    """Blocks of the attention kernel for head dim ``dh`` one SM of device
    ``index`` holds at once, as the card's occupancy query answers it for
    the kernel's shared memory (``ext.partition_attention_occupancy``): 8
    at Dh = 64, 5 at 128 and 3 at 256 in bf16 on an H100."""
    with torch.cuda.device(index):
        return ext.partition_attention_occupancy(1, dh, bf16)[1]


def splits_for(ext, q, n_max: int) -> int:
    """``num_splits`` for a call on ``q`` (P, Hkv, G, Dh) on its device,
    with the blocks an SM that ``ext``'s kernel holds at q's head dim and
    dtype."""
    p, hkv, g, dh = q.shape
    index = q.device.index
    splits = num_splits(p, hkv, g, n_max, _sm_count(index),
                        blocks_per_sm(ext, index, dh,
                                      q.dtype == torch.bfloat16))
    if p * hkv * -(-g // ROWS_PER_BLOCK) * splits > MAX_BLOCKS:
        raise ValueError("the grid exceeds CUDA's limit of 2**31 - 1 blocks")
    return splits


def head_dim_fits(dh: int) -> bool:
    """The head dims the port's decode kernels take: multiples of 16 (the
    mma's depth) in [16, 256]."""
    return dh % 16 == 0 and 16 <= dh <= 256


def check_head_dim(dh: int) -> None:
    if not head_dim_fits(dh):
        raise ValueError(f"head_dim {dh} must be a multiple of 16 in "
                         f"[16, 256] (the mma's depth)")


def block_runs(pos: int, t: int, window: int, off: int,
               tb: int) -> list[tuple[int, int]]:
    """The valid slots of one row in a block of the ring, as the kernel
    finds them (``partition_attention.cu``): slots ``[off, off + tb)`` of
    a ring of ``t``, the row at ``pos``.  At most two runs ``[s0, s1)``
    of block-local slots, in the order of the row's valid range; a row
    with ``pos < 0`` takes the whole block (every slot at NEG_INF)."""
    if pos < 0:
        return [(0, tb)]
    n = min(pos + 1, t, window or t)
    d = (off - (pos - n + 1) % t) % t
    a0 = t - d
    runs = [(a0, min(tb, a0 + n)), (0, max(0, min(tb, t - d, n - d)))]
    return [r for r in runs if r[1] > r[0]]


def partition_attention(ext, q, k_cache, v_cache, positions, *,
                        window: int = 0, logit_cap: float = 0.0,
                        scale: float | None = None, off: int = 0,
                        t: int | None = None, partials: bool = False):
    """q (P, Hkv, G, Dh); k/v_cache (P, T, Hkv, Dh), slots ``[off, off +
    T)`` of a ring of ``t`` slots (default T); positions (P,) int32, all
    on one CUDA device; ``ext`` the kernels' extension module
    (``ops.load()``).  Returns (P, Hkv, G, Dh) in q's dtype or, with
    ``partials``, the f32 softmax partials (max (P, Hkv, G), normaliser
    (P, Hkv, G), unnormalised output (P, Hkv, G, Dh)) of
    ``ref.partition_attention``."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"partition_attention runs on CUDA tensors, "
                         f"got {dev}")
    p, hkv, g, dh = q.shape
    tb = k_cache.shape[1]
    t = tb if t is None else t
    if tuple(k_cache.shape) != (p, tb, hkv, dh) \
            or v_cache.shape != k_cache.shape \
            or tuple(positions.shape) != (p,):
        raise ValueError(f"shapes q {tuple(q.shape)}, k "
                         f"{tuple(k_cache.shape)}, v {tuple(v_cache.shape)}, "
                         f"positions {tuple(positions.shape)} do not agree")
    if not (0 <= off and off + tb <= t):
        raise ValueError(f"a block of {tb} slots at {off} does not lie in "
                         f"a ring of {t}")
    if q.dtype not in (torch.bfloat16, torch.float32) \
            or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError("q, k and v must share one dtype, bf16 or f32")
    if positions.dtype != torch.int32:
        raise ValueError("positions must be int32")
    check_head_dim(dh)
    if window < 0:
        raise ValueError(f"window {window} must be >= 0")
    for x in (q, k_cache, v_cache, positions):
        if x.device != dev or not x.is_contiguous():
            raise ValueError("every input must be contiguous on q's device")
    for x in (k_cache, v_cache):
        if x.data_ptr() % 16:
            raise ValueError("K/V must be 16-byte aligned")
    if scale is None:
        scale = dh ** -0.5
    if partials:
        f32 = torch.float32
        top = torch.empty((p, hkv, g), dtype=f32, device=dev)
        lsum = torch.empty((p, hkv, g), dtype=f32, device=dev)
        out = torch.empty((p, hkv, g, dh), dtype=f32, device=dev)
    else:
        top = lsum = torch.empty(0, dtype=torch.float32, device=dev)
        out = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ext.partition_attention(q, k_cache, v_cache, positions, out, top,
                                lsum, splits_for(ext, q, tb), float(scale),
                                float(logit_cap), int(window), int(off),
                                int(t), stream)
    return (top, lsum, out) if partials else out
