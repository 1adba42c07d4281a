"""Block migration (compaction) of the vanilla paged pool: launch of the
CUDA kernel in ``csrc/kv_compact.cu``.

Port of the Pallas kernel ``repro.kernels.kv_compact``, the cost HotMem
eliminates: before a vanilla arena shrinks, the live blocks in the pool's
tail are copied into free head slots, ``pool[dst[i]] = pool[src[i]]``, in
place.  One launch moves every block of every pool leaf.
``ops.kv_compact`` checks and filters the move list for both devices and
picks this kernel for CUDA tensors and ``ref.kv_compact`` for CPU tensors.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.kv_snapshot import widest_unit


def kv_compact(ext, pools, moves):
    """Copy block ``moves[0, i]`` to block ``moves[1, i]`` of every pool
    leaf, in place: one launch.  ``pools`` are contiguous CUDA tensors
    sharing their leading (block) extent; ``moves`` is an int32 (2, M)
    tensor on their device whose moves are live, in range and independent
    (checked by ``ops.kv_compact``).  Returns the pools."""
    pools = tuple(pools)
    dev = pools[0].device
    if dev.type != "cuda":
        raise ValueError(f"kv_compact runs on CUDA tensors, got {dev}")
    nb = pools[0].shape[0]
    for x in pools:
        if x.device != dev or not x.is_contiguous() or x.shape[0] != nb:
            raise ValueError("every pool leaf must be contiguous on one "
                             "device with one block extent")
    if moves.dtype != torch.int32 or moves.device != dev \
            or moves.dim() != 2 or moves.shape[0] != 2 \
            or moves.shape[1] == 0 or not moves.is_contiguous():
        raise ValueError("moves must be a contiguous int32 (2, M) tensor, "
                         "M > 0, on the pools' device")
    block_bytes = [math.prod(x.shape[1:]) * x.element_size() for x in pools]
    unit = widest_unit(block_bytes + [x.data_ptr() for x in pools])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ext.kv_compact(list(pools), block_bytes, moves, unit, stream)
    return pools
