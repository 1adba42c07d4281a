"""Decode attention over the vanilla paged layout: launch of the CUDA
kernel in ``csrc/paged_attention.cu``.

Port of the Pallas kernel ``repro.kernels.paged_attention``: K/V blocks lie
scattered over a shared pool and each row's block table says where its
tokens are (linear fill, no ring); the kernel chases the table, skipping
``-1`` entries.  Same online-softmax math as ``partition_attention``: the
layout indirection is the only difference, the HotMem-vs-vanilla contrast
at kernel level.  ``ops.paged_attention`` picks this kernel for CUDA
tensors and ``ref.paged_attention`` for CPU tensors.  The split count is
``partition_attention``'s, over each row's linear range of MB * BT tokens.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.partition_attention import (check_head_dim,
                                                     splits_for)


def paged_attention(ext, q, k_pool, v_pool, tables, positions, *,
                    logit_cap: float = 0.0, scale: float | None = None):
    """q (P, Hkv, G, Dh); k/v_pool (NB, BT, Hkv, Dh); tables (P, MB) int32
    (-1 = unmapped); positions (P,) int32, all on one CUDA device; ``ext``
    the kernels' extension module (``ops.load()``).  Returns
    (P, Hkv, G, Dh) in q's dtype."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged_attention runs on CUDA tensors, got {dev}")
    p, hkv, g, dh = q.shape
    nb, bt = k_pool.shape[:2]
    if tuple(k_pool.shape) != (nb, bt, hkv, dh) \
            or v_pool.shape != k_pool.shape \
            or tables.dim() != 2 or tables.shape[0] != p \
            or tables.shape[1] < 1 or tuple(positions.shape) != (p,):
        raise ValueError(f"shapes q {tuple(q.shape)}, k_pool "
                         f"{tuple(k_pool.shape)}, v_pool "
                         f"{tuple(v_pool.shape)}, tables "
                         f"{tuple(tables.shape)}, positions "
                         f"{tuple(positions.shape)} do not agree")
    if q.dtype not in (torch.bfloat16, torch.float32) \
            or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError("q and the pools must share one dtype, bf16 or f32")
    if tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise ValueError("tables and positions must be int32")
    check_head_dim(dh)
    for x in (q, k_pool, v_pool, tables, positions):
        if x.device != dev or not x.is_contiguous():
            raise ValueError("every input must be contiguous on q's device")
    for x in (k_pool, v_pool):
        if x.data_ptr() % 16:
            raise ValueError("K/V pools must be 16-byte aligned")
    if scale is None:
        scale = dh ** -0.5
    out = torch.empty_like(q)
    mb = tables.shape[1]
    if mb * bt >= 2 ** 31:
        raise ValueError(f"tables of {mb} blocks of {bt} tokens exceed "
                         f"int32 token indices")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ext.paged_attention(q, k_pool, v_pool, tables, positions, out,
                            splits_for(ext, q, mb * bt), float(scale),
                            float(logit_cap), stream)
    return out
