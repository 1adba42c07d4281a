"""Decode attention over contiguous HotMem partitions: launch of the CUDA
kernel in ``csrc/partition_attention.cu``.

Port of the Pallas kernel ``repro.kernels.partition_attention``: each
request's KV lives contiguously in its partition row, so the kernel streams
K/V tiles of the row with no block-table indirection (contrast with the
vanilla slice's ``paged_attention``).  Online softmax in f32 over the
tiles; ring-cache masking for windowed layers; optional tanh logit cap.
``ops.partition_attention`` picks this kernel for CUDA tensors and
``ref.partition_attention`` for CPU tensors.
"""
from __future__ import annotations

import torch


def partition_attention(ext, q, k_cache, v_cache, positions, *,
                        window: int = 0, logit_cap: float = 0.0,
                        scale: float | None = None):
    """q (P, Hkv, G, Dh); k/v_cache (P, T, Hkv, Dh); positions (P,) int32,
    all on one CUDA device; ``ext`` the kernels' extension module
    (``ops.load()``).  Returns (P, Hkv, G, Dh) in q's dtype."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"partition_attention runs on CUDA tensors, "
                         f"got {dev}")
    p, hkv, g, dh = q.shape
    t = k_cache.shape[1]
    if tuple(k_cache.shape) != (p, t, hkv, dh) \
            or v_cache.shape != k_cache.shape \
            or tuple(positions.shape) != (p,):
        raise ValueError(f"shapes q {tuple(q.shape)}, k "
                         f"{tuple(k_cache.shape)}, v {tuple(v_cache.shape)}, "
                         f"positions {tuple(positions.shape)} do not agree")
    if q.dtype not in (torch.bfloat16, torch.float32) \
            or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError("q, k and v must share one dtype, bf16 or f32")
    if positions.dtype != torch.int32:
        raise ValueError("positions must be int32")
    if dh % 8 or dh > 256:
        raise ValueError(f"head_dim {dh} must be a multiple of 8, <= 256")
    for x in (q, k_cache, v_cache, positions):
        if x.device != dev or not x.is_contiguous():
            raise ValueError("every input must be contiguous on q's device")
    for x in (k_cache, v_cache):
        if x.data_ptr() % 16:
            raise ValueError("K/V must be 16-byte aligned")
    if scale is None:
        scale = dh ** -0.5
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ext.partition_attention(q, k_cache, v_cache, positions, out,
                                float(scale), float(logit_cap), int(window),
                                stream)
    return out
