"""The front end of one attention block's decode step in one launch: the
q/k/v bias adds, the rotary embedding of q and k and the write of the new
K/V into each row's ring slot (``csrc/decode_qkv_rope.cu``).

It replaces no Pallas kernel (XLA fuses this work for the JAX package); in
the port these were 47 device operations a block, more than half the nodes
of qwen2-7b's replayed decode step.  ``ops.decode_qkv_rope`` picks this
kernel for CUDA tensors and ``ref.decode_qkv_rope``, the block's former
sequence of operations, for CPU and meta tensors; the two agree bit for
bit, as the kernel rounds where torch rounds.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.partition_attention import check_head_dim


def decode_qkv_rope(ext, q, k, v, bq, bk, bv, positions, freqs, k_cache,
                    v_cache):
    """q (P, Hq * Dh), k and v (P, Hkv * Dh): the block's projections
    before their biases; bq, bk, bv (H * Dh,) or None; positions (P,)
    int32; freqs (Dh / 2,) f32, the rotary frequencies; k/v_cache (P, t,
    Hkv, Dh), written in place at slot ``positions mod t`` of every row;
    all on one CUDA device, ``ext`` the kernels' extension module
    (``ops.load()``).  Returns the rotated q as (P, Hkv, G, Dh)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"decode_qkv_rope runs on CUDA tensors, got {dev}")
    p, t, hkv, dh = k_cache.shape
    check_head_dim(dh)          # those of the attention kernel after it
    hq = q.shape[-1] // dh
    dt = q.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError("q must be bf16 or f32")
    if 0 in (p, hq, hkv) or hq % hkv or tuple(q.shape) != (p, hq * dh) \
            or tuple(k.shape) != (p, hkv * dh) or v.shape != k.shape \
            or v_cache.shape != k_cache.shape \
            or tuple(positions.shape) != (p,) \
            or tuple(freqs.shape) != (dh // 2,):
        raise ValueError(
            f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, caches {tuple(k_cache.shape)} and "
            f"{tuple(v_cache.shape)}, positions {tuple(positions.shape)}, "
            f"freqs {tuple(freqs.shape)} do not agree")
    biases = []
    for b, n in ((bq, hq), (bk, hkv), (bv, hkv)):
        if b is None:
            b = torch.empty(0, dtype=dt, device=dev)
        elif tuple(b.shape) != (n * dh,):
            raise ValueError(f"a bias of shape {tuple(b.shape)} for "
                             f"{n * dh} outputs")
        biases.append(b)
    if any(x.dtype != dt for x in (k, v, k_cache, v_cache, *biases)):
        raise ValueError("q, k, v, the biases and the caches must share "
                         "one dtype")
    if positions.dtype != torch.int32 or freqs.dtype != torch.float32:
        raise ValueError("positions must be int32 and freqs f32")
    for x in (q, k, v, positions, freqs, k_cache, v_cache, *biases):
        if x.device != dev or not x.is_contiguous():
            raise ValueError("every input must be contiguous on q's device")
    out = torch.empty((p, hkv, hq // hkv, dh), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ext.decode_qkv_rope(q, k, v, *biases, positions, freqs, k_cache,
                            v_cache, out, stream)
    return out
