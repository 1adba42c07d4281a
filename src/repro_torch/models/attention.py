"""Attention for the dense family: GQA, RoPE, optional sliding window and
softcap, ring KV caches.

Port of ``repro.models.attention``.  Three modes share one entry point:
  * ``train``   — no cache, causal (optionally windowed) mask.
  * ``prefill`` — as train, and fills the partition KV cache.
  * ``decode``  — one query token per row against the cache; per-row
                  positions support continuous batching.

Unlike the JAX package, caches are updated IN PLACE (prefill fills the given
cache tensors, decode writes the new K/V slot into them) and the same cache
dict is returned: the engine owns one copy of the arena and never pays a
second one per step.  Decode attention runs through
``kernels.ops.partition_attention`` — the hand-written kernel on the card,
its plain version on the CPU.  Prefill at or above ``FLASH_SEQ`` (the JAX
package's chunked online-softmax path) is not ported yet and raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import (ParamSpec, apply_rope, bf16, dense,
                                       dense_spec, f32, softcap)

FLASH_SEQ = 8192
NEG_INF = -2.0 ** 30


def attn_spec(cfg):
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "q": dense_spec(cfg.d_model, hq * dh, ("w_embed", "heads"),
                        bias=cfg.qkv_bias),
        "k": dense_spec(cfg.d_model, hkv * dh, ("w_embed", "kv_heads"),
                        bias=cfg.qkv_bias),
        "v": dense_spec(cfg.d_model, hkv * dh, ("w_embed", "kv_heads"),
                        bias=cfg.qkv_bias),
        "o": dense_spec(hq * dh, cfg.d_model, ("heads", "w_embed")),
    }


def _split_heads(x, n, d):
    return x.reshape(x.shape[:-1] + (n, d))


def _plain_attention(q, k, v, qpos, kpos, window, scale, cap):
    """q (B,S,K,G,D) x k/v (B,T,K,D) -> (B,S,K,G,D); scores in f32."""
    s = torch.einsum("bskgd,btkd->bkgst", q.to(f32), k.to(f32)) * scale
    s = softcap(s, cap)
    mask = kpos[:, None, :] <= qpos[:, :, None]            # causal
    if window:
        mask &= kpos[:, None, :] > qpos[:, :, None] - window
    s = torch.where(mask[:, None, None, :, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bkgst,btkd->bskgd", w.to(v.dtype), v)


def attention(cfg, p, x, *, positions, mode: str, cache=None,
              window: int = 0):
    """Returns (y, cache).  ``positions``: (B,S) int32 for train/prefill;
    (B,) global positions for decode.  ``cache`` is updated in place."""
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = hq // hkv
    scale = cfg.query_scale or dh ** -0.5
    cap = cfg.attn_logit_softcap
    b, s = x.shape[:2]

    rope_pos = positions if mode != "decode" else positions[:, None]
    q = _split_heads(dense(p["q"], x), hq, dh)
    k = _split_heads(dense(p["k"], x), hkv, dh)
    v = _split_heads(dense(p["v"], x), hkv, dh)
    q = apply_rope(q, rope_pos, cfg.rope_theta)
    k = apply_rope(k, rope_pos, cfg.rope_theta)

    if mode == "decode":
        t = cache["k"].shape[1]
        idx = torch.remainder(positions, t).long()         # ring slot
        rows = torch.arange(b, device=x.device)
        cache["k"][rows, idx] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, idx] = v[:, 0].to(cache["v"].dtype)
        out = ops.partition_attention(
            q.reshape(b, hkv, g, dh), cache["k"], cache["v"],
            positions.to(torch.int32), window=window, logit_cap=cap,
            scale=scale)
        return dense(p["o"], out.reshape(b, 1, hq * dh)), cache

    if s >= FLASH_SEQ:
        raise NotImplementedError(
            f"prefill of {s} >= FLASH_SEQ={FLASH_SEQ} tokens needs the "
            f"chunked attention path, which is not ported yet")
    out = _plain_attention(q.reshape(b, s, hkv, g, dh), k, v, positions,
                           positions, window, scale, cap)
    if mode == "prefill":
        t = cache["k"].shape[1]
        for name, new in (("k", k), ("v", v)):
            if t >= s:                                   # linear fill
                cache[name][:, :s] = new
            else:                # ring: keep tail; global pos p -> slot p % t
                cache[name].copy_(torch.roll(new[:, -t:], s % t, dims=1))
    return dense(p["o"], out.reshape(b, s, hq * dh)), cache


def make_attn_cache_spec(cfg, batch: int, cache_len: int, window: int = 0):
    """ParamSpec tree for one attention block's KV cache."""
    t = min(cache_len, window) if window else cache_len
    sp = ParamSpec((batch, t, cfg.num_kv_heads, cfg.head_dim), bf16,
                   ("batch", "kv_seq", "kv_heads", None), init="zeros")
    return {"k": sp, "v": sp}
