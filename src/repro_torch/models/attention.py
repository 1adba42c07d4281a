"""Attention: GQA, RoPE/M-RoPE, full/sliding-window, softcap, ring KV
caches.

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
its plain version on the CPU and on meta tensors.  Train and prefill at or
above ``FLASH_SEQ`` tokens take ``_chunked_attention``, an online softmax
over ``Q_CHUNK`` x ``KV_CHUNK`` tiles that never builds an S x S score
matrix (plain torch, as the JAX package's is pure jnp), except under
``tracemode.analysis_mode``, which counts the plain path.

On a mesh the serving rules split each cache on "kv_seq".  Prefill and
decode then run per rank on the rank's block (``sharding.local_blocks``):
each rank writes the slots it holds, and decode merges the ranks' partial
softmaxes over the "kv_seq" axes (``_decode_block``), as GSPMD partitions
the reference's decode attention.
"""
from __future__ import annotations

from functools import partial

import torch
import torch.distributed as dist

from repro_torch.kernels import ops
from repro_torch.models.layers import (ParamSpec, apply_rope, bf16, dense,
                                       dense_spec, dense_to_stream, f32,
                                       softcap)
from repro_torch.sharding import (P, block_start, current_ctx, entry_axes,
                                  is_dtensor, local_blocks, psum, shard,
                                  spec_for, split_last)
from repro_torch.spans import span
from repro_torch.tracemode import is_analysis

# chunked online-softmax attention at/above this length; the chunk sizes are
# read at call time, so a test can patch them
FLASH_SEQ = 8192
Q_CHUNK = 512
KV_CHUNK = 1024
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


def _scores(q, k, scale, cap):
    """q (B,S,K,G,D) x k (B,T,K,D) -> (B,K,G,S,T) f32, softcapped."""
    s = torch.einsum("bskgd,btkd->bkgst", q.to(f32), k.to(f32)) * scale
    return softcap(s, cap)


def _weighted(v, w):
    """w (B,K,G,S,T) x v (B,T,K,D) -> (B,S,K,G,D), in v's dtype."""
    return torch.einsum("bkgst,btkd->bskgd", w.to(v.dtype), v)


def _mask(qpos, kpos, window):
    """(B,S,T): key at or before the query, and inside the window."""
    mask = kpos[:, None, :] <= qpos[:, :, None]            # causal
    if window:
        mask &= kpos[:, None, :] > qpos[:, :, None] - window
    return mask


def _plain_attention(q, k, v, qpos, kpos, window, scale, cap):
    """q (B,S,K,G,D) x k/v (B,T,K,D) -> (B,S,K,G,D); scores in f32."""
    s = torch.where(_mask(qpos, kpos, window)[:, None, None],
                    _scores(q, k, scale, cap), NEG_INF)
    return _weighted(v, torch.softmax(s, dim=-1))


def _chunked_attention(q, k, v, qpos, kpos, window, scale, cap):
    """Online-softmax flash attention in plain torch: a loop over query
    chunks, and inside it over KV chunks, carrying the running max ``m``,
    the normaliser ``l`` and the output ``acc`` in f32.  Every tile is
    visited, masked ones included, as the JAX scan does."""
    b, sq, hk, g, d = q.shape
    t = k.shape[1]
    qc, kc = Q_CHUNK, KV_CHUNK
    assert sq % qc == 0 and t % kc == 0, (sq, t)
    out = torch.empty_like(q)
    for i in range(0, sq, qc):
        qi, qp = q[:, i:i + qc], qpos[:, i:i + qc]
        m = torch.full((b, hk, g, qc), NEG_INF, dtype=f32, device=q.device)
        l = torch.zeros((b, hk, g, qc), dtype=f32, device=q.device)
        acc = torch.zeros((b, hk, g, qc, d), dtype=f32, device=q.device)
        for j in range(0, t, kc):
            s = torch.where(
                _mask(qp, kpos[:, j:j + kc], window)[:, None, None],
                _scores(qi, k[:, j:j + kc], scale, cap), NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgst,btkd->bkgsd", p, v[:, j:j + kc].to(f32))
            m = m_new
        o = acc / torch.clamp(l[..., None], min=1e-30)     # (B,K,G,Cq,D)
        out[:, i:i + qc] = o.permute(0, 3, 1, 2, 4).to(q.dtype)
    return out


def _grouped(core, q, k, v, *rows):
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    out = core(q.reshape(b, s, hkv, hq // hkv, dh), k, v, *rows)
    return out.reshape(b, s, hq * dh)


def grouped_attention(core, q, k, v, *rows):
    """``core(qg, k, v, *rows)`` over q (B,S,Hq,D) grouped as (B,S,Hkv,G,D)
    and k/v (B,T,Hkv,D), returned as (B,S,Hq*D); ``rows`` are per-row
    tensors (B, ...) such as the positions.

    On a mesh each rank runs ``core`` on plain tensors, its own rows and
    KV heads with their query groups (``sharding.local_blocks``):
    attention needs no communication there, as GSPMD partitions it, and
    DTensor's einsum cannot flatten a sharded head dim on every torch
    version.  q's heads take k's ("kv_heads") sharding so that each group
    stays whole."""
    ctx = current_ctx()
    if ctx is None:
        return _grouped(core, q, k, v, *rows)
    ks = spec_for(("batch", "seq", "kv_heads", None), tuple(k.shape), ctx)
    return local_blocks(
        partial(_grouped, core), (q, k, v) + rows,
        (ks, ks, ks) + tuple(P(ks[0], *(None,) * (r.ndim - 1))
                             for r in rows),
        P(ks[0], None, ks[2]))


def attention(cfg, p, x, *, positions, mode: str, cache=None,
              window: int = 0):
    """Returns (y, cache).  ``positions``: (B,S) [or (3,B,S) M-RoPE] int32
    for train/prefill; (B,) [or (3,B)] global positions for decode.
    ``cache`` is updated in place.  Spans (``repro_torch.spans``):
    ``attn.qkv`` (projections and RoPE), ``attn.core`` (the attention and
    the cache write), ``attn.out`` (the output projection)."""
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = hq // hkv
    scale = cfg.query_scale or dh ** -0.5
    cap = cfg.attn_logit_softcap
    b, s = x.shape[:2]

    rope_pos = positions if mode != "decode" else (
        positions[..., None])  # (B,1) / (3,B,1)
    with span("attn.qkv"):
        q = split_last(dense(p["q"], x), hq, dh)
        k = split_last(dense(p["k"], x), hkv, dh)
        v = split_last(dense(p["v"], x), hkv, dh)
        q = apply_rope(q, rope_pos, cfg.rope_theta, cfg.mrope_sections)
        k = apply_rope(k, rope_pos, cfg.rope_theta, cfg.mrope_sections)
    # the mask, the cache slot and the kernel read the token index, which
    # is M-RoPE's first (temporal) section
    tok_pos = positions[0] if cfg.mrope_sections else positions

    ctx = current_ctx()
    cs = spec_for(("batch", "kv_seq", "kv_heads", None),
                  tuple(cache["k"].shape), ctx) \
        if ctx is not None and cache is not None \
        and is_dtensor(cache["k"]) else P(None, None, None, None)
    if mode == "decode":
        # heads stay replicated through decode attention: the cache is
        # sequence-sharded over "model" under the serving rules
        q = shard(q, "batch", None, None, None)
        k = shard(k, "batch", None, None, None)
        v = shard(v, "batch", None, None, None)
        t = cache["k"].shape[1]
        qs, ns = P(cs[0], cs[2], None, None), P(cs[0], cs[2], None)
        with span("attn.core"):
            out = local_blocks(
                partial(_decode_block, t=t, axes=entry_axes(cs[1]),
                        window=window, scale=scale, cap=cap),
                (q.reshape(b, hkv, g, dh), k[:, 0], v[:, 0], cache["k"],
                 cache["v"], tok_pos), (qs, ns, ns, cs, cs, P(cs[0])), qs)
        with span("attn.out"):
            out = shard(out.reshape(b, 1, hq * dh), "batch", "seq", None)
            return dense_to_stream(p["o"], out, mode), cache

    q = shard(q, "batch", "seq", "heads", None)
    k = shard(k, "batch", "seq", "kv_heads", None)
    v = shard(v, "batch", "seq", "kv_heads", None)
    # analysis traces count the plain path's FLOPs (the same as the
    # chunked path's) without its loops
    fn = _chunked_attention if s >= FLASH_SEQ and not is_analysis() \
        else _plain_attention
    with span("attn.core"):
        out = grouped_attention(
            lambda qg, k, v, pos: fn(qg, k, v, pos, pos, window, scale,
                                     cap),
            q, k, v, tok_pos)
        if mode == "prefill":
            ns = P(cs[0], None, cs[2], None)
            local_blocks(partial(_prefill_block, t=cache["k"].shape[1],
                                 axes=entry_axes(cs[1])),
                         (k, v, cache["k"], cache["v"]), (ns, ns, cs, cs),
                         cs)
    with span("attn.out"):
        out = shard(out, "batch", "seq", "heads")
        return dense_to_stream(p["o"], out, mode), cache


# ---------------------------------------------------------------------------
# The cache, block by block.  Each function below runs on plain tensors:
# the whole cache, or on a mesh one rank's block of it, which holds slots
# [off, off + block) of the ``t`` slots along "kv_seq".
# ---------------------------------------------------------------------------


def _prefill_block(kn, vn, kc, vc, *, t: int, axes):
    """Fill the cache block from the new K/V (B, S, Hkv, Dh) of positions
    0..S-1: a linear cache takes positions [off, off + block), a ring
    (``t`` < S) keeps the last ``t`` with position p in slot p % t."""
    tb = kc.shape[1]
    off = block_start(axes, tb)
    for c, new in ((kc, kn), (vc, vn)):
        s = new.shape[1]
        if t >= s:                                       # linear fill
            n = max(0, min(tb, s - off))
            c[:, :n] = new[:, off:off + n]
        else:
            c.copy_(torch.roll(new[:, -t:], s % t, dims=1)[:, off:off + tb])
    return kc


def _decode_block(qg, kn, vn, kc, vc, pos, *, t: int, axes, window, scale,
                  cap):
    """Write each row's new K/V (B, Hkv, Dh) into its ring slot pos mod t,
    where this block holds it, then attend.  Over a whole cache (``axes``
    of one rank) that is the attention kernel.  Over a block of a cache
    split along "kv_seq", each rank forms its partial softmax (max,
    normaliser, unnormalised output) with the kernel's ``partials``, and
    the ranks merge them (``merge_partials``): an all-reduce max and two
    sums over ``axes``, the all-reduces GSPMD places for the reference's
    decode attention."""
    ctx = current_ctx()
    ranks = ctx.axis_size(axes) if axes else 1
    tb = kc.shape[1]
    off = block_start(axes, tb)
    slot = torch.remainder(pos.long(), t) - off
    rows = torch.arange(kc.shape[0], device=kc.device)
    for c, new in ((kc, kn), (vc, vn)):
        new = new.to(c.dtype)
        if tb == t:
            c[rows, slot] = new
        else:                     # rows whose slot another rank holds
            mine = ((slot >= 0) & (slot < tb))[:, None, None]
            idx = slot.clamp(0, tb - 1)
            c[rows, idx] = torch.where(mine, new, c[rows, idx])
    kw = dict(window=window, logit_cap=cap, scale=scale)
    if ranks == 1:
        return ops.partition_attention(qg, kc, vc, pos.to(torch.int32), **kw)
    top, l, acc = ops.partition_attention(qg, kc, vc, pos.to(torch.int32),
                                          off=off, t=t, partials=True, **kw)

    def amax(x):
        x = x.clone()
        for a in axes:
            if ctx.shape[a] > 1:
                dist.all_reduce(x, op=dist.ReduceOp.MAX,
                                group=ctx.mesh.get_group(a))
        return x

    def total(x):
        for a in axes:
            x = psum(x, a)
        return x
    return merge_partials(top, l, acc, amax, total).to(vc.dtype)


def merge_partials(top, l, acc, amax, total):
    """Blocks' softmax partials (max, normaliser, unnormalised output) as
    one softmax's output: with ``amax``/``total`` the max and the sum over
    the blocks (all-reduces over ranks, or reductions over a stacked dim
    with ``keepdim``), sum(acc * e) / sum(l * e), e = exp(max - the
    blocks' max).  A block with no valid slot has max NEG_INF and weighs
    exactly 0; a row with no valid slot anywhere (pos < 0) takes every
    block at weight 1, the mean of V over the ring."""
    m = amax(top)
    e = torch.exp(top - m)
    return total(acc * e[..., None]) / total(l * e)[..., None]


def make_attn_cache_spec(cfg, batch: int, cache_len: int, window: int = 0):
    """ParamSpec tree for one attention block's KV cache."""
    t = min(cache_len, window) if window else cache_len
    sp = ParamSpec((batch, t, cfg.num_kv_heads, cfg.head_dim), bf16,
                   ("batch", "kv_seq", "kv_heads", None), init="zeros")
    return {"k": sp, "v": sp}
