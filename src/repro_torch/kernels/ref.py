"""Plain PyTorch versions of the port's kernels: the CPU path of every
wrapper in ``ops`` and the oracle each CUDA kernel is held against on the
card.  They follow ``repro.kernels.ref`` line by line, except that
``snapshot_restore`` and ``kv_compact`` write in place (the kernels alias
their operands the way the Pallas kernels' ``input_output_aliases`` do).
``decode_qkv_rope`` has no counterpart there: it is the sequence that
``models.attention`` ran before its kernel, moved here as it was, with
``rotate``, the rotary embedding's arithmetic that ``models.layers.
apply_rope`` shares, and ``write_ring_slots``, the decode step's K/V write
that ``models.attention`` shares."""
from __future__ import annotations

import torch

f32 = torch.float32
NEG_INF = -2.0 ** 30


def _softcap(x, cap):
    return torch.tanh(x / cap) * cap if cap else x


def partition_attention(q, k_cache, v_cache, positions, *, window: int = 0,
                        logit_cap: float = 0.0, scale: float | None = None,
                        off: int = 0, t: int | None = None,
                        partials: bool = False):
    """Decode attention over contiguous (HotMem partition) KV rows.

    q: (P, Hkv, G, Dh); k/v_cache: (P, T, Hkv, Dh) ring caches;
    positions: (P,) global position of the current token (already written).
    Returns (P, Hkv, G, Dh) in the dtype of ``v_cache``.

    The rows may be a block of a larger ring: slots [off, off + T) of
    ``t`` (default: the whole ring).  With ``partials`` the result is the
    block's softmax partials, all f32: the max (P, Hkv, G), the normaliser
    (P, Hkv, G) and the unnormalised output (P, Hkv, G, Dh), which blocks
    merge as sum(acc * e) / sum(l * e) with e = exp(max - the blocks' max).
    """
    tb = k_cache.shape[1]
    t = tb if t is None else t
    if scale is None:
        scale = q.shape[-1] ** -0.5
    slots = off + torch.arange(tb, dtype=torch.int64,
                               device=q.device)[None, :]
    pos = positions.to(torch.int64)[:, None]
    # torch.remainder is a floor modulo, like jnp's %
    gidx = pos - torch.remainder(pos - slots, t)
    valid = gidx >= 0
    if window:
        valid &= gidx > pos - window
    s = torch.einsum("bkgd,btkd->bkgt", q.to(f32), k_cache.to(f32)) * scale
    s = _softcap(s, logit_cap)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    if partials:
        top = s.amax(-1)
        e = torch.exp(s - top[..., None])
        return top, e.sum(-1), torch.einsum("bkgt,btkd->bkgd", e,
                                            v_cache.to(f32))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bkgt,btkd->bkgd", w.to(v_cache.dtype), v_cache)


def paged_attention(q, k_pool, v_pool, tables, positions, *,
                    logit_cap: float = 0.0, scale: float | None = None):
    """Decode attention over the vanilla paged layout.

    q: (P, Hkv, G, Dh); k/v_pool: (NB, BT, Hkv, Dh);
    tables: (P, MB) int32 block ids (-1 = unmapped);
    positions: (P,) current token position (token i lives in logical block
    i // BT at offset i % BT — linear fill, no ring).
    An unmapped slot gathers block 0 and is masked, as in the JAX oracle;
    the kernel skips it.  The two differ only for a row with no valid
    token.  Returns (P, Hkv, G, Dh) in the dtype of ``v_pool``.
    """
    bt = k_pool.shape[1]
    p, mb = tables.shape
    if scale is None:
        scale = q.shape[-1] ** -0.5
    idx = tables.long().clamp(min=0)
    sh = (p, mb * bt) + tuple(k_pool.shape[2:])
    k_rows = k_pool[idx].reshape(sh)                # (P, MB*BT, Hkv, Dh)
    v_rows = v_pool[idx].reshape(sh)
    tok = torch.arange(mb * bt, dtype=torch.int64, device=q.device)[None, :]
    valid = (tok <= positions.long()[:, None]) & \
        (tables.repeat_interleave(bt, dim=1) >= 0)
    s = torch.einsum("bkgd,btkd->bkgt", q.to(f32), k_rows.to(f32)) * scale
    s = _softcap(s, logit_cap)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bkgt,btkd->bkgd", w.to(v_rows.dtype), v_rows)


def rotate(x, angles):
    """The rotary embedding of x (B, S, H, D) by ``angles`` (B, S, D/2) f32:
    the halves (x1, x2) become (x1 cos - x2 sin, x2 cos + x1 sin) in f32,
    rounded to x's dtype (``models.layers.apply_rope``)."""
    d2 = x.shape[-1] // 2
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :d2].to(f32), x[..., d2:].to(f32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def decode_qkv_rope(q, k, v, bq, bk, bv, positions, freqs, k_cache,
                    v_cache):
    """The front end of one attention block's decode step: the bias adds
    (where ``bq``, ``bk``, ``bv`` are not None), the rotary embedding of q
    and k at ``positions`` (P,) with ``freqs`` (Dh/2,) f32 (``models.
    layers.apply_rope``'s), and the write of k and v into every
    row's slot ``positions mod t`` (floor modulo) of k/v_cache (P, t, Hkv,
    Dh), in place.  q (P, Hq*Dh), k and v (P, Hkv*Dh).  Returns q as (P,
    Hkv, G, Dh)."""
    p, t, hkv, dh = k_cache.shape
    hq = q.shape[-1] // dh
    q, k, v = (x if b is None else x + b
               for x, b in ((q, bq), (k, bk), (v, bv)))
    angles = positions[:, None, None].to(f32) * freqs         # (P, 1, D/2)
    q = rotate(q.reshape(p, 1, hq, dh), angles)
    k = rotate(k.reshape(p, 1, hkv, dh), angles)
    write_ring_slots(k_cache, v_cache, k[:, 0], v.reshape(p, hkv, dh),
                     positions, t=t)
    return q.reshape(p, hkv, hq // hkv, dh)


def write_ring_slots(kc, vc, k, v, positions, *, t: int, off: int = 0):
    """Write each row's new k and v (P, Hkv, Dh), cast to the caches'
    dtype, into its ring slot ``positions mod t`` (P,) of kc/vc (P, T, Hkv,
    Dh), in place.  The caches may be a block of the ring, slots [off, off
    + T) of ``t``: a row whose slot lies outside the block keeps its
    bytes."""
    tb = kc.shape[1]
    # torch.remainder is a floor modulo, like jnp's %
    slot = torch.remainder(positions.long(), t) - off
    rows = torch.arange(kc.shape[0], device=kc.device)
    for c, new in ((kc, k), (vc, v)):
        new = new.to(c.dtype)
        if tb == t:
            c[rows, slot] = new
        else:
            mine = ((slot >= 0) & (slot < tb))[:, None, None]
            idx = slot.clamp(0, tb - 1)
            c[rows, idx] = torch.where(mine, new, c[rows, idx])


def kv_compact(pool, src, dst, count):
    """Migration, in place: ``pool[dst[i]] = pool[src[i]]`` for the live
    moves ``i < count``.  A move whose ``dst`` lies at or past NB is dropped
    (the JAX oracle's ``mode="drop"``, which the engine's padding with
    ``dst = NB`` relies on).  Every source block is gathered before any
    write, as in the JAX oracle.  ``src``/``dst`` are int tensors on the
    pool's device.  Returns ``pool``."""
    src, dst = src.long(), dst.long()
    live = (torch.arange(src.shape[0], device=src.device) < count) \
        & (dst < pool.shape[0])
    blocks = pool.index_select(0, src[live])
    pool.index_copy_(0, dst[live], blocks)
    return pool


def snapshot_capture(leaves, rows, layout):
    """Per-row slices of every leaf, concatenated in tree-flatten order
    into a (N, row_elems) blob; ``rows`` is an int64 tensor on the leaves'
    device."""
    n = rows.shape[0]
    parts = []
    for leaf, slot in zip(leaves, layout.slots):
        sl = torch.index_select(leaf, slot.axis, rows).movedim(slot.axis, 0)
        parts.append(sl.reshape(n, slot.size))
    return torch.cat(parts, dim=1)


def snapshot_restore(leaves, blob, rows, layout):
    """Scatter blob rows back into every leaf at ``rows``, in place;
    untouched rows keep their bytes.  Returns the leaves."""
    n = rows.shape[0]
    for leaf, slot in zip(leaves, layout.slots):
        chunk = blob[:, slot.offset:slot.offset + slot.size]
        ax = slot.axis
        rest = slot.block_shape[:ax] + slot.block_shape[ax + 1:]
        vals = chunk.reshape((n,) + rest).movedim(0, ax)
        leaf.index_copy_(ax, rows, vals.to(leaf.dtype))
    return leaves
