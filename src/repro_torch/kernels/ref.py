"""Plain PyTorch versions of the port's kernels: the CPU path of every
wrapper in ``ops`` and the oracle each CUDA kernel is held against on the
card.  They follow ``repro.kernels.ref`` line by line, except that
``snapshot_restore`` writes in place (the kernel aliases the leaves the way
the Pallas kernel's ``input_output_aliases`` does)."""
from __future__ import annotations

import torch

f32 = torch.float32
NEG_INF = -2.0 ** 30


def _softcap(x, cap):
    return torch.tanh(x / cap) * cap if cap else x


def partition_attention(q, k_cache, v_cache, positions, *, window: int = 0,
                        logit_cap: float = 0.0, scale: float | None = None):
    """Decode attention over contiguous (HotMem partition) KV rows.

    q: (P, Hkv, G, Dh); k/v_cache: (P, T, Hkv, Dh) ring caches;
    positions: (P,) global position of the current token (already written).
    Returns (P, Hkv, G, Dh) in the dtype of ``v_cache``.
    """
    t = k_cache.shape[1]
    if scale is None:
        scale = q.shape[-1] ** -0.5
    slots = torch.arange(t, dtype=torch.int64, device=q.device)[None, :]
    pos = positions.to(torch.int64)[:, None]
    # torch.remainder is a floor modulo, like jnp's %
    gidx = pos - torch.remainder(pos - slots, t)
    valid = gidx >= 0
    if window:
        valid &= gidx > pos - window
    s = torch.einsum("bkgd,btkd->bkgt", q.to(f32), k_cache.to(f32)) * scale
    s = _softcap(s, logit_cap)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bkgt,btkd->bkgd", w.to(v_cache.dtype), v_cache)


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
