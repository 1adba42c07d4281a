"""Mixture-of-Experts FFN: top-k routing with expert capacity.

Port of ``repro.models.moe``.  Tokens are scattered into a dense (E, C, D)
dispatch buffer (C = per-expert capacity), batched-matmul'd through the
stacked expert weights, and gathered back with combine weights, so the
work is proportional to the *active* experts (E*C ~ top_k * tokens *
capacity_factor).

Under a mesh with a "model" axis ``moe_block`` takes ``_moe_shard_map``,
the twin of the JAX package's ``shard_map`` path, through DTensor's
``local_map``: the FSDP'd expert-weight dims are gathered explicitly,
tokens are dispatched on the rank that holds them (expert parallelism
keeps only the local experts, tensor parallelism all experts with d_ff
sliced), capacity comes from the *local* token count, and one sum over
"model" combines the result.  Without a mesh it takes ``_moe_dense``, the
reference path.  Both run the same per-token code (``_local_experts``).
"""
from __future__ import annotations

import torch

import torch.distributed as dist

from repro_torch.models.layers import ParamSpec, act_fn, f32
from repro_torch.sharding import (P, current_ctx, entry_axes, is_dtensor,
                                  local_blocks, psum, shard, spec_for)


def moe_spec(cfg):
    e, d, ff = cfg.num_experts, cfg.d_model, cfg.d_ff
    wa = ("experts", "w_embed", "expert_mlp")
    return {
        "router": ParamSpec((d, e), f32, (None, None)),   # tiny: replicated
        "gate": ParamSpec((e, d, ff), axes=wa),
        "up": ParamSpec((e, d, ff), axes=wa),
        "down": ParamSpec((e, ff, d), axes=("experts", "expert_mlp",
                                            "w_embed")),
    }


def capacity(cfg, n_tokens: int) -> int:
    c = int(n_tokens * cfg.num_experts_per_tok * cfg.moe_capacity_factor
            / cfg.num_experts)
    return max(((c + 7) // 8) * 8, 8)


def moe_block(cfg, p, x):
    """x: (B, S, D) -> (B, S, D).  Dispatches to the shard-map path when a
    mesh context with a "model" axis is active (partitioning the capacity
    scatter op by op would replicate the dispatch buffers on every rank;
    the shard-map path keeps dispatch rank-local and pays one sum over
    "model" per layer, like a dense TP MLP)."""
    ctx = current_ctx()
    if ctx is not None and "model" in ctx.shape:
        return _moe_shard_map(cfg, p, x, ctx)
    return _moe_dense(cfg, p, x)


def route(cfg, p, xt):
    """Top-k routing of tokens ``xt`` (N, D) in f32: softmax over the
    experts, the k largest, renormalised.  Returns (weights, experts),
    each (N, K) with the largest weight first."""
    # a bf16 router (a tree cast whole) is promoted, as JAX promotes it
    probs = torch.softmax(xt.to(f32) @ p["router"].to(f32), dim=-1)
    top_w, top_e = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    return top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9), top_e


def dispatch_slots(cfg, top_e, c):
    """Slot ranks inside each expert's buffer, in token order (a cumsum
    over a one-hot, as the reference computes them), and which slots fit
    the capacity ``c``.  A slot over capacity is dropped: its rank is set
    to 0 and ``keep`` is False."""
    flat_e = top_e.reshape(-1)                                  # (N*K,)
    onehot = torch.nn.functional.one_hot(flat_e, cfg.num_experts)
    rank = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1   # (N*K,)
    keep = rank < c
    return flat_e, torch.where(keep, rank, 0), keep


def _local_experts(cfg, xt, router, gate, up, down, c, e0=None):
    """Tokens ``xt`` (N, D) through the experts whose weights are given,
    with capacity ``c``: (N, D).  ``gate``/``up``/``down`` hold all E
    experts (``e0`` None: the reference path, or tensor parallelism with
    d_ff sliced) or the ``gate.shape[0]`` experts from ``e0`` on (expert
    parallelism: slots routed elsewhere are dropped here and counted by
    the rank that holds their expert).

    A dropped slot is written nowhere (the reference adds a zero value to
    the expert's rank 0, or drops an out-of-range expert) and contributes
    a zero-weighted output.  The combine adds each token's k slot outputs
    in slot order onto zeros, in the activation dtype, as the reference's
    ``zeros.at[src].add`` does: the order, and so the rounding, is fixed."""
    n, d = xt.shape
    k = cfg.num_experts_per_tok
    e_loc = gate.shape[0]
    top_w, top_e = route(cfg, {"router": router}, xt)
    flat_e, rank, keep = dispatch_slots(cfg, top_e, c)
    w = top_w.reshape(-1) * keep
    le = flat_e
    if e0 is not None:
        local = (flat_e >= e0) & (flat_e < e0 + e_loc)
        le = torch.where(local, flat_e - e0, 0)
        keep = keep & local
        w = w * local
    # flat buffer row of each slot; dropped slots go to a spare last row
    dest = torch.where(keep, le * c + rank, e_loc * c)
    buf = torch.zeros((e_loc * c + 1, d), dtype=xt.dtype, device=xt.device)
    buf.index_copy_(0, dest, xt.repeat_interleave(k, dim=0))
    buf = shard(buf[:e_loc * c].view(e_loc, c, d),
                "experts", "expert_cap", None)

    h = act_fn(cfg.act, torch.bmm(buf, gate)) * torch.bmm(buf, up)
    h = shard(h, "experts", "expert_cap", "expert_mlp")
    out = shard(torch.bmm(h, down), "experts", "expert_cap", None)
    out = out.reshape(e_loc * c, d)

    gathered = out[le * c + rank]                               # (N*K, D)
    gathered = (gathered * w[:, None].to(xt.dtype)).view(n, k, d)
    y = torch.zeros((n, d), dtype=xt.dtype, device=xt.device)
    for j in range(k):
        y = y + gathered[:, j]
    return y


def _moe_dense(cfg, p, x):
    """Reference path (no mesh): capacity-based scatter/gather over every
    token of the batch."""
    b, s, d = x.shape
    n = b * s
    y = _local_experts(cfg, x.reshape(n, d), p["router"], p["gate"],
                       p["up"], p["down"], capacity(cfg, n))
    return y.reshape(b, s, d)


# ---------------------------------------------------------------------------
# Shard-map path
# ---------------------------------------------------------------------------

CHUNK = 16384        # bound dispatch-buffer size at long prefills


class _AllGather(torch.autograd.Function):
    """Tiled all-gather of ``x`` along ``dim`` over one mesh axis's group;
    the backward sums every rank's gradient of the whole and keeps this
    rank's block (a reduce-scatter, as ``jax.lax.all_gather``'s transpose
    is ``psum_scatter``)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        n = g.shape[ctx.dim] // dist.get_world_size(ctx.group)
        return g.narrow(ctx.dim, dist.get_rank(ctx.group) * n, n), None, None


def _gather_dim(w, spec, dim, ctx):
    """Gather ``w``'s block along ``dim`` over the mesh axes ``spec``
    shards it on, minor axis first, so the blocks land major to minor.
    An axis of one rank gathers nothing (XLA drops such a gather too)."""
    entry = spec[dim] if dim < len(spec) else None
    if entry is None:
        return w
    for ax in reversed(entry_axes(entry)):
        if ctx.shape[ax] > 1:
            w = _AllGather.apply(w, dim, ctx.mesh.get_group(ax))
    return w


def _moe_shard_map(cfg, p, x, ctx):
    """``shard_map``'s twin through ``sharding.local_blocks``: the router
    and the replicated weight dims take their gradients summed over the
    axes the work is split on (rows over "data", experts or d_ff over
    "model")."""
    assert is_dtensor(x), "the shard-map path takes DTensors on a mesh"
    mesh = ctx.mesh
    ep = cfg.moe_sharding == "ep"
    x = shard(x, "batch", "seq", None)          # tokens: DP only
    xs = spec_for(("batch", "seq", None), tuple(x.shape), ctx)
    gs = spec_for(("experts", "w_embed", "expert_mlp"),
                  tuple(p["gate"].shape), ctx)
    ds_ = spec_for(("experts", "expert_mlp", "w_embed"),
                   tuple(p["down"].shape), ctx)

    def local_fn(xb, router, gate, up, down):
        bl, sl, dm = xb.shape
        n = bl * sl
        xt = xb.reshape(n, dm)
        # FSDP'd weight dims are gathered explicitly
        gate = _gather_dim(gate, gs, 1, ctx)
        up = _gather_dim(up, gs, 1, ctx)
        down = _gather_dim(down, ds_, 2, ctx)
        e0 = mesh.get_local_rank("model") * gate.shape[0] if ep else None

        def tokens_fn(xc):
            return _local_experts(cfg, xc, router, gate, up, down,
                                  capacity(cfg, xc.shape[0]), e0)
        if n <= CHUNK:
            y = tokens_fn(xt)
        else:
            nc = -(-n // CHUNK)
            xp = torch.nn.functional.pad(xt, (0, 0, 0, nc * CHUNK - n))
            y = torch.cat([tokens_fn(ch) for ch in xp.split(CHUNK)])[:n]
        y = psum(y, "model")                     # combine experts / F
        return y.reshape(bl, sl, dm)

    return local_blocks(local_fn, (x, p["router"], p["gate"], p["up"],
                                   p["down"]),
                        (xs, P(None, None), gs, gs, ds_), xs)
