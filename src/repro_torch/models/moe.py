"""Mixture-of-Experts FFN: top-k routing with expert capacity.

Port of ``repro.models.moe``.  Tokens are scattered into a dense (E, C, D)
dispatch buffer (C = per-expert capacity), batched-matmul'd through the
stacked expert weights, and gathered back with combine weights.  The three
batched matmuls compute all E*C rows and read every expert's weights,
whether or not a slot was routed to it: E*C is about top_k * tokens *
capacity_factor, so at a capacity factor of E / top_k (dropless) the
experts compute E / top_k times the routed slots (4x for Mixtral).

Spans (``repro_torch.spans``): ``moe`` around the block (``tokens``,
``experts``, ``top_k``, and ``capacity`` where the block runs whole on one
device), with ``moe.route``, ``moe.dispatch``, ``moe.experts`` (the three
matmuls and the activation) and ``moe.combine`` inside.  A ``Probe``
made active by ``probing`` has each block of a step write its device
readings (its rank cumsum, whose last row is the slots routed to each
expert, and on the card a pair of timing events around the block) into
persistent buffers, so that they survive a CUDA graph's replay and are
read after the step.

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

import contextlib
import threading

import torch

import torch.distributed as dist

from repro_torch.models.layers import ParamSpec, act_fn, f32
from repro_torch.sharding import (P, current_ctx, entry_axes, is_dtensor,
                                  local_blocks, psum, shard, spec_for)
from repro_torch.spans import span

_local = threading.local()


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
    n = x.shape[0] * x.shape[1]
    with span("moe", tokens=n, experts=cfg.num_experts,
              top_k=cfg.num_experts_per_tok) as s:
        if ctx is not None and "model" in ctx.shape:
            return _moe_shard_map(cfg, p, x, ctx)
        s.note(capacity=capacity(cfg, n))
        return _moe_dense(cfg, p, x)


def route(cfg, p, xt):
    """Top-k routing of tokens ``xt`` (N, D) in f32: softmax over the
    experts, the k largest, renormalised.  Returns (weights, experts),
    each (N, K) with the largest weight first."""
    # a bf16 router (a tree cast whole) is promoted, as JAX promotes it
    probs = torch.softmax(xt.to(f32) @ p["router"].to(f32), dim=-1)
    top_w, top_e = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    return top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9), top_e


def dispatch_slots(cfg, top_e, c, cum=None):
    """Slot ranks inside each expert's buffer, in token order (a cumsum
    over a one-hot, as the reference computes them), and which slots fit
    the capacity ``c``.  A slot over capacity is dropped: its rank is set
    to 0 and ``keep`` is False.  ``cum`` (N*K, E), a probe's buffer, takes
    the cumsum, whose last row is the slots routed to each expert."""
    flat_e = top_e.reshape(-1)                                  # (N*K,)
    onehot = torch.nn.functional.one_hot(flat_e, cfg.num_experts)
    cum = torch.cumsum(onehot, dim=0, out=cum)
    rank = (cum * onehot).sum(-1) - 1                           # (N*K,)
    keep = rank < c
    return flat_e, torch.where(keep, rank, 0), keep


def _local_experts(cfg, xt, router, gate, up, down, c, e0=None,
                   cum=None):
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
    ``zeros.at[src].add`` does: the order, and so the rounding, is fixed.
    ``cum``: as ``dispatch_slots`` takes it."""
    n, d = xt.shape
    k = cfg.num_experts_per_tok
    e_loc = gate.shape[0]
    with span("moe.route"):
        top_w, top_e = route(cfg, {"router": router}, xt)
    with span("moe.dispatch"):
        flat_e, rank, keep = dispatch_slots(cfg, top_e, c, cum)
        w = top_w.reshape(-1) * keep
        le = flat_e
        if e0 is not None:
            local = (flat_e >= e0) & (flat_e < e0 + e_loc)
            le = torch.where(local, flat_e - e0, 0)
            keep = keep & local
            w = w * local
        # flat buffer row of each slot; dropped slots go to a spare last row
        dest = torch.where(keep, le * c + rank, e_loc * c)
        buf = torch.zeros((e_loc * c + 1, d), dtype=xt.dtype,
                          device=xt.device)
        buf.index_copy_(0, dest, xt.repeat_interleave(k, dim=0))
        buf = shard(buf[:e_loc * c].view(e_loc, c, d),
                    "experts", "expert_cap", None)

    with span("moe.experts"):
        h = act_fn(cfg.act, torch.bmm(buf, gate)) * torch.bmm(buf, up)
        h = shard(h, "experts", "expert_cap", "expert_mlp")
        out = shard(torch.bmm(h, down), "experts", "expert_cap", None)
        out = out.reshape(e_loc * c, d)

    with span("moe.combine"):
        gathered = out[le * c + rank]                           # (N*K, D)
        gathered = (gathered * w[:, None].to(xt.dtype)).view(n, k, d)
        y = torch.zeros((n, d), dtype=xt.dtype, device=xt.device)
        for j in range(k):
            y = y + gathered[:, j]
    return y


def _moe_dense(cfg, p, x):
    """Reference path (no mesh): capacity-based scatter/gather over every
    token of the batch; the path an active ``Probe`` reads."""
    b, s, d = x.shape
    n = b * s
    c = capacity(cfg, n)
    probe = getattr(_local, "probe", None)
    cum = probe.begin(n, c) if probe is not None else None
    y = _local_experts(cfg, x.reshape(n, d), p["router"], p["gate"],
                       p["up"], p["down"], c, cum=cum)
    if probe is not None:
        probe.end()
    return y.reshape(b, s, d)


class Probe:
    """Device readings of the expert blocks of one decode step, written
    by the step itself, and so by its CUDA graph when it is replayed: each
    block's rank cumsum goes to a persistent buffer (``cums``, one per
    token count), whose last row is the slots routed to each expert, and
    on the card a pair of timing events brackets each block, recorded as
    graph nodes in a capture (``external``).  Neither adds a kernel to the
    step.  Nothing is read on the host until ``read``.

    ``blocks`` holds the token count and capacity of each block the last
    probed step ran (its Python, an eager step's or a capture's: a replay
    runs the captured blocks again)."""

    def __init__(self, cfg, device):
        self.layers, self.k = cfg.num_layers, cfg.num_experts_per_tok
        self.experts = cfg.num_experts
        self.device = torch.device(device)
        self.cums: dict[int, torch.Tensor] = {}
        self.events = [
            tuple(torch.cuda.Event(enable_timing=True, external=True)
                  for _ in range(2)) for _ in range(cfg.num_layers)] \
            if self.device.type == "cuda" else None
        self.blocks: list[tuple[int, int]] = []

    def begin(self, n: int, c: int) -> torch.Tensor:
        """The next block's cumsum buffer (n * k, E); its start event
        recorded."""
        i = len(self.blocks)
        self.blocks.append((n, c))
        if n not in self.cums:
            self.cums[n] = torch.zeros((self.layers, n * self.k,
                                        self.experts), dtype=torch.int64,
                                       device=self.device)
        if self.events is not None:
            self.events[i][0].record()
        return self.cums[n][i]

    def end(self) -> None:
        if self.events is not None:
            self.events[len(self.blocks) - 1][1].record()

    def routed(self) -> torch.Tensor:
        """(blocks, E) on the host: the slots the last step routed to each
        expert, block by block (one copy of the blocks' buffers from the
        device, contiguous, so no gather kernel)."""
        n = self.blocks[0][0]
        return self.cums[n][:len(self.blocks)].cpu()[:, -1]

    def read(self):
        """The last step's readings, summed over its expert blocks, once
        the step is done; ``expert_ms`` from the events on the card.  A
        slot is dropped where its rank reaches the capacity C, so an
        expert routed r slots drops max(r - C, 0).  None where the step
        ran no block through the probe (a mesh's)."""
        if not self.blocks:
            return None
        routed = self.routed()
        caps = torch.tensor([c for _n, c in self.blocks])
        dropped = int((routed - caps[:, None]).clamp(min=0).sum())
        out = {"layers": len(self.blocks), "tokens": self.blocks[0][0],
               "slots": int(routed.sum()) - dropped, "dropped": dropped,
               "experts_hit": int((routed > 0).sum()),
               "rows": self.experts * int(caps.sum())}
        if self.events is not None:
            out["expert_ms"] = sum(a.elapsed_time(b)
                                   for a, b in self.events[:len(self.blocks)])
        return out


@contextlib.contextmanager
def probing(probe):
    """Run the expert blocks of the code inside under ``probe`` (None:
    under none), on this thread; the probe forgets its last step's
    blocks."""
    prev = getattr(_local, "probe", None)
    if probe is not None:
        probe.blocks = []
    _local.probe = probe
    try:
        yield
    finally:
        _local.probe = prev


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
