"""Mixture-of-Experts FFN: top-k routing with expert capacity.

Port of ``repro.models.moe``.  Tokens are scattered into a dense (E, C, D)
dispatch buffer (C = per-expert capacity), batched-matmul'd through the
stacked expert weights, and gathered back with combine weights, so the
work is proportional to the *active* experts (E*C ~ top_k * tokens *
capacity_factor).

Only the reference path (``_moe_dense``) is ported: the JAX package's
``_moe_shard_map`` needs a device mesh, which waits for the sharding
layer; until then ``moe_block`` always takes the dense path.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import ParamSpec, act_fn, f32


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
    """x: (B, S, D) -> (B, S, D)."""
    return _moe_dense(cfg, p, x)


def route(cfg, p, xt):
    """Top-k routing of tokens ``xt`` (N, D) in f32: softmax over the
    experts, the k largest, renormalised.  Returns (weights, experts),
    each (N, K) with the largest weight first."""
    probs = torch.softmax(xt.to(f32) @ p["router"], dim=-1)     # (N, E)
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


def _moe_dense(cfg, p, x):
    """Reference path (no mesh): capacity-based scatter/gather.

    A dropped slot is written nowhere (the reference adds a zero value to
    the expert's rank 0) and contributes a zero-weighted output.  The
    combine adds each token's k slot outputs in slot order onto zeros, in
    the activation dtype, as the reference's ``zeros.at[src].add`` does:
    the order, and so the rounding, is fixed."""
    b, s, d = x.shape
    k, e = cfg.num_experts_per_tok, cfg.num_experts
    n = b * s
    c = capacity(cfg, n)
    xt = x.reshape(n, d)

    top_w, top_e = route(cfg, p, xt)
    flat_e, rank, keep = dispatch_slots(cfg, top_e, c)
    # flat buffer row of each slot; dropped slots go to a spare last row
    dest = torch.where(keep, flat_e * c + rank, e * c)
    buf = torch.zeros((e * c + 1, d), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, dest, xt.repeat_interleave(k, dim=0))
    buf = buf[:e * c].view(e, c, d)

    h = act_fn(cfg.act, torch.bmm(buf, p["gate"])) * torch.bmm(buf, p["up"])
    out = torch.bmm(h, p["down"]).reshape(e * c, d)

    gathered = out[flat_e * c + rank]                           # (N*K, D)
    gathered = gathered * (top_w.reshape(-1) * keep)[:, None].to(x.dtype)
    gathered = gathered.view(n, k, d)
    y = torch.zeros((n, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        y = y + gathered[:, j]
    return y.reshape(b, s, d)

