"""RG-LRU recurrent block (RecurrentGemma / Griffin).  [arXiv:2402.19427]

Port of ``repro.models.rglru``.  Block: gated dual-branch —
y = GeLU(W_y u); x = RG-LRU(conv4(W_x u)); out = W_o (x * y).  The RG-LRU
diagonal recurrence
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
    a_t = exp(-c * softplus(L) * r_t),  c = 8,
runs over the sequence as a log-depth doubling scan (torch has no
``associative_scan``: about log2(S) elementwise steps instead of S) and as
a single step in decode.  Gates use block-diagonal weights (num_heads
blocks) as in Griffin.  Per-request decode state = {h + conv tail}: O(1)
in context.  Prefill and decode write the cache leaves in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (ParamSpec, act_fn, bf16, dense,
                                       dense_spec, dense_to_stream, f32)
from repro_torch.models.ssm import causal_conv
from repro_torch.sharding import is_dtensor, redistribute, shard, split_last

LRU_C = 8.0


def rglru_spec(cfg):
    d, w = cfg.d_model, cfg.lru_width
    nb = cfg.num_heads                       # gate blocks
    bs = w // nb
    cw = 4                                   # temporal conv width
    return {
        "y": dense_spec(d, w, ("w_embed", "lru")),
        "x": dense_spec(d, w, ("w_embed", "lru")),
        "conv": {"w": ParamSpec((cw, w), axes=(None, "lru"), scale=0.3),
                 "b": ParamSpec((w,), axes=("lru",), init="zeros")},
        "gate_i": {"w": ParamSpec((nb, bs, bs), axes=("heads", None, None)),
                   "b": ParamSpec((nb, bs), axes=("heads", None),
                                  init="zeros")},
        "gate_r": {"w": ParamSpec((nb, bs, bs), axes=("heads", None, None)),
                   "b": ParamSpec((nb, bs), axes=("heads", None),
                                  init="zeros")},
        "lam": ParamSpec((w,), f32, ("lru",), init="ones"),
        "out": dense_spec(w, d, ("lru", "w_embed")),
    }


def _conv(p, x):
    return causal_conv(p, x, "lru")


def _gates(p, x, nb):
    """Block-diagonal sigmoid gates; x (..., W) -> (r, i) each (..., W)
    in f32 (the bf16 weights are cast up, as JAX promotes them)."""
    bs = x.shape[-1] // nb
    xb = split_last(x, nb, bs).to(f32)
    r = torch.sigmoid(torch.einsum("...hi,hio->...ho", xb,
                                   p["gate_r"]["w"].to(f32))
                      + p["gate_r"]["b"])
    i = torch.sigmoid(torch.einsum("...hi,hio->...ho", xb,
                                   p["gate_i"]["w"].to(f32))
                      + p["gate_i"]["b"])
    flat = x.shape[:-1] + (nb * bs,)
    r, i = r.reshape(flat), i.reshape(flat)
    if is_dtensor(x):
        # back onto x's split, so that the backward gathers the incoming
        # gradient before it unflattens it (see ``split_last``)
        from torch.distributed.tensor import Replicate
        to = [pl if pl.is_shard() else Replicate() for pl in x.placements]
        r, i = redistribute(r, to), redistribute(i, to)
    return r, i


def _lru_coeffs(p, x, nb):
    r, i = _gates(p, x, nb)
    log_a = -LRU_C * F.softplus(p["lam"]) * r             # (..., W), <= 0
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * x.to(f32))
    return a, b


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t over axis 1 with h_{-1} = 0, by doubling:
    after the step of stride d every position holds the composition of
    the maps of its last 2d inputs, so ceil(log2(S)) steps cover S."""
    s, d = a.shape[1], 1
    while d < s:
        b = torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b[:, :-d]], dim=1)
        if 2 * d < s:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_block(cfg, p, u, *, mode: str, cache=None):
    """u (B,S,D) -> (y, cache); ``cache`` is updated in place."""
    nb = cfg.num_heads
    gate = act_fn("gelu", dense(p["y"], u))
    x = dense(p["x"], u)

    if mode in ("train", "prefill"):
        xc = _conv(p["conv"], x)
        xc = shard(xc, "batch", "seq", "lru")
        a, bb = _lru_coeffs(p, xc, nb)                     # (B,S,W) f32
        h = linear_scan(a, bb)
        if mode == "prefill":
            cache["state"].copy_(h[:, -1].to(bf16))
            cache["conv"].copy_(x[:, -(p["conv"]["w"].shape[0] - 1):])
    else:
        full = torch.cat([cache["conv"], x[:, 0:1]], dim=1)    # (B,w,W)
        xc = torch.einsum("bwc,wc->bc", full, p["conv"]["w"]) \
            + p["conv"]["b"]
        a, bb = _lru_coeffs(p, xc, nb)                     # (B,W)
        h1 = a * cache["state"].to(f32) + bb
        h = h1[:, None]
        cache["state"].copy_(h1.to(bf16))
        cache["conv"].copy_(full[:, 1:])

    y = h.to(u.dtype) * gate
    return dense_to_stream(p["out"], y, mode), cache


def make_rglru_cache_spec(cfg, batch: int):
    return {
        "state": ParamSpec((batch, cfg.lru_width), bf16, ("batch", "lru"),
                           init="zeros"),
        "conv": ParamSpec((batch, 3, cfg.lru_width), bf16,
                          ("batch", None, "lru"), init="zeros"),
    }
