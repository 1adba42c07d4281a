"""Mamba2 / SSD (state-space duality) block.  [arXiv:2405.21060]

Port of ``repro.models.ssm``.  Train/prefill use the chunked SSD algorithm:
quadratic attention-like math within chunks, a loop over chunks carrying
the state — O(S * L) compute, O(1)-in-S decode state.  Decode is the plain
diagonal recurrence h = h * exp(dt*A) + dt * (B (x) x).

As in the port's attention, prefill and decode write the cache leaves IN
PLACE and return the same cache dict.  Three rules keep the numbers the
JAX package's:
  * the chunk length is ``min(256, S)`` (the JAX function ignores
    ``cfg.ssm_chunk``), and S must be a multiple of it;
  * the state is rounded to bf16 after prefill and after every decode step
    and read back as f32;
  * JAX promotes mixed bf16/f32 operands of an einsum to f32, torch refuses
    them, so every such operand is cast to f32 here, never the other way.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (ParamSpec, bf16, dense, dense_spec,
                                       dense_to_stream, f32, norm_spec,
                                       rmsnorm)
from repro_torch.sharding import P, current_ctx, local_blocks, shard, spec_for


def ssm_spec(cfg):
    d, di = cfg.d_model, cfg.d_inner
    g, ds, h = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    w = cfg.ssm_conv_width
    return {
        "z": dense_spec(d, di, ("w_embed", "ssm_inner")),
        "x": dense_spec(d, di, ("w_embed", "ssm_inner")),
        "B": dense_spec(d, g * ds, ("w_embed", None)),
        "C": dense_spec(d, g * ds, ("w_embed", None)),
        "dt": dense_spec(d, h, ("w_embed", "ssm_heads")),
        "conv_x": {"w": ParamSpec((w, di), axes=(None, "ssm_inner"),
                                  scale=0.3),
                   "b": ParamSpec((di,), axes=("ssm_inner",), init="zeros")},
        "conv_B": {"w": ParamSpec((w, g * ds), axes=(None, None), scale=0.3),
                   "b": ParamSpec((g * ds,), axes=(None,), init="zeros")},
        "conv_C": {"w": ParamSpec((w, g * ds), axes=(None, None), scale=0.3),
                   "b": ParamSpec((g * ds,), axes=(None,), init="zeros")},
        "A_log": ParamSpec((h,), f32, ("ssm_heads",), init="a_log"),
        "D": ParamSpec((h,), f32, ("ssm_heads",), init="ones"),
        "dt_bias": ParamSpec((h,), f32, ("ssm_heads",), init="dt_bias"),
        "norm": norm_spec(di, ("ssm_inner",)),
        "out": dense_spec(di, d, ("ssm_inner", "w_embed")),
    }


def _shifted_conv(w, b, x):
    """Depthwise causal conv via shifted adds: w (W,C), b (C,), x (B,S,C)."""
    s = x.shape[1]
    xp = F.pad(x, (0, 0, w.shape[0] - 1, 0))
    return sum(xp[:, i:i + s] * w[i] for i in range(w.shape[0])) + b


def causal_conv(p, x, axis=None):
    """``_shifted_conv`` with the channels on the logical ``axis``; on a
    mesh each rank convolves its own rows and channels (no
    communication), as GSPMD partitions it."""
    ctx = current_ctx()
    if ctx is None:
        return _shifted_conv(p["w"], p["b"], x)
    xs = spec_for(("batch", "seq", axis), tuple(x.shape), ctx)
    return local_blocks(_shifted_conv, (p["w"], p["b"], x),
                        (P(None, xs[2]), P(xs[2]), xs), xs)


def _causal_conv(p, x, axis=None):
    """Depthwise causal conv, then SiLU; x (B,S,C)."""
    return F.silu(causal_conv(p, x, axis))


def _conv_step(p, hist, xt):
    """One-token conv; hist (B, w-1, C), xt (B, C) -> (y, new_hist)."""
    w = p["w"].shape[0]
    full = torch.cat([hist, xt[:, None]], dim=1)            # (B, w, C)
    y = F.silu(torch.einsum("bwc,wc->bc", full, p["w"]) + p["b"])
    return y, full[:, -(w - 1):]


def _broadcast_groups(bc, h):
    """(B,...,G,ds) -> (B,...,H,ds)."""
    g = bc.shape[-2]
    return torch.repeat_interleave(bc, h // g, dim=-2)


def ssd_chunked(x, dt, A, B, C, h0):
    """Chunked SSD.  x (B,S,H,P), dt (B,S,H), A (H,), B/C (B,S,H,N),
    h0 (B,H,P,N) initial state.  Returns (y (B,S,H,P), h_final f32)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    l = min(256, s)
    assert s % l == 0, f"sequence {s} is not a multiple of the chunk {l}"
    nc = s // l
    xr = x.reshape(b, nc, l, h, p).to(f32)
    dtr = dt.reshape(b, nc, l, h).to(f32)
    Br = B.reshape(b, nc, l, h, n).to(f32)
    Cr = C.reshape(b, nc, l, h, n).to(f32)

    da = dtr * A                                            # (B,nc,L,H) <= 0
    da_cs = torch.cumsum(da, dim=2)                         # inclusive
    da_total = da_cs[:, :, -1]                              # (B,nc,H)

    # intra-chunk (quadratic within chunk)
    seg = da_cs[:, :, :, None, :] - da_cs[:, :, None, :, :]  # (B,nc,Li,Lj,H)
    causal = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
    decay = torch.where(causal[None, None, :, :, None], torch.exp(seg),
                        torch.zeros((), dtype=f32, device=x.device))
    scores = torch.einsum("bclhn,bcmhn->bclmh", Cr, Br)
    wts = scores * decay * dtr[:, :, None, :, :]
    y_intra = torch.einsum("bclmh,bcmhp->bclhp", wts, xr)

    # chunk states + cross-chunk recurrence
    decay_to_end = torch.exp(da_total[:, :, None, :] - da_cs)  # (B,nc,L,H)
    states = torch.einsum("bclhn,bclhp->bchpn",
                          (decay_to_end * dtr)[..., None] * Br, xr)
    h_prev = h0.to(f32)
    prevs = []
    for c in range(nc):
        prevs.append(h_prev)
        h_prev = h_prev * torch.exp(da_total[:, c])[:, :, None, None] \
            + states[:, c]
    h_prevs = torch.stack(prevs, dim=1)                     # (B,nc,H,P,N)

    y_inter = torch.einsum("bclhn,bchpn->bclhp",
                           torch.exp(da_cs)[..., None] * Cr, h_prevs)
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y.to(x.dtype), h_prev


def _ssd_blocks(x, dt, A, B, C, h0):
    """``ssd_chunked`` over each rank's rows and SSM heads on a mesh."""
    ctx = current_ctx()
    if ctx is None:
        return ssd_chunked(x, dt, A, B, C, h0)
    xs = spec_for(("batch", "seq", "ssm_heads", None), tuple(x.shape), ctx)
    bt, hs = xs[0], xs[2]
    return local_blocks(
        ssd_chunked, (x, dt, A, B, C, h0),
        (xs, P(bt, None, hs), P(hs), xs, xs, P(bt, hs, None, None)),
        (xs, P(bt, hs, None, None)))


def ssm_block(cfg, p, u, *, mode: str, cache=None):
    """u (B,S,D) -> (y, cache); ``cache`` is updated in place."""
    b, s, _ = u.shape
    h, hd = cfg.ssm_nheads, cfg.ssm_headdim
    g, ds = cfg.ssm_ngroups, cfg.ssm_state
    A = -torch.exp(p["A_log"].to(f32))

    z = dense(p["z"], u)
    xr = dense(p["x"], u)
    Br = dense(p["B"], u)
    Cr = dense(p["C"], u)
    dt_raw = dense(p["dt"], u)

    if mode in ("train", "prefill"):
        xc = _causal_conv(p["conv_x"], xr, "ssm_inner")
        Bc = _causal_conv(p["conv_B"], Br)
        Cc = _causal_conv(p["conv_C"], Cr)
        dt = F.softplus(dt_raw.to(f32) + p["dt_bias"])
        xh = shard(xc.reshape(b, s, h, hd), "batch", "seq", "ssm_heads",
                   None)
        Bh = _broadcast_groups(Bc.reshape(b, s, g, ds), h)
        Ch = _broadcast_groups(Cc.reshape(b, s, g, ds), h)
        h0 = torch.zeros((b, h, hd, ds), dtype=f32, device=u.device)
        # each rank scans its own rows and heads (no communication)
        y, h_final = _ssd_blocks(xh, dt, A, Bh, Ch, h0)
        y = y + xh.to(f32) * p["D"][None, None, :, None]
        if mode == "prefill":
            w = cfg.ssm_conv_width
            cache["state"].copy_(h_final.to(bf16))
            cache["conv_x"].copy_(xr[:, -(w - 1):])
            cache["conv_B"].copy_(Br[:, -(w - 1):])
            cache["conv_C"].copy_(Cr[:, -(w - 1):])
    else:  # decode: single-token recurrence
        xc, hx = _conv_step(p["conv_x"], cache["conv_x"], xr[:, 0])
        Bc, hB = _conv_step(p["conv_B"], cache["conv_B"], Br[:, 0])
        Cc, hC = _conv_step(p["conv_C"], cache["conv_C"], Cr[:, 0])
        dt = F.softplus(dt_raw[:, 0].to(f32) + p["dt_bias"])     # (B,H)
        xh = xc.reshape(b, h, hd)
        # each rank's heads of the group-broadcast B and C, as the state's
        Bh, Ch = (shard(_broadcast_groups(t.reshape(b, g, ds), h).to(f32),
                        "batch", "ssm_heads", None) for t in (Bc, Cc))
        hs = cache["state"].to(f32)                             # (B,H,P,N)
        hs = hs * torch.exp(dt * A)[:, :, None, None] \
            + torch.einsum("bh,bhn,bhp->bhpn", dt, Bh, xh.to(f32))
        y = torch.einsum("bhn,bhpn->bhp", Ch, hs)
        y = y + xh.to(f32) * p["D"][None, :, None]
        y = y[:, None]                                          # (B,1,H,P)
        cache["state"].copy_(hs.to(bf16))
        cache["conv_x"].copy_(hx)
        cache["conv_B"].copy_(hB)
        cache["conv_C"].copy_(hC)

    y = y.reshape(b, s, cfg.d_inner)
    y = rmsnorm(p["norm"], y.to(u.dtype) * F.silu(z), cfg.norm_eps)
    return dense_to_stream(p["out"], y, mode), cache


def make_ssm_cache_spec(cfg, batch: int):
    h, hd, ds = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    g, w = cfg.ssm_ngroups, cfg.ssm_conv_width
    return {
        "state": ParamSpec((batch, h, hd, ds), bf16,
                           ("batch", "ssm_heads", None, None), init="zeros"),
        "conv_x": ParamSpec((batch, w - 1, cfg.d_inner), bf16,
                            ("batch", None, "ssm_inner"), init="zeros"),
        "conv_B": ParamSpec((batch, w - 1, g * ds), bf16,
                            ("batch", None, None), init="zeros"),
        "conv_C": ParamSpec((batch, w - 1, g * ds), bf16,
                            ("batch", None, None), init="zeros"),
    }
