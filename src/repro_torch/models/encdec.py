"""Encoder-decoder backbone (SeamlessM4T-medium).  [arXiv:2308.11596]

Port of ``repro.models.encdec``.  The modality frontend is a stub: the
encoder consumes precomputed frame embeddings (B, encoder_src_len,
d_model).  RoPE stands in for learned positions, as in the JAX package.
The decoder block is causal self-attention (cached, decoded through
``kernels.ops.partition_attention``), cross-attention over the encoder
output (its K/V cached at prefill) and the FFN.

As in ``models.attention``, prefill writes the caches IN PLACE: the cross
cache takes the whole encoder K/V, so the frames must be exactly
``encoder_src_len`` long.  Decode reads the cross cache unmasked.  The
encoder and the cross-attention use ``head_dim ** -0.5`` and no logit cap,
whatever the config says; the decoder self-attention takes the config's.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models.attention import (_scores, _weighted,
                                          make_attn_cache_spec)
from repro_torch.models.layers import (apply_rope, bf16, dense, dense_spec,
                                       dense_to_stream, mlp, mlp_spec,
                                       norm_spec, rmsnorm, stack_specs)
from repro_torch.models.transformer import _index, checkpointed, unstack
from repro_torch.sharding import shard, split_last


def _cross_attn_spec(cfg):
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "q": dense_spec(cfg.d_model, hq * dh, ("w_embed", "heads")),
        "k": dense_spec(cfg.d_model, hkv * dh, ("w_embed", "kv_heads")),
        "v": dense_spec(cfg.d_model, hkv * dh, ("w_embed", "kv_heads")),
        "o": dense_spec(hq * dh, cfg.d_model, ("heads", "w_embed")),
    }


def enc_block_spec(cfg):
    return {"ln1": norm_spec(cfg.d_model), "attn": attn_mod.attn_spec(cfg),
            "ln2": norm_spec(cfg.d_model), "ffn": mlp_spec(cfg)}


def dec_block_spec(cfg):
    return {"ln1": norm_spec(cfg.d_model), "self": attn_mod.attn_spec(cfg),
            "ln2": norm_spec(cfg.d_model), "cross": _cross_attn_spec(cfg),
            "ln3": norm_spec(cfg.d_model), "ffn": mlp_spec(cfg)}


def encoder_specs(cfg):
    return {"src_proj": dense_spec(cfg.d_model, cfg.d_model,
                                   ("w_embed", None)),
            "blocks": stack_specs(enc_block_spec(cfg), cfg.encoder_layers),
            "final_norm": norm_spec(cfg.d_model)}


def decoder_specs(cfg):
    return {"blocks": stack_specs(dec_block_spec(cfg), cfg.num_layers),
            "final_norm": norm_spec(cfg.d_model)}


def dec_cache_specs(cfg, batch: int, cache_len: int):
    self_spec = make_attn_cache_spec(cfg, batch, cache_len)
    cross = make_attn_cache_spec(cfg, batch, cfg.encoder_src_len)
    block = {"self": self_spec, "cross": cross}
    return {"blocks": stack_specs(block, cfg.num_layers)}


# ---------------------------------------------------------------------------


def _unmasked(cfg, q, k, v):
    """q (B,S,Hq,Dh) over every key of k/v (B,T,Hkv,Dh) -> (B,S,Hq*Dh)."""
    scale = cfg.head_dim ** -0.5
    return attn_mod.grouped_attention(
        lambda qg, k, v: _weighted(
            v, torch.softmax(_scores(qg, k, scale, 0.0), dim=-1)), q, k, v)


def _bidir_attention(cfg, p, x, positions, mode):
    """Full bidirectional self-attention (encoder)."""
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = apply_rope(split_last(dense(p["q"], x), hq, dh), positions,
                   cfg.rope_theta)
    k = apply_rope(split_last(dense(p["k"], x), hkv, dh), positions,
                   cfg.rope_theta)
    v = split_last(dense(p["v"], x), hkv, dh)
    return dense_to_stream(p["o"], _unmasked(cfg, q, k, v), mode)


def run_encoder(cfg, params, frames, mode: str = "train"):
    """frames (B, src, D) stub embeddings -> encoder output (B, src, D);
    ``mode`` as the decoder's (train or prefill)."""
    x = dense(params["src_proj"], frames.to(bf16))
    x = shard(x, "batch", "src", "embed")
    b, s = x.shape[:2]
    pos = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    for p in unstack(params["blocks"], cfg.encoder_layers):
        x = x + _bidir_attention(cfg, p["attn"],
                                 rmsnorm(p["ln1"], x, cfg.norm_eps), pos,
                                 mode)
        x = x + mlp(cfg, p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps), mode)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps)


def _cross_attention(cfg, p, x, mode, enc_out=None, cache=None):
    """Decoder cross-attention.  At prefill/train ``enc_out`` is given and
    the cross K/V are computed from it (and written into ``cache`` in
    place when one is given); at decode the cache is read."""
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = split_last(dense(p["q"], x), hq, dh)
    if enc_out is not None:
        k = split_last(dense(p["k"], enc_out), hkv, dh)
        v = split_last(dense(p["v"], enc_out), hkv, dh)
        if cache is not None:
            for name, new in (("k", k), ("v", v)):
                if cache[name].shape != new.shape:
                    raise ValueError(
                        f"cross cache {tuple(cache[name].shape)} does not "
                        f"fit the encoder K/V {tuple(new.shape)}: frames "
                        f"must be encoder_src_len long")
                cache[name].copy_(new)
    else:
        k, v = cache["k"], cache["v"]
    return dense_to_stream(p["o"], _unmasked(cfg, q, k, v), mode)


def run_decoder(cfg, params, x, *, mode: str, caches=None, positions=None,
                enc_out=None, remat: bool = False):
    """Decoder over token embeddings x (B,S,D) -> (y (B,S,D), caches), the
    caches updated in place.  ``remat`` checkpoints each block, in train
    mode with autograd on only."""
    remat = remat and caches is None and torch.is_grad_enabled()
    for i, p in enumerate(unstack(params["blocks"], cfg.num_layers)):
        c = _index(caches["blocks"], i) if caches is not None else None

        def block(h, p=p, c=c):
            hh, _ = attn_mod.attention(
                cfg, p["self"], rmsnorm(p["ln1"], h, cfg.norm_eps),
                positions=positions, mode=mode,
                cache=c["self"] if c is not None else None)
            h = h + hh
            h = h + _cross_attention(
                cfg, p["cross"], rmsnorm(p["ln2"], h, cfg.norm_eps), mode,
                enc_out=enc_out, cache=c["cross"] if c is not None else None)
            return h + mlp(cfg, p["ffn"], rmsnorm(p["ln3"], h, cfg.norm_eps),
                           mode)
        x = checkpointed(block, x) if remat else block(x)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), caches
