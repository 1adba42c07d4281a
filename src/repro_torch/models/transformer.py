"""Decoder-only transformer assembly: block groups + cache trees.

Port of ``repro.models.transformer``.  Parameters and caches keep the JAX
package's stacked layout: one ``block_pattern`` group repeated ``n_groups``
times, every leaf of the group carrying a leading ``n_groups`` axis (KV
caches are ``(n_groups, P, T, Hkv, Dh)``), plus optional unstacked
``tail_pattern`` blocks whose batch axis is 0.  Where JAX scans over the
groups, this module loops over them and hands each block the group's slice
(a view, so in-place cache writes land in the stacked tensors).  Block
kinds: ``attn``, ``local`` and ``global`` attention, ``ssm`` (mamba2) and
``rglru`` (recurrentgemma).  An attention block's FFN is a dense MLP or,
when ``cfg.num_experts``, the top-k MoE of ``models.moe``; gemma2's
sandwich norms (``pn1``/``pn2``) follow the attention and the FFN when
``cfg.post_norms``.
"""
from __future__ import annotations

import contextlib
from functools import partial

import torch
import torch.utils.checkpoint

from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (ParamSpec, dense, dense_spec, mlp,
                                       mlp_spec, norm_spec, padded_vocab,
                                       rmsnorm, softcap, stack_specs,
                                       tree_flatten, tree_unflatten)
from repro_torch.sharding import (P, block_start, current_ctx, entry_axes,
                                  gather_weight, local_blocks, psum, shard,
                                  spec_for, use_ctx)
from repro_torch.spans import span

ATTN_KINDS = ("attn", "local", "global")
KINDS = ATTN_KINDS + ("ssm", "rglru")


def _check_kind(cfg, kind: str) -> None:
    if kind not in KINDS:
        raise NotImplementedError(
            f"{cfg.name}: block kind {kind!r} is not ported yet")


def block_spec(cfg, kind: str):
    _check_kind(cfg, kind)
    d = cfg.d_model
    if kind == "ssm":
        return {"ln": norm_spec(d), "mixer": ssm_mod.ssm_spec(cfg)}
    if kind == "rglru":
        return {"ln1": norm_spec(d), "rec": rglru_mod.rglru_spec(cfg),
                "ln2": norm_spec(d), "ffn": mlp_spec(cfg)}
    ffn = moe_mod.moe_spec(cfg) if cfg.num_experts else mlp_spec(cfg)
    s = {"ln1": norm_spec(d), "attn": attn_mod.attn_spec(cfg),
         "ln2": norm_spec(d), "ffn": ffn}
    if cfg.post_norms:
        s["pn1"] = norm_spec(d)
        s["pn2"] = norm_spec(d)
    return s


def _window_for(cfg, kind: str) -> int:
    if kind == "local":
        return cfg.local_window
    if kind == "global":
        return 0
    return cfg.sliding_window


def block_cache_spec(cfg, kind: str, batch: int, cache_len: int):
    _check_kind(cfg, kind)
    if kind == "ssm":
        return ssm_mod.make_ssm_cache_spec(cfg, batch)
    if kind == "rglru":
        return rglru_mod.make_rglru_cache_spec(cfg, batch)
    return attn_mod.make_attn_cache_spec(cfg, batch, cache_len,
                                         _window_for(cfg, kind))


def decoder_specs(cfg):
    """Param specs for the block stack (no embeddings)."""
    groups = tuple(stack_specs(block_spec(cfg, k), cfg.n_groups)
                   for k in cfg.block_pattern)
    tail = tuple(block_spec(cfg, k) for k in cfg.tail_pattern)
    return {"groups": groups, "tail": tail,
            "final_norm": norm_spec(cfg.d_model)}


def decoder_cache_specs(cfg, batch: int, cache_len: int):
    groups = tuple(
        stack_specs(block_cache_spec(cfg, k, batch, cache_len), cfg.n_groups)
        for k in cfg.block_pattern)
    tail = tuple(block_cache_spec(cfg, k, batch, cache_len)
                 for k in cfg.tail_pattern)
    return {"groups": groups, "tail": tail}


def embed_specs(cfg):
    vp = padded_vocab(cfg)
    out = {"tok": ParamSpec((vp, cfg.d_model), axes=("vocab", "w_embed"),
                            scale=24.0)}
    if not cfg.tie_embeddings:
        out["lm_head"] = dense_spec(cfg.d_model, vp, ("w_embed", "vocab"))
    return out


def _index(tree, i: int):
    """Slice ``i`` of the leading (stacked-group) axis of every leaf."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def unstack(tree, n: int) -> list:
    """The ``n`` slices of the leading (stacked) axis of every leaf, as
    ``n`` trees of views, from one ``unbind`` per leaf: autograd then
    stacks the slices' gradients once, where indexing each slice would
    add a zero-filled gradient of the whole stack per slice."""
    leaves, treedef = tree_flatten(tree)
    parts = [x.unbind(0) for x in leaves]
    return [tree_unflatten(treedef, [p[i] for p in parts]) for i in range(n)]


def block_forward(cfg, kind: str, p, x, *, mode: str, cache, positions):
    if kind == "ssm":
        h, _ = ssm_mod.ssm_block(cfg, p["mixer"],
                                 rmsnorm(p["ln"], x, cfg.norm_eps),
                                 mode=mode, cache=cache)
        return x + h
    if kind == "rglru":
        h, _ = rglru_mod.rglru_block(cfg, p["rec"],
                                     rmsnorm(p["ln1"], x, cfg.norm_eps),
                                     mode=mode, cache=cache)
        x = x + h
        h = rmsnorm(p["ln2"], x, cfg.norm_eps)
        with span("mlp"):
            h = mlp(cfg, p["ffn"], h, mode)
        return x + h
    h, _ = attn_mod.attention(cfg, p["attn"],
                              rmsnorm(p["ln1"], x, cfg.norm_eps),
                              positions=positions, mode=mode, cache=cache,
                              window=_window_for(cfg, kind))
    if cfg.post_norms:
        h = rmsnorm(p["pn1"], h, cfg.norm_eps)
    x = x + h
    h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
    with span("mlp"):
        h2 = moe_mod.moe_block(cfg, p["ffn"], h2) if cfg.num_experts \
            else mlp(cfg, p["ffn"], h2, mode)
    if cfg.post_norms:
        h2 = rmsnorm(p["pn2"], h2, cfg.norm_eps)
    return x + h2


def checkpointed(fn, x):
    """``fn(x)`` under activation checkpointing, the twin of the JAX
    package's ``jax.checkpoint(..., nothing_saveable)``: only ``x`` is
    kept for the backward pass, and ``fn`` runs again to rebuild the rest.
    The model draws no random numbers, so no RNG state is kept.  The
    rebuild runs under the sharding context of the forward (on the card
    it runs on the autograd thread, which does not see the caller's)."""
    ctx = current_ctx()
    return torch.utils.checkpoint.checkpoint(
        fn, x, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (contextlib.nullcontext(), use_ctx(ctx)))


def run_decoder(cfg, params, x, *, mode: str, caches=None, positions=None,
                remat: bool = False):
    """x (B,S,D) -> (y (B,S,D), caches), the caches updated in place.
    ``remat`` checkpoints each block group (the tail blocks are not), as
    the JAX package does; it acts only in train mode with autograd on."""
    remat = remat and mode == "train" and torch.is_grad_enabled()
    groups = [unstack(p, cfg.n_groups) for p in params["groups"]]
    per = len(cfg.block_pattern)
    for gi in range(cfg.n_groups):
        gp = [g[gi] for g in groups]
        gc = [_index(c, gi) for c in caches["groups"]] \
            if caches is not None else [None] * len(gp)

        def group(h, gp=gp, gc=gc, gi=gi):
            for j, (kind, p, c) in enumerate(zip(cfg.block_pattern, gp, gc)):
                with span("model.block", layer=gi * per + j, kind=kind):
                    h = block_forward(cfg, kind, p, h, mode=mode, cache=c,
                                      positions=positions)
            # the group boundary is what remat saves; "seq_remat" (None by
            # default) lets wide models store it seq-sharded
            return shard(h, "batch", "seq" if caches is not None
                         else "seq_remat", "embed")
        x = checkpointed(group, x) if remat else group(x)
    for i, kind in enumerate(cfg.tail_pattern):
        c = caches["tail"][i] if caches is not None else None
        with span("model.block", layer=cfg.n_groups * per + i, kind=kind):
            x = block_forward(cfg, kind, params["tail"][i], x, mode=mode,
                              cache=c, positions=positions)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), caches


def embed_tokens(cfg, embed_params, tokens, vision_embeds=None):
    def lookup(table, ids, *vision, axes=()):
        if axes:                       # this rank's block of the vocab
            vb = table.shape[0]
            idx = ids.long() - block_start(axes, vb)
            mine = (idx >= 0) & (idx < vb)
            x = torch.where(mine[..., None], table[idx.clamp(0, vb - 1)], 0)
            for a in axes:
                x = psum(x, a)
        else:
            x = table[ids]
        if cfg.scale_embeddings:
            # the scale is rounded to the activation dtype first, as the
            # JAX package computes it (sqrt(2560) is 50.5 in bf16)
            x = x * torch.sqrt(torch.tensor(float(cfg.d_model),
                                            dtype=x.dtype, device=x.device))
        if vision:                     # stub patches over the first tokens
            x[:, :vision[0].shape[1]] = vision[0].to(x.dtype)
        return x

    vision = () if vision_embeds is None else (vision_embeds,)
    ctx = current_ctx()
    if ctx is None:
        return lookup(embed_params["tok"], tokens, *vision)
    # on a mesh each rank looks up its own rows of ids in its block of the
    # vocab, and the rows are summed over the vocab's mesh axes, as GSPMD
    # partitions the gather (the table's d_model dim is gathered: FSDP's
    # gather; DTensor's index strategy rejects ids sharded over two mesh
    # dims)
    rows = spec_for(("batch", "seq"), tuple(tokens.shape), ctx)
    out = spec_for(("batch", "seq", "embed"),
                   tuple(tokens.shape) + (cfg.d_model,), ctx)
    table = shard(embed_params["tok"], "vocab", None)
    ts = spec_for(("vocab", None), tuple(table.shape), ctx)
    return local_blocks(partial(lookup, axes=entry_axes(ts[0])),
                        (table, tokens, *vision),
                        (ts, rows)
                        + tuple(P(rows[0], None, out[2]) for _ in vision),
                        out)


def lm_logits(cfg, embed_params, x):
    if cfg.tie_embeddings:
        logits = x @ gather_weight(embed_params["tok"], x).T
    else:
        logits = dense(embed_params["lm_head"], x)
    logits = softcap(logits, cfg.final_logit_softcap)
    return shard(logits, "batch", "seq", "vocab")

