"""Decoder-only transformer assembly for the dense family.

Port of ``repro.models.transformer``.  Parameters and caches keep the JAX
package's stacked layout: one ``block_pattern`` group repeated ``n_groups``
times, every leaf of the group carrying a leading ``n_groups`` axis (KV
caches are ``(n_groups, P, T, Hkv, Dh)``), plus optional unstacked
``tail_pattern`` blocks.  Where JAX scans over the groups, this module loops
over them and hands each block the group's slice (a view, so in-place cache
writes land in the stacked tensors).  Only ``attn`` blocks are ported; every
other block kind raises.
"""
from __future__ import annotations

from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (ParamSpec, dense, dense_spec, mlp,
                                       mlp_spec, norm_spec, padded_vocab,
                                       rmsnorm, softcap, stack_specs)


def _check_kind(cfg, kind: str) -> None:
    if kind != "attn" or cfg.num_experts:
        raise NotImplementedError(
            f"{cfg.name}: block kind {kind!r}"
            f"{' with experts' if cfg.num_experts else ''} is not ported "
            f"yet (dense attention blocks only)")


def block_spec(cfg, kind: str):
    _check_kind(cfg, kind)
    d = cfg.d_model
    return {"ln1": norm_spec(d), "attn": attn_mod.attn_spec(cfg),
            "ln2": norm_spec(d), "ffn": mlp_spec(cfg)}


def block_cache_spec(cfg, kind: str, batch: int, cache_len: int):
    _check_kind(cfg, kind)
    return attn_mod.make_attn_cache_spec(cfg, batch, cache_len,
                                         cfg.sliding_window)


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


def block_forward(cfg, p, x, *, mode: str, cache, positions):
    h, _ = attn_mod.attention(cfg, p["attn"],
                              rmsnorm(p["ln1"], x, cfg.norm_eps),
                              positions=positions, mode=mode, cache=cache,
                              window=cfg.sliding_window)
    x = x + h
    return x + mlp(cfg, p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps))


def run_decoder(cfg, params, x, *, mode: str, caches=None, positions=None):
    """x (B,S,D) -> (y (B,S,D), caches), the caches updated in place."""
    for gi in range(cfg.n_groups):
        for i, _kind in enumerate(cfg.block_pattern):
            c = _index(caches["groups"][i], gi) if caches is not None \
                else None
            x = block_forward(cfg, _index(params["groups"][i], gi), x,
                              mode=mode, cache=c, positions=positions)
    for i, _kind in enumerate(cfg.tail_pattern):
        c = caches["tail"][i] if caches is not None else None
        x = block_forward(cfg, params["tail"][i], x, mode=mode, cache=c,
                          positions=positions)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), caches


def embed_tokens(embed_params, tokens):
    return embed_params["tok"][tokens]


def lm_logits(cfg, embed_params, x):
    if cfg.tie_embeddings:
        logits = x @ embed_params["tok"].T
    else:
        logits = dense(embed_params["lm_head"], x)
    return softcap(logits, cfg.final_logit_softcap)

