"""Top-level model API: param/cache specs, init, the row-wise cache
utilities and the entry points (train forward, prefill, decode step).

Port of ``repro.models.model`` for every family: dense (with gemma2's
post-norms and local/global blocks), moe (mixtral, dbrx), vlm (qwen2-vl:
M-RoPE and the vision stub), ssm (mamba2), hybrid (recurrentgemma) and the
encoder-decoder audio family (seamless, ``models.encdec``).  Params and
caches are plain nested dicts of tensors (tuples for the stacked groups),
with the JAX package's tree structure, so ``tree_flatten`` orders their
leaves the same way and the snapshot blob layout carries over byte for
byte.

On a mesh, ``init_params(..., mesh=, rules=)`` returns DTensors with the
same values, ``param_shardings``/``cache_shardings`` the placements, and
``abstract_params``/``abstract_caches`` meta tensors (the JAX package's
``ShapeDtypeStruct`` trees).

Two differences from the JAX package, both about memory:
  * prefill, decode and the row writes update the cache tensors in place
    (JAX donates them to the next step; here there is no second copy);
  * ``cache_slice_rows`` and ``cache_grow_rows`` copy into fresh storage.
    A torch slice is a view that keeps the whole old tensor alive, so an
    unplug built on views would reclaim no device memory.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, transformer
from repro_torch.models.layers import (materialize, sharding_tree,
                                       tree_flatten, tree_map)
from repro_torch.spans import span


# ---------------------------------------------------------------------------
# Specs / init
# ---------------------------------------------------------------------------


def param_specs(cfg: ModelConfig):
    specs: dict[str, Any] = {"embed": transformer.embed_specs(cfg)}
    if cfg.family == "audio":
        specs["encoder"] = encdec.encoder_specs(cfg)
        specs["decoder"] = encdec.decoder_specs(cfg)
    else:
        specs["decoder"] = transformer.decoder_specs(cfg)
    return specs


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int):
    if cfg.family == "audio":
        return encdec.dec_cache_specs(cfg, batch, cache_len)
    return transformer.decoder_cache_specs(cfg, batch, cache_len)


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda",
                mesh=None, rules=None):
    """Random parameters drawn on ``device`` from a ``torch.Generator``
    seeded with ``seed`` (the JAX package's fan-in initialisation rule;
    the numbers differ from ``jax.random``'s); with a ``mesh`` and
    ``rules``, DTensors on the mesh with the same values."""
    return materialize(param_specs(cfg), seed, device=device, mesh=mesh,
                       rules=rules)


def init_caches(cfg: ModelConfig, batch: int, cache_len: int, *,
                device="cuda"):
    return materialize(cache_specs(cfg, batch, cache_len), device=device)


def abstract_params(cfg: ModelConfig, mesh=None, rules=None):
    return materialize(param_specs(cfg), abstract=True, mesh=mesh,
                       rules=rules)


def abstract_caches(cfg: ModelConfig, batch: int, cache_len: int, mesh=None,
                    rules=None):
    return materialize(cache_specs(cfg, batch, cache_len), abstract=True,
                       mesh=mesh, rules=rules)


def param_shardings(cfg: ModelConfig, mesh, rules):
    return sharding_tree(param_specs(cfg), mesh, rules)


def cache_shardings(cfg: ModelConfig, batch: int, cache_len: int, mesh,
                    rules):
    return sharding_tree(cache_specs(cfg, batch, cache_len), mesh, rules)


# ---------------------------------------------------------------------------
# Row-wise cache utilities (the batch/partition axis is 1 inside stacked
# groups — leading axis is n_groups — and 0 in unstacked tail blocks)
# ---------------------------------------------------------------------------


def cache_axis_map(caches, fn):
    """Apply fn(leaf, batch_axis) across a cache tree."""
    return {key: tree_map(lambda x, _ax=(0 if key == "tail" else 1):
                          fn(x, _ax), sub)
            for key, sub in caches.items()}


def cache_slice_rows(caches, rows: int):
    """Keep rows [0, rows), copied into fresh storage: the old tensors are
    freed once the caller drops them (unplug reclaims device memory)."""
    return cache_axis_map(
        caches, lambda x, ax: x.narrow(ax, 0, rows).clone(
            memory_format=torch.contiguous_format))


def cache_grow_rows(caches, rows: int):
    """Extend to ``rows`` rows in fresh storage; the new rows are zero."""
    def g(x, ax):
        shape = list(x.shape)
        shape[ax] = rows
        out = torch.zeros(shape, dtype=x.dtype, device=x.device)
        out.narrow(ax, 0, x.shape[ax]).copy_(x)
        return out
    return cache_axis_map(caches, g)


def cache_num_rows(caches) -> int:
    for key, sub in caches.items():
        for leaf in tree_flatten(sub)[0]:
            return leaf.shape[0 if key == "tail" else 1]
    raise ValueError("empty cache tree")


def cache_read_row(caches, row: int):
    """Copy arena row ``row`` out as a single-request cache (batch==1)."""
    return cache_axis_map(caches, lambda x, ax: x.narrow(ax, row, 1).clone())


def cache_write_row(caches, row_caches, row: int):
    """Write a single-request cache (batch==1) into arena row ``row``, in
    place.  Returns ``caches``."""
    dst, _ = tree_flatten(cache_axis_map(
        caches, lambda x, ax: x.narrow(ax, row, 1)))
    for d, r in zip(dst, tree_flatten(row_caches)[0], strict=True):
        d.copy_(r)
    return caches


# ---------------------------------------------------------------------------
# Fused row staging (snapshot data plane): whole rows move as ONE flat blob
# through one kernel launch, instead of one copy per leaf
# ---------------------------------------------------------------------------


def cache_flat_axes(caches):
    """Flat cache leaves + their batch axes, in tree-flatten order.
    Returns (leaves, axes, treedef)."""
    leaves, treedef = tree_flatten(caches)
    axes = tree_flatten(cache_axis_map(caches, lambda x, ax: ax))[0]
    return leaves, axes, treedef


def cache_row_layout(caches):
    """Static ``RowLayout`` of this cache tree's per-row staging blob,
    valid across every bucket of the ladder."""
    from repro_torch.kernels.kv_snapshot import build_layout
    leaves, axes, _ = cache_flat_axes(caches)
    return build_layout(leaves, axes)


def cache_read_rows(caches, rows, *, layout=None):
    """Gather arena rows ``rows`` (a sequence of ints) of EVERY leaf into
    one contiguous (N, row_elems) staging blob: one kernel launch on the
    card."""
    from repro_torch.kernels import ops
    leaves, _axes, _ = cache_flat_axes(caches)
    if layout is None:
        layout = cache_row_layout(caches)
    return ops.snapshot_capture(leaves, rows, layout=layout)


def cache_write_rows(caches, blob, rows, *, layout=None):
    """Scatter staging-blob rows into EVERY leaf at arena rows ``rows``, in
    place: one kernel launch on the card.  Untouched rows keep their bytes.
    Returns ``caches``."""
    from repro_torch.kernels import ops
    leaves, _axes, _ = cache_flat_axes(caches)
    if layout is None:
        layout = cache_row_layout(caches)
    ops.snapshot_restore(leaves, blob, rows, layout=layout)
    return caches


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _train_positions(cfg, batch: int, seq: int, device):
    pos = torch.arange(seq, dtype=torch.int32,
                       device=device).expand(batch, seq)
    if cfg.mrope_sections:
        pos = pos.expand(3, batch, seq)
    return pos


def _decode_positions(cfg, positions):
    """(B,) host-tracked global positions -> model positions."""
    if cfg.mrope_sections and positions.dim() == 1:
        return positions.expand(3, positions.shape[0])
    return positions


def _backbone(cfg: ModelConfig, params, x, batch=None, **kw):
    """The decoder stack over embeddings ``x``; in the audio family the
    encoder runs first over ``batch["frames"]`` (train and prefill; decode
    passes no batch and reads the cross cache)."""
    if cfg.family != "audio":
        return transformer.run_decoder(cfg, params["decoder"], x, **kw)
    enc_out = None if batch is None else encdec.run_encoder(
        cfg, params["encoder"], batch["frames"], kw["mode"])
    return encdec.run_decoder(cfg, params["decoder"], x, enc_out=enc_out,
                              **kw)


def forward_train(cfg: ModelConfig, params, batch: dict, *,
                  remat: bool = True):
    """batch: tokens (B,S) [+ vision_embeds (B,N,D) | frames (B,src,D)]
    [+ positions (B,S), or (3,B,S) under M-RoPE].  Returns logits
    (B,S,Vp).  ``remat`` checkpoints the decoder's block groups when
    autograd is on (``transformer.checkpointed``)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    pos = batch.get("positions")
    if pos is None:
        pos = _train_positions(cfg, b, s, tokens.device)
    x = transformer.embed_tokens(cfg, params["embed"], tokens,
                                 batch.get("vision_embeds"))
    x, _ = _backbone(cfg, params, x, batch, mode="train", positions=pos,
                     remat=remat)
    return transformer.lm_logits(cfg, params["embed"], x)


def prefill(cfg: ModelConfig, params, batch: dict, caches):
    """Fill ``caches`` (in place) from a prompt; returns (last-token logits
    (B,Vp), caches).  ``batch`` as for ``forward_train`` (the audio family
    needs ``frames`` of exactly ``encoder_src_len``).  All rows prefill
    from position 0."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    pos = batch.get("positions")
    if pos is None:
        pos = _train_positions(cfg, b, s, tokens.device)
    with span("model.embed"):
        x = transformer.embed_tokens(cfg, params["embed"], tokens,
                                     batch.get("vision_embeds"))
    x, caches = _backbone(cfg, params, x, batch, mode="prefill",
                          caches=caches, positions=pos)
    with span("model.logits"):
        logits = transformer.lm_logits(cfg, params["embed"], x[:, -1:])
    return logits[:, 0], caches


def decode_step(cfg: ModelConfig, params, tokens, positions, caches):
    """One decode step.  tokens (B,1) int; positions (B,) global position
    of the new token per row (continuous batching: rows are independent;
    under M-RoPE all three sections take it).  Returns (logits (B,Vp),
    caches), the caches updated in place.  Spans (``repro_torch.spans``):
    ``model.embed``, a ``model.block`` per block, ``model.logits``."""
    with span("model.embed"):
        x = transformer.embed_tokens(cfg, params["embed"], tokens)
    x, caches = _backbone(cfg, params, x, mode="decode", caches=caches,
                          positions=_decode_positions(cfg, positions))
    with span("model.logits"):
        logits = transformer.lm_logits(cfg, params["embed"], x)
    return logits[:, 0], caches
