"""Train step: micro-batched gradient accumulation + AdamW.

Port of ``repro.training.train_step``.  Gradients come from autograd
(``torch.autograd.grad`` over detached views of the params, so the state's
tensors never carry ``requires_grad``).  ``grad_accum`` splits the global
batch into micro-batches run one after the other, with an f32 gradient
accumulator, which bounds saved-activation memory to one micro-batch.  The
step updates the state in place (``optimizer.apply_updates``).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.models.layers import (cross_entropy, f32, tree_flatten,
                                       tree_map, tree_unflatten)
from repro_torch.models.model import forward_train
from repro_torch.sharding import is_dtensor, shard
from repro_torch.training.optimizer import AdamWConfig, apply_updates


def _loss_fn(cfg, params, batch, remat: bool = True):
    logits = forward_train(cfg, params, batch, remat=remat)
    return cross_entropy(cfg, logits, batch["labels"])


def _split_micro(batch, accum: int):
    """(B, ...) -> (A, B/A, ...) for every leaf.  On a mesh the batch
    comes back sharded on the micro-batch's rows: the (small) batch is
    gathered, reshaped and sharded on its second dim, since a reshape of
    a dim sharded over several ranks into (A, B/A) would put the shards
    on A."""
    def sp(x):
        b = x.shape[0]
        assert b % accum == 0, (b, accum)
        shape = (accum, b // accum) + tuple(x.shape[1:])
        if not is_dtensor(x):
            return x.reshape(shape)
        rest = (None,) * (x.ndim - 1)
        return shard(shard(x, None, *rest).reshape(shape), None, "batch",
                     *rest)
    # frames/vision leaves reshape on batch too; positions built inside
    return tree_map(sp, batch)


def value_and_grad(cfg, params, batch, remat: bool = True):
    """(loss, grads): the loss as a 0-d f32 tensor, the grads a tree like
    ``params`` in the params' dtypes."""
    leaves, treedef = tree_flatten(params)
    with torch.enable_grad():
        xs = [x.detach().requires_grad_() for x in leaves]
        loss = _loss_fn(cfg, tree_unflatten(treedef, xs), batch, remat)
        grads = torch.autograd.grad(loss, xs)
    return loss.detach(), tree_unflatten(treedef, list(grads))


def make_train_step(cfg, opt: Optional[AdamWConfig] = None,
                    grad_accum: int = 1, remat: bool = True):
    """``train_step(state, batch) -> (state, metrics)``; ``remat`` as in
    ``forward_train`` (the JAX package's step always remats)."""
    opt = opt or AdamWConfig()

    def train_step(state: dict[str, Any], batch: dict[str, torch.Tensor]):
        params = state["params"]
        if grad_accum == 1:
            loss, grads = value_and_grad(cfg, params, batch, remat)
        else:
            micro = _split_micro(batch, grad_accum)
            grads = tree_map(lambda x: torch.zeros_like(x, dtype=f32),
                             params)
            loss = torch.zeros((), dtype=f32,
                               device=next(iter(batch.values())).device)
            for i in range(grad_accum):
                mb = {k: v[i] for k, v in micro.items()}
                l, g = value_and_grad(cfg, params, mb, remat)
                for a, b in zip(tree_flatten(grads)[0], tree_flatten(g)[0]):
                    a.add_(b.to(f32))
                loss = loss + l
            grads = tree_map(lambda g: g / grad_accum, grads)
            loss = loss / grad_accum
        _, new_opt, metrics = apply_updates(opt, params, grads, state["opt"])
        metrics["loss"] = loss
        return {"params": params, "opt": new_opt}, metrics

    return train_step


def make_batch_labels(tokens: torch.Tensor) -> dict[str, torch.Tensor]:
    """Next-token prediction: labels are tokens shifted left."""
    return {"tokens": tokens,
            "labels": torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)}
