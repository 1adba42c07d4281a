"""AdamW with f32 master weights over bf16 compute params.

Port of ``repro.training.optimizer``.  Gradients arrive in the params'
dtype (bf16 from autograd, as from ``jax.value_and_grad``) and are applied
in f32 against the master copy; each param is then re-derived from its
master.  m and v are f32.

Unlike the JAX package, ``apply_updates`` updates IN PLACE: the params, the
master weights, m, v and the step counter are the same tensors before and
after (JAX donates the old state to the step; here there is no second
copy of the 13 GB of f32 state of a 1.1 B-parameter model).  The step
counter, the learning rate, the norm and the clip scale stay 0-d tensors on
the params' device, so a step does not wait for the card.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models.layers import f32, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def init_opt_state(params) -> dict[str, Any]:
    """f32 master weights, m and v, each leaf in storage of its own:
    ``x.float()`` of an f32 leaf (the norm scales) is the leaf itself, and
    an in-place update of an aliased master would change the param too."""
    device = tree_leaves(params)[0].device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "master": tree_map(lambda x: x.float().clone(), params),
        "m": tree_map(lambda x: torch.zeros_like(x, dtype=f32), params),
        "v": tree_map(lambda x: torch.zeros_like(x, dtype=f32), params),
    }


def _schedule(opt: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(step / max(opt.warmup_steps, 1), max=1.0)
    return opt.lr * warm


@torch.no_grad()
def apply_updates(opt: AdamWConfig, params, grads, state):
    """One AdamW step, in place; returns (params, state, metrics) with
    ``grad_norm`` and ``lr`` as 0-d f32 tensors."""
    state["step"] += 1
    step = state["step"].to(f32)
    lr = _schedule(opt, step)

    flat_g = tree_leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(f32)))
                           for g in flat_g))
    scale = torch.clamp(opt.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if opt.grad_clip else 1.0

    b1c = 1.0 - torch.pow(opt.b1, step)
    b2c = 1.0 - torch.pow(opt.b2, step)
    for g, m, v, w, p in zip(flat_g, tree_leaves(state["m"]),
                             tree_leaves(state["v"]),
                             tree_leaves(state["master"]),
                             tree_leaves(params), strict=True):
        g = g.to(f32) * scale
        m.copy_(opt.b1 * m + (1 - opt.b1) * g)
        v.copy_(opt.b2 * v + (1 - opt.b2) * torch.square(g))
        u = (m / b1c) / (torch.sqrt(v / b2c) + opt.eps)
        w.copy_(w - lr * (u + opt.weight_decay * w))
        p.copy_(w)
    return params, state, {"grad_norm": gnorm, "lr": lr}
