"""Shared model building blocks: parameter specs, norms, projections, RoPE.

Port of ``repro.models.layers``.  Parameters are plain nested dicts of
tensors (tuples for scanned group stacks, as in the JAX package), and
``ParamSpec`` leaves are the single source of truth for shapes, dtypes and
initialisation.  ``tree_flatten`` orders dict keys sorted, as
``jax.tree.flatten`` does: the snapshot blob layout depends on that order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

bf16 = torch.bfloat16
f32 = torch.float32

# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    dtype: Any = bf16
    axes: tuple[Optional[str], ...] = ()
    init: str = "normal"        # normal | zeros | ones
    scale: float = 1.0          # stddev multiplier for "normal"


def tree_map_specs(fn, tree):
    if isinstance(tree, ParamSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_specs(fn, v) for v in tree)
    raise TypeError(type(tree))


def stack_specs(tree, n: int):
    """Prepend a scanned-layer dimension of size ``n`` to every leaf."""
    return tree_map_specs(
        lambda s: dataclasses.replace(
            s, shape=(n,) + s.shape, axes=("layers",) + s.axes), tree)


# ---------------------------------------------------------------------------
# Trees (dict keys sorted, like jax.tree.flatten)
# ---------------------------------------------------------------------------


def tree_flatten(tree):
    """Leaves in ``jax.tree.flatten`` order, plus a structure to rebuild
    the tree from them with ``tree_unflatten``."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves, subs = [], []
        for k in keys:
            lv, s = tree_flatten(tree[k])
            leaves += lv
            subs.append(s)
        return leaves, ("dict", tuple(keys), tuple(subs))
    if isinstance(tree, (list, tuple)):
        leaves, subs = [], []
        for v in tree:
            lv, s = tree_flatten(v)
            leaves += lv
            subs.append(s)
        return leaves, (type(tree).__name__, len(tree), tuple(subs))
    return [tree], None


def tree_unflatten(treedef, leaves):
    it = iter(leaves)

    def build(td):
        if td is None:
            return next(it)
        kind, keys, subs = td
        if kind == "dict":
            return {k: build(s) for k, s in zip(keys, subs)}
        seq = [build(s) for s in subs]
        return tuple(seq) if kind == "tuple" else seq

    out = build(treedef)
    assert next(it, None) is None, "more leaves than the structure holds"
    return out


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn, tree):
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(x) for x in leaves])


# ---------------------------------------------------------------------------
# Initialisation
# ---------------------------------------------------------------------------


def _init_leaf(spec: ParamSpec, gen: torch.Generator,
               device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init != "normal":
        raise NotImplementedError(f"init {spec.init!r} is not ported yet")
    # fan-in rule of the JAX package (repro.models.layers._init_leaf)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    std = spec.scale / math.sqrt(max(fan_in, 1))
    x = torch.randn(spec.shape, generator=gen, dtype=f32, device=device)
    return x.mul_(std).to(spec.dtype)


def materialize(specs, seed: int = 0, *, device="cuda"):
    """Specs -> tensors on ``device``, drawn from one ``torch.Generator``
    seeded with ``seed`` (on that device) in tree-flatten order."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    leaves, treedef = tree_flatten(specs)
    return tree_unflatten(treedef,
                          [_init_leaf(s, gen, device) for s in leaves])


# ---------------------------------------------------------------------------
# Primitive layers (functional; params are dict slices)
# ---------------------------------------------------------------------------


def dense_spec(d_in: int, d_out: int, axes, *, bias=False):
    out = {"w": ParamSpec((d_in, d_out), bf16, axes)}
    if bias:
        out["b"] = ParamSpec((d_out,), bf16, (axes[-1],), init="zeros")
    return out


def dense(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def norm_spec(d: int, axes=(None,)):
    return {"scale": ParamSpec((d,), f32, axes, init="ones")}


def rmsnorm(p, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(f32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


def act_fn(name: str, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh") if name == "gelu" else F.silu(x)


def mlp_spec(cfg):
    return {
        "gate": dense_spec(cfg.d_model, cfg.d_ff, ("w_embed", "mlp")),
        "up": dense_spec(cfg.d_model, cfg.d_ff, ("w_embed", "mlp")),
        "down": dense_spec(cfg.d_ff, cfg.d_model, ("mlp", "w_embed")),
    }


def mlp(cfg, p, x: torch.Tensor) -> torch.Tensor:
    h = act_fn(cfg.act, dense(p["gate"], x)) * dense(p["up"], x)
    return dense(p["down"], h)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap else x


# ---------------------------------------------------------------------------
# Rotary embeddings (standard + M-RoPE)
# ---------------------------------------------------------------------------


def _rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=f32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: tuple[int, ...] = ()) -> torch.Tensor:
    """x: (B, S, H, D).  positions: (B, S) or (3, B, S) for M-RoPE."""
    d2 = x.shape[-1] // 2
    freqs = _rope_freqs(x.shape[-1], theta, x.device)          # (D/2,)
    if mrope_sections:
        assert positions.ndim == 3, "M-RoPE needs (3, B, S) positions"
        assert sum(mrope_sections) == d2
        sec, start = [], 0
        for i, n in enumerate(mrope_sections):
            sec.append(positions[i][..., None].to(f32)
                       * freqs[start:start + n])
            start += n
        angles = torch.cat(sec, dim=-1)                        # (B, S, D/2)
    else:
        angles = positions[..., None].to(f32) * freqs          # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :d2].to(f32), x[..., d2:].to(f32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Vocabulary padding
# ---------------------------------------------------------------------------

VOCAB_PAD = 2048


def padded_vocab(cfg) -> int:
    v = cfg.vocab_size
    if v % 16 == 0:          # evenly shardable over a 16-way model axis
        return v
    return ((v + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD
