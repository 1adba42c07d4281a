"""Shared model building blocks: parameter specs, norms, projections, RoPE.

Port of ``repro.models.layers``.  Parameters are plain nested dicts of
tensors (tuples for scanned group stacks, as in the JAX package), and
``ParamSpec`` leaves are the single source of truth for shapes, dtypes and
initialisation.  ``tree_flatten`` orders dict keys sorted, as
``jax.tree.flatten`` does: the snapshot blob layout depends on that order.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.kernels.ref import rotate
from repro_torch.sharding import (P, block_start, current_ctx, distribute,
                                  entry_axes, gather_weight, is_dtensor,
                                  local_blocks, named_sharding, psum, shard,
                                  spec_for, sum_partials)

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
    init: str = "normal"        # normal | zeros | ones | a_log | dt_bias
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
    if spec.init == "a_log":    # mamba2: A in [1, 16], store log
        u = torch.rand(spec.shape, generator=gen, dtype=f32, device=device)
        return torch.log(u.mul_(15.0).add_(1.0)).to(spec.dtype)
    if spec.init == "dt_bias":  # mamba2: softplus^-1(dt), dt in [1e-3, 0.1]
        u = torch.rand(spec.shape, generator=gen, dtype=f32, device=device)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        return (dt + torch.log(-torch.expm1(-dt))).to(spec.dtype)
    if spec.init != "normal":
        raise NotImplementedError(f"init {spec.init!r} is not ported yet")
    # fan-in rule of the JAX package (repro.models.layers._init_leaf)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    std = spec.scale / math.sqrt(max(fan_in, 1))
    x = torch.randn(spec.shape, generator=gen, dtype=f32, device=device)
    return x.mul_(std).to(spec.dtype)


def materialize(specs, seed: int = 0, *, device="cuda", abstract=False,
                mesh=None, rules=None):
    """Specs -> tensors on ``device``, drawn from one ``torch.Generator``
    seeded with ``seed`` (on that device) in tree-flatten order.

    With a ``mesh`` (a ``DeviceMesh``) and ``rules``, each leaf is drawn
    in full from the same stream, then distributed onto its placements,
    so a sharded init equals the unsharded one value for value.  With
    ``abstract`` nothing is allocated: ``meta`` tensors (the twin of
    ``jax.ShapeDtypeStruct``), DTensors of the global shape over ``meta``
    blocks on a mesh."""
    leaves, treedef = tree_flatten(specs)
    if abstract:
        return tree_unflatten(treedef, [_abstract_leaf(s, mesh, rules)
                                        for s in leaves])
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = []
    for s in leaves:
        x = _init_leaf(s, gen, device)
        if mesh is not None:
            x = distribute(x, named_sharding(s.axes, s.shape, mesh, rules))
        out.append(x)
    return tree_unflatten(treedef, out)


def _abstract_leaf(spec: ParamSpec, mesh, rules) -> torch.Tensor:
    if mesh is None:
        return torch.empty(spec.shape, dtype=spec.dtype, device="meta")
    from torch.distributed.tensor import DTensor
    sh = named_sharding(spec.axes, spec.shape, mesh, rules)
    local = torch.empty(sh.shard_shape(spec.shape), dtype=spec.dtype,
                        device="meta")
    return DTensor.from_local(local, mesh, sh.placements, run_check=False,
                              shape=torch.Size(spec.shape),
                              stride=torch.empty(spec.shape,
                                                 device="meta").stride())


def sharding_tree(specs, mesh, rules):
    """``NamedSharding`` tree matching a materialized param tree."""
    return tree_map_specs(
        lambda s: named_sharding(s.axes, s.shape, mesh, rules), specs)


# ---------------------------------------------------------------------------
# Primitive layers (functional; params are dict slices)
# ---------------------------------------------------------------------------


# int8 weight quantization for serving (a perf lever of the analysis
# tools' hill-climb): projection weights are stored int8 with a
# per-output-channel scale, which halves the HBM weight traffic.
_QUANT = contextvars.ContextVar("weight_quant", default=False)


@contextlib.contextmanager
def weight_quant():
    tok = _QUANT.set(True)
    try:
        yield
    finally:
        _QUANT.reset(tok)


def dense_spec(d_in: int, d_out: int, axes, *, bias=False):
    if _QUANT.get():
        out = {"w": ParamSpec((d_in, d_out), torch.int8, axes, init="zeros"),
               "qscale": ParamSpec((d_out,), f32, (axes[-1],),
                                   init="ones")}
    else:
        out = {"w": ParamSpec((d_in, d_out), bf16, axes)}
    if bias:
        out["b"] = ParamSpec((d_out,), bf16, (axes[-1],), init="zeros")
    return out


def dense(p, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
    """``x @ w``, plus the bias where ``p`` has one and ``bias`` is set
    (``models.attention``'s decode kernel adds its own)."""
    w = gather_weight(p["w"], x)
    if w.dtype == torch.int8:
        w = w.to(x.dtype) * p["qscale"].to(x.dtype)
    if w.dtype != x.dtype:        # mixed: promote both, as JAX's ``@`` does
        t = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(t), w.to(t)
    y = x @ w
    if bias and "b" in p:
        # a contraction over a split dim leaves partial sums: sum them
        # before the bias is added once
        y = sum_partials(y) + p["b"]
    return y


def dense_to_stream(p, x: torch.Tensor, mode: str) -> torch.Tensor:
    """``dense(p, x)`` for a projection into the residual stream (attention
    output, MLP down, recurrent and SSM out).  On a mesh its input dim may
    be split over ranks, each rank's product then a partial sum.  Serving
    (prefill, decode) forms those products in f32, sums them
    (``sum_partials``, an all-reduce) and rounds once to x's dtype, as the
    unsharded product accumulates in f32 and rounds once; no later op of
    the stream then needs DTensor to move it.  Training leaves the partial
    sums to DTensor's plan, which keeps the stream a partial sum until a
    norm needs it whole: summing here rounds bf16 otherwise and moves
    reduced mixtral's router gradient past its bound in
    ``tests/test_torch_mesh.py`` (a top-k choice near a tie)."""
    if mode == "train" or not (is_dtensor(p["w"]) and any(
            pl.is_shard(0) for pl in p["w"].placements)):
        return dense(p, x)
    return sum_partials(dense(p, x.to(f32))).to(x.dtype)


def norm_spec(d: int, axes=(None,)):
    return {"scale": ParamSpec((d,), f32, axes, init="ones")}


def rmsnorm(p, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(f32)
    # over a split last dim (mamba2's gated norm) the ranks' partial means
    # are summed here
    var = sum_partials(xf.square().mean(dim=-1, keepdim=True))
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


def mlp(cfg, p, x: torch.Tensor, mode: str = "train") -> torch.Tensor:
    h = act_fn(cfg.act, dense(p["gate"], x)) * dense(p["up"], x)
    h = shard(h, "batch", "seq", "mlp")
    return dense_to_stream(p["down"], h, mode)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap else x


# ---------------------------------------------------------------------------
# Rotary embeddings (standard + M-RoPE)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """The rotary frequencies (D/2,) f32, computed once for each head dim,
    theta and device, for ``apply_rope`` and the decode kernel to read.  A
    first call must come before any graph capture, which runs nothing and
    would leave the tensor without its values (a decode graph captures only
    after an eager step with the same key)."""
    if torch.device(device).type == "cuda" \
            and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("rope frequencies first asked for in a capture")
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=f32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: tuple[int, ...] = ()) -> torch.Tensor:
    """x: (B, S, H, D).  positions: (B, S) or (3, B, S) for M-RoPE."""
    d2 = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)           # (D/2,)
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
    return rotate(x, angles)


# ---------------------------------------------------------------------------
# Vocabulary padding + loss
# ---------------------------------------------------------------------------

VOCAB_PAD = 2048


def padded_vocab(cfg) -> int:
    v = cfg.vocab_size
    if v % 16 == 0:          # evenly shardable over a 16-way model axis
        return v
    return ((v + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD


def vocab_logit_bias(cfg) -> Optional[np.ndarray]:
    """-1e9 bias on padded vocab entries (None when unpadded)."""
    vp = padded_vocab(cfg)
    if vp == cfg.vocab_size:
        return None
    bias = np.zeros((vp,), np.float32)
    bias[cfg.vocab_size:] = -1e9
    return bias


def cross_entropy(cfg, logits: torch.Tensor,
                  labels: torch.Tensor) -> torch.Tensor:
    """Mean token NLL in f32; logits (B, S, Vp) possibly vocab-padded and
    softcapped (the cap is applied in the logits' dtype, then f32).  On a
    mesh each rank works on its own rows and, where the rules shard the
    vocab over an axis, its own block of the vocab (``_vocab_block_nll``),
    as GSPMD partitions it: the logits are never gathered, and the
    gradient of the gold logit is formed per rank, not as a replicated
    zeros of the global logits' shape (DTensor's ``new_zeros``)."""
    ctx = current_ctx()
    if ctx is not None and is_dtensor(logits):
        ls = spec_for(("batch", "seq", "vocab"), tuple(logits.shape), ctx)
        axes = entry_axes(ls[2])
        # every rule table shards the vocab over one axis at most
        assert len(axes) <= 1, ls
        rows = P(ls[0], ls[1])
        return torch.mean(local_blocks(
            lambda lg, lb: _vocab_block_nll(cfg, axes[0] if axes else None,
                                            lg, lb),
            (logits, labels), (ls, rows), rows))
    logits = softcap(logits, cfg.final_logit_softcap).to(f32)
    bias = vocab_logit_bias(cfg)
    if bias is not None:
        logits = logits + torch.from_numpy(bias).to(logits.device)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)


def _vocab_block_nll(cfg, axis: Optional[str], logits: torch.Tensor,
                     labels: torch.Tensor) -> torch.Tensor:
    """Per-token NLL from this rank's block of the vocab (plain tensors,
    the vocab split over mesh ``axis``, or whole when ``axis`` is None):
    the max and the sum of the log-sum-exp and the gold logit each
    combined over ``axis``."""
    ctx = current_ctx()
    vb = logits.shape[-1]
    v0 = block_start((axis,) if axis else (), vb)
    logits = softcap(logits, cfg.final_logit_softcap).to(f32)
    bias = vocab_logit_bias(cfg)
    if bias is not None:
        logits = logits + torch.from_numpy(bias[v0:v0 + vb]).to(
            logits.device)
    # the max only keeps exp() in range; its gradient cancels, so it is
    # taken without one
    top = logits.detach().amax(-1)
    if axis and ctx.shape[axis] > 1:
        dist.all_reduce(top, op=dist.ReduceOp.MAX,
                        group=ctx.mesh.get_group(axis))
    total = torch.exp(logits - top[..., None]).sum(-1)
    idx = labels.long() - v0
    mine = (idx >= 0) & (idx < vb)
    gold = torch.gather(logits, -1, idx.clamp(0, vb - 1)[..., None])[..., 0]
    gold = torch.where(mine, gold, 0.0)
    if axis:
        total, gold = psum(total, axis), psum(gold, axis)
    return top + torch.log(total) - gold
