"""Weights drawn by the benchmark, on the device, from ``--seed``.

The tree has the port's parameter layout (``param_specs``: nested dicts and
tuples of tensors), so the program takes it as it is, and the reference
reads the same tensors.  The numbers are the benchmark's own: two calls of
``normal_`` on one ``torch.Generator`` on the device, one over every bf16
leaf and one over every f32 leaf, each leaf a view of one of the two
buffers, then scaled in place.  Matrices follow the fan-in rule of the
port's initialiser (std = scale / sqrt(fan_in)); biases are drawn at std
0.02 and norm scales at 1 + 0.1 N(0, 1), so those paths carry numbers too.
"""
from __future__ import annotations

import math

import torch

ALIGN = 64        # elements; every leaf starts on a 128-byte boundary

# What each control (``run.py --control``, not part of a cell) serves in
# place of the drawn bf16 weights: the projections as the port's int8
# path stores them (``quantize_int8``), the experts on int8's grid
# (``round_experts_int8``), or both
CONTROLS = {"int8": ("projections",), "int8x": ("projections", "experts"),
            "int8e": ("experts",)}


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


def _rebuild(tree, leaves: dict, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves, path + (i,))
                          for i, v in enumerate(tree))
    return leaves[path]


def _std(spec) -> float:
    if spec.init == "zeros":
        return 0.02
    if spec.init == "ones":
        return 0.1
    if spec.init != "normal":
        raise NotImplementedError(f"no draw for init {spec.init!r}")
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    return spec.scale / math.sqrt(max(fan_in, 1))


def draw(specs, seed: int, device, into: dict | None = None) -> dict:
    """The port's ``ParamSpec`` tree -> tensors on ``device``.  ``into``: a
    tree that an earlier call drew from the same specs, whose leaves are
    drawn again in place, in its buffers (and returned)."""
    items = list(_walk(specs))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    old = dict(_walk(into)) if into is not None else {}
    leaves = {}
    for dtype in (torch.bfloat16, torch.float32):
        mine = [(p, s) for p, s in items if s.dtype == dtype]
        offs, total = [], 0
        for _, s in mine:
            offs.append(total)
            total += -(-math.prod(s.shape) // ALIGN) * ALIGN
        if not mine:
            continue
        buf = old[mine[0][0]]._base if old else \
            torch.empty(total, dtype=dtype, device=device)
        if buf is None or buf.numel() != total:
            raise ValueError("into is not a tree that draw made from these "
                             "specs")
        buf.normal_(generator=gen)
        for (path, s), off in zip(mine, offs):
            x = buf[off:off + math.prod(s.shape)].view(s.shape)
            x.mul_(_std(s))
            if s.init == "ones":
                x.add_(1.0)
            leaves[path] = x
    missing = [p for p, s in items if p not in leaves]
    if missing:
        raise NotImplementedError(f"leaves of other dtypes: {missing[:3]}")
    return into if old else _rebuild(specs, leaves)


def _int8_grid(wf: torch.Tensor):
    """(q, scale): f32 weights (..., d_in, d_out) on int8's per-output-
    channel grid, symmetric, absmax / 127; q holds whole numbers in f32."""
    scale = wf.abs().amax(dim=-2, keepdim=True).clamp(min=1e-12) / 127.0
    return torch.round(wf / scale).clamp(-127, 127), scale


def quantize_int8(params) -> dict:
    """The control's weights: every projection (a dict with a ``w`` of
    (d_in, d_out), or stacked over the layers) as the port's int8 serving
    path stores it, int8 with a per-output-
    channel f32 ``qscale`` (symmetric, absmax / 127).  Other leaves are
    shared with ``params``."""
    if isinstance(params, dict):
        w = params.get("w")
        if isinstance(w, torch.Tensor) and w.dim() in (2, 3) \
                and w.dtype == torch.bfloat16:
            # (d_in, d_out), or stacked over layers
            q, scale = _int8_grid(w.float())
            out = {k: v for k, v in params.items() if k != "w"}
            out.update(w=q.to(torch.int8), qscale=scale.squeeze(-2))
            return out
        return {k: quantize_int8(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(quantize_int8(v) for v in params)
    return params


def round_experts_int8(params) -> dict:
    """The ``int8x`` and ``int8e`` controls' experts, in place: every
    expert matrix (a ``gate``, ``up`` or ``down`` beside a ``router``,
    stacked over the layers and the experts, (..., d_in, d_out)) rounded
    to int8's per-output-channel grid as ``quantize_int8`` rounds a
    projection (symmetric, absmax / 127) and kept in bf16, one matrix at a
    time: the experts hold most of the card's memory, and a copy would not
    fit.  Returns ``params``; a tree without experts is left as it is."""
    if isinstance(params, dict):
        if "router" in params:
            for name in ("gate", "up", "down"):
                for w in params[name].view(-1, *params[name].shape[-2:]):
                    q, scale = _int8_grid(w.float())
                    w.copy_(q * scale)
        else:
            for v in params.values():
                round_experts_int8(v)
    elif isinstance(params, (list, tuple)):
        for v in params:
            round_experts_int8(v)
    return params
