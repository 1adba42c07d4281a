"""Plain reference of Mixtral's sparse-expert decoder block, layer by layer:
in float32 with TF32 off, or in the configuration's own type.

It imports nothing of the program.  It reads the weights the benchmark
drew, in the port's parameter layout (``embed/tok``; stacked over the
layers, ``decoder/groups/0/{ln1,attn,ln2}`` as for the dense block and
``decoder/groups/0/ffn/{router,gate,up,down}``: router (d, E) f32, gate
and up (E, d, ff), down (E, ff, d)), and the model's sizes, and returns
what a serving cache must hold after a sequence went through, with which
of its routing decisions were too close to call.

The block, as published for Mixtral (arXiv:2401.04088): x +=
o(attn(rmsnorm(x))) as in ``decoder`` (no biases, RoPE theta and eps from
the sizes); then h = rmsnorm(x), router logits h @ router in f32, a
softmax over the E experts, the k largest, renormalised to sum to 1, and
x += sum over the k experts e of w_e down_e(silu(gate_e h) * up_e h), each
expert's output weighted in the activations' type and added into the
token's row in expert order.  Every routed token goes through its experts:
nothing is dropped, so ``covers`` refuses a configuration in which the
program would drop tokens over an expert's capacity.
Departures: none in what it computes; the weights are random.

A top-k router makes discrete choices.  Where the k-th and (k+1)-th
router logits of a slot lie within rounding of each other, the program and
this reference may pick different experts, and that slot's residual, the
K/V of every later layer at that slot and at every later slot that attends
to it, differ wholesale.  ``kv_cache`` therefore also says which routing
decisions are settled: those whose gap between the k-th and (k+1)-th
largest router logits exceeds ``TIE_MARGIN``; the check judges a slot only
where everything it was computed from was settled.
"""
from __future__ import annotations

import torch

from .decoder import (FIXED as DENSE_FIXED, INERT as DENSE_INERT,
                      READS as DENSE_READS, attention, check_fields,
                      exact_f32, layer_params, rmsnorm)

f32 = torch.float32

# The router logits' gap between the k-th and (k+1)-th experts above which
# a routing decision counts as settled, by layer index (the last entry for
# every deeper layer).  Set from the port's routes recorded in eager
# prefill and decode against this reference's in bf16, at Mixtral-8x7B's
# widths on 16 layers, over 8 seeds on an H100 (PERF.md §2): where every
# decision a slot was computed from agreed, the two sides routed it
# differently at reference margins up to 0.0227 in layer 0 and 0.0519 in
# layers 1-15, and their margins differed by up to 0.026 and 0.065 where
# they agreed.  Each entry is at least twice the largest margin of a
# flip in its layers.  With it the saturated mix's rows (one prompt token
# repeated, then token 0) had 0.156-0.424 of their (layer, slot) pairs
# judged over 8 seeds: layer 0 all, layers 1-2 at a median of 0.92 and
# 0.83, layers 3-7 at 0.20-0.50, layers 8-15 at 0.04 or less.
TIE_MARGIN = (0.05, 0.11)

READS = DENSE_READS + ("num_experts", "num_experts_per_tok",
                       "moe_capacity_factor")
# ``moe_sharding`` says how a mesh splits the experts; on one device
# without a mesh the program computes every expert alike
INERT = DENSE_INERT + ("moe_sharding",)
FIXED = {k: v for k, v in DENSE_FIXED.items() if k not in READS + INERT}
FIXED["family"] = "moe"


def expert_layer(model: dict) -> int:
    """The first layer whose K/V were computed from an expert block's
    output: layer 1, every block being sparse (one block pattern,
    ``FIXED``), so layer 0's expert block feeds it."""
    return 1


# Numbers this reference asks the check for beside the shared ones, each
# the pooled K/V error of one layer over its judged slots (``check.judge``),
# by a function of the sizes that gives the layer, and held to the limit
# the configuration's file states under ``"limits"``:
#   expert_kv_err  at ``expert_layer``, which is nearly all judged, where
#                  deeper layers are judged thinly: lower precision in the
#                  experts alone moves it, and not the shared limits
NUMBERS = {"expert_kv_err": expert_layer}


def covers(model: dict) -> None:
    """Raises ``NotImplementedError``, with the reason, for a ``model``
    whose block this reference does not compute."""
    e = model.get("num_experts", 0)
    k = model.get("num_experts_per_tok", 0)
    if not e:
        raise NotImplementedError("this reference is the sparse-expert "
                                  "block; the model has no experts")
    if not 0 < k < e:
        raise NotImplementedError(f"top-{k} routing over {e} experts")
    if model.get("num_layers", 0) <= expert_layer(model):
        raise NotImplementedError(
            f"{model.get('num_layers')} layer(s): no layer's K/V were "
            "computed from an expert block's output")
    if model.get("act", "silu") != "silu":
        raise NotImplementedError("this reference is the SiLU MLP")
    # the program gives each expert int(n k cf / E) slots (rounded up to
    # 8) over the n tokens of a call: cf >= E / k leaves room for all n
    cf = model.get("moe_capacity_factor", 1.25)
    if cf * k < e:
        raise NotImplementedError(
            f"moe_capacity_factor {cf} is below num_experts / "
            f"num_experts_per_tok = {e / k:g}: the program drops tokens "
            "over an expert's capacity, and this reference drops none")
    check_fields(model, READS, INERT, FIXED)


def tie_margin(layer: int) -> float:
    return TIE_MARGIN[min(layer, len(TIE_MARGIN) - 1)]


def forward(model: dict, params: dict, tokens: torch.Tensor,
            qblock: int = 1024, dtype=f32):
    """tokens (S,) int64 on the weights' device -> (K, V, experts,
    margins): K and V (layers, S, kv_heads, head_dim) f32, what each layer
    writes into a cache for these tokens at positions 0..S-1; experts
    (layers, S, k), the experts each slot was routed to, largest weight
    first; margins (layers, S) f32, the k-th largest router logit less the
    (k+1)-th.

    ``dtype`` is the type of the activations and weights: float32 (the
    exact reference, TF32 off), or the configuration's own type (bfloat16,
    with the norms, the RoPE angles, the softmax and the router in f32 and
    every matmul accumulating in f32)."""
    covers(model)
    eps = model["norm_eps"]
    n_exp, top = model["num_experts"], model["num_experts_per_tok"]
    s = tokens.shape[0]
    pos = torch.arange(s, device=tokens.device)
    group = params["decoder"]["groups"][0]
    ks, vs, experts, margins = [], [], [], []
    with exact_f32():
        x = params["embed"]["tok"][tokens].to(dtype)
        for i in range(model["num_layers"]):
            p = layer_params(group, i, dtype)
            x, k, v = attention(model, p, x, pos, qblock, dtype)
            ks.append(k.to(f32))
            vs.append(v.to(f32))
            h = rmsnorm(x, p["ln2"]["scale"], eps)
            f = p["ffn"]
            logits = h.to(f32) @ f["router"].to(f32)            # (S, E)
            best = logits.topk(top + 1, dim=-1)
            margins.append(best.values[:, top - 1] - best.values[:, top])
            sel = best.indices[:, :top]                          # (S, k)
            experts.append(sel)
            w = torch.softmax(logits, dim=-1).gather(-1, sel)
            w = (w / w.sum(-1, keepdim=True)).to(dtype)
            y = torch.zeros_like(x)
            for e in range(n_exp):
                rows, slot = (sel == e).nonzero(as_tuple=True)
                if rows.numel() == 0:
                    continue
                he = h[rows]
                o = (torch.nn.functional.silu(he @ f["gate"][e])
                     * (he @ f["up"][e])) @ f["down"][e]
                y.index_add_(0, rows, o * w[rows, slot, None])
            x = x + y
    return (torch.stack(ks), torch.stack(vs), torch.stack(experts),
            torch.stack(margins))


def kv_cache(model: dict, params: dict, tokens: torch.Tensor,
             qblock: int = 1024, dtype=f32):
    """tokens (S,) -> (K, V, settled): K and V as ``forward`` gives them;
    settled (layers, S) bool, whether the routing decision of each slot at
    each layer cleared ``TIE_MARGIN``."""
    k, v, _, margins = forward(model, params, tokens, qblock, dtype)
    limit = torch.tensor([tie_margin(i) for i in range(margins.shape[0])],
                         device=margins.device)
    return k, v, margins > limit[:, None]
