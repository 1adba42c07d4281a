"""The least bytes the expert path of a decode step must move, from the
configuration file's sizes and the step's ``decode.moe`` readings: each
expert that was routed a slot has its gate, up and down weights read once;
each expert block reads the router (f32) once, and its tokens once, and
writes their outputs once.  A lower bound: the port's expert matmuls read
every expert's weights, hit or not, and more than the tokens."""
from __future__ import annotations

from squeeze_bench.costs import BF16

F32 = 4                 # bytes: the router's weights


def expert_weight_bytes(model: dict, experts_hit: int) -> int:
    """The gate, up and down weights of ``experts_hit`` experts (summed
    over the blocks of a step)."""
    return experts_hit * 3 * model["d_model"] * model["d_ff"] * BF16


def expert_path_bytes(model: dict, experts_hit: int, layers: int,
                      tokens: int) -> int:
    """One step's expert path: ``layers`` expert blocks of ``tokens``
    tokens each, ``experts_hit`` experts with a slot over all of them."""
    d = model["d_model"]
    per_block = d * model["num_experts"] * F32 + 2 * tokens * d * BF16
    return expert_weight_bytes(model, experts_hit) + layers * per_block
