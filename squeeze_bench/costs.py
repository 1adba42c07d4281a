"""The yardstick's arithmetic: the card's peaks and the operations and bytes
each measured piece of work needs, from the configuration file's sizes.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W power limit (the
port's ``roofline.py`` uses the same rates; this is the benchmark's own
copy, which later changes to the program cannot move).
"""
from __future__ import annotations

PEAK_BF16 = 989e12      # FLOP/s, bf16 tensor cores, dense
HBM_BW = 3.35e12        # bytes/s
BF16 = 2                # bytes


def matmul_params(model: dict) -> int:
    """Weights one token multiplies through, per layer and in the LM head
    (an MoE layer counts its ``num_experts_per_tok`` experts and router)."""
    d, hq, hkv, dh, ff = (model["d_model"], model["num_heads"],
                          model["num_kv_heads"], model["head_dim"],
                          model["d_ff"])
    attn = d * hq * dh * 2 + d * hkv * dh * 2
    if model.get("num_experts"):
        ffn = 3 * d * ff * model["num_experts_per_tok"] \
            + d * model["num_experts"]
    else:
        ffn = 3 * d * ff
    return model["num_layers"] * (attn + ffn)


def head_params(model: dict) -> int:
    return model["d_model"] * model["vocab_size"]


def attn_flops(model: dict, keys: int) -> int:
    """QK and PV of one query over ``keys`` keys, all layers."""
    return 4 * model["num_layers"] * model["num_heads"] \
        * model["head_dim"] * keys


def prefill_flops(model: dict, prompt: int) -> int:
    """Model FLOPs of one cold-start prefill: every prompt token through
    every layer, causal attention (query i sees i + 1 keys), and the LM head
    for the last token only, as the program computes it."""
    keys = prompt * (prompt + 1) // 2
    return 2 * matmul_params(model) * prompt + attn_flops(model, keys) \
        + 2 * head_params(model)


def decode_flops(model: dict, positions) -> int:
    """Model FLOPs of one decode step over rows at ``positions`` (each row's
    new token attends to positions + 1 keys)."""
    n = len(positions)
    keys = sum(int(p) + 1 for p in positions)
    return 2 * (matmul_params(model) + head_params(model)) * n \
        + attn_flops(model, keys)


def partition_attention_bytes(model: dict, positions, rows: int) -> int:
    """Bytes one ``partition_attention`` call must move: each valid K/V slot
    of each row read once (slots 0..pos), q read and the output written
    once, the positions read.  ``positions`` of the bound rows; the other
    ``rows - len(positions)`` rows sit at position 0 (one slot each)."""
    hkv, dh, hq = model["num_kv_heads"], model["head_dim"], model["num_heads"]
    slots = sum(int(p) + 1 for p in positions) + (rows - len(positions))
    return slots * hkv * dh * BF16 * 2 + 2 * rows * hq * dh * BF16 + 4 * rows


def snapshot_restore_bytes(row_bytes: int) -> int:
    """One restore launch: the staged blob read once, the row written once."""
    return 2 * row_bytes
