"""Mixtral-8x7B: 8 experts top-2, sliding-window attention.  [arXiv:2401.04088]

8 experts do not divide the 16-way "model" axis -> tensor-parallel expert
FFNs (TP over d_ff) instead of EP.  SWA makes decode state O(window), so the
long_500k cell runs with a ring-buffer KV cache.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=1_000_000.0,
    sliding_window=4096,
    num_experts=8,
    num_experts_per_tok=2,
    moe_sharding="tp",
    act="silu",
    source="arXiv:2401.04088; hf:mistralai/Mixtral-8x7B-v0.1",
))
