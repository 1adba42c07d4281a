"""DBRX-132B: fine-grained MoE, 16 experts top-4.  [hf:databricks/dbrx-base]

16 experts % 16-way "model" axis == 0 -> expert-parallel sharding (EP).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    rope_theta=500_000.0,
    num_experts=16,
    num_experts_per_tok=4,
    moe_sharding="ep",
    act="silu",
    source="hf:databricks/dbrx-base (unverified)",
))
