"""Qwen2-VL-72B backbone: M-RoPE, dynamic resolution.  [arXiv:2409.12191; hf]

Vision frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings that are scattered into the token stream.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),   # (temporal, height, width) half-dims
    vision_stub_tokens=256,
    act="silu",
    source="arXiv:2409.12191; hf:Qwen/Qwen2-VL-72B",
))
