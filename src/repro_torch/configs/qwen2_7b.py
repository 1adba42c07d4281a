"""Qwen2-7B: dense GQA decoder with QKV bias.  [arXiv:2407.10671; hf]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    act="silu",
    source="arXiv:2407.10671; hf:Qwen/Qwen2-7B",
))
