"""Mamba2-780M: attention-free SSD (state-space duality).  [arXiv:2405.21060]

Decode state is O(1) in context length -> the best case for HotMem
partitions (constant, tiny per-request partitions); runs long_500k.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    block_pattern=("ssm",),
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_ngroups=1,
    ssm_conv_width=4,
    ssm_chunk=256,
    norm_eps=1e-5,
    tie_embeddings=True,
    source="arXiv:2405.21060; hf:state-spaces/mamba2-780m (unverified)",
))
