"""Gemma2-9B: alternating local/global attention, logit softcaps, sandwich
norms, tied embeddings.  [arXiv:2408.00118; hf]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,                # decoupled from d_model/num_heads
    d_ff=14336,
    vocab_size=256000,
    rope_theta=10_000.0,
    block_pattern=("local", "global"),
    local_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    query_scale=256.0 ** -0.5,   # query_pre_attn_scalar = 256
    act="gelu",
    post_norms=True,
    tie_embeddings=True,
    scale_embeddings=True,
    source="arXiv:2408.00118; hf:google/gemma-2-9b",
))
