"""SeamlessM4T-medium backbone: encoder-decoder, multimodal.
[arXiv:2308.11596; hf]

The speech/text modality frontend is a STUB per the assignment:
``input_specs()`` provides precomputed frame embeddings (B, src_len, d_model)
for the encoder; the text decoder is exercised by the shape cells.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,                 # decoder layers
    encoder_layers=12,
    encoder_src_len=1024,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,               # MHA
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,             # padded to 2048-multiple when vocab-sharded
    block_pattern=("encdec",),
    act="gelu",
    norm_eps=1e-5,
    source="arXiv:2308.11596; hf:facebook/seamless-m4t-medium",
))
