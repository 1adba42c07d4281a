"""RecurrentGemma-2B: RG-LRU recurrent blocks + local attention, 1:2 ratio.
[arXiv:2402.19427; hf]

Pattern (rglru, rglru, local) x 8 + (rglru, rglru) tail = 26 blocks.
Decode state is O(window) -> runs long_500k.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,                # MQA
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    rope_theta=10_000.0,
    block_pattern=("rglru", "rglru", "local"),
    tail_pattern=("rglru", "rglru"),
    local_window=2048,
    lru_width=2560,
    final_logit_softcap=30.0,
    act="gelu",
    tie_embeddings=True,
    scale_embeddings=True,
    source="arXiv:2402.19427; hf:google/recurrentgemma-2b",
))
