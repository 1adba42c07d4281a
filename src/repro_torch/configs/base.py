"""Model/shape configuration registry.

One ``ModelConfig`` describes any architecture in the assigned pool (dense /
MoE / VLM / SSM / audio enc-dec / hybrid).  Per-arch modules under
``repro/configs`` register themselves into ``ARCHS``; ``SHAPES`` holds the
assigned input-shape cells.  ``reduced()`` derives the CPU-smoke-test config
for an arch (same family, tiny dims).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

# ---------------------------------------------------------------------------
# Shapes (assigned): every (arch x shape) cell is defined by these four.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int       # decoder-side sequence length (KV length for decode)
    global_batch: int


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524_288, 1),
}


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | vlm | ssm | audio | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention variants -------------------------------------------------
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    mrope_sections: tuple[int, ...] = ()     # qwen2-vl M-RoPE (t, h, w)
    sliding_window: int = 0                  # SWA window; 0 = full attention
    # layer pattern within one scanned group, e.g. ("local", "global") for
    # gemma2 or ("rglru", "rglru", "attn") for recurrentgemma.  Dense archs
    # use a single-entry group.  ``tail_pattern`` holds unscanned trailing
    # blocks when num_layers % len(pattern) != 0.
    block_pattern: tuple[str, ...] = ("attn",)
    tail_pattern: tuple[str, ...] = ()
    local_window: int = 0                    # window for "local" blocks
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    query_scale: float = 0.0                 # 0 => 1/sqrt(head_dim)

    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25
    moe_sharding: str = "ep"                 # "ep" | "tp"

    # --- SSM (mamba2 / SSD) -------------------------------------------------
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_ngroups: int = 1
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # --- hybrid (recurrentgemma RG-LRU) --------------------------------------
    lru_width: int = 0

    # --- enc-dec (seamless) ---------------------------------------------------
    encoder_layers: int = 0
    encoder_src_len: int = 1024              # stub frame-embedding length

    # --- misc -----------------------------------------------------------------
    act: str = "silu"                        # "silu" | "gelu"
    norm_eps: float = 1e-6
    post_norms: bool = False                 # gemma2 sandwich norms
    tie_embeddings: bool = False
    scale_embeddings: bool = False           # gemma-style sqrt(d_model)
    vision_stub_tokens: int = 0              # vlm: injected patch embeddings
    source: str = ""                         # provenance tag

    # ------------------------------------------------------------------ utils
    @property
    def n_groups(self) -> int:
        body = self.num_layers - len(self.tail_pattern)
        assert body % len(self.block_pattern) == 0, (
            f"{self.name}: {body} body layers not divisible by "
            f"pattern {self.block_pattern}")
        return body // len(self.block_pattern)

    @property
    def d_inner(self) -> int:                # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """True when decode state is sub-linear in context (assigned rule:
        run long_500k for SSM / hybrid / windowed / local-global archs)."""
        if self.family in ("ssm", "hybrid"):
            return True
        if self.sliding_window > 0:
            return True
        return "local" in self.block_pattern  # alternating local/global
    # Encoder-only archs would skip decode shapes entirely; every assigned
    # arch has a decoder, so no such skip exists in this pool.

    def cells(self) -> list[str]:
        out = []
        for s in SHAPES.values():
            if s.name == "long_500k" and not self.supports_long_context:
                continue
            out.append(s.name)
        return out

    def param_count(self) -> int:
        """Exact parameter count from the spec tree."""
        from repro_torch.models.model import param_specs
        import math
        return sum(math.prod(s.shape)
                   for _, s in _iter_specs(param_specs(self), True))

    def active_param_count(self) -> int:
        """Params touched per token (MoE counts top-k experts only)."""
        total = self.param_count()
        if self.num_experts:
            from repro_torch.models.model import param_specs
            import math
            expert, active = 0, 0
            for path, s in _iter_specs(param_specs(self), True):
                # expert-stacked ffn weights carry E at dim -3
                if "/ffn/" in path and len(s.shape) >= 3 \
                        and s.shape[-3] == self.num_experts:
                    n = math.prod(s.shape)
                    expert += n
                    active += n * self.num_experts_per_tok \
                        // self.num_experts
            total = total - expert + active
        return total


def _iter_specs(tree, with_path: bool = False, path: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _iter_specs(v, with_path, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _iter_specs(v, with_path, f"{path}/{i}")
    else:
        yield (path, tree) if with_path else tree


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCHS: dict[str, ModelConfig] = {}
_REDUCERS: dict[str, Callable[[ModelConfig], ModelConfig]] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    ARCHS[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    return ARCHS[name]


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(ARCHS)


def _ensure_loaded() -> None:
    if len(ARCHS) >= 10:
        return
    import importlib
    for mod in ("qwen2_7b", "gemma2_9b", "tinyllama_1_1b", "qwen2_1_5b",
                "dbrx_132b", "mixtral_8x7b", "qwen2_vl_72b", "mamba2_780m",
                "seamless_m4t_medium", "recurrentgemma_2b"):
        importlib.import_module(f"repro_torch.configs.{mod}")


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    pat = len(cfg.block_pattern)
    layers = pat * 2 + len(cfg.tail_pattern)
    kv = min(cfg.num_kv_heads, 2)
    heads = max(4, kv)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        num_layers=layers,
        d_model=64,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        num_experts=min(cfg.num_experts, 4) if cfg.num_experts else 0,
        num_experts_per_tok=min(cfg.num_experts_per_tok, 2)
        if cfg.num_experts else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_headdim=16 if cfg.ssm_state else cfg.ssm_headdim,
        ssm_chunk=8,
        lru_width=64 if cfg.lru_width else 0,
        sliding_window=min(cfg.sliding_window, 8) if cfg.sliding_window else 0,
        local_window=min(cfg.local_window, 8) if cfg.local_window else 0,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_src_len=16 if cfg.encoder_layers else cfg.encoder_src_len,
        mrope_sections=(4, 2, 2) if cfg.mrope_sections else (),
        vision_stub_tokens=4 if cfg.vision_stub_tokens else 0,
    )
