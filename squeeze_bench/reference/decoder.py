"""Plain reference of a dense decoder-only transformer (Qwen2's block),
layer by layer: in float32 with TF32 off, or in the configuration's own
type.

It imports nothing of the program.  It reads the weights the benchmark
drew (a nested dict in the port's parameter layout: ``embed/tok``,
``decoder/groups/0/<leaf>`` stacked over the layers, ``final_norm``) and
the model's sizes from the configuration file, and returns what a serving
cache must hold after a sequence went through: each layer's keys (after
RoPE) and values at every position.

The block, as published for Qwen2: x += o(attn(rmsnorm(x))), x +=
down(silu(gate(h)) * up(h)) with h = rmsnorm(x); q, k and v with biases;
rotary embeddings on the two halves of each head (theta from the config);
grouped-query attention, causal, softmax(q k / sqrt(head_dim)).
Departures: none in what it computes; the weights are random.
"""
from __future__ import annotations

import contextlib

import torch

f32 = torch.float32


@contextlib.contextmanager
def exact_f32():
    """float32 matmuls without TF32 (restored on exit)."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def rmsnorm(x, scale, eps):
    """In f32 whatever the activations' type, rounded back to it."""
    xf = x.to(f32)
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * scale.to(f32)).to(x.dtype)


def rope(x, pos, theta):
    """x (S, H, D), pos (S,) -> rotated halves; the angles in f32, the
    rotation in x's type."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=f32,
                                        device=x.device) / d))
    ang = pos.to(f32)[:, None] * inv                     # (S, D/2)
    cos = torch.cos(ang)[:, None].to(x.dtype)
    sin = torch.sin(ang)[:, None].to(x.dtype)
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _proj(p, x):
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def layer_params(group: dict, i: int, dtype) -> dict:
    """Layer ``i`` of a stacked group, cast to ``dtype`` (norm scales stay
    f32)."""
    if isinstance(group, dict):
        return {k: layer_params(v, i, dtype) for k, v in group.items()}
    x = group[i]
    return x.to(f32) if x.dtype == f32 else x.to(dtype)


# What this reference does with each field of the port's ``ModelConfig``
# (``covers`` is given every field, the registered architecture's with the
# file's sizes laid over them; ``test_sqb_reference.py`` walks the
# dataclass's fields): it computes from ``READS``; ``INERT`` are labels, or
# reach no K/V slot (the output head); every other field may hold only the
# value in ``FIXED`` (the port's default where it has one), and is refused
# at any other.
READS = ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim",
         "d_ff", "vocab_size", "qkv_bias", "rope_theta", "norm_eps", "act")
INERT = ("name", "source", "tie_embeddings")
FIXED = {
    "family": "dense", "mrope_sections": (), "sliding_window": 0,
    "block_pattern": ("attn",), "tail_pattern": (), "local_window": 0,
    "attn_logit_softcap": 0.0, "final_logit_softcap": 0.0,
    "query_scale": 0.0, "num_experts": 0, "num_experts_per_tok": 0,
    "moe_capacity_factor": 1.25, "moe_sharding": "ep", "ssm_state": 0,
    "ssm_headdim": 64, "ssm_expand": 2, "ssm_ngroups": 1,
    "ssm_conv_width": 4, "ssm_chunk": 256, "lru_width": 0,
    "encoder_layers": 0, "encoder_src_len": 1024, "post_norms": False,
    "scale_embeddings": False, "vision_stub_tokens": 0,
}


def check_fields(model: dict, reads, inert, fixed: dict) -> None:
    """Raises ``NotImplementedError`` for a field of ``model`` that is
    neither read nor inert and holds another value than ``fixed`` gives,
    or that none of the three names."""
    for key, value in model.items():
        if key in reads or key in inert:
            continue
        if key not in fixed:
            raise NotImplementedError(
                f"field {key!r} is unknown to this reference")
        if isinstance(value, list):
            value = tuple(value)
        if value != fixed[key]:
            raise NotImplementedError(
                f"{key} = {value!r}: this reference computes only "
                f"{fixed[key]!r}")


def covers(model: dict) -> None:
    """Raises ``NotImplementedError``, with the reason, for a ``model``
    whose block this reference does not compute."""
    if model.get("num_experts"):
        raise NotImplementedError("this reference is the dense block")
    if model.get("act", "silu") != "silu":
        raise NotImplementedError("this reference is the SiLU MLP")
    check_fields(model, READS, INERT, FIXED)


def attention(model: dict, p: dict, x, pos, qblock: int, dtype):
    """One layer's attention on the residual ``x`` (S, d_model): returns
    ``(x + o(attn(rmsnorm(x))), k, v)``, the keys after RoPE.  Queries go
    through ``qblock`` rows at a time."""
    hq, hkv, dh = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    eps, theta = model["norm_eps"], model["rope_theta"]
    s = x.shape[0]
    h = rmsnorm(x, p["ln1"]["scale"], eps)
    q = rope(_proj(p["attn"]["q"], h).view(s, hq, dh), pos, theta)
    k = rope(_proj(p["attn"]["k"], h).view(s, hkv, dh), pos, theta)
    v = _proj(p["attn"]["v"], h).view(s, hkv, dh)
    qg = q.view(s, hkv, hq // hkv, dh)
    out = torch.empty_like(qg)
    for a in range(0, s, qblock):
        b = min(s, a + qblock)
        sc = torch.einsum("skgd,tkd->kgst", qg[a:b].to(f32),
                          k[:b].to(f32)) * dh ** -0.5
        mask = pos[:b][None, :] > pos[a:b][:, None]
        sc = sc.masked_fill(mask, float("-inf"))
        w = torch.softmax(sc, dim=-1).to(dtype)
        out[a:b] = torch.einsum("kgst,tkd->skgd", w, v[:b])
    return x + _proj(p["attn"]["o"], out.reshape(s, hq * dh)), k, v


def kv_cache(model: dict, params: dict, tokens: torch.Tensor,
             qblock: int = 1024, dtype=f32):
    """tokens (S,) int64 on the weights' device -> (K, V), each
    (layers, S, kv_heads, head_dim) f32: what each layer writes into a
    cache for these tokens at positions 0..S-1.  Queries go through
    attention ``qblock`` rows at a time.

    ``dtype`` is the type of the activations and weights: float32 (the
    exact reference, TF32 off), or the configuration's own type (bfloat16:
    the plain published block in that type, with the norms, the RoPE
    angles and the softmax in f32 and every matmul accumulating in f32, as
    the Qwen2 reference code runs it)."""
    covers(model)
    eps = model["norm_eps"]
    s = tokens.shape[0]
    pos = torch.arange(s, device=tokens.device)
    group = params["decoder"]["groups"][0]
    ks, vs = [], []
    with exact_f32():
        x = params["embed"]["tok"][tokens].to(dtype)
        for i in range(model["num_layers"]):
            p = layer_params(group, i, dtype)
            x, k, v = attention(model, p, x, pos, qblock, dtype)
            ks.append(k.to(f32))
            vs.append(v.to(f32))
            h = rmsnorm(x, p["ln2"]["scale"], eps)
            f = p["ffn"]
            x = x + _proj(f["down"], torch.nn.functional.silu(
                _proj(f["gate"], h)) * _proj(f["up"], h))
    return torch.stack(ks), torch.stack(vs)
