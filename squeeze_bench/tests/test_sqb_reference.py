"""The plain reference against the port on the CPU, at the port's reduced
widths: prefill then decode through the cache, K/V slot by slot."""
import dataclasses

import pytest
import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.models import model as M
from squeeze_bench import check, weights
from squeeze_bench.reference import decoder

torch.set_num_threads(1)

FIELDS = ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim",
          "d_ff", "vocab_size", "qkv_bias", "rope_theta", "norm_eps", "act",
          "num_experts")


def model_dict(cfg):
    return {k: getattr(cfg, k) for k in FIELDS}


def port_kv(cfg, params, prompt, n_decode, rows=3, row=1, cache_len=64):
    """Prefill ``prompt`` into ``row`` of a ``rows``-row arena, then decode
    token 0 ``n_decode`` times with the other rows at other positions."""
    caches = M.init_caches(cfg, rows, cache_len, device="cpu")
    one = M.init_caches(cfg, 1, cache_len, device="cpu")
    M.prefill(cfg, params, {"tokens": prompt[None].int()}, one)
    M.cache_write_row(caches, one, row)
    p = prompt.shape[0]
    for i in range(n_decode):
        pos = torch.tensor([3 + i] * rows, dtype=torch.int32)
        pos[row] = p + i
        M.decode_step(cfg, params, torch.zeros((rows, 1), dtype=torch.int32),
                      pos, caches)
    g = caches["groups"][0]
    return g["k"][:, row, :p + n_decode], g["v"][:, row, :p + n_decode]


@pytest.mark.parametrize("seed", [0, 1, 2 ** 40 + 3])
@pytest.mark.parametrize("tok", [5, 300])
def test_reference_matches_port_on_reduced_qwen2(seed, tok):
    cfg = reduced(get_config("qwen2-7b"))
    params = weights.draw(M.param_specs(cfg), seed, "cpu")
    prompt = torch.full((20,), tok, dtype=torch.long)
    k, v = port_kv(cfg, params, prompt, 12)
    tokens = torch.cat([prompt, torch.zeros(12, dtype=torch.long)])
    rk, rv = decoder.kv_cache(model_dict(cfg), params, tokens)
    assert check.slot_err(k, rk) < 0.03
    assert check.slot_err(v, rv) < 0.03


def test_reference_sees_a_changed_token():
    cfg = reduced(get_config("qwen2-7b"))
    params = weights.draw(M.param_specs(cfg), 4, "cpu")
    prompt = torch.full((20,), 9, dtype=torch.long)
    k, _ = port_kv(cfg, params, prompt, 4)
    tokens = torch.cat([prompt, torch.zeros(4, dtype=torch.long)])
    tokens[0] = 10
    rk, _ = decoder.kv_cache(model_dict(cfg), params, tokens)
    assert check.slot_err(k, rk) > 0.3


def test_reference_is_causal_and_blockwise():
    cfg = dataclasses.replace(reduced(get_config("qwen2-7b")), num_layers=3)
    params = weights.draw(M.param_specs(cfg), 5, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (40,))
    k1, v1 = decoder.kv_cache(model_dict(cfg), params, tokens)
    k2, v2 = decoder.kv_cache(model_dict(cfg), params, tokens[:25],
                              qblock=7)
    torch.testing.assert_close(k1[:, :25], k2, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(v1[:, :25], v2, rtol=1e-5, atol=1e-5)


def test_reference_refuses_experts():
    cfg = reduced(get_config("mixtral-8x7b"))
    with pytest.raises(NotImplementedError):
        decoder.kv_cache(model_dict(cfg), {}, torch.zeros(4, dtype=torch.long))


@pytest.mark.parametrize("arch,refused", [
    ("qwen2-7b", None), ("tinyllama-1.1b", None),
    ("mixtral-8x7b", "dense block"), ("gemma2-9b", "SiLU MLP")])
def test_covers_says_what_the_reference_computes(arch, refused):
    model = model_dict(reduced(get_config(arch)))
    if refused is None:
        decoder.covers(model)
        return
    with pytest.raises(NotImplementedError, match=refused):
        decoder.covers(model)


def test_weights_repeat_by_seed_and_quantize():
    cfg = reduced(get_config("qwen2-7b"))
    a = weights.draw(M.param_specs(cfg), 11, "cpu")
    b = weights.draw(M.param_specs(cfg), 11, "cpu")
    c = weights.draw(M.param_specs(cfg), 12, "cpu")
    la, lb = weights._walk(a), weights._walk(b)
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))
    wa = a["decoder"]["groups"][0]["attn"]["q"]["w"]
    assert not torch.equal(wa, c["decoder"]["groups"][0]["attn"]["q"]["w"])
    assert a["decoder"]["groups"][0]["attn"]["q"]["b"].abs().max() > 0
    q = weights.quantize_int8(a)["decoder"]["groups"][0]["attn"]["q"]
    assert q["w"].dtype == torch.int8
    back = q["w"].float() * q["qscale"][:, None, :]
    err = (back - wa.float()).abs().max() / wa.float().abs().max()
    assert 0 < err < 1 / 127
