"""The port's model (``repro_torch.models.model``) against the JAX package's
on the reduced decoder-only configs, with the JAX parameters moved across
by ``repro_torch.convert``, plus the row-wise cache utilities.

Logit tolerance: 2e-2 of the largest logit.  Both models run in bf16 (the
parameter and cache specs are bf16) and round activations at different
places (XLA fuses, PyTorch's CPU kernels round every op), which leaves
differences near 1e-2 of the largest logit; the algorithm is checked in f32
per layer in ``test_torch_layers.py``.  The MoE configs are held to 8e-2,
the reference's own MoE bound (``tests/test_decode_consistency.py``): a
bf16 rounding difference upstream can flip a top-k choice near a tie."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.core.arena import ArenaSpec as JaxArenaSpec
from repro.models import model as JM
from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import tree_from_numpy
from repro_torch.core.arena import ArenaSpec
from repro_torch.models import model as M
from repro_torch.models.layers import tree_flatten, tree_leaves

torch.set_num_threads(1)
DENSE = ["qwen2-7b", "qwen2-1.5b", "tinyllama-1.1b"]
RECURRENT = ["mamba2-780m", "recurrentgemma-2b"]
FAMILIES = ["gemma2-9b", "mixtral-8x7b", "dbrx-132b", "qwen2-vl-72b"]
AUDIO = "seamless-m4t-medium"     # its model-level parity: test_torch_encdec
B, S = 2, 12


def _tol(cfg) -> float:
    return 8e-2 if cfg.family == "moe" else 2e-2


def _rel_err(got, want):
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    return float(np.abs(g - w).max() / (np.abs(w).max() + 1e-9))


@pytest.fixture(scope="module", params=DENSE + RECURRENT + FAMILIES)
def both(request):
    jcfg = jax_reduced(jax_get_config(request.param))
    cfg = reduced(get_config(request.param))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, tree_from_numpy(jax.device_get(jp), "cpu")


def test_prefill_and_decode_logits_match_jax(both):
    jcfg, cfg, jp, tp = both
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(B, S + 2)).astype(np.int32)
    jc = JM.init_caches(jcfg, B, 32)
    tc = M.init_caches(cfg, B, 32, device="cpu")
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :S])}, jc)
    tl, tc = M.prefill(cfg, tp, {"tokens": torch.from_numpy(toks[:, :S])},
                       tc)
    tol = _tol(cfg)
    assert tl.shape == jl.shape and _rel_err(tl, jl) < tol
    for i in (S, S + 1):                 # two steps: rows stay independent
        pos = np.asarray([i, i - 3], np.int32)
        jl, jc = JM.decode_step(jcfg, jp, jnp.asarray(toks[:, i:i + 1]),
                                jnp.asarray(pos), jc)
        tl, tc = M.decode_step(cfg, tp, torch.from_numpy(toks[:, i:i + 1]),
                               torch.from_numpy(pos), tc)
        assert _rel_err(tl, jl) < tol, i
    for t, j in zip(tree_leaves(tc), jax.tree.leaves(jc)):
        assert _rel_err(t, j) < tol


def test_ring_cache_prefill_longer_than_cache(both):
    """Prompt longer than the cache: the ring keeps the tail (slot p % T),
    as in the JAX package."""
    jcfg, cfg, jp, tp = both
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(1, 11)).astype(np.int32)
    _, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                       JM.init_caches(jcfg, 1, 8))
    _, tc = M.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)},
                      M.init_caches(cfg, 1, 8, device="cpu"))
    for t, j in zip(tree_leaves(tc), jax.tree.leaves(jc)):
        assert _rel_err(t, j) < _tol(cfg)


def test_decode_matches_forward():
    cfg = reduced(get_config("qwen2-7b"))
    params = M.init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32))
    full = M.forward_train(cfg, params, {"tokens": toks})[:, S].float()
    caches = M.init_caches(cfg, B, 32, device="cpu")
    _, caches = M.prefill(cfg, params, {"tokens": toks[:, :S]}, caches)
    lg, _ = M.decode_step(cfg, params, toks[:, S:],
                          torch.full((B,), S, dtype=torch.int32), caches)
    assert float((full - lg.float()).abs().max()) \
        < 0.05 * float(full.abs().max())


@pytest.mark.parametrize("arch", DENSE + RECURRENT + FAMILIES + [AUDIO])
@pytest.mark.parametrize("tokens", [128, 2048])
def test_arena_bytes_match_jax(arch, tokens):
    for cut in (lambda c: c, reduced):
        cfg = cut(get_config(arch))
        jcfg = (jax_reduced if cut is reduced else (lambda c: c))(
            jax_get_config(arch))
        got = ArenaSpec.from_model(cfg, tokens, 8, 32)
        want = JaxArenaSpec.from_model(jcfg, tokens, 8, 32)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
    if arch == "qwen2-7b" and tokens == 2048:   # 28 x 2 x 4 x 128 x 2 B
        full = ArenaSpec.from_model(get_config(arch), tokens, 8, 32)
        assert full.bytes_per_partition == 57_344 * 2048 == 117_440_512
    if arch == "mamba2-780m":   # 48 x (48 x 64 x 128 + 3 x (3072 + 256)) x 2
        full = ArenaSpec.from_model(get_config(arch), tokens, 8, 32)
        assert full.bytes_per_partition == 38_707_200
    if arch == "recurrentgemma-2b":
        full = ArenaSpec.from_model(get_config(arch), tokens, 8, 32)
        assert full.bytes_per_partition == {128: 1_417_216,
                                            2048: 17_145_856}[tokens]
    # 2 K/V x Hkv 8 x 2 B x Dh per layer and token; gemma2's local ring is
    # min(tokens, 4096) slots, mixtral's sliding ring min(tokens, 4096)
    want = {"gemma2-9b": 42 * 2 * 8 * 256 * 2 * tokens,
            "mixtral-8x7b": 32 * 2 * 8 * 128 * 2 * tokens,
            "dbrx-132b": 40 * 2 * 8 * 128 * 2 * tokens,
            "qwen2-vl-72b": 80 * 2 * 8 * 128 * 2 * tokens,
            # self K/V over the tokens + cross K/V over 1024 source frames
            AUDIO: 12 * 2 * 16 * 64 * 2 * (tokens + 1024)}.get(arch)
    if want is not None:
        full = ArenaSpec.from_model(get_config(arch), tokens, 8, 32)
        assert full.bytes_per_partition == want
        if tokens == 2048:
            assert want == {"gemma2-9b": 704_643_072,
                            "mixtral-8x7b": 268_435_456,
                            "dbrx-132b": 335_544_320,
                            "qwen2-vl-72b": 671_088_640,
                            AUDIO: 150_994_944}[arch]


@pytest.mark.parametrize("arch", DENSE + RECURRENT + FAMILIES + [AUDIO])
def test_param_specs_match_jax(arch):
    """Full-width spec trees (no allocation): same leaves in the same
    tree-flatten order, same shapes, same dtypes and init scales."""
    from repro.models.layers import tree_map_specs as jmap
    want = []
    jmap(want.append, JM.param_specs(jax_get_config(arch)))
    got = tree_flatten(M.param_specs(get_config(arch)))[0]
    jleaves = jax.tree.leaves(JM.param_specs(jax_get_config(arch)),
                              is_leaf=lambda x: hasattr(x, "init"))
    assert len(got) == len(want) == len(jleaves)
    for g, j in zip(got, jleaves):
        assert (g.shape, str(g.dtype).removeprefix("torch."), g.init,
                g.scale) == (j.shape, str(np.dtype(j.dtype)), j.init,
                             j.scale)
    assert get_config(arch).param_count() == \
        jax_get_config(arch).param_count()


# ------------------------------------------------- row-wise cache utilities


def _caches(rows=4, t=16, seed=0):
    cfg = reduced(get_config("qwen2-7b"))
    caches = M.init_caches(cfg, rows, t, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    for x in tree_leaves(caches):
        x.copy_(torch.randn(x.shape, generator=gen))
    return cfg, caches


def test_slice_rows_copies_into_fresh_storage():
    _cfg, caches = _caches()
    old = {x.untyped_storage().data_ptr() for x in tree_leaves(caches)}
    small = M.cache_slice_rows(caches, 2)
    assert M.cache_num_rows(small) == 2
    for x, y in zip(tree_leaves(small), tree_leaves(caches)):
        assert x.untyped_storage().data_ptr() not in old
        assert x.untyped_storage().nbytes() == x.numel() * x.element_size()
        assert torch.equal(x, y[:, :2])


def test_grow_rows_zero_fills_new_rows():
    _cfg, caches = _caches()
    big = M.cache_grow_rows(caches, 6)
    for x, y in zip(tree_leaves(big), tree_leaves(caches)):
        assert x.shape[1] == 6 and torch.equal(x[:, :4], y)
        assert not x[:, 4:].any()


def test_read_write_row_round_trip():
    cfg, caches = _caches(seed=1)
    row = M.cache_read_row(caches, 2)
    assert M.cache_num_rows(row) == 1
    other = M.init_caches(cfg, 4, 16, device="cpu")
    assert M.cache_write_row(other, row, 3) is other
    for x, y in zip(tree_leaves(other), tree_leaves(caches)):
        assert torch.equal(x[:, 3], y[:, 2]) and not x[:, :3].any()
