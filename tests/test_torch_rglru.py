"""The port's RG-LRU block (``repro_torch.models.rglru``) against the JAX
package's (``repro.models.rglru``) on the same inputs, made with numpy from
a seed, and the whole reduced recurrentgemma model (rglru, rglru, local
attention with a ring cache, scaled embeddings) against the JAX model.

Tolerances, each stated where it is used:
  * layer functions in f32: 1e-4 of the largest value (the doubling scan
    multiplies in another order than ``jax.lax.associative_scan``);
  * the bf16 state a block leaves in its cache: one bf16 step (2**-8) of
    the largest state value;
  * model logits and caches in bf16: 2e-2 of the largest value
    (``test_torch_model``); decode against the full forward: 5e-2
    (``tests/test_decode_consistency``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models import model as JM
from repro.models import rglru as JR
from repro.models import transformer as JT
from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import tree_from_numpy
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import rglru as R
from repro_torch.models import transformer as T

from test_torch_ssm import _both, _close, _state_close, _x, np_params

torch.set_num_threads(1)
ARCH = "recurrentgemma-2b"
B = 2


@pytest.fixture(scope="module")
def cfgs():
    return jax_reduced(jax_get_config(ARCH)), reduced(get_config(ARCH))


# --------------------------------------------------------- layer functions


@pytest.mark.parametrize("s", [1, 2, 7, 64, 300])
def test_linear_scan_equals_the_sequential_recurrence(s):
    """The doubling scan against h_t = a_t h_{t-1} + b_t step by step, in
    f64 so that only the algorithm is compared (1e-12)."""
    rng = np.random.default_rng(s)
    a = torch.from_numpy(rng.uniform(0.0, 1.0, (2, s, 5)))
    b = torch.from_numpy(rng.standard_normal((2, s, 5)))
    h, want = torch.zeros((2, 5), dtype=torch.float64), []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(R.linear_scan(a, b), torch.stack(want, 1),
                               atol=1e-12, rtol=1e-12)


def test_conv_gates_and_coefficients_match_jax(cfgs):
    jcfg, cfg = cfgs
    pj, pt = _both(np_params(JR.rglru_spec(jcfg), 0))
    x = _x((B, 9, cfg.lru_width), 1)
    _close(R._conv(pt["conv"], torch.from_numpy(x)),
           JR._conv(pj["conv"], jnp.asarray(x)))
    for got, want in zip(R._gates(pt, torch.from_numpy(x), cfg.num_heads),
                         JR._gates(pj, jnp.asarray(x), cfg.num_heads)):
        _close(got, want)
    for got, want in zip(
            R._lru_coeffs(pt, torch.from_numpy(x), cfg.num_heads),
            JR._lru_coeffs(pj, jnp.asarray(x), cfg.num_heads)):
        _close(got, want)


def test_gates_take_bf16_weights_against_f32_activations(cfgs):
    """The model's gate weights are bf16 and the activations f32: the
    weights are cast up (JAX promotes), never the activations down."""
    jcfg, cfg = cfgs
    tree = np_params(JR.rglru_spec(jcfg), 2)
    pj, pt = _both(tree)
    for g in ("gate_i", "gate_r"):
        pj[g]["w"] = pj[g]["w"].astype(jnp.bfloat16)
        pt[g]["w"] = pt[g]["w"].to(torch.bfloat16)
    x = _x((B, 3, cfg.lru_width), 3)
    for got, want in zip(R._gates(pt, torch.from_numpy(x), cfg.num_heads),
                         JR._gates(pj, jnp.asarray(x), cfg.num_heads)):
        assert got.dtype == torch.float32
        _close(got, want)


def _zero_cache(cfg):
    return {k: torch.zeros(sp.shape, dtype=torch.float32)
            for k, sp in R.make_rglru_cache_spec(cfg, B).items()}


@pytest.mark.parametrize("s", [12, 100])
def test_rglru_block_prefill_then_decode_matches_jax(cfgs, s):
    """Prefill (the scan) fills the cache in place; decode from one shared
    cache gives the same output and the same new cache, leaf by leaf."""
    jcfg, cfg = cfgs
    pj, pt = _both(np_params(JR.rglru_spec(jcfg), 4))
    u = _x((B, s, cfg.d_model), 5)
    jy, jc = JR.rglru_block(jcfg, pj, jnp.asarray(u), mode="prefill")
    tc = _zero_cache(cfg)
    ty, tc2 = R.rglru_block(cfg, pt, torch.from_numpy(u), mode="prefill",
                            cache=tc)
    assert tc2 is tc and set(tc) == set(jc)
    _close(ty, jy)
    _state_close(tc["state"], jc["state"])
    _close(tc["conv"], jc["conv"])
    shared = {k: np.asarray(jnp.asarray(v, jnp.float32))
              for k, v in jc.items()}
    tc = {k: torch.from_numpy(v.copy()) for k, v in shared.items()}
    ut = _x((B, 1, cfg.d_model), 6)
    jy, jc = JR.rglru_block(jcfg, pj, jnp.asarray(ut), mode="decode",
                            cache={k: jnp.asarray(v)
                                   for k, v in shared.items()})
    ty, _ = R.rglru_block(cfg, pt, torch.from_numpy(ut), mode="decode",
                          cache=tc)
    _close(ty, jy)
    _state_close(tc["state"], jc["state"])
    _close(tc["conv"], jc["conv"])


def test_rglru_decode_continues_the_prefill_scan(cfgs):
    """Prefill of S tokens then one decode step gives the train output at
    token S (f32 cache, so only the state's bf16 rounding separates them:
    1e-2 of the largest output)."""
    _jcfg, cfg = cfgs
    pt = tree_from_numpy(np_params(JR.rglru_spec(_jcfg), 7), "cpu")
    u = torch.from_numpy(_x((B, 13, cfg.d_model), 8))
    full, _ = R.rglru_block(cfg, pt, u, mode="train")
    cache = _zero_cache(cfg)
    R.rglru_block(cfg, pt, u[:, :12], mode="prefill", cache=cache)
    y, _ = R.rglru_block(cfg, pt, u[:, 12:], mode="decode", cache=cache)
    err = float((y[:, 0] - full[:, 12]).abs().max())
    assert err <= 1e-2 * float(full[:, 12].abs().max()), err


# ------------------------------------------------------ embedding scale


@pytest.mark.parametrize("arch", [ARCH, "qwen2-7b"])
def test_embed_scale_rounds_in_the_activation_dtype(arch):
    """Full-width d_model: recurrentgemma scales by sqrt(2560) rounded to
    bf16 (50.5), bit for bit as the JAX package; qwen2 does not scale."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    table = _x((6, cfg.d_model), 9)
    tj = jnp.asarray(table, jnp.bfloat16)
    tt = torch.from_numpy(table).to(torch.bfloat16)
    toks = np.asarray([[0, 5, 3]], np.int32)
    want = JT.embed_tokens(jcfg, {"tok": tj}, jnp.asarray(toks))
    got = T.embed_tokens(cfg, {"tok": tt}, torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(),
                          np.asarray(want).view(np.int16))
    if cfg.scale_embeddings:
        assert torch.equal(got[0, 0], (tt[0] * 50.5).to(torch.bfloat16))


# --------------------------------------------------------- the whole model


@pytest.fixture(scope="module")
def model(cfgs):
    jcfg, cfg = cfgs
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, tree_from_numpy(jax.device_get(jp), "cpu")


def _rel_err(got, want):
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    return float(np.abs(g - w).max() / (np.abs(w).max() + 1e-9))


def test_cache_tree_mixes_stacked_and_tail_leaves(model):
    """Groups (rglru, rglru, local) stack n_groups on axis 0 with the
    batch on axis 1; the two tail rglru blocks keep the batch on axis 0;
    the local blocks' ring holds the window."""
    _jcfg, cfg, _jp, _tp = model
    caches = M.init_caches(cfg, 3, 32, device="cpu")
    g0, g2 = caches["groups"][0], caches["groups"][2]
    assert g0["state"].shape == (cfg.n_groups, 3, cfg.lru_width)
    assert g2["k"].shape == (cfg.n_groups, 3, cfg.local_window,
                             cfg.num_kv_heads, cfg.head_dim)
    assert [t["state"].shape for t in caches["tail"]] == \
        [(3, cfg.lru_width)] * 2
    assert M.cache_num_rows(caches) == 3
    leaves, axes, _ = M.cache_flat_axes(caches)
    assert axes == [1] * 6 + [0] * 4 and len(leaves) == 10


def test_decode_matches_forward(model):
    _jcfg, cfg, _jp, tp = model
    s = 12
    toks = torch.from_numpy(np.random.default_rng(10).integers(
        0, cfg.vocab_size, size=(B, s + 1)).astype(np.int32))
    full = M.forward_train(cfg, tp, {"tokens": toks})[:, s].float()
    caches = M.init_caches(cfg, B, 32, device="cpu")
    _, caches = M.prefill(cfg, tp, {"tokens": toks[:, :s]}, caches)
    lg, _ = M.decode_step(cfg, tp, toks[:, s:],
                          torch.full((B,), s, dtype=torch.int32), caches)
    assert float((full - lg.float()).abs().max()) \
        < 0.05 * float(full.abs().max())


def test_ring_cache_beyond_window_matches_jax(model):
    """The twin of ``tests/test_decode_consistency.py``'s ring test:
    prefill 12 tokens, then decode 20 steps, well past the window of 8,
    on the tokens the JAX model picks.  Logits stay finite and within
    2e-2 of JAX's at every step; the local blocks' ring keeps only the
    window, and every cache leaf agrees with JAX's at the end."""
    jcfg, cfg, jp, tp = model
    toks = np.random.default_rng(11).integers(
        0, cfg.vocab_size, size=(B, 12)).astype(np.int32)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                        JM.init_caches(jcfg, B, 16))
    tl, tc = M.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)},
                       M.init_caches(cfg, B, 16, device="cpu"))
    assert _rel_err(tl, jl) < 2e-2
    for i in range(20):
        nxt = np.array(jnp.argmax(jl, -1)[:, None].astype(jnp.int32))
        pos = np.full((B,), 12 + i, np.int32)
        jl, jc = JM.decode_step(jcfg, jp, jnp.asarray(nxt),
                                jnp.asarray(pos), jc)
        tl, tc = M.decode_step(cfg, tp, torch.from_numpy(nxt),
                               torch.from_numpy(pos), tc)
        assert bool(torch.isfinite(tl.float()).all())
        assert _rel_err(tl, jl) < 2e-2, i
    assert tc["groups"][2]["k"].shape[2] == cfg.local_window == 8
    for t, j in zip(L.tree_leaves(tc), jax.tree.leaves(jc)):
        assert t.shape == j.shape and _rel_err(t, j) < 2e-2
