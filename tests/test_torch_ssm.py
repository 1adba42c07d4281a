"""The port's mamba2 block (``repro_torch.models.ssm``) against the JAX
package's (``repro.models.ssm``) on the same inputs, made with numpy from a
seed, and the whole reduced mamba2 model against the JAX model.

Tolerances, each stated where it is used:
  * layer functions in f32: 1e-4 of the largest value (the same arithmetic,
    summed in another order; the SSD chunk sums run over up to 256 terms);
  * the bf16 state a block leaves in its cache: one bf16 step (2**-8) of
    the largest state value, since a value near a rounding boundary may
    round either way after f32 sums in another order;
  * model logits in bf16: 2e-2 of the largest logit (``test_torch_model``);
    decode against the full forward: 5e-2 (``tests/test_decode_consistency``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import ssm as JS
from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import tree_from_numpy
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import ssm as S

torch.set_num_threads(1)
TOL = 1e-4
ARCH = "mamba2-780m"


def _close(got, want, tol=TOL):
    g = got.detach().float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    assert g.shape == w.shape
    err = float(np.abs(g - w).max())
    assert err <= tol * (float(np.abs(w).max()) + 1e-9), err


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def np_params(spec_tree, seed):
    """f32 numpy weights for a JAX spec tree: the fan-in normal rule, the
    mamba2 ``a_log``/``dt_bias`` ranges, and non-trivial norms and biases."""
    rng = np.random.default_rng(seed)

    def mk(s):
        if s.init == "a_log":
            return np.log(rng.uniform(1.0, 16.0, s.shape)).astype(np.float32)
        if s.init == "dt_bias":
            dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), s.shape))
            return (dt + np.log(-np.expm1(-dt))).astype(np.float32)
        if s.init == "ones":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(
                np.float32)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        return (rng.standard_normal(s.shape) * s.scale
                / np.sqrt(fan_in)).astype(np.float32)
    return JL.tree_map_specs(mk, spec_tree)


def _both(tree):
    return jax.tree.map(jnp.asarray, tree), tree_from_numpy(tree, "cpu")


@pytest.fixture(scope="module")
def cfgs():
    return jax_reduced(jax_get_config(ARCH)), reduced(get_config(ARCH))


# --------------------------------------------------------- layer functions


@pytest.mark.parametrize("s", [12, 512])
def test_ssd_chunked_matches_jax(s):
    """One chunk (S = 12) and two chunks of 256 (S = 512), f32."""
    b, h, p, n = 2, 4, 8, 16
    rng = np.random.default_rng(s)
    x = _x((b, s, h, p), 1)
    dt = rng.uniform(1e-3, 0.1, (b, s, h)).astype(np.float32)
    a = -rng.uniform(1.0, 16.0, (h,)).astype(np.float32)
    bm, cm = _x((b, s, h, n), 2), _x((b, s, h, n), 3)
    h0 = _x((b, h, p, n), 4)
    jy, jh = JS.ssd_chunked(*map(jnp.asarray, (x, dt, a, bm, cm, h0)))
    ty, th = S.ssd_chunked(*map(torch.from_numpy, (x, dt, a, bm, cm, h0)))
    _close(ty, jy)
    _close(th, jh)


def test_ssd_chunked_refuses_a_ragged_length():
    x = torch.zeros((1, 300, 2, 4))
    with pytest.raises(AssertionError):
        S.ssd_chunked(x, torch.zeros((1, 300, 2)), torch.ones(2),
                      torch.zeros((1, 300, 2, 3)), torch.zeros((1, 300, 2, 3)),
                      torch.zeros((1, 2, 4, 3)))


def test_causal_conv_and_conv_step_match_jax():
    w, c = 4, 24
    pw = {"w": _x((w, c), 5), "b": _x((c,), 6)}
    pj, pt = _both(pw)
    x = _x((2, 9, c), 7)
    _close(S._causal_conv(pt, torch.from_numpy(x)),
           JS._causal_conv(pj, jnp.asarray(x)))
    hist, xt = _x((2, w - 1, c), 8), _x((2, c), 9)
    ty, th = S._conv_step(pt, torch.from_numpy(hist), torch.from_numpy(xt))
    jy, jh = JS._conv_step(pj, jnp.asarray(hist), jnp.asarray(xt))
    _close(ty, jy)
    _close(th, jh)


def test_conv_step_continues_the_causal_conv():
    """Decoding token S with the last w-1 inputs as history gives the
    causal conv's output at S (the cache handoff prefill -> decode)."""
    w, c = 4, 8
    pt = tree_from_numpy({"w": _x((w, c), 10), "b": _x((c,), 11)}, "cpu")
    x = torch.from_numpy(_x((1, 10, c), 12))
    full = S._causal_conv(pt, x)
    y, _ = S._conv_step(pt, x[:, 6:9], x[:, 9])
    torch.testing.assert_close(y, full[:, 9], atol=1e-6, rtol=1e-6)


def _state_close(got, want):
    w = np.asarray(jnp.asarray(want, jnp.float32))
    err = float(np.abs(got.float().numpy() - w).max())
    assert err <= 2.0 ** -8 * float(np.abs(w).max()), err


def test_ssm_block_prefill_then_decode_matches_jax(cfgs):
    """Prefill fills the cache in place (state rounded to bf16, conv
    tails); decode from one shared cache gives the same output and the
    same new cache, leaf by leaf."""
    jcfg, cfg = cfgs
    pj, pt = _both(np_params(JS.ssm_spec(jcfg), 0))
    b, s = 2, 12
    u = _x((b, s, cfg.d_model), 1)
    jy, jc = JS.ssm_block(jcfg, pj, jnp.asarray(u), mode="prefill")
    tc = {k: torch.zeros(v.shape, dtype=torch.float32) for k, v in
          L.tree_map_specs(lambda sp: sp, S.make_ssm_cache_spec(
              cfg, b)).items()}
    ty, tc2 = S.ssm_block(cfg, pt, torch.from_numpy(u), mode="prefill",
                          cache=tc)
    assert tc2 is tc
    _close(ty, jy)
    assert set(tc) == set(jc)
    _state_close(tc["state"], jc["state"])
    for k in ("conv_x", "conv_B", "conv_C"):
        _close(tc[k], jc[k])
    # decode from JAX's cache on both sides
    shared = {k: np.asarray(jnp.asarray(v, jnp.float32))
              for k, v in jc.items()}
    tc = {k: torch.from_numpy(v.copy()) for k, v in shared.items()}
    ut = _x((b, 1, cfg.d_model), 2)
    jy, jc = JS.ssm_block(jcfg, pj, jnp.asarray(ut), mode="decode",
                          cache={k: jnp.asarray(v) for k, v in
                                 shared.items()})
    ty, _ = S.ssm_block(cfg, pt, torch.from_numpy(ut), mode="decode",
                        cache=tc)
    _close(ty, jy)
    _state_close(tc["state"], jc["state"])
    for k in ("conv_x", "conv_B", "conv_C"):
        _close(tc[k], jc[k])


def test_ssm_train_prefill_outputs_agree(cfgs):
    """The train and prefill modes give the same output."""
    _jcfg, cfg = cfgs
    pt = tree_from_numpy(np_params(JS.ssm_spec(_jcfg), 3), "cpu")
    u = torch.from_numpy(_x((1, 8, cfg.d_model), 4))
    cache = L.materialize(S.make_ssm_cache_spec(cfg, 1), device="cpu")
    yt, _ = S.ssm_block(cfg, pt, u, mode="train")
    yp, _ = S.ssm_block(cfg, pt, u, mode="prefill", cache=cache)
    torch.testing.assert_close(yt, yp, atol=0, rtol=0)


# --------------------------------------------------------- initialisation


def test_a_log_and_dt_bias_draws_lie_in_their_ranges():
    """``A_log`` is log U[1, 16]; ``dt_bias`` inverts softplus on a
    log-uniform dt in [1e-3, 0.1]; both come from the one generator."""
    spec = {"A_log": L.ParamSpec((4096,), L.f32, init="a_log"),
            "dt_bias": L.ParamSpec((4096,), L.f32, init="dt_bias")}
    p = L.materialize(spec, 0, device="cpu")
    a = torch.exp(p["A_log"])
    assert float(a.min()) >= 1.0 and float(a.max()) <= 16.0
    assert float(a.max()) - float(a.min()) > 14.0
    dt = torch.nn.functional.softplus(p["dt_bias"].double())
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 0.1 * (1 + 1e-5)
    # log-uniform: the median dt is near the geometric mean 1e-2
    assert 5e-3 < float(dt.median()) < 2e-2
    again = L.materialize(spec, 0, device="cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)
    other = L.materialize(spec, 1, device="cpu")
    assert not torch.equal(p["A_log"], other["A_log"])


def test_init_params_draws_every_leaf(cfgs):
    _jcfg, cfg = cfgs
    params = M.init_params(cfg, 0, device="cpu")
    mixer = params["decoder"]["groups"][0]["mixer"]
    a = torch.exp(mixer["A_log"])
    assert a.shape == (cfg.n_groups, cfg.ssm_nheads)
    assert bool(((a >= 1) & (a <= 16)).all())
    assert bool(torch.isfinite(mixer["dt_bias"]).all())


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


def test_two_chunk_prefill_matches_jax(model):
    """A 512-token prompt runs two SSD chunks of 256; the prefill logits
    and the cache (bf16) agree with the JAX model within 2e-2."""
    jcfg, cfg, jp, tp = model
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, size=(1, 512)).astype(np.int32)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                        JM.init_caches(jcfg, 1, 8))
    tl, tc = M.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)},
                       M.init_caches(cfg, 1, 8, device="cpu"))
    assert _rel_err(tl, jl) < 2e-2
    for t, j in zip(L.tree_leaves(tc), jax.tree.leaves(jc)):
        assert _rel_err(t, j) < 2e-2


def test_decode_matches_forward(model):
    """Prefill S tokens then decode one against the full forward at S."""
    _jcfg, cfg, _jp, tp = model
    b, s = 2, 12
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, size=(b, s + 1)).astype(np.int32))
    full = M.forward_train(cfg, tp, {"tokens": toks})[:, s].float()
    caches = M.init_caches(cfg, b, 32, device="cpu")
    _, caches = M.prefill(cfg, tp, {"tokens": toks[:, :s]}, caches)
    lg, _ = M.decode_step(cfg, tp, toks[:, s:],
                          torch.full((b,), s, dtype=torch.int32), caches)
    assert float((full - lg.float()).abs().max()) \
        < 0.05 * float(full.abs().max())


def test_cache_rows_are_constant_in_context(model):
    """A mamba2 partition's bytes do not depend on its token budget."""
    _jcfg, cfg, _jp, _tp = model
    from repro_torch.core.arena import state_bytes_for_tokens
    assert state_bytes_for_tokens(cfg, 128) == \
        state_bytes_for_tokens(cfg, 2048) == \
        state_bytes_for_tokens(cfg, 500_000)
