"""The port's training path (``repro_torch.training``, the loss in
``repro_torch.models.layers``) against the JAX package's on the same
inputs: numpy-made logits, labels and gradients, and the JAX parameters and
optimizer state moved across by ``repro_torch.convert``.

Tolerances, each stated where it is used:
  * the loss on f32 logits: 1e-5 of its value (the same f32 arithmetic,
    summed in another order);
  * AdamW on identical f32 gradients: master, m and v within 1e-5 of each
    leaf's largest value (f32 elementwise arithmetic in the same order; a
    last-place difference of an operand shows as a large relative error
    where ``w - lr * u`` cancels near zero); the step and the learning
    rate exactly; the bf16
    params within one bf16 step (at most 2**-7 of the value) of JAX's,
    since a master value near a rounding boundary may round either way;
  * autograd against ``jax.grad`` through the bf16 models: each leaf's
    gradient within 5e-2 of its norm, the loss within 2e-2 (both packages
    round bf16 activations at other places);
  * a whole step: loss within 2e-2, grad norm within 5e-2 relative, the
    bounds of ``tests/test_training.py``'s grad-accumulation check.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models import layers as JL
from repro.models import model as JM
from repro.training import optimizer as JO
from repro.training import train_step as JT
from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import state_from_numpy, tree_from_numpy
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.layers import tree_leaves
from repro_torch.training import optimizer as O
from repro_torch.training import train_step as T

torch.set_num_threads(1)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jax_state(jcfg, seed=0):
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    return {"params": jp, "opt": JO.init_opt_state(jp)}


def _batch(cfg, b=4, s=16, seed=0):
    """numpy batch: tokens, next-token labels and, for audio, frames."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    out = {"tokens": toks,
           "labels": np.concatenate([toks[:, 1:], toks[:, :1]], axis=1)}
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (b, cfg.encoder_src_len, cfg.d_model)).astype(np.float32)
    return out


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ------------------------------------------------------------------ loss


@pytest.mark.parametrize("vocab,cap", [(512, 0.0), (500, 0.0), (512, 30.0),
                                       (500, 30.0)])
def test_cross_entropy_matches_jax(vocab, cap):
    """Unpadded and padded vocabularies (500 pads to 2048, the padded
    entries biased by -1e9), with and without a final softcap."""
    cut = dict(vocab_size=vocab, final_logit_softcap=cap)
    jcfg = dataclasses.replace(jax_reduced(jax_get_config("qwen2-7b")), **cut)
    cfg = dataclasses.replace(reduced(get_config("qwen2-7b")), **cut)
    vp = L.padded_vocab(cfg)
    assert vp == JL.padded_vocab(jcfg) == (2048 if vocab == 500 else 512)
    rng = np.random.default_rng(vocab + int(cap))
    logits = (rng.standard_normal((2, 8, vp)) * 20).astype(np.float32)
    labels = rng.integers(0, vocab, size=(2, 8)).astype(np.int32)
    want = float(JL.cross_entropy(jcfg, jnp.asarray(logits),
                                  jnp.asarray(labels)))
    got = L.cross_entropy(cfg, torch.from_numpy(logits),
                          torch.from_numpy(labels))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-5 * abs(want)
    if vocab == 500:
        assert (L.vocab_logit_bias(cfg) == JL.vocab_logit_bias(jcfg)).all()
    else:
        assert L.vocab_logit_bias(cfg) is None


# ------------------------------------------------------------- optimizer


def test_init_opt_state_owns_its_storage():
    cfg = reduced(get_config("tinyllama-1.1b"))
    params = M.init_params(cfg, 0, device="cpu")
    opt = O.init_opt_state(params)
    ptrs = [x.data_ptr() for x in tree_leaves(params)]
    for name in ("master", "m", "v"):
        assert all(x.dtype == torch.float32 for x in tree_leaves(opt[name]))
        ptrs += [x.data_ptr() for x in tree_leaves(opt[name])]
    assert len(set(ptrs)) == len(ptrs)       # f32 norm scales not aliased
    assert opt["step"].dtype == torch.int32 and int(opt["step"]) == 0


def test_apply_updates_matches_jax():
    """Three steps on identical f32 gradients, warmup 2 (the rate changes),
    the second step's gradients large enough to be clipped."""
    jcfg = jax_reduced(jax_get_config("tinyllama-1.1b"))
    opt_cfg = dict(lr=1e-2, warmup_steps=2)
    jopt, topt = JO.AdamWConfig(**opt_cfg), O.AdamWConfig(**opt_cfg)
    japply = jax.jit(lambda *a: JO.apply_updates(jopt, *a))
    js = _jax_state(jcfg)
    ts = state_from_numpy(jax.device_get(js), "cpu")
    rng = np.random.default_rng(5)
    for i, gscale in enumerate((0.01, 10.0, 0.1)):
        grads = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * gscale
                                        ).astype(np.float32), js["params"])
        jp, jo, jm = japply(js["params"], grads, js["opt"])
        js = {"params": jp, "opt": jo}
        params, opt, tm = O.apply_updates(topt, ts["params"],
                                          tree_from_numpy(grads, "cpu"),
                                          ts["opt"])
        assert params is ts["params"] and opt is ts["opt"]     # in place
        assert int(opt["step"]) == int(jo["step"]) == i + 1
        assert float(tm["lr"]) == float(jm["lr"])
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) \
            <= 1e-5 * float(jm["grad_norm"])
        for name in ("master", "m", "v"):
            for t, j in zip(tree_leaves(opt[name]), jax.tree.leaves(jo[name]),
                            strict=True):
                t, j = _np(t), _np(j)
                assert np.abs(t - j).max() <= 1e-5 * np.abs(j).max()
        for t, j in zip(tree_leaves(params), jax.tree.leaves(jp),
                        strict=True):
            assert t.dtype == {jnp.bfloat16: torch.bfloat16,
                               jnp.float32: torch.float32}[j.dtype.type]
            np.testing.assert_allclose(_np(t), _np(j), rtol=2 ** -7,
                                       atol=1e-12)


# ------------------------------------------------------------- gradients


@pytest.fixture(scope="module", params=["tinyllama-1.1b",
                                        "seamless-m4t-medium"])
def pair(request):
    jcfg = jax_reduced(jax_get_config(request.param))
    cfg = reduced(get_config(request.param))
    return jcfg, cfg, jax.device_get(_jax_state(jcfg))


def _leaf_errors(got, want):
    """Each leaf's gradient error over the norm of JAX's."""
    out = []
    for t, j in zip(tree_leaves(got), jax.tree.leaves(want), strict=True):
        t, j = _np(t), _np(j)
        assert t.shape == j.shape
        out.append(float(np.linalg.norm(t - j) / (np.linalg.norm(j) + 1e-12)))
    return out


def test_grads_match_jax_grad(pair):
    jcfg, cfg, state = pair
    batch = _batch(cfg)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: JT._loss_fn(jcfg, p, _jb(batch))))(state["params"])
    tl, tg = T.value_and_grad(cfg, tree_from_numpy(state["params"], "cpu"),
                              _tb(batch))
    assert abs(float(tl) - float(jl)) < 2e-2
    for g in tree_leaves(tg):
        assert g.dtype in (torch.bfloat16, torch.float32)
    errs = _leaf_errors(tg, jg)
    assert max(errs) < 5e-2, errs


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(pair, accum):
    jcfg, cfg, state = pair
    batch = _batch(cfg)
    _, jm = jax.jit(JT.make_train_step(jcfg, grad_accum=accum))(
        jax.tree.map(jnp.asarray, state), _jb(batch))
    ts = state_from_numpy(state, "cpu")
    ts, tm = T.make_train_step(cfg, grad_accum=accum)(ts, _tb(batch))
    assert abs(float(tm["loss"]) - float(jm["loss"])) < 2e-2
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) \
        < 5e-2 * float(jm["grad_norm"])
    assert int(ts["opt"]["step"]) == 1


def test_grad_accum_equivalence():
    """accum=2 against accum=1 on one global batch, in the port alone
    (``tests/test_training.py``'s bounds)."""
    cfg = reduced(get_config("qwen2-1.5b"))
    batch = _tb(_batch(cfg, b=4, s=16, seed=1))
    outs = {}
    for accum in (1, 2):
        params = M.init_params(cfg, 0, device="cpu")
        state = {"params": params, "opt": O.init_opt_state(params)}
        _, m = T.make_train_step(cfg, grad_accum=accum)(state, batch)
        outs[accum] = (float(m["loss"]), float(m["grad_norm"]))
    assert abs(outs[1][0] - outs[2][0]) < 2e-2
    assert abs(outs[1][1] - outs[2][1]) / (outs[1][1] + 1e-9) < 5e-2


def test_loss_decreases_and_master_stays_f32():
    cfg = reduced(get_config("tinyllama-1.1b"))
    params = M.init_params(cfg, 0, device="cpu")
    state = {"params": params, "opt": O.init_opt_state(params)}
    step = T.make_train_step(cfg, O.AdamWConfig(lr=3e-3, warmup_steps=1))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(4, 32)).astype(np.int32))
    batch = T.make_batch_labels(toks)            # fixed batch -> memorize
    losses = []
    for _ in range(20):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.8, losses[::5]
    assert all(x.dtype == torch.float32
               for x in tree_leaves(state["opt"]["master"]))
    assert all(x.dtype in (torch.bfloat16, torch.float32)
               for x in tree_leaves(state["params"]))
    assert not any(x.requires_grad for x in tree_leaves(state))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "seamless-m4t-medium"])
def test_remat_changes_neither_loss_nor_grads(arch):
    cfg = reduced(get_config(arch))
    params = M.init_params(cfg, 0, device="cpu")
    batch = _tb(_batch(cfg, seed=4))
    l0, g0 = T.value_and_grad(cfg, params, batch, remat=False)
    l1, g1 = T.value_and_grad(cfg, params, batch, remat=True)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g0),
                                                 tree_leaves(g1)))


def test_make_batch_labels_shifts_left():
    toks = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    b = T.make_batch_labels(toks)
    assert b["labels"].tolist() == [[1, 2, 0], [4, 5, 3]]
    want = JT.make_batch_labels(jnp.asarray(toks.numpy()))["labels"]
    assert b["labels"].tolist() == np.asarray(want).tolist()
