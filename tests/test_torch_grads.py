"""Autograd through the port's model families against ``jax.grad``
through the JAX package's, on the reduced configs with the JAX parameters
moved across by ``repro_torch.convert`` and a numpy-made batch.  The port's
model code writes some tensors in place on the train path (the chunked
attention's output tiles, MoE dispatch's ``index_copy_``, the vision
stub's slice assignment), so each family's gradients are held to JAX's;
gemma2 also runs with the chunk sizes patched small in both packages, so
that its train forward goes through the chunked attention.  tinyllama and
seamless are checked in ``test_torch_training.py``, mamba2 and
recurrentgemma in ``test_torch_recurrent_grads.py``.

Tolerances: each leaf's gradient within 5e-2 of the norm of JAX's, the
loss within 2e-2 (both packages round bf16 activations at other places;
the errors seen are near 1e-2 on every family, MoE included)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models import attention as jax_attn
from repro.models import model as JM
from repro.training import train_step as JT
from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import tree_from_numpy
from repro_torch.models import attention as attn
from repro_torch.models.layers import tree_leaves
from repro_torch.training import train_step as T

torch.set_num_threads(1)


def _batch(cfg, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    out = {"tokens": toks,
           "labels": np.concatenate([toks[:, 1:], toks[:, :1]], axis=1)}
    if cfg.family == "vlm":
        out["vision_embeds"] = rng.standard_normal(
            (b, cfg.vision_stub_tokens, cfg.d_model)).astype(np.float32)
    return out


def check_grads_match_jax(arch):
    jcfg = jax_reduced(jax_get_config(arch))
    cfg = reduced(get_config(arch))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    batch = _batch(cfg)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: JT._loss_fn(
        jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()})))(jp)
    tl, tg = T.value_and_grad(
        cfg, tree_from_numpy(jax.device_get(jp), "cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(tl) - float(jl)) < 2e-2
    errs = []
    for t, j in zip(tree_leaves(tg), jax.tree.leaves(jg), strict=True):
        assert t.dtype == {jnp.bfloat16: torch.bfloat16,
                           jnp.float32: torch.float32}[j.dtype.type]
        t = t.float().numpy()
        j = np.asarray(jnp.asarray(j, jnp.float32))
        assert t.shape == j.shape
        errs.append(float(np.linalg.norm(t - j) / (np.linalg.norm(j)
                                                   + 1e-12)))
    assert max(errs) < 5e-2, errs


@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen2-1.5b", "gemma2-9b",
                                  "mixtral-8x7b", "dbrx-132b",
                                  "qwen2-vl-72b"])
def test_grads_match_jax_grad(arch):
    check_grads_match_jax(arch)


def test_chunked_attention_grads_match_jax(monkeypatch):
    """gemma2 (logit cap 50, local window 8) over 16 tokens in 8 x 8 tiles:
    the train forward takes ``_chunked_attention`` in every block."""
    for mod in (attn, jax_attn):
        monkeypatch.setattr(mod, "FLASH_SEQ", 16)
        monkeypatch.setattr(mod, "Q_CHUNK", 8)
        monkeypatch.setattr(mod, "KV_CHUNK", 8)
    calls = []
    chunked = attn._chunked_attention
    monkeypatch.setattr(attn, "_chunked_attention",
                        lambda *a: calls.append(1) or chunked(*a))
    check_grads_match_jax("gemma2-9b")
    assert len(calls) == 2 * reduced(get_config("gemma2-9b")).num_layers
