"""Per-architecture smoke tests of the port, the twin of
``tests/test_archs.py``: every config of ``list_archs()`` builds its
reduced same-family config, runs the train forward with the expected shape
and no NaN, and takes one train step with a finite loss and a non-zero
gradient norm, on the CPU."""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config, list_archs, reduced
from repro_torch.models import model as M
from repro_torch.models.layers import padded_vocab, tree_leaves
from repro_torch.training.optimizer import init_opt_state
from repro_torch.training.train_step import make_batch_labels, make_train_step

torch.set_num_threads(1)
B, S = 2, 16


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    batch = make_batch_labels(torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)))
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.encoder_src_len, cfg.d_model)).astype(np.float32))
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.vision_stub_tokens, cfg.d_model)).astype(np.float32))
    return batch


def test_every_arch_is_listed():
    assert len(list_archs()) == 10
    assert "seamless-m4t-medium" in list_archs()


@pytest.mark.parametrize("arch", list_archs())
def test_forward_shapes_no_nans(arch):
    cfg = reduced(get_config(arch))
    params = M.init_params(cfg, 0, device="cpu")
    logits = M.forward_train(cfg, params, _batch(cfg), remat=False)
    assert tuple(logits.shape) == (B, S, padded_vocab(cfg))
    assert not bool(torch.isnan(logits).any())


@pytest.mark.parametrize("arch", list_archs())
def test_one_train_step(arch):
    cfg = reduced(get_config(arch))
    params = M.init_params(cfg, 0, device="cpu")
    before = [x.clone() for x in tree_leaves(params)]
    state = {"params": params, "opt": init_opt_state(params)}
    state, metrics = make_train_step(cfg)(state, _batch(cfg))
    assert bool(torch.isfinite(metrics["loss"]))
    assert float(metrics["grad_norm"]) > 0
    after = tree_leaves(state["params"])
    assert any(not torch.equal(a, b) for a, b in zip(after, before))
