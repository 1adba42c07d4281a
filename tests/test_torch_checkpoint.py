"""The port's checkpoints (``repro_torch.training.checkpoint``) and its
fault-tolerant launcher (``repro_torch.launch.train``), the twin of
``tests/test_checkpoint.py`` without the mesh case (a sharded restore
waits for ROADMAP item 13): atomic manifest commits, async saves, resume
after a crash, and the on-disk format shared with the JAX package, so a
checkpoint written by either package restores in the other bit for bit."""
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models import model as JM
from repro.training import checkpoint as jax_ckpt
from repro.training import optimizer as JO
from repro.training import train_step as JT
from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import state_from_numpy
from repro_torch.launch.train import train
from repro_torch.models import model as M
from repro_torch.models.layers import tree_leaves
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as O
from repro_torch.training import train_step as T

torch.set_num_threads(1)


def _bytes(x):
    if isinstance(x, torch.Tensor):
        return x.reshape(-1).contiguous().view(torch.uint8).numpy().tobytes()
    return np.asarray(x).tobytes()


def test_atomic_commit_ignores_partial(tmp_path):
    d = str(tmp_path)
    state = {"a": torch.arange(4.0),
             "b": {"c": torch.ones((2, 2), dtype=torch.bfloat16)}}
    ckpt.save(d, 10, state)
    os.makedirs(os.path.join(d, "step_20"))      # a crashed save
    os.makedirs(os.path.join(d, "step_30.tmp"))
    assert ckpt.latest(d) == 10
    got = ckpt.restore(d, 10, state)
    assert torch.equal(got["a"], state["a"])
    assert got["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(got["b"]["c"], state["b"]["c"])


def test_async_save_overlaps(tmp_path):
    d = str(tmp_path)
    t = ckpt.save(d, 5, {"x": torch.ones(8)}, blocking=False)
    t.join(timeout=60)
    assert not t.is_alive()
    assert ckpt.latest(d) == 5


def test_async_save_holds_the_values_at_the_call(tmp_path):
    """The leaves are copied to host memory before the writer starts, so
    an in-place update right after the call does not reach the file."""
    d = str(tmp_path)
    x = torch.arange(1 << 16, dtype=torch.float32)
    t = ckpt.save(d, 1, {"x": x}, blocking=False)
    x.add_(1.0)
    t.join(timeout=60)
    assert not t.is_alive()
    got = ckpt.restore(d, 1, {"x": x})["x"]
    assert torch.equal(got, torch.arange(1 << 16, dtype=torch.float32))


def test_restore_onto_a_device(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 2, {"w": torch.arange(6, dtype=torch.int32)})
    got = ckpt.restore(d, 2, {"w": None}, device="cpu")
    assert got["w"].device.type == "cpu" and got["w"].dtype == torch.int32


def test_crash_resume_continuity(tmp_path):
    """Train 12 steps with a crash at step 8; resume must complete and the
    final state must equal an uninterrupted run (pure-function data
    pipeline + step-indexed checkpoints)."""
    d = str(tmp_path / "ck")
    kw = dict(steps=12, batch=2, seq=16, log_every=100, device="cpu")
    with pytest.raises(RuntimeError, match="injected failure"):
        train("qwen2-1.5b", ckpt_dir=d, ckpt_every=4, fail_at_step=8, **kw)
    # the async step-8 save may or may not have committed before the crash
    # (both are legal); either way resume must reach the clean-run state
    assert ckpt.latest(d) in (4, 8)
    resumed, _ = train("qwen2-1.5b", ckpt_dir=d, ckpt_every=4, resume=True,
                       **kw)
    clean, _ = train("qwen2-1.5b", ckpt_dir=str(tmp_path / "clean"),
                     ckpt_every=100, **kw)
    for a, b in zip(tree_leaves(resumed["params"]),
                    tree_leaves(clean["params"]), strict=True):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   atol=1e-2, rtol=1e-2)
    assert int(resumed["opt"]["step"]) == int(clean["opt"]["step"]) == 12


@pytest.fixture(scope="module")
def jax_state():
    """Reduced tinyllama after one JAX train step: bf16 params, f32 norm
    scales, master, m and v, and an int32 step counter."""
    jcfg = jax_reduced(jax_get_config("tinyllama-1.1b"))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
    state, _ = jax.jit(JT.make_train_step(jcfg))(
        {"params": jp, "opt": JO.init_opt_state(jp)},
        JT.make_batch_labels(jax.numpy.asarray(toks)))
    return jax.device_get(state)


def test_jax_checkpoint_restores_in_the_port(tmp_path, jax_state):
    d = str(tmp_path)
    jax_ckpt.save(d, 1, jax_state)
    cfg = reduced(get_config("tinyllama-1.1b"))
    p = M.init_params(cfg, 1, device="cpu")     # the port's own template
    template = {"params": p, "opt": O.init_opt_state(p)}
    assert ckpt.latest(d) == 1
    got = ckpt.restore(d, 1, template)
    want = jax.tree.leaves(jax_state)
    assert len(tree_leaves(got)) == len(want)
    for t, j in zip(tree_leaves(got), want, strict=True):
        assert tuple(t.shape) == j.shape
        assert _bytes(t) == _bytes(j)
    assert got["params"]["embed"]["tok"].dtype == torch.bfloat16
    assert int(got["opt"]["step"]) == 1


def test_port_checkpoint_restores_in_jax(tmp_path, jax_state):
    d = str(tmp_path)
    state = state_from_numpy(jax_state, "cpu")
    cfg = reduced(get_config("tinyllama-1.1b"))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(2, 16)).astype(np.int32))
    state, _ = T.make_train_step(cfg)(state, T.make_batch_labels(toks))
    ckpt.save(d, 2, state)
    assert jax_ckpt.latest(d) == 2
    got = jax_ckpt.restore(d, 2, jax_state)
    for t, j in zip(tree_leaves(state), jax.tree.leaves(got), strict=True):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
        assert _bytes(t) == _bytes(j)
    assert int(got["opt"]["step"]) == 2
