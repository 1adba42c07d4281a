"""The port's encoder-decoder family (``repro_torch.models.encdec``, the
audio branches of ``repro_torch.models.model``) against the JAX package's
on reduced seamless-m4t-medium (2 encoder and 2 decoder layers, d_model
64, 16 source frames), with the JAX parameters moved across by
``repro_torch.convert`` and the inputs made with numpy from a seed.

Tolerances: bf16 activations and logits within 2e-2 of the largest value
(the reduced-model bound of ``test_torch_model.py``: both packages round
bf16 at other places); blobs and cache layouts exactly; decode against the
port's own train forward within 5e-2 (``tests/test_decode_consistency``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models import encdec as JE
from repro.models import model as JM
from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import tree_from_numpy
from repro_torch.core.arena import ArenaSpec
from repro_torch.models import encdec as E
from repro_torch.models import model as M
from repro_torch.models.layers import tree_leaves

torch.set_num_threads(1)
ARCH = "seamless-m4t-medium"
TOL = 2e-2
B, S = 2, 12


def _rel_err(got, want):
    g = got.detach().float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / (np.abs(w).max() + 1e-9))


def _bytes(x):
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().tobytes()
    return np.asarray(x).tobytes()


@pytest.fixture(scope="module")
def both():
    jcfg = jax_reduced(jax_get_config(ARCH))
    cfg = reduced(get_config(ARCH))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, tree_from_numpy(jax.device_get(jp), "cpu")


def _inputs(cfg, n=S + 4, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, n)).astype(np.int32)
    frames = rng.standard_normal(
        (B, cfg.encoder_src_len, cfg.d_model)).astype(np.float32)
    return toks, frames


def _jbatch(toks, frames):
    return {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}


def _tbatch(toks, frames):
    return {"tokens": torch.from_numpy(toks),
            "frames": torch.from_numpy(frames)}


def test_reduced_and_full_shapes():
    cfg = reduced(get_config(ARCH))
    assert (cfg.encoder_layers, cfg.num_layers, cfg.d_model,
            cfg.encoder_src_len) == (2, 2, 64, 16)
    full = get_config(ARCH)
    assert full.param_count() == 982_579_200
    # self k/v (12 x 2048 x 16 x 64 x 2 B) + cross k/v (1024 source frames)
    row = ArenaSpec.from_model(full, 2048, 8, 32).bytes_per_partition
    assert row == 2 * 50_331_648 + 2 * 25_165_824 == 150_994_944


def test_run_encoder_matches_jax(both):
    jcfg, cfg, jp, tp = both
    _, frames = _inputs(cfg)
    want = JE.run_encoder(jcfg, jp["encoder"], jnp.asarray(frames))
    got = E.run_encoder(cfg, tp["encoder"], torch.from_numpy(frames))
    assert got.dtype == torch.bfloat16
    assert _rel_err(got, want) < TOL


@pytest.mark.parametrize("remat", [False, True])
def test_forward_train_logits_match_jax(both, remat):
    jcfg, cfg, jp, tp = both
    toks, frames = _inputs(cfg)
    want = JM.forward_train(jcfg, jp, _jbatch(toks, frames), remat=remat)
    got = M.forward_train(cfg, tp, _tbatch(toks, frames), remat=remat)
    assert _rel_err(got, want) < TOL


def test_prefill_and_decode_logits_match_jax(both):
    jcfg, cfg, jp, tp = both
    toks, frames = _inputs(cfg)
    jc = JM.init_caches(jcfg, B, 32)
    tc = M.init_caches(cfg, B, 32, device="cpu")
    jl, jc = JM.prefill(jcfg, jp, _jbatch(toks[:, :S], frames), jc)
    tl, tc = M.prefill(cfg, tp, _tbatch(toks[:, :S], frames), tc)
    assert _rel_err(tl, jl) < TOL
    for i in range(S, S + 4):          # rows at different positions
        pos = np.asarray([i, i - 3], np.int32)
        jl, jc = JM.decode_step(jcfg, jp, jnp.asarray(toks[:, i:i + 1]),
                                jnp.asarray(pos), jc)
        tl, tc = M.decode_step(cfg, tp, torch.from_numpy(toks[:, i:i + 1]),
                               torch.from_numpy(pos), tc)
        assert _rel_err(tl, jl) < TOL, i
    for t, j in zip(tree_leaves(tc), jax.tree.leaves(jc), strict=True):
        assert _rel_err(t, j) < TOL


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield prefix, tuple(tree.shape), str(tree.dtype).split(".")[-1]


def test_cache_tree_order_and_shapes_match_jax(both):
    jcfg, cfg, _jp, _tp = both
    jc = JM.init_caches(jcfg, B, 32)
    tc = M.init_caches(cfg, B, 32, device="cpu")
    want = [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p),
             tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(jc)[0]]
    got = list(_paths(tc))
    assert got == want
    assert [p for p, _, _ in got] == [("blocks", "cross", "k"),
                                      ("blocks", "cross", "v"),
                                      ("blocks", "self", "k"),
                                      ("blocks", "self", "v")]
    leaves, axes, _ = M.cache_flat_axes(tc)
    assert axes == [1, 1, 1, 1]
    assert tuple(leaves[0].shape) == (2, B, 16, 2, 16)      # the source
    assert tuple(leaves[2].shape) == (2, B, 32, 2, 16)      # the prompt


def test_cache_read_rows_blob_equals_jax(both):
    jcfg, cfg, jp, _tp = both
    toks, frames = _inputs(cfg, seed=3)
    jc = JM.init_caches(jcfg, 3, 32)
    _, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(
        np.concatenate([toks, toks[:1]])[:, :S]), "frames": jnp.asarray(
            np.concatenate([frames, frames[:1] * 2]))}, jc)
    tc = tree_from_numpy(jax.device_get(jc), "cpu")
    jl, tl = JM.cache_row_layout(jc), M.cache_row_layout(tc)
    assert tl.row_bytes == jl.row_bytes and tl.total_elems == jl.total_elems
    for rows in ([1], [2, 0]):
        want = JM.cache_read_rows(jc, jnp.asarray(rows, jnp.int32),
                                  impl="ref")
        got = M.cache_read_rows(tc, rows, layout=tl)
        assert _bytes(got) == _bytes(jax.device_get(want))


def test_decode_matches_forward(both):
    _jcfg, cfg, _jp, tp = both
    toks, frames = _inputs(cfg, n=S + 1, seed=2)
    tb = _tbatch(toks, frames)
    full = M.forward_train(cfg, tp, tb, remat=False)[:, S].float()
    caches = M.init_caches(cfg, B, 32, device="cpu")
    _, caches = M.prefill(cfg, tp, {"tokens": tb["tokens"][:, :S],
                                    "frames": tb["frames"]}, caches)
    lg, _ = M.decode_step(cfg, tp, tb["tokens"][:, S:],
                          torch.full((B,), S, dtype=torch.int32), caches)
    err = float((full - lg.float()).abs().max())
    assert err < 0.05 * float(full.abs().max())


def test_prefill_refuses_frames_of_another_length(both):
    _jcfg, cfg, _jp, tp = both
    toks, frames = _inputs(cfg)
    caches = M.init_caches(cfg, B, 32, device="cpu")
    with pytest.raises(ValueError, match="encoder_src_len"):
        M.prefill(cfg, tp, _tbatch(toks[:, :S], frames[:, :8]), caches)
