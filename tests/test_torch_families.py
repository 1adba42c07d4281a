"""The decoder-only families the port gained after dense and recurrent:
gemma2 (post-norms, local/global blocks, logit softcaps and the chunked
long-prefill attention), the MoE models (mixtral, dbrx) and qwen2-vl
(M-RoPE positions and the vision stub), against the JAX package on the
same numpy-made inputs and the same ``PRNGKey(0)`` weights carried across
by ``repro_torch.convert``.

Tolerances, as stated before the first run: attention in f32 within 2e-5
and in bf16 within 2e-2 (``tests/test_kernels.py``); bf16 model logits
within 2e-2 of the largest logit, MoE models 8e-2, the reference's own MoE
bound (``tests/test_decode_consistency.py``); decode against the train
forward within 5e-2 (MoE 8e-2), the bound of the same file."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as jax_attn
import repro.models.transformer as jax_transformer
import repro_torch.models.attention as attn
import repro_torch.models.moe as moe
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models import model as JM
from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import tree_from_numpy
from repro_torch.models import model as M
from repro_torch.models.layers import tree_leaves

torch.set_num_threads(1)
FAMILIES = ["gemma2-9b", "mixtral-8x7b", "dbrx-132b", "qwen2-vl-72b"]
B, S = 2, 12


def _tol(cfg, dense=2e-2) -> float:
    return 8e-2 if cfg.family == "moe" else dense


def _rel_err(got, want):
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    return float(np.abs(g - w).max() / (np.abs(w).max() + 1e-9))


def _both(arch):
    jcfg = jax_reduced(jax_get_config(arch))
    cfg = reduced(get_config(arch))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, tree_from_numpy(jax.device_get(jp), "cpu")


# ------------------------------------------------ chunked attention


def _attn_inputs(dtype, b=2, s=32, hk=2, g=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, hk, g, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else \
        (jnp.bfloat16, torch.bfloat16)
    jx = [jnp.asarray(a, jdt) for a in (q, k, v)] + [jnp.asarray(pos)] * 2
    tx = [torch.from_numpy(a).to(tdt) for a in (q, k, v)] + \
        [torch.from_numpy(pos)] * 2
    return jx, tx


@pytest.mark.parametrize("dtype,tol", [("f32", 2e-5), ("bf16", 2e-2)])
@pytest.mark.parametrize("cap", [0.0, 50.0])
@pytest.mark.parametrize("window", [0, 8])
def test_chunked_attention_matches_jax(monkeypatch, dtype, tol, cap,
                                       window):
    """Chunks patched small in both packages (8 queries x 16 keys over 32
    tokens: 4 x 2 tiles, masked ones included); the port's chunked path
    also equals its own plain path."""
    for mod in (jax_attn, attn):
        monkeypatch.setattr(mod, "Q_CHUNK", 8)
        monkeypatch.setattr(mod, "KV_CHUNK", 16)
    jx, tx = _attn_inputs(dtype)
    scale = 16 ** -0.5
    want = jax_attn._chunked_attention(*jx, window, scale, cap)
    got = attn._chunked_attention(*tx, window, scale, cap)
    assert got.dtype == tx[0].dtype and tuple(got.shape) == want.shape
    assert _rel_err(got, want) < tol
    plain = attn._plain_attention(*tx, window, scale, cap)
    assert _rel_err(got, plain.float().numpy()) < tol


def test_chunked_attention_keeps_the_reference_asserts(monkeypatch):
    monkeypatch.setattr(attn, "Q_CHUNK", 8)
    monkeypatch.setattr(attn, "KV_CHUNK", 16)
    _jx, tx = _attn_inputs("f32", s=24)
    with pytest.raises(AssertionError):
        attn._chunked_attention(*tx, 0, 0.25, 0.0)


def test_long_prefill_matches_jax(monkeypatch):
    """Reduced gemma2-9b prefills 8192 tokens (FLASH_SEQ): every block
    takes the chunked path in both packages, and the last logits and the
    caches (local ring of 8, global 8192) agree.  Replaces the test that
    pinned the port's refusal of such a prefill."""
    jcfg, cfg, jp, tp = _both("gemma2-9b")
    calls = []
    chunked = attn._chunked_attention

    def spy(*a):
        calls.append(a[0].shape)
        return chunked(*a)
    monkeypatch.setattr(attn, "_chunked_attention", spy)
    s = attn.FLASH_SEQ
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, size=(1, s)).astype(np.int32)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                        JM.init_caches(jcfg, 1, s))
    tl, tc = M.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)},
                       M.init_caches(cfg, 1, s, device="cpu"))
    assert len(calls) == cfg.num_layers
    assert _rel_err(tl, jl) < 2e-2
    for t, j in zip(tree_leaves(tc), jax.tree.leaves(jc), strict=True):
        assert tuple(t.shape) == j.shape and _rel_err(t, j) < 2e-2


# ------------------------------------------------ qwen2-vl: M-RoPE, stub


def _vlm_positions(b, s, n_patch, grid):
    """(3, B, S) positions: section 0 is the token index (the mask and the
    cache slot read it); the first ``n_patch`` tokens get the row and the
    column of a ``grid``-wide patch grid in sections 1 and 2; text tokens
    repeat the index in all three."""
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (3, b, s)).copy()
    idx = np.arange(n_patch)
    pos[1, :, :n_patch] = idx // grid
    pos[2, :, :n_patch] = idx % grid
    return pos


def _vlm_batch(cfg, toks, seed=1):
    b, s = toks.shape
    n = cfg.vision_stub_tokens
    vis = np.random.default_rng(seed).standard_normal(
        (b, n, cfg.d_model)).astype(np.float32)
    return vis, _vlm_positions(b, s, n, 2)


def test_vlm_logits_match_jax_with_vision_and_mrope():
    """qwen2-vl with stub patches over the first 4 tokens and M-RoPE
    sections that differ: the train forward, prefill and two decode steps
    (whose (B,) positions broadcast to (3, B)) agree with the JAX package."""
    jcfg, cfg, jp, tp = _both("qwen2-vl-72b")
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, size=(B, S + 2)).astype(np.int32)
    vis, pos = _vlm_batch(cfg, toks[:, :S])
    assert not np.array_equal(pos[0], pos[1])
    jb = {"tokens": jnp.asarray(toks[:, :S]), "positions": jnp.asarray(pos),
          "vision_embeds": jnp.asarray(vis)}
    tb = {"tokens": torch.from_numpy(toks[:, :S]),
          "positions": torch.from_numpy(pos),
          "vision_embeds": torch.from_numpy(vis)}
    want = JM.forward_train(jcfg, jp, jb, remat=False)
    got = M.forward_train(cfg, tp, tb)
    assert _rel_err(got, want) < 2e-2
    # the stub changed the output: without it the logits differ
    plain = M.forward_train(cfg, tp, {k: v for k, v in tb.items()
                                      if k != "vision_embeds"})
    assert _rel_err(plain, want) > 5e-2
    jl, jc = JM.prefill(jcfg, jp, jb, JM.init_caches(jcfg, B, 32))
    tl, tc = M.prefill(cfg, tp, tb, M.init_caches(cfg, B, 32, device="cpu"))
    assert _rel_err(tl, jl) < 2e-2
    for i in (S, S + 1):
        p = np.asarray([i, i - 3], np.int32)
        jl, jc = JM.decode_step(jcfg, jp, jnp.asarray(toks[:, i:i + 1]),
                                jnp.asarray(p), jc)
        tl, tc = M.decode_step(cfg, tp, torch.from_numpy(toks[:, i:i + 1]),
                               torch.from_numpy(p), tc)
        assert _rel_err(tl, jl) < 2e-2, i
    for t, j in zip(tree_leaves(tc), jax.tree.leaves(jc), strict=True):
        assert _rel_err(t, j) < 2e-2


def test_mrope_sections_rotate_differently():
    """At decode, positions (3, B) with sections that differ rotate q and
    k otherwise than the broadcast (B,) positions: the M-RoPE sections
    reach ``apply_rope``."""
    cfg = reduced(get_config("qwen2-vl-72b"))
    params = M.init_params(cfg, 0, device="cpu")
    toks = torch.zeros((1, 1), dtype=torch.int32)
    out = []
    for pos in (torch.tensor([5], dtype=torch.int32),
                torch.tensor([[5], [1], [2]], dtype=torch.int32)):
        caches = M.init_caches(cfg, 1, 16, device="cpu")
        lg, caches = M.decode_step(cfg, params, toks, pos, caches)
        out.append((lg, caches["groups"][0]["k"][:, 0, 5].clone()))
    # both wrote slot 5, section 0's position, with other rotations
    assert out[0][1].any() and out[1][1].any()
    assert not torch.equal(out[0][1], out[1][1])


# ------------------------------------------------ decode vs forward


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_forward(arch):
    """Prefill S tokens and decode token S against the train forward on
    S + 1 (``tests/test_decode_consistency.py``), in the port alone."""
    cfg = reduced(get_config(arch))
    params = M.init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32))
    batch = {"tokens": toks}
    pre = {"tokens": toks[:, :S]}
    if cfg.family == "vlm":
        vis, _pos = _vlm_batch(cfg, toks.numpy())
        batch["vision_embeds"] = pre["vision_embeds"] = \
            torch.from_numpy(vis)
    full = M.forward_train(cfg, params, batch)[:, S].float()
    caches = M.init_caches(cfg, B, 32, device="cpu")
    _, caches = M.prefill(cfg, params, pre, caches)
    lg, _ = M.decode_step(cfg, params, toks[:, S:],
                          torch.full((B,), S, dtype=torch.int32), caches)
    err = float((full - lg.float()).abs().max()) / float(full.abs().max())
    assert err < _tol(cfg, 5e-2), err


def _routing_spies(monkeypatch):
    """Record, per MoE layer call, each package's router probabilities and
    top-k experts (the JAX ones through a debug callback from inside its
    layer scan).  Returns (jax_calls, torch_calls), lists of (probs,
    experts) numpy pairs."""
    jax_calls, torch_calls = [], []
    jax_block = jax_transformer.moe_block

    def jax_spy(cfg, p, x):
        xt = x.reshape(-1, x.shape[-1]).astype(jnp.float32)
        probs = jax.nn.softmax(xt @ p["router"], axis=-1)
        _w, top_e = jax.lax.top_k(probs, cfg.num_experts_per_tok)
        jax.debug.callback(lambda pr, e: jax_calls.append(
            (np.asarray(pr), np.asarray(e))), probs, top_e)
        return jax_block(cfg, p, x)

    route = moe.route

    def torch_spy(cfg, p, xt):
        w, top_e = route(cfg, p, xt)
        probs = torch.softmax(xt.float() @ p["router"], dim=-1)
        torch_calls.append((probs.numpy(), top_e.numpy()))
        return w, top_e
    monkeypatch.setattr(jax_transformer, "moe_block", jax_spy)
    monkeypatch.setattr(moe, "route", torch_spy)
    return jax_calls, torch_calls


def _flipped_rows(jax_calls, torch_calls, k):
    """Rows whose top-k expert set differs between the packages, at any
    layer.  Each flip must be a near-tie: in both packages the k-th and
    (k+1)-th probabilities lie closer than twice the largest difference
    between the two packages' probabilities of that row, the drift that
    bf16 rounding upstream leaves in the router's input."""
    flipped = set()
    assert len(jax_calls) == len(torch_calls) > 0
    for (jpr, je), (tpr, te) in zip(jax_calls, torch_calls):
        for r in range(je.shape[0]):
            if set(je[r]) == set(te[r]):
                continue
            drift = float(np.abs(jpr[r] - tpr[r]).max())
            for pr in (jpr[r], tpr[r]):
                top = np.sort(pr)[::-1]
                assert top[k - 1] - top[k] < 2 * drift, (r, pr, drift)
            flipped.add(r)
    return flipped


@pytest.mark.parametrize("arch", ["gemma2-9b", "mixtral-8x7b"])
def test_ring_run_past_the_window_matches_jax(arch, monkeypatch):
    """Windowed models decode 20 tokens past a prompt of 12 on caches of
    16 (rings of 8), the tokens fed from one fixed random sequence: every
    step's logits agree with the JAX package's.

    On the MoE model the two packages' top-k choices are compared at every
    layer and step.  This data has one near-tie (step 31, layer 1, row 1:
    experts 1 and 2 at 0.19207 / 0.19388 in JAX, 0.19285 / 0.19222 here)
    that bf16 rounding upstream flips; a row whose routing differs is held
    to being such a near-tie (``_flipped_rows``) and to finite logits,
    every other row to the MoE bound."""
    jcfg, cfg, jp, tp = _both(arch)
    jax_calls, torch_calls = _routing_spies(monkeypatch)
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, size=(B, 32)).astype(np.int32)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :12])},
                        JM.init_caches(jcfg, B, 16))
    tl, tc = M.prefill(cfg, tp, {"tokens": torch.from_numpy(toks[:, :12])},
                       M.init_caches(cfg, B, 16, device="cpu"))
    assert _rel_err(tl, jl) < _tol(cfg)
    ring = {x.shape[2] for x in tree_leaves(tc)}
    assert 8 in ring
    flips = []
    for i in range(12, 32):
        jax_calls.clear()
        torch_calls.clear()
        p = np.full((B,), i, np.int32)
        jl, jc = JM.decode_step(jcfg, jp, jnp.asarray(toks[:, i:i + 1]),
                                jnp.asarray(p), jc)
        tl, tc = M.decode_step(cfg, tp, torch.from_numpy(toks[:, i:i + 1]),
                               torch.from_numpy(p), tc)
        assert bool(torch.isfinite(tl.float()).all())
        rows = set()
        if cfg.num_experts:
            rows = _flipped_rows(jax_calls, torch_calls,
                                 cfg.num_experts_per_tok)
            flips += [(i, r) for r in rows]
        keep = [r for r in range(B) if r not in rows]
        w = np.asarray(jl, np.float32)
        err = float(np.abs(tl.float().numpy()[keep] - w[keep]).max()
                    / (np.abs(w).max() + 1e-9))
        assert err < _tol(cfg), i
    assert len(flips) <= 1, flips

