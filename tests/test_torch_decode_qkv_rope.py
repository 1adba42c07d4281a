"""The decode step's attention front end in one kernel
(``ops.decode_qkv_rope``: the q/k/v bias adds, RoPE and the cache write).

On the CPU: its plain version (``ref.decode_qkv_rope``) is the sequence
``models.attention`` ran before, bit for bit, alone and inside a whole
decode step; its ring write (``ref.write_ring_slots``), which
``attention._decode_block`` shares, is the former write over a whole ring
and over each block of a split one; ``attention.fused_decode`` keeps the separate operations for
M-RoPE, a sharding context, prefill and train.  On the card (``card``
marker): the kernel against the plain version, bit for bit, at the widths
of qwen2-7b, tinyllama, mixtral and gemma2, and a replayed qwen2-7b step
against an eager one.  This file imports no JAX, so the card tests run on
the chip with
``PYTHONPATH=src python -m pytest -q --noconftest -m card
tests/test_torch_decode_qkv_rope.py``.
"""
import dataclasses
import types

import pytest
import torch

from repro_torch import spans
from repro_torch.configs.base import get_config, reduced
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.models.layers import (apply_rope, materialize, rope_freqs,
                                       tree_leaves, tree_map)
from repro_torch.sharding import sharding_ctx, split_last

torch.set_num_threads(1)
ARCHS = ["qwen2-7b", "tinyllama-1.1b", "gemma2-9b"]
DTYPES = [torch.bfloat16, torch.float32]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _same(a, b) -> bool:
    """Equal bits, shapes and dtypes."""
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def _positions(rows: int, t: int, gen) -> torch.Tensor:
    """0, t - 1, t, 3t + 5 and -1 first, then draws in [-3, 4t)."""
    fixed = [0, t - 1, t, 3 * t + 5, -1]
    more = torch.randint(-3, 4 * t, (rows - len(fixed),), generator=gen)
    return torch.cat([torch.tensor(fixed), more]).to(torch.int32)


def _inputs(rows, hq, hkv, dh, t, dtype, bias, seed, device="cpu"):
    """Projections, biases (or None), positions and caches, drawn on the
    CPU from ``seed``."""
    gen = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=gen).to(dtype).to(device)
    q, k, v = r(rows, hq * dh), r(rows, hkv * dh), r(rows, hkv * dh)
    bq, bk, bv = (r(hq * dh), r(hkv * dh), r(hkv * dh)) if bias \
        else (None, None, None)
    pos = _positions(rows, t, gen).to(device)
    kc, vc = r(rows, t, hkv, dh), r(rows, t, hkv, dh)
    return q, k, v, bq, bk, bv, pos, kc, vc


def _former(q, k, v, bq, bk, bv, pos, theta, kc, vc):
    """What ``attention`` ran before the kernel: ``dense``'s bias adds,
    ``apply_rope`` on q and k, and ``_decode_block``'s write over a whole
    ring."""
    b, t, hkv, dh = kc.shape
    hq = q.shape[-1] // dh
    if bq is not None:
        q, k, v = q + bq, k + bk, v + bv
    q, k, v = (split_last(x[:, None], n, dh)
               for x, n in ((q, hq), (k, hkv), (v, hkv)))
    q = apply_rope(q, pos[..., None], theta)
    k = apply_rope(k, pos[..., None], theta)
    slot = torch.remainder(pos.long(), t)
    rows = torch.arange(b)
    for c, new in ((kc, k[:, 0]), (vc, v[:, 0])):
        c[rows, slot] = new.to(c.dtype)
    return q.reshape(b, hkv, hq // hkv, dh)


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_plain_version_is_the_former_sequence(arch, dtype):
    cfg = reduced(get_config(arch))
    t = 8
    args = _inputs(12, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, t,
                   dtype, cfg.qkv_bias, seed=3)
    q, k, v, bq, bk, bv, pos, kc, vc = args
    kf, vf = kc.clone(), vc.clone()
    got = ref.decode_qkv_rope(q, k, v, bq, bk, bv, pos,
                              rope_freqs(cfg.head_dim, cfg.rope_theta,
                                         q.device), kc, vc)
    want = _former(q, k, v, bq, bk, bv, pos, cfg.rope_theta, kf, vf)
    assert _same(got, want)
    assert _same(kc, kf) and _same(vc, vf)
    # the write reached slot pos mod t of every row, -1 into slot t - 1
    assert _same(vc[4, t - 1], (v[4] + bv if bv is not None else v[4])
                 .reshape(cfg.num_kv_heads, cfg.head_dim))


def _former_block_write(kc, vc, kn, vn, pos, t, off):
    """``_decode_block``'s own write, as it was: slot pos mod t of the
    block's slots [off, off + T) of the ring, rows whose slot another rank
    holds left as they are."""
    tb = kc.shape[1]
    slot = torch.remainder(pos.long(), t) - off
    rows = torch.arange(kc.shape[0], device=kc.device)
    for c, new in ((kc, kn), (vc, vn)):
        new = new.to(c.dtype)
        if tb == t:
            c[rows, slot] = new
        else:
            mine = ((slot >= 0) & (slot < tb))[:, None, None]
            idx = slot.clamp(0, tb - 1)
            c[rows, idx] = torch.where(mine, new, c[rows, idx])


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("blocks,block", [(1, 0), (2, 0), (2, 1), (4, 0),
                                          (4, 1), (4, 2), (4, 3)])
def test_the_ring_write_is_the_former_block_write(blocks, block, dtype):
    """``ref.write_ring_slots`` over a whole ring and over each block of a
    ring split in 2 and in 4, at positions 0, t - 1, t, 3t + 5 and -1: the
    bits of the former write, new K/V cast from f32, and every slot not
    written unchanged."""
    t, hkv, dh = 16, 2, 8
    tb, off = t // blocks, block * (t // blocks)
    pos = torch.tensor([0, t - 1, t, 3 * t + 5, -1], dtype=torch.int32)
    gen = torch.Generator().manual_seed(7 + block)
    kn, vn = (torch.randn((5, hkv, dh), generator=gen) for _ in range(2))
    kc, vc = (torch.randn((5, tb, hkv, dh), generator=gen).to(dtype)
              for _ in range(2))
    before = kc.clone(), vc.clone()
    kf, vf = kc.clone(), vc.clone()
    ref.write_ring_slots(kc, vc, kn, vn, pos, t=t, off=off)
    _former_block_write(kf, vf, kn, vn, pos, t, off)
    assert _same(kc, kf) and _same(vc, vf)
    written = torch.zeros((5, tb), dtype=torch.bool)
    for row, p in enumerate(pos.tolist()):
        if 0 <= p % t - off < tb:
            written[row, p % t - off] = True
    for c, old, new in ((kc, before[0], kn), (vc, before[1], vn)):
        assert _same(c[~written], old[~written])
        assert _same(c[written], new[written.any(1)].to(dtype))


def _random_biases(tree, gen=None) -> None:
    """Every bias drawn, not zero, so that the adds are seen."""
    gen = gen or torch.Generator().manual_seed(9)
    items = tree.items() if isinstance(tree, dict) else enumerate(tree) \
        if isinstance(tree, (list, tuple)) else ()
    for key, sub in items:
        if key == "b":
            sub.copy_(torch.randn(sub.shape, generator=gen) * 0.5)
        else:
            _random_biases(sub, gen)


@pytest.mark.parametrize("arch", ARCHS)
def test_a_decode_step_is_the_former_step(arch, monkeypatch):
    """Two decode steps of the reduced model through the new path give the
    logits and caches of the former path, and mark ``attn.qkv`` fused."""
    cfg = reduced(get_config(arch))
    params = M.init_params(cfg, 0, device="cpu")
    _random_biases(params)
    rows, t = 6, 16
    new = M.init_caches(cfg, rows, t, device="cpu")
    gen = torch.Generator().manual_seed(4)
    for x in tree_leaves(new):
        x.copy_(torch.randn(x.shape, generator=gen))
    old = tree_map(lambda x: x.clone(), new)
    steps = []
    for s in range(2):
        toks = torch.randint(0, cfg.vocab_size, (rows, 1), generator=gen,
                             dtype=torch.int32)
        pos = (torch.arange(rows, dtype=torch.int32) * 7 + s) % 40 - 1
        steps.append((toks, pos))
    spans.clear()
    spans.enable()
    try:
        got = [M.decode_step(cfg, params, tk, ps, new)[0] for tk, ps in steps]
    finally:
        spans.enable(False)
    fused = [r.attrs.get("fused") for r in spans.log()
             if r.name == "attn.qkv"]
    spans.clear()
    assert fused == [True] * (2 * cfg.num_layers)
    monkeypatch.setattr(A, "fused_decode", lambda *a, **kw: False)
    want = [M.decode_step(cfg, params, tk, ps, old)[0] for tk, ps in steps]
    assert all(_same(a, b) for a, b in zip(got, want))
    assert all(_same(a, b) for a, b in zip(tree_leaves(new),
                                           tree_leaves(old), strict=True))


def _block(cfg, rows=2, t=8, dtype=torch.bfloat16):
    p = materialize(A.attn_spec(cfg), 0, device="cpu")
    cache = materialize(A.make_attn_cache_spec(cfg, rows, t), device="cpu")
    x = torch.zeros((rows, 1, cfg.d_model), dtype=dtype)
    return p, x, cache


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_takes_the_kernel(arch):
    cfg = reduced(get_config(arch))
    p, x, cache = _block(cfg)
    assert A.fused_decode(cfg, p, x, "decode", cache)


@pytest.mark.parametrize("case", ["mrope", "sharding", "prefill", "train",
                                  "f32_cache", "head_dim_8"])
def test_the_separate_operations_stay(case):
    """M-RoPE, a sharding context, prefill and train keep the former
    sequence; so do caches of another dtype than the activations, and a
    head dim the kernel does not take."""
    arch = "qwen2-vl-72b" if case == "mrope" else "qwen2-7b"
    cfg = reduced(get_config(arch))
    if case == "head_dim_8":
        cfg = dataclasses.replace(cfg, head_dim=8)
    p, x, cache = _block(cfg)
    mode = case if case in ("prefill", "train") else "decode"
    if case == "train":
        cache = None
    if case == "f32_cache":
        cache = {n: c.float() for n, c in cache.items()}
    if case == "sharding":
        mesh = types.SimpleNamespace(shape={"data": 1, "model": 2})
        with sharding_ctx(mesh, {}):
            assert not A.fused_decode(cfg, p, x, mode, cache)
        assert A.fused_decode(cfg, p, x, mode, cache)
    else:
        assert not A.fused_decode(cfg, p, x, mode, cache)


def test_the_cpu_path_counts_no_launch():
    ops.reset_launches()
    q, k, v, bq, bk, bv, pos, kc, vc = _inputs(
        6, 4, 2, 16, 8, torch.bfloat16, True, seed=1)
    ops.decode_qkv_rope(q, k, v, bq, bk, bv, pos, rope_freqs(16, 1e4, "cpu"),
                        kc, vc)
    assert ops.LAUNCHES["decode_qkv_rope"] == 0


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

# (Hq, Hkv, Dh, biases, ring slots): gemma2's ring is shorter than the
# positions drawn, up to 4t
WIDTHS = {"qwen2-7b": (28, 4, 128, True, 256),
          "tinyllama-1.1b": (32, 4, 64, False, 256),
          "mixtral-8x7b": (32, 8, 128, False, 256),
          "gemma2-9b": (16, 8, 256, False, 64)}


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("arch", list(WIDTHS))
def test_kernel_is_the_plain_version(card, arch, dtype):
    """64 rows: q and the written K/V slots bit-equal to the plain
    version's on the card, every other slot bit-unchanged, one launch
    counted."""
    hq, hkv, dh, bias, t = WIDTHS[arch]
    freqs = rope_freqs(dh, get_config(arch).rope_theta, card)
    q, k, v, bq, bk, bv, pos, kc, vc = _inputs(64, hq, hkv, dh, t, dtype,
                                               bias, seed=5, device=card)
    kc0, vc0 = kc.clone(), vc.clone()
    kp, vp = kc.clone(), vc.clone()
    n = ops.LAUNCHES["decode_qkv_rope"]
    got = ops.decode_qkv_rope(q, k, v, bq, bk, bv, pos, freqs, kc, vc)
    want = ref.decode_qkv_rope(q, k, v, bq, bk, bv, pos, freqs, kp, vp)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_qkv_rope"] == n + 1
    assert _same(got, want)
    assert _same(kc, kp) and _same(vc, vp)
    written = torch.zeros((64, t), dtype=torch.bool, device=card)
    written[torch.arange(64, device=card), torch.remainder(pos.long(), t)] \
        = True
    assert int(written.sum()) == 64
    assert _same(kc[~written], kc0[~written])
    assert _same(vc[~written], vc0[~written])
    assert not _same(kc[written], kc0[written])


@pytest.mark.card
def test_replayed_steps_are_eager_steps(card):
    """Full-width qwen2-7b, 8 rows: an eager step launches the kernel once
    a block (28), and steps replayed from a CUDA graph give the eager
    steps' logits and caches bit for bit."""
    cfg = get_config("qwen2-7b")
    params = M.init_params(cfg, 0, device=card)
    _random_biases(params)
    rows, t = 8, 64
    eager = M.init_caches(cfg, rows, t, device=card)
    gen = torch.Generator(device=card).manual_seed(6)
    for x in tree_leaves(eager):
        x.copy_(torch.randn(x.shape, generator=gen, device=card,
                            dtype=x.dtype))
    graphed = tree_map(lambda x: x.clone(), eager)
    gen = torch.Generator().manual_seed(7)
    inputs = [(torch.randint(0, cfg.vocab_size, (rows, 1), generator=gen,
                             dtype=torch.int32),
               (torch.arange(rows, dtype=torch.int32) * 9 + s) % 100 - 1)
              for s in range(3)]
    toks = inputs[0][0].to(card)
    pos = inputs[0][1].to(card)
    n = ops.LAUNCHES["decode_qkv_rope"]
    want, _ = M.decode_step(cfg, params, toks, pos, eager)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_qkv_rope"] - n == cfg.num_layers == 28
    # warm-up and capture on a side stream; the warm-up is this step's
    # work, and the capture runs nothing
    stream = torch.cuda.Stream(card)
    stream.wait_stream(torch.cuda.current_stream(card))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        M.decode_step(cfg, params, toks, pos, graphed)
        with torch.cuda.graph(graph, stream=stream):
            logits, _ = M.decode_step(cfg, params, toks, pos, graphed)
    torch.cuda.current_stream(card).wait_stream(stream)
    graph.replay()
    torch.cuda.synchronize()
    assert _same(logits, want)
    for tk, ps in inputs[1:]:
        toks.copy_(tk)
        pos.copy_(ps)
        want, _ = M.decode_step(cfg, params, toks, pos, eager)
        graph.replay()
        torch.cuda.synchronize()
        assert _same(logits, want)
    assert all(_same(a, b) for a, b in zip(tree_leaves(eager),
                                           tree_leaves(graphed), strict=True))
