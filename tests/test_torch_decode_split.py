"""The host side of the split-K decode-attention kernels on the CPU: the
split count (``num_splits``, a function of the shapes alone, and
``splits_for``, which asks the card's occupancy query), the slices
the kernel cuts (``split_bounds``, the mirror of ``split_slice`` in
``csrc/decode_attention.cuh``), the head-dim rule, and a float64 model of
the kernels' ranges, per-slice partials and cluster merge held against the
Pallas kernels in interpret mode, edge rows included.  The CUDA kernels
themselves run only on the card (``chip_smoke.py``)."""
import contextlib
import json
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import \
    paged_attention as pallas_paged_attention
from repro.kernels.partition_attention import \
    partition_attention as pallas_partition_attention
from repro_torch.kernels import partition_attention as pa
from repro_torch.launch import attention_cases as cases

H100_SMS = 132
# blocks an SM of the attention kernel in bf16 on an H100, per head dim, as
# the card's occupancy query answers (launch/attention_sweep.py)
H100_BLOCKS_PER_SM = {64: 8, 128: 5, 256: 3}
H100 = dict(sms=H100_SMS, blocks_per_sm=H100_BLOCKS_PER_SM[128])
NEG_INF = -2.0 ** 30
# the engine's decode shape in the saturated cell: 64 rows of qwen2-7b
# heads over 2,048-slot rows
ENGINE = dict(rows=64, hkv=4, g=7, n_max=2048, **H100)
SATURATED = Path(__file__).resolve().parents[1] / "squeeze_bench" \
    / "traffic" / "saturated.json"


@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("t", [100, 2048, 4096])
def test_split_slices_cover_every_valid_slot(rows, t):
    """Every valid length n in [1, T] is cut into contiguous, disjoint
    slices that cover [0, n) exactly; slices start on 16-token
    boundaries; the grid stays within CUDA's limits."""
    s = pa.num_splits(rows, 4, 7, t, **H100)
    assert 1 <= s <= pa.MAX_SPLITS
    assert rows * 4 * s <= pa.MAX_BLOCKS
    for n in range(1, t + 1):
        bounds = pa.split_bounds(n, s)
        assert len(bounds) == s
        assert bounds[0][0] == 0 and bounds[-1][1] == n
        for (a0, a1), (b0, _b1) in zip(bounds, bounds[1:]):
            assert a0 <= a1 == b0
        assert all(j0 % pa.SPLIT_ALIGN == 0 or j0 == n for j0, _ in bounds)


def test_split_count_fills_the_h100_at_the_path_shapes():
    """P = 8 rows, Hkv = 4, T = 2048 (the engine's arena): at least
    2 x 132 blocks, each with work when the rows are full, in one wave of
    the blocks an SM holds."""
    per_sm = H100["blocks_per_sm"]
    s = pa.num_splits(8, 4, 7, 2048, **H100)
    busy = sum(1 for j0, j1 in pa.split_bounds(2048, s) if j1 > j0)
    assert 8 * 4 * busy >= 2 * H100_SMS
    assert 8 * 4 * s <= per_sm * H100_SMS
    assert s == 16
    # G > 16 takes two query blocks, and fewer splits for the same blocks
    assert pa.num_splits(8, 4, 17, 2048, **H100) \
        == per_sm * H100_SMS // (8 * 4 * 2) == 10
    # one row: a full cluster of splits
    assert pa.num_splits(1, 4, 7, 2048, **H100) == pa.MAX_SPLITS
    # never more splits than 16-token slices of the range
    assert pa.num_splits(1, 1, 1, 40, **H100) == 3
    assert pa.num_splits(1, 1, 1, 1, **H100) == 1
    # gemma2-9b's heads (Hkv 8, G 2, Dh 256): 3 blocks an SM, one wave of
    # 6 splits at P = 8
    assert pa.num_splits(8, 8, 2, 2048, H100_SMS,
                         H100_BLOCKS_PER_SM[256]) == 6


def test_split_count_bounds_the_longest_slice_at_the_engine_shape():
    """64 rows: no block walks more than ``SPLIT_TOKENS`` of a full row,
    every block of a full row has work, and the grid fills at least one
    wave of the blocks an SM holds."""
    s = pa.num_splits(**ENGINE)
    assert s == 4
    bounds = pa.split_bounds(ENGINE["n_max"], s)
    assert max(j1 - j0 for j0, j1 in bounds) <= pa.SPLIT_TOKENS
    assert all(j1 > j0 for j0, j1 in bounds)
    assert ENGINE["rows"] * 4 * s >= H100["blocks_per_sm"] * H100_SMS
    # the longest row the saturated mix binds (position 1,823): 4 slices
    # of 464 tokens or fewer
    assert max(j1 - j0 for j0, j1 in pa.split_bounds(1824, s)) == 464


class _Occupancy:
    """An extension whose occupancy query answers the H100's bf16 blocks an
    SM (f32: one fewer) and counts the questions."""

    def __init__(self):
        self.asked = []

    def partition_attention_occupancy(self, splits, dh, bf16):
        self.asked.append((splits, dh, bf16))
        return 0, H100_BLOCKS_PER_SM[dh] - (not bf16)


@pytest.mark.parametrize("dh,dtype,want", [
    (128, torch.bfloat16, 10), (256, torch.bfloat16, 6),
    (64, torch.bfloat16, 16), (256, torch.float32, 4)])
def test_splits_for_asks_the_card_per_head_dim_and_dtype(monkeypatch, dh,
                                                         dtype, want):
    """``splits_for`` takes the one-wave term's blocks an SM from the
    extension's occupancy query at the call's head dim and dtype, once a
    device: at P = 8 of Hkv 8, G 2 (gemma2-9b's heads at Dh 256), 10, 6,
    16 and 4 splits where the card holds 5, 3, 8 and 2 blocks an SM."""
    monkeypatch.setattr(pa, "_sm_count", lambda index: H100_SMS)
    monkeypatch.setattr(pa.torch.cuda, "device",
                        lambda index: contextlib.nullcontext())
    pa.blocks_per_sm.cache_clear()
    ext = _Occupancy()
    q = SimpleNamespace(shape=(8, 8, 2, dh), dtype=dtype,
                        device=SimpleNamespace(index=0))
    try:
        assert pa.splits_for(ext, q, 2048) == want
        assert pa.splits_for(ext, q, 2048) == want
    finally:
        pa.blocks_per_sm.cache_clear()
    assert ext.asked == [(1, dh, dtype == torch.bfloat16)]


def test_engine_rows_are_the_saturated_mix():
    """The engine's rows that the card's checks and the sweep draw are the
    benchmark's saturated mix: its functions' prompt and decode lengths, its
    clients a function, and positions inside each function's range."""
    mix = json.loads(SATURATED.read_text())
    assert cases.ENGINE_FUNCTIONS == tuple(
        (f["prompt_tokens"], f["decode_tokens"]) for f in mix["profiles"])
    assert cases.ENGINE_ROWS_PER_FUNCTION == mix["clients_per_profile"]
    pos = cases.engine_positions(5).reshape(len(cases.ENGINE_FUNCTIONS), -1)
    assert pos.shape[1] == cases.ENGINE_ROWS_PER_FUNCTION
    for (prompt, decode), row in zip(cases.ENGINE_FUNCTIONS, pos):
        assert ((prompt <= row) & (row < prompt + decode)).all()


@pytest.mark.parametrize("dh,ok", [(16, True), (64, True), (128, True),
                                   (256, True), (8, False), (24, False),
                                   (272, False)])
def test_head_dim_rule(dh, ok):
    if ok:
        pa.check_head_dim(dh)
    else:
        with pytest.raises(ValueError, match="multiple of 16"):
            pa.check_head_dim(dh)


# ------------------------------------------- float64 model of the kernels


def _merge(parts, dh):
    """The cluster's merge of the splits' (m, l, acc) partials; every m is at
    least NEG_INF, so no exp(-inf - -inf) is formed."""
    mm = max(m for m, _, _ in parts)
    w = [np.exp(m - mm) for m, _, _ in parts]
    ll = sum(l * x for (_, l, _), x in zip(parts, w))
    acc = sum((a * x for (_, _, a), x in zip(parts, w)), np.zeros(dh))
    return acc / max(ll, 1e-30)


def _slice_partial(scores, vals):
    """One block's (m, l, acc) for one query head: scores of its tokens
    (-inf for a token that weighs nothing), m starting at NEG_INF."""
    m = max([NEG_INF] + list(scores))
    p = np.exp(np.asarray(scores, np.float64) - m) if scores else np.zeros(0)
    acc = (p[:, None] * vals).sum(0) if len(p) else 0.0
    return m, float(p.sum()), acc


def _model(q, k_of, v_of, n, masked, live, splits):
    """Output of one (row, KV head): q (G, Dh); token j of the range
    [0, n) lives at k_of(j) / v_of(j) when live(j)."""
    g, dh = q.shape
    out = np.zeros((g, dh))
    for gi in range(g):
        parts = []
        for j0, j1 in pa.split_bounds(n, splits):
            js = [j for j in range(j0, j1) if live(j)]
            sc = [NEG_INF if masked else float(q[gi] @ k_of(j)) * dh ** -0.5
                  for j in js]
            vals = np.array([v_of(j) for j in js]).reshape(len(js), dh)
            parts.append(_slice_partial(sc, vals))
        out[gi] = _merge(parts, dh)
    return out


def _edge_rows():
    """Six rows of a 24-slot ring: masked, short, at and past the ring's end,
    wrapped; (positions, T, Hkv, Pallas block)."""
    t = 24
    return np.array([-1, 0, 5, 23, 40, 3 * t + 7], np.int32), t, 2, 8


def _saturated_rows():
    """The engine's 64 rows of 2,048 slots at positions drawn as the
    saturated mix binds them, one KV head of small width."""
    return cases.engine_positions(5), ENGINE["n_max"], 1, 512


@pytest.mark.parametrize("splits,window,rows", [
    *(pytest.param(s, w, _edge_rows, id=f"{s}-{w}")
      for s in (1, 3, 7) for w in (0, 6)),
    pytest.param(pa.num_splits(**ENGINE), 0, _saturated_rows,
                 id="engine-saturated")])
def test_partition_split_model_vs_pallas(splits, window, rows):
    """The ring range of L = min(pos + 1, T, window) slots ending at
    pos mod T (wrapping once), pos = -1 as all T slots at NEG_INF."""
    pos, t, hkv, block_t = rows()
    p, g, dh = len(pos), 3, 16
    rng = np.random.default_rng(splits + window)
    q = rng.normal(size=(p, hkv, g, dh))
    k = rng.normal(size=(p, t, hkv, dh))
    v = rng.normal(size=(p, t, hkv, dh))
    want = np.asarray(pallas_partition_attention(
        jnp.asarray(q, jnp.float32), jnp.asarray(k, jnp.float32),
        jnp.asarray(v, jnp.float32), jnp.asarray(pos), window=window,
        block_t=block_t, interpret=True), np.float64)
    for r in range(p):
        if pos[r] < 0:
            n, first, masked = t, 0, True
        else:
            n = min(pos[r] + 1, t, window or t)
            first, masked = pos[r] - n + 1, False
        for h in range(hkv):
            got = _model(q[r, h], lambda j: k[r, (first + j) % t, h],
                         lambda j: v[r, (first + j) % t, h], n, masked,
                         lambda j: True, splits)
            np.testing.assert_allclose(got, want[r, h], atol=2e-5,
                                       rtol=2e-5)


@pytest.mark.parametrize("splits", [1, 2, 5])
def test_paged_split_model_vs_pallas(splits):
    """The linear range [0, min(pos + 1, MB * BT)) with -1 entries not
    read; a row with no mapped token at or before pos takes its whole
    table at NEG_INF (mean of V over the mapped slots, or zeros)."""
    nb, bt, mb, hkv, g, dh = 16, 8, 5, 2, 2, 16
    rng = np.random.default_rng(splits)
    q = rng.normal(size=(6, hkv, g, dh))
    kp = rng.normal(size=(nb, bt, hkv, dh))
    vp = rng.normal(size=(nb, bt, hkv, dh))
    tables = np.array([[3, 7, -1, 11, 2], [-1, 4, 5, -1, -1],
                       [-1, -1, -1, -1, -1], [0, 1, 2, 3, 4],
                       [9, -1, -1, -1, -1], [6, 8, 10, 12, 14]], np.int32)
    pos = np.array([4 * bt + 1, 3, 10, -1, 100, 2 * bt], np.int32)
    want = np.asarray(pallas_paged_attention(
        jnp.asarray(q, jnp.float32), jnp.asarray(kp, jnp.float32),
        jnp.asarray(vp, jnp.float32), jnp.asarray(tables), jnp.asarray(pos),
        interpret=True), np.float64)
    for r in range(6):
        row = tables[r]
        nvb = 0 if pos[r] < 0 else min(pos[r] // bt + 1, mb)
        found = any(0 <= row[i] < nb for i in range(nvb))
        n = min(pos[r] + 1, mb * bt) if found else mb * bt
        for h in range(hkv):
            got = _model(q[r, h], lambda j: kp[row[j // bt], j % bt, h],
                         lambda j: vp[row[j // bt], j % bt, h], n,
                         not found, lambda j: 0 <= row[j // bt] < nb,
                         splits)
            np.testing.assert_allclose(got, want[r, h], atol=2e-5,
                                       rtol=2e-5)
