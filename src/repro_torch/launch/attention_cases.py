"""Decode-attention cases that the card's checks and the split-count sweep
share: the engine's 64 rows as the benchmark's saturated mix binds them,
the split-K design's edge positions, and the test that holds a bf16
attention output to its plain version.
"""
from __future__ import annotations

import numpy as np
import torch

TOL_BF16, TOL_F32 = 2e-2, 2e-5  # the JAX package's kernel-test tolerances
# (prompt tokens, decode tokens) of the eight functions of the benchmark's
# saturated mix (squeeze_bench/traffic/saturated.json), 8 rows each
ENGINE_FUNCTIONS = ((128, 256), (256, 192), (384, 160), (512, 128),
                    (768, 96), (1024, 64), (1536, 64), (1792, 32))
ENGINE_ROWS_PER_FUNCTION = 8
ENGINE_ROWS = len(ENGINE_FUNCTIONS) * ENGINE_ROWS_PER_FUNCTION


def engine_positions(seed: int) -> np.ndarray:
    """The 64 rows' positions in one decode step of the saturated mix: each
    function's 8 rows at positions uniform in [prompt, prompt + decode)."""
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.integers(prompt, prompt + decode, ENGINE_ROWS_PER_FUNCTION)
        for prompt, decode in ENGINE_FUNCTIONS]).astype(np.int32)


def edge_positions(t: int) -> tuple[int, ...]:
    """Eight rows of a ring of ``t`` slots at the split-K design's edges:
    valid lengths under one 32-slot tile (5, 31), of exactly one (32), not
    a multiple of the split (1,001), the ring's end, rings wrapped far past
    ``t``, and pos = -1 (every slot masked: the mean of V)."""
    return (5, 31, 32, 1001, t - 1, 10 * t + 123, 1_000_003, -1)


def allclose(got, want, tol: float) -> tuple[bool, float]:
    g, w = got.float(), want.float()
    err = (g - w).abs()
    return bool((err <= tol + tol * w.abs()).all()), float(err.max())


def attention_close(got, want) -> tuple[bool, float, float]:
    """bf16 attention outputs: within the JAX package's 2e-2 and, tighter,
    within 8 * 2**-8 of the largest output (4 to 8 bf16 ulps at that size):
    an output is a softmax-weighted mean of ~1,000 V rows, far smaller
    than 1, where 2e-2 alone would pass an off-by-one mask.  Returns
    (ok, max abs error, the tight limit)."""
    ok, err = allclose(got, want, TOL_BF16)
    limit = 8 * 2.0 ** -8 * float(want.float().abs().max())
    return ok and err <= limit, err, limit


def mean_of_v(v: torch.Tensor, g: int) -> torch.Tensor:
    """What a row with every slot masked returns: the mean of its V rows
    (T, Hkv, Dh) over all slots, for each of the ``g`` query heads of a KV
    head, as (Hkv, G, Dh)."""
    hkv, dh = v.shape[1:]
    return v.float().mean(0)[:, None].expand(hkv, g, dh)
