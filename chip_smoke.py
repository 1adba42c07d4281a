#!/usr/bin/env python3
"""Proof that the PyTorch/CUDA port (``src/repro_torch``) runs on one
NVIDIA card: builds the hand-written kernels, holds each against its plain
PyTorch version at the shapes of the main path, drives the layout-contrast
entry point (``launch/kernel_demo.py::layout_contrast``) at full width,
then drives the hotmem ``ServeEngine`` on full-width qwen2-7b (random
weights from a seed) through cold start, warm start, snapshot capture,
restore, the paged copy-on-write remap, plug and unplug, and the vanilla
paged ``ServeEngine`` through the same bursty trace and a scripted unplug
that must migrate blocks, then two full-width replicas on one host budget
through the cluster layer (``launch/cluster_demo.py``): a scripted steal
per mode, the demo's two-replica trace under the sync and the async
broker, and two hosts whose late tail restores remotely; it checks what
comes out.

    python3 chip_smoke.py

Every phase prints a JSON line (the cluster phase a second one with every
steal's wall).  The script fails (raises, non-zero exit)
when there is no CUDA device, when a kernel does not build, launch or agree
with its plain version, or when any check of the engine run fails.  A
``summary`` line repeats the engine's headline figures near the end.  The
last three lines are the kernel table, the card's name and power limit as
``nvidia-smi`` reports them, and ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import gc
import hashlib
import json
import subprocess
import sys
import time
from collections import deque
from functools import partial
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import roofline  # noqa: E402
from repro_torch.cluster.host import HostMemoryBroker  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.core.arena import ArenaSpec  # noqa: E402
from repro_torch.core.elastic import gather_blocks  # noqa: E402
from repro_torch.kernels import kv_snapshot, ops, ref  # noqa: E402
from repro_torch.launch.cluster_demo import (build_cluster,  # noqa: E402
                                             demo_requests, summarize)
from repro_torch.launch.kernel_demo import (layout_contrast,  # noqa: E402
                                            scatter_to_pool)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.layers import tree_leaves, tree_map  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.serving.request import (PROFILES,  # noqa: E402
                                         FunctionProfile, Request, State)
from repro_torch.serving.tracegen import (assign_profiles,  # noqa: E402
                                          bursty_trace)

ARCH = "qwen2-7b"
PARTITION_TOKENS, N_PARTITIONS, BLOCK_TOKENS = 2048, 8, 32
PAGE_BYTES = 2 << 20            # paged CoW: 56 pages of one 112 MiB row
TOL_BF16, TOL_F32 = 2e-2, 2e-5  # the JAX package's kernel-test tolerances
COMPACT_MOVES = 128             # kv_compact phase: tail [384, 512) -> head
TIMED_RUNS = 20
FLUSH_BYTES = 2 << 30
DEV = torch.device("cuda", 0)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(f"chip_smoke check failed: {what}")


def median_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median time of ``fn`` between two CUDA events over ``runs`` runs
    after a warm-up, each run starting with a cold L2 (the decode step
    streams 15 GB of weights between two uses of one layer's cache, and a
    snapshot row is larger than the 50 MB L2).  L2 is flushed by reading
    2 GiB, about 0.6 ms of work during which the host enqueues ``fn``, so
    the time between the events is the device's, not the host's."""
    flush = torch.ones(FLUSH_BYTES, dtype=torch.uint8, device=DEV)
    fn()
    times = []
    for _ in range(runs):
        flush.amax()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


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


def randn(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device=DEV).to(dtype)


# ---------------------------------------------------------------------------
# Phase 1: the card and the build
# ---------------------------------------------------------------------------


def phase_build() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    ops.load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": list(ops.SOURCES), "route": "cpp_extension.load"})
    return smi


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version at the main path's shapes
# ---------------------------------------------------------------------------


def _valid_slots(pos: torch.Tensor, t: int) -> int:
    """Ring slots holding a token at or before each row's position (no
    window): the K/V the function needs to read for this run's data."""
    return int(torch.clamp(pos.long() + 1, max=t).sum())


def phase_attention(cfg, gen) -> dict:
    p, t, hkv, dh = N_PARTITIONS, PARTITION_TOKENS, cfg.num_kv_heads, \
        cfg.head_dim
    g = cfg.num_heads // hkv
    bf16 = torch.bfloat16
    q = randn((p, hkv, g, dh), bf16, gen)
    k = randn((p, t, hkv, dh), bf16, gen)
    v = randn((p, t, hkv, dh), bf16, gen)
    lo = torch.randint(0, t, (p,), generator=gen, device=DEV,
                       dtype=torch.int32)
    ring = torch.randint(t, 3 * t, (p,), generator=gen, device=DEV,
                         dtype=torch.int32)
    cases = [("main", q, lo, {}), ("ring", q, ring, {}),
             ("window", q, ring, {"window": 512}),
             ("logit_cap", q * 8, lo, {"logit_cap": 30.0})]
    errs, limits = {}, {}
    for name, qq, pos, kw in cases:
        ok, err, limit = attention_close(
            ops.partition_attention(qq, k, v, pos, **kw),
            ref.partition_attention(qq, k, v, pos, **kw))
        check(ok, f"partition_attention {name}: error {err} within "
                  f"{TOL_BF16} and {limit}")
        errs[name], limits[name] = err, limit
    # planted faults the check must reject: one more token in every row
    # (positions + 1) and one more in every window (window + 1)
    faults = {}
    for name, pos, kw, bad_pos, bad_kw in (
            ("positions+1", lo, {}, lo + 1, {}),
            ("window+1", ring, {"window": 512}, ring, {"window": 513})):
        ok, err, limit = attention_close(
            ops.partition_attention(q, k, v, bad_pos, **bad_kw),
            ref.partition_attention(q, k, v, pos, **kw))
        check(not ok, f"planted fault {name} passed the check: error {err} "
                      f"within {limit}")
        faults[name] = err
    # f32, a ragged T (no tile divides it) and G > 8 (two query blocks)
    q2 = randn((3, 2, 9, 64), torch.float32, gen)
    k2 = randn((3, 100, 2, 64), torch.float32, gen)
    v2 = randn((3, 100, 2, 64), torch.float32, gen)
    pos2 = torch.tensor([5, 99, 250], dtype=torch.int32, device=DEV)
    ok, err = allclose(ops.partition_attention(q2, k2, v2, pos2, window=64),
                       ref.partition_attention(q2, k2, v2, pos2, window=64),
                       TOL_F32)
    check(ok, f"partition_attention f32 ragged within {TOL_F32}: {err}")
    errs["f32_ragged"] = err

    # the split-K design's edge cases: P = 1; valid lengths under one
    # 32-slot tile, of exactly one, and not a multiple of the split; windows
    # shorter than a tile and than a split; rings wrapped far past T; and
    # pos = -1, every slot masked, against the mean of V over all T slots
    edge = torch.tensor([5, 31, 32, 1001, 2047, 10 * t + 123, 1_000_003, -1],
                        dtype=torch.int32, device=DEV)
    edge_cases = [("p1", 1, lo, {}), ("p1_ring", 1, ring, {}),
                  ("edge_lengths", p, edge, {}),
                  ("edge_window_7", p, edge, {"window": 7}),
                  ("edge_window_100", p, edge, {"window": 100})]
    for name, rows, pos, kw in edge_cases:
        got = ops.partition_attention(q[:rows], k[:rows], v[:rows],
                                      pos[:rows], **kw)
        ok, err, limit = attention_close(
            got, ref.partition_attention(q[:rows], k[:rows], v[:rows],
                                         pos[:rows], **kw))
        check(ok, f"partition_attention {name}: error {err} within "
                  f"{TOL_BF16} and {limit}")
        errs[name], limits[name] = err, limit
        if pos is edge:
            mean = v[p - 1].float().mean(0)[:, None].expand(hkv, g, dh)
            ok, err, limit = attention_close(got[p - 1], mean)
            check(ok, f"partition_attention {name}, pos -1: error {err} "
                      f"from the mean of V within {limit}")
            errs[name + "_pos-1_vs_mean_v"] = err
    pos3 = torch.tensor([-1, 250, 31], dtype=torch.int32, device=DEV)
    for w in (0, 7):
        got = ops.partition_attention(q2, k2, v2, pos3, window=w)
        ok, err = allclose(got, ref.partition_attention(q2, k2, v2, pos3,
                                                        window=w), TOL_F32)
        ok2, err2 = allclose(got[0], v2[0].mean(0)[:, None].expand(2, 9, 64),
                             TOL_F32)
        check(ok and ok2, f"partition_attention f32 G=9 Dh=64 edges, window "
                          f"{w}, within {TOL_F32}: {err}, {err2}")
        errs[f"f32_g9_dh64_edges_w{w}"] = max(err, err2)

    # yardstick: one SDPA call on the unrolled GQA (K/V repeated per query
    # head and the ring mask built beforehand, outside the timing)
    scale = dh ** -0.5
    slots = torch.arange(t, device=DEV)[None, :]
    gidx = lo.long()[:, None] - torch.remainder(lo.long()[:, None] - slots, t)
    mask = (gidx >= 0)[:, None, None, :]
    qs = q.reshape(p, hkv * g, 1, dh)
    ks = k.permute(0, 2, 1, 3).repeat_interleave(g, dim=1).contiguous()
    vs = v.permute(0, 2, 1, 3).repeat_interleave(g, dim=1).contiguous()
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qs, ks, vs, attn_mask=mask, scale=scale)
    _, sdpa_err = allclose(sdpa().reshape(p, hkv, g, dh),
                           ref.partition_attention(q, k, v, lo), TOL_BF16)

    valid = _valid_slots(lo, t)
    item = q.element_size()
    nbytes = 2 * valid * hkv * dh * item + 2 * q.numel() * item + 4 * p
    flops = 4.0 * valid * hkv * g * dh
    bound_s, bound_by = roofline.bound_seconds(nbytes, flops)
    kernel = lambda: ops.partition_attention(q, k, v, lo)  # noqa: E731
    plain = lambda: ref.partition_attention(q, k, v, lo)  # noqa: E731
    # two more shapes, timed for the kernel line only: one row at its
    # ring's end, and eight rows at the engine's positions (<= 256)
    short = torch.randint(0, 257, (p,), generator=gen, device=DEV,
                          dtype=torch.int32)
    extra = []
    for name, rows, pos in (
            ("p1_pos2047", 1,
             torch.tensor([t - 1], dtype=torch.int32, device=DEV)),
            ("p8_pos_le_256", p, short)):
        n_valid = _valid_slots(pos, t)
        args = (q[:rows], k[:rows], v[:rows], pos)
        extra.append(_timed_shape(
            name, n_valid, partial(ops.partition_attention, *args),
            partial(ref.partition_attention, *args),
            2 * n_valid * hkv * dh * item + 2 * rows * hkv * g * dh * item
            + 4 * rows, 4.0 * n_valid * hkv * g * dh))
    row = {"name": "partition_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/partition_attention.cu",
           "replaces": "src/repro/kernels/partition_attention.py:70",
           "path": "engine",
           "max_abs_err": errs["main"], "ms": median_ms(kernel),
           "plain_ms": median_ms(plain),
           "bound_ms": bound_s * 1e3, "bound_by": bound_by,
           "library_ms": median_ms(sdpa)}
    emit({"phase": "kernel", "shape": [p, t, hkv, g, dh], "dtype": "bf16",
          "valid_slots": valid, "bytes": nbytes, "flops": flops,
          "errors": errs, "tight_limits": limits,
          "planted_fault_errors": faults, "sdpa_max_abs_err": sdpa_err,
          "more_shapes": extra, **row})
    return row


def _timed_shape(name, valid, kernel, plain, nbytes, flops) -> dict:
    """One more shape of an attention kernel: its time, its plain
    version's and its bound, for the kernel's line."""
    bound_s, bound_by = roofline.bound_seconds(nbytes, flops)
    return {"case": name, "valid_slots": valid, "ms": median_ms(kernel),
            "plain_ms": median_ms(plain), "bound_ms": bound_s * 1e3,
            "bound_by": bound_by}


def _linear_slots(pos: torch.Tensor, t: int) -> int:
    """Tokens at or before each row's position in a linear (paged) row of
    ``t`` slots: the K/V the paged function needs to read for this run."""
    return int(torch.clamp(pos.long() + 1, max=t).sum())


def phase_paged_attention(cfg, gen) -> dict:
    """``paged_attention`` at full width (P=8, T=2048 in MB=64 blocks of
    BT=32, NB=512 pool blocks), driven first through ``layout_contrast``
    with the launch counts set to 0 just before and read just after."""
    p, t, hkv, dh = N_PARTITIONS, PARTITION_TOKENS, cfg.num_kv_heads, \
        cfg.head_dim
    g, bt = cfg.num_heads // hkv, BLOCK_TOKENS
    bf16 = torch.bfloat16
    q = randn((p, hkv, g, dh), bf16, gen)
    k = randn((p, t, hkv, dh), bf16, gen)
    v = randn((p, t, hkv, dh), bf16, gen)
    lo = torch.randint(0, t, (p,), generator=gen, device=DEV,
                       dtype=torch.int32)
    # the path: the layout-contrast entry point, counted on its own
    ops.reset_launches()
    lc = layout_contrast(q, k, v, lo, block_tokens=bt, seed=5)
    torch.cuda.synchronize()
    path_launches = dict(ops.LAUNCHES)
    check(path_launches["paged_attention"] == 1
          and path_launches["partition_attention"] == 1
          and path_launches["kv_compact"] == 1,
          f"layout_contrast launched its three kernels: {path_launches}")
    ok, contrast_err, contrast_limit = attention_close(lc["paged"],
                                                       lc["partition"])
    check(ok, f"paged vs partition on the same K/V: error {contrast_err} "
              f"within {TOL_BF16} and {contrast_limit}")
    check(lc["compacted"], "layout_contrast's kv_compact moved its blocks")
    del lc

    # the kernel against its plain version on a fresh (uncompacted) pool
    kp, vp, tables, _perm = scatter_to_pool(k, v, bt, seed=5)
    nb, mb = kp.shape[0], tables.shape[1]
    check((nb, mb) == (512, 64), f"pool of {nb} blocks, tables of {mb}")
    ok, err, limit = attention_close(
        ops.paged_attention(q, kp, vp, tables, lo),
        ref.paged_attention(q, kp, vp, tables, lo))
    check(ok, f"paged_attention main: error {err} within {TOL_BF16} and "
              f"{limit}")
    errs, limits = {"main": err, "vs_partition": contrast_err}, \
        {"main": limit, "vs_partition": contrast_limit}
    # planted faults the check must reject: one more token in every row
    # (positions + 1), and the first block of the row with the fewest
    # tokens pointed at another row's first block
    r = int(torch.argmin(lo))
    swapped = tables.clone()
    swapped[r, 0] = tables[(r + 1) % p, 0]
    faults = {}
    for name, bad_tab, bad_pos in (("positions+1", tables, lo + 1),
                                   ("foreign_block", swapped, lo)):
        ok, e, lim = attention_close(
            ops.paged_attention(q, kp, vp, bad_tab, bad_pos),
            ref.paged_attention(q, kp, vp, tables, lo))
        check(not ok, f"planted fault {name} passed the check: error {e} "
                      f"within {lim}")
        faults[name] = e
    # f32, a ragged MB, BT = 24 (no power of two), G = 9 (two query
    # blocks) and -1 entries after each row's last valid block
    q2 = randn((3, 2, 9, 64), torch.float32, gen)
    kp2 = randn((20, 24, 2, 64), torch.float32, gen)
    vp2 = randn((20, 24, 2, 64), torch.float32, gen)
    tab2 = torch.tensor([[3, 7, 11, -1, -1], [0, 1, 2, 4, 5],
                         [19, 18, -1, -1, -1]], dtype=torch.int32,
                        device=DEV)
    pos2 = torch.tensor([3 * 24 - 5, 5 * 24 - 1, 2 * 24 - 20],
                        dtype=torch.int32, device=DEV)
    for name, qq, kw in (("f32_ragged", q2, {}),
                         ("f32_logit_cap", q2 * 8, {"logit_cap": 30.0})):
        ok, e = allclose(ops.paged_attention(qq, kp2, vp2, tab2, pos2, **kw),
                         ref.paged_attention(qq, kp2, vp2, tab2, pos2, **kw),
                         TOL_F32)
        check(ok, f"paged_attention {name} within {TOL_F32}: {e}")
        errs[name] = e

    # the split-K design's edge cases: P = 1; lengths under one tile, of
    # exactly one and not a multiple of the split, with -1 entries inside
    # the valid range (held to the plain version, which masks them); then
    # the rows with no valid token, held to the TPU kernel's results (the
    # plain version differs there): no mapped entry at or before pos, or
    # pos = -1, averages V over the table's mapped slots; no mapped entry
    # at all gives zeros
    edge = torch.tensor([5, 31, 32, 1001, 2047, 700, 300, 1500],
                        dtype=torch.int32, device=DEV)
    holes = tables.clone()
    holes[3, 0] = holes[5, 10] = holes[6, 2] = holes[7, 40] = -1
    for name, rows, tab, pos in (("p1", 1, tables, lo),
                                 ("edge_lengths_holes", p, holes, edge)):
        ok, e, lim = attention_close(
            ops.paged_attention(q[:rows], kp, vp, tab[:rows], pos[:rows]),
            ref.paged_attention(q[:rows], kp, vp, tab[:rows], pos[:rows]))
        check(ok, f"paged_attention {name}: error {e} within {TOL_BF16} "
                  f"and {lim}")
        errs[name], limits[name] = e, lim
    empty = tables.clone()
    empty[0, :4] = -1                 # tokens 0..127 unmapped, pos 100
    empty[1] = -1                     # nothing mapped
    pos_e = lo.clone()
    pos_e[0], pos_e[2] = 100, -1
    got = ops.paged_attention(q, kp, vp, empty, pos_e)
    want = ref.paged_attention(q, kp, vp, empty, pos_e)
    for r, blocks in ((0, empty[0, 4:]), (2, empty[2])):
        want[r] = vp[blocks.long()].float().reshape(-1, hkv, dh).mean(0)[
            :, None].expand(hkv, g, dh).to(want.dtype)
    want[1] = 0
    ok, e, lim = attention_close(got, want)
    check(ok and bool((got[1] == 0).all()),
          f"paged_attention rows with no valid token: error {e} within "
          f"{TOL_BF16} and {lim}, all-unmapped row zero")
    errs["no_valid_token_rows"], limits["no_valid_token_rows"] = e, lim
    tab5 = torch.tensor([[3, -1, 11, -1, -1], [-1, -1, -1, -1, -1],
                         [-1, 18, 6, -1, -1]], dtype=torch.int32, device=DEV)
    pos5 = torch.tensor([3 * 24 - 5, 50, 10], dtype=torch.int32, device=DEV)
    got = ops.paged_attention(q2, kp2, vp2, tab5, pos5)
    want = ref.paged_attention(q2, kp2, vp2, tab5, pos5)
    want[1] = 0
    want[2] = vp2[[18, 6]].reshape(-1, 2, 64).mean(0)[:, None].expand(2, 9,
                                                                       64)
    ok, e = allclose(got, want, TOL_F32)
    check(ok, f"paged_attention f32 G=9 Dh=64 edges within {TOL_F32}: {e}")
    errs["f32_g9_dh64_edges"] = e

    valid = _linear_slots(lo, mb * bt)
    item = q.element_size()
    nbytes = 2 * valid * hkv * dh * item + 2 * q.numel() * item + 4 * p \
        + 4 * tables.numel()
    flops = 4.0 * valid * hkv * g * dh
    bound_s, bound_by = roofline.bound_seconds(nbytes, flops)
    kernel = lambda: ops.paged_attention(q, kp, vp, tables, lo)  # noqa: E731
    plain = lambda: ref.paged_attention(  # noqa: E731
        q, kp, vp, tables, lo)
    partition = lambda: ops.partition_attention(q, k, v, lo)  # noqa: E731
    ms, partition_ms = median_ms(kernel), median_ms(partition)
    short = torch.randint(0, 257, (p,), generator=gen, device=DEV,
                          dtype=torch.int32)
    extra = []
    for name, rows, pos in (
            ("p1_pos2047", 1,
             torch.tensor([t - 1], dtype=torch.int32, device=DEV)),
            ("p8_pos_le_256", p, short)):
        n_valid = _linear_slots(pos, mb * bt)
        args = (q[:rows], kp, vp, tables[:rows], pos)
        extra.append(_timed_shape(
            name, n_valid, partial(ops.paged_attention, *args),
            partial(ref.paged_attention, *args),
            2 * n_valid * hkv * dh * item + 2 * rows * hkv * g * dh * item
            + 4 * rows + 4 * rows * mb, 4.0 * n_valid * hkv * g * dh))
    row = {"name": "paged_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
           "replaces": "src/repro/kernels/paged_attention.py:65",
           "path": "layout_contrast", "path_launches": path_launches,
           "max_abs_err": err, "ms": ms, "plain_ms": median_ms(plain),
           "bound_ms": bound_s * 1e3, "bound_by": bound_by,
           "library_ms": None}
    emit({"phase": "kernel", "shape": [p, nb, bt, mb, hkv, g, dh],
          "dtype": "bf16", "valid_slots": valid, "bytes": nbytes,
          "flops": flops, "errors": errs, "tight_limits": limits,
          "planted_fault_errors": faults,
          "library": "none: no single PyTorch call computes paged attention",
          "partition_ms": partition_ms, "gather_overhead": ms / partition_ms,
          "more_shapes": extra, **row})
    return row


def phase_kv_compact(cfg, gen) -> dict:
    """``kv_compact`` over two pool leaves shaped like the engine's,
    (512, 32, 28, 4, 128) bf16, with 128 moves from the tail [384, 512)
    into permuted head slots."""
    shape = (4 * 128, BLOCK_TOKENS, cfg.num_layers, cfg.num_kv_heads,
             cfg.head_dim)
    leaves = [randn(shape, torch.bfloat16, gen) for _ in range(2)]
    block_bytes = sum(x[0].numel() * x.element_size() for x in leaves)
    check(block_bytes == 1_835_008 and sum(
        x.numel() * x.element_size() for x in leaves) == 939_524_096,
        f"pool leaves hold {block_bytes} bytes a block")
    rng = np.random.default_rng(7)
    src = [int(b) for b in rng.permutation(np.arange(384, 512))]
    dst = [int(b) for b in rng.permutation(384)[:COMPACT_MOVES]]
    s_t = torch.tensor(src, device=DEV)
    d_t = torch.tensor(dst, device=DEV)

    def bits(x):
        return x.view(torch.int16)

    a = [x.clone() for x in leaves]
    b = [x.clone() for x in leaves]
    c = [x.clone() for x in leaves]
    ops.kv_compact(a, src, dst)
    for x in b:
        ref.kv_compact(x, s_t, d_t, len(src))
    for x in c:
        x[d_t] = x[s_t]
    check(all(torch.equal(bits(x), bits(y)) for x, y in zip(a, b)),
          "kv_compact bit-exact against its plain version")
    check(all(torch.equal(bits(x), bits(y)) for x, y in zip(a, c)),
          "kv_compact bit-exact against leaf[dst] = leaf[src]")
    check(all(torch.equal(bits(x[d_t]), bits(y[s_t]))
              for x, y in zip(a, leaves)), "moved blocks arrived")
    keep = torch.tensor(sorted(set(range(shape[0])) - set(dst)), device=DEV)
    check(all(torch.equal(bits(x[keep]), bits(y[keep]))
              for x, y in zip(a, leaves)), "blocks not named untouched")
    del a, b, c
    refused = {}
    for name, bad_src, bad_dst in (("dst is another move's src",
                                    [500, 400], [400, 3]),
                                   ("two moves, one dst", [500, 501],
                                    [3, 3])):
        try:
            ops.kv_compact(leaves, bad_src, bad_dst)
        except ValueError as e:
            refused[name] = str(e)
        check(name in refused, f"kv_compact accepted a move list where "
                               f"{name}")
    nbytes = 2 * COMPACT_MOVES * block_bytes + 8 * COMPACT_MOVES
    bound_s, bound_by = roofline.bound_seconds(nbytes)

    def library():
        for x in leaves:
            x[d_t] = x[s_t]

    def plain():
        for x in leaves:
            ref.kv_compact(x, s_t, d_t, len(src))

    row = {"name": "kv_compact", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/kv_compact.cu",
           "replaces": "src/repro/kernels/kv_compact.py:27",
           "path": "engine", "max_abs_err": 0.0,
           "ms": median_ms(lambda: ops.kv_compact(leaves, src, dst)),
           "plain_ms": median_ms(plain), "bound_ms": bound_s * 1e3,
           "bound_by": bound_by, "library_ms": median_ms(library)}
    emit({"phase": "kernel", "leaves": [list(shape)] * 2, "dtype": "bf16",
          "moves": COMPACT_MOVES, "block_bytes": block_bytes,
          "bytes": nbytes, "refused": refused,
          "library": "leaf[dst] = leaf[src], per leaf", **row})
    return row


def phase_snapshot(cfg, gen) -> list[dict]:
    caches = M.init_caches(cfg, N_PARTITIONS, PARTITION_TOKENS, device=DEV)
    leaves, axes, _ = M.cache_flat_axes(caches)
    for leaf in leaves:
        leaf.copy_(randn(leaf.shape, leaf.dtype, gen))
    layout = M.cache_row_layout(caches)
    row_bytes = kv_snapshot.expected_row_bytes(cfg, PARTITION_TOKENS)
    check(layout.row_bytes == row_bytes, "layout bytes == spec bytes")

    def bits(x):
        return x.view(torch.int16)

    errs = {}
    for rows in ([5], [6, 1]):                 # the engine's N=1, unordered
        r = torch.tensor(rows, device=DEV)
        got = ops.snapshot_capture(leaves, rows, layout=layout)
        want = ref.snapshot_capture(leaves, r, layout)
        check(tuple(got.shape) == (len(rows), layout.total_elems)
              and torch.equal(bits(got), bits(want)),
              f"snapshot_capture bit-exact for rows {rows}")
        blob = randn(tuple(want.shape), want.dtype, gen)
        a = [x.clone() for x in leaves]
        b = [x.clone() for x in leaves]
        ops.snapshot_restore(a, blob, rows, layout=layout)
        ref.snapshot_restore(b, blob, r, layout)
        check(all(torch.equal(bits(x), bits(y)) for x, y in zip(a, b)),
              f"snapshot_restore bit-exact for rows {rows}")
        keep = [i for i in range(N_PARTITIONS) if i not in rows]
        check(all(torch.equal(bits(x.index_select(ax, torch.tensor(
            keep, device=DEV))), bits(y.index_select(ax, torch.tensor(
                keep, device=DEV))))
            for x, y, ax in zip(a, leaves, axes)),
            f"rows other than {rows} untouched by restore")
        back = ops.snapshot_capture(a, rows, layout=layout)
        check(torch.equal(bits(back), bits(blob)),
              f"capture after restore returns the blob for rows {rows}")
        errs[str(rows)] = 0.0
        del a, b

    rows, r = [5], torch.tensor([5], device=DEV)
    blob = ops.snapshot_capture(leaves, rows, layout=layout)
    nbytes = 2 * row_bytes + 4                  # read the row, write it
    bound_s, bound_by = roofline.bound_seconds(nbytes)

    # yardsticks, one PyTorch call each on the same row: a concatenation of
    # the leaves' row slices (they share one shape here), and one
    # multi-tensor copy of the blob's slices back into them
    sel = [leaf.select(ax, 5) for leaf, ax in zip(leaves, axes)]
    check(len({x.shape for x in sel}) == 1, "leaf row slices share a shape")
    lib_capture = lambda: torch.cat(sel)  # noqa: E731
    check(torch.equal(bits(lib_capture().reshape(1, -1)), bits(blob)),
          "torch.cat of the row slices equals the blob")

    def blob_parts(b):
        return [b[0, s.offset:s.offset + s.size].view(x.shape)
                for s, x in zip(layout.slots, sel)]

    parts = blob_parts(blob)
    lib_restore = lambda: torch._foreach_copy_(sel, parts)  # noqa: E731
    a = [x.clone() for x in leaves]
    b = [x.clone() for x in leaves]
    src = randn(tuple(blob.shape), blob.dtype, gen)
    ops.snapshot_restore(a, src, rows, layout=layout)
    torch._foreach_copy_([x.select(ax, 5) for x, ax in zip(b, axes)],
                         blob_parts(src))
    check(all(torch.equal(bits(x), bits(y)) for x, y in zip(a, b)),
          "torch._foreach_copy_ restore equals the kernel's")
    del a, b, src
    capture = lambda: ops.snapshot_capture(  # noqa: E731
        leaves, rows, layout=layout)
    restore = lambda: ops.snapshot_restore(  # noqa: E731
        leaves, blob, rows, layout=layout)
    plain_capture = lambda: ref.snapshot_capture(  # noqa: E731
        leaves, r, layout)
    plain_restore = lambda: ref.snapshot_restore(  # noqa: E731
        leaves, blob, r, layout)
    # the kernel with its row ids copied to the card synchronously, as the
    # wrapper did before it staged them through pinned memory: the host's
    # work after that copy lands inside the events
    sync_rows = lambda: kv_snapshot.snapshot_capture(  # noqa: E731
        ops.load(), leaves,
        torch.tensor(rows, dtype=torch.int32, device=DEV), layout=layout)
    check(torch.equal(bits(sync_rows()), bits(blob)),
          "capture with synchronously copied rows equals the blob")
    out = [
        {"name": "snapshot_capture", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/kv_snapshot.cu",
         "replaces": "src/repro/kernels/kv_snapshot.py:123",
         "path": "engine",
         "max_abs_err": 0.0, "ms": median_ms(capture),
         "plain_ms": median_ms(plain_capture),
         "bound_ms": bound_s * 1e3, "bound_by": bound_by,
         "library_ms": median_ms(lib_capture)},
        {"name": "snapshot_restore", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/kv_snapshot.cu",
         "replaces": "src/repro/kernels/kv_snapshot.py:160",
         "path": "engine",
         "max_abs_err": 0.0, "ms": median_ms(restore),
         "plain_ms": median_ms(plain_restore),
         "bound_ms": bound_s * 1e3, "bound_by": bound_by,
         "library_ms": median_ms(lib_restore)},
    ]
    out[0]["ms_sync_staged_rows"] = median_ms(sync_rows)
    for row in out:
        emit({"phase": "kernel", "rows": 1, "row_bytes": row_bytes,
              "bytes": nbytes, "checked_rows": list(errs), **row})
    return out


# ---------------------------------------------------------------------------
# Phase 3: the engine on full-width qwen2-7b
# ---------------------------------------------------------------------------


def _run_one(eng, rid, prof="cnn"):
    eng.submit(Request(rid=rid, profile=PROFILES[prof], submit_s=eng.now))
    empty = deque()
    while eng.active or eng.pending:
        eng._tick(empty)


def _expire(eng):
    eng.now += eng.keep_alive + 1.0
    eng._recycle_idle()


def _bursty(seed=3, duration=16.0):
    arr = bursty_trace(duration, 0.8, burst_x=6, burst_at=(0.0,),
                       burst_len=3.0, quiet_after=duration / 2, seed=seed)
    return [Request(rid=f"b{i}", profile=p, submit_s=t)
            for i, (t, p) in enumerate(assign_profiles(arr, PROFILES, seed))]


def _measure_unplugs(eng, drops: list) -> None:
    """Record each vanilla unplug's drop of ``memory_allocated()`` (its
    pool shrinks in the arena; the row view stays full-size)."""
    unplug = eng.arena.unplug

    def measured(units, notify_host=True):
        blocks = eng.arena.units()
        before = torch.cuda.memory_allocated(DEV)
        ev = unplug(units, notify_host)
        torch.cuda.synchronize()
        drops.append({"blocks": blocks, "kept": eng.arena.units(),
                      "migrated_blocks": ev.migrated_blocks,
                      "freed_bytes": before
                      - torch.cuda.memory_allocated(DEV)})
        return ev
    eng.arena.unplug = measured


def _fill_random(tensors, gen) -> None:
    """Random content in place (a helper, so that no loop variable keeps a
    tensor alive in the caller: the unplug check counts freed bytes)."""
    for x in tensors:
        x.copy_(randn(x.shape, x.dtype, gen))


def _vanilla_migration(eng, gen) -> dict:
    """A scripted vanilla schedule whose unplug must migrate: seven short
    requests grow the pool to 8 partitions, a half-partition request then
    takes blocks all over it, the seven expire and the shrink to 2
    partitions has to move the long request's tail blocks into the head.
    The plan is checked before the unplug (so migration does not depend
    on walls), and the copies are checked on the pool's content."""
    mgr, bpp = eng.arena.manager, eng.spec.blocks_per_partition
    empty = deque()
    for i in range(7):
        eng.submit(Request(rid=f"v{i}", profile=PROFILES["bert"],
                           submit_s=eng.now))
    while eng.active or eng.pending:
        eng._tick(empty)
    check(eng._units() == N_PARTITIONS, "the short burst grew the pool")
    long = FunctionProfile("long", prompt_tokens=PARTITION_TOKENS // 2,
                           decode_tokens=8, max_tokens=PARTITION_TOKENS)
    eng.submit(Request(rid="L", profile=long, submit_s=eng.now))
    while eng.active or eng.pending:
        eng._tick(empty)
    for prof in [k for k in eng.warm if k != "long"]:
        for _t, rid, _row in eng.warm.pop(prof):
            eng.arena.finish(rid)
    units = (eng._units() - eng.ladder[0]) * bpp
    k, moves = mgr.shrink_plan(units)
    check(moves and k == units,
          f"shrink plan of {units} blocks migrates: k={k}, {len(moves)} moves")
    _fill_random(eng.pool, gen)
    before = [x.clone() for x in eng.pool]
    n_events = len(mgr.reclaim_events)
    eng._resize()
    evs = mgr.reclaim_events[n_events:]
    check(len(evs) == 1 and evs[0].migrated_blocks == len(moves)
          and evs[0].reclaimed_units == units,
          f"one unplug of {units} blocks moved {len(moves)} blocks")
    src = torch.tensor([m[0] for m in moves], device=DEV)
    dst = torch.tensor([m[1] for m in moves], device=DEV)
    kept = torch.tensor(sorted(set(range(mgr.pool_blocks))
                               - {m[1] for m in moves}), device=DEV)
    check(all(torch.equal(x[dst].view(torch.int16),
                          y[src].view(torch.int16))
              and torch.equal(x[kept].view(torch.int16),
                              y[kept].view(torch.int16))
              for x, y in zip(eng.pool, before)),
          "migrated blocks arrived, kept blocks untouched")
    del before
    eng.submit(Request(rid="L2", profile=long, submit_s=eng.now))
    while eng.active or eng.pending:
        eng._tick(empty)
    check(eng.warm_starts >= 1, "the long request warm-started again")
    return {"moves": len(moves), "unplug_blocks": units,
            "migrated_bytes": evs[0].migrated_bytes,
            "unplug_wall_ms": evs[0].wall_seconds * 1e3}


def phase_engine(cfg, gen) -> tuple[dict, dict, dict]:
    t0 = time.perf_counter()
    params = M.init_params(cfg, 0, device=DEV)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(params))
    spec = ArenaSpec.from_model(cfg, partition_tokens=PARTITION_TOKENS,
                                n_partitions=N_PARTITIONS,
                                block_tokens=BLOCK_TOKENS)
    kv_per_token = spec.bytes_per_partition // PARTITION_TOKENS
    check(kv_per_token == 57_344, f"KV bytes per token {kv_per_token}")
    check(spec.bytes_per_partition == 117_440_512,
          f"bytes per partition {spec.bytes_per_partition}")
    emit({"phase": "engine_setup", "params": n_params,
          "param_bytes": sum(x.numel() * x.element_size()
                             for x in tree_leaves(params)),
          "kv_bytes_per_token": kv_per_token,
          "bytes_per_partition": spec.bytes_per_partition,
          "arena_bytes": spec.arena_bytes,
          "init_seconds": time.perf_counter() - t0})
    bpp = spec.blocks_per_partition

    # every engine is made first: building and loading the kernels and the
    # throw-away warm-up decode are set-up, outside the counted run
    snap_broker = HostMemoryBroker(budget_units=12 * bpp,
                                   snapshot_pool_units=4 * bpp)
    snap = ServeEngine(cfg, params, spec, mode="hotmem", keep_alive=2.0,
                       seed=0, broker=snap_broker, replica_id="A")
    cow_broker = HostMemoryBroker(budget_units=12 * bpp,
                                  snapshot_pool_units=4 * bpp)
    cow_a = ServeEngine(cfg, params, spec, keep_alive=2.0, seed=0,
                        broker=cow_broker, replica_id="A",
                        snapshot_page_bytes=PAGE_BYTES)
    cow_b = ServeEngine(cfg, params, spec, keep_alive=2.0, seed=1,
                        broker=cow_broker, replica_id="B",
                        snapshot_page_bytes=PAGE_BYTES)
    burst = ServeEngine(cfg, params, spec, mode="hotmem", keep_alive=3.0)
    van = ServeEngine(cfg, params, spec, mode="vanilla", keep_alive=3.0)
    van_s = ServeEngine(cfg, params, spec, mode="vanilla", keep_alive=1000.0,
                        seed=1)
    hotmem_engines = (snap, cow_a, cow_b, burst)
    vanilla_engines = (van, van_s)
    engines = hotmem_engines + vanilla_engines
    van_drops = []
    for eng in vanilla_engines:
        _measure_unplugs(eng, van_drops)

    drops = []
    sync_rows = burst._sync_rows

    def measured_sync_rows(parts):
        rows = burst._rows()
        before = torch.cuda.memory_allocated(DEV)
        sync_rows(parts)
        torch.cuda.synchronize()
        if parts < rows:
            drops.append({"rows": rows, "parts": parts,
                          "freed_bytes": before
                          - torch.cuda.memory_allocated(DEV),
                          "reserved_bytes": torch.cuda.memory_reserved(DEV)})
    burst._sync_rows = measured_sync_rows

    ops.reset_launches()
    kv_snapshot.reset_stats()
    t_run = time.perf_counter()
    # (a) cold -> warm -> expiry capture -> restore -> restore
    _run_one(snap, "c0")
    _run_one(snap, "w0")
    _expire(snap)
    snap_ev = [e for e in snap.events if e.kind == "snapshot"]
    _run_one(snap, "s0")
    _expire(snap)
    _run_one(snap, "s1")
    m_snap = snap.metrics()
    # (b) paged copy-on-write: a local restore remaps on the device, a
    # fresh replica pays one host->device copy
    _run_one(cow_a, "c0")
    _expire(cow_a)
    stats_before = dict(kv_snapshot.STATS)
    _run_one(cow_a, "r0")
    remap_h2d = kv_snapshot.STATS["h2d_bytes"] - stats_before["h2d_bytes"]
    remaps = kv_snapshot.STATS["remap_restores"] \
        - stats_before["remap_restores"]
    h2d_before = kv_snapshot.STATS["h2d_transfers"]
    _run_one(cow_b, "r1")
    fresh_h2d = kv_snapshot.STATS["h2d_transfers"] - h2d_before
    # (c) a bursty trace that plugs up the ladder and unplugs back down
    reqs = _bursty()
    m_burst = burst.run(reqs, max_virtual_s=2000)
    # (d) the vanilla paged baseline on the same trace, and (e) a scripted
    # vanilla unplug that must migrate
    van_reqs = _bursty()
    m_van = van.run(van_reqs, max_virtual_s=2000)
    scripted = _vanilla_migration(van_s, gen)
    m_van_s = van_s.metrics()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    launches = dict(ops.LAUNCHES)
    stats = dict(kv_snapshot.STATS)

    decode_steps = sum(e.metrics()["decode_steps"] for e in engines)
    row_bytes = kv_snapshot.expected_row_bytes(cfg, PARTITION_TOKENS)
    cow_ev = [e for e in cow_a.events if e.kind == "restore"]
    van_events = [ev for e in vanilla_engines
                  for ev in e.arena.manager.reclaim_events]
    passes = sum(1 for ev in van_events if ev.migrated_blocks)
    for eng in vanilla_engines:
        eng.arena.manager.check_invariants()
    checks = {
        "completed == submitted": m_burst["completed"] == len(reqs)
        and m_van["completed"] == len(van_reqs)
        and m_van_s["completed"] == len(van_s.done) == 9,
        "killed == 0": m_burst["killed"] == 0 and all(
            e.metrics()["killed"] == 0 for e in engines),
        "hotmem migrated_bytes == 0": all(
            e.metrics()["migrated_bytes"] == 0 for e in hotmem_engines),
        "vanilla migrated_bytes > 0, == blocks x 1,835,008":
            m_van["migrated_bytes"] + m_van_s["migrated_bytes"] > 0
            and spec.bytes_per_block == 1_835_008 and all(
                ev.migrated_bytes == ev.migrated_blocks * 1_835_008
                for ev in van_events),
        "vanilla reclaimed_bytes > 0": m_van["reclaimed_bytes"] > 0
        and m_van_s["reclaimed_bytes"] > 0,
        "kv_compact launches == migration passes":
            launches["kv_compact"] == passes > 0,
        "vanilla unplugs free device memory": bool(van_drops) and all(
            d["freed_bytes"] >= (d["blocks"] - d["kept"])
            * spec.bytes_per_block for d in van_drops),
        "reclaimed_bytes > 0": m_burst["reclaimed_bytes"] > 0,
        "plugged and unplugged": any(
            e.kind == "plug" for e in burst.events) and any(
            e.kind == "unplug" for e in burst.events),
        "cold, warm, restore starts": (m_snap["cold_starts"],
                                       m_snap["warm_starts"]) == (1, 1)
        and m_snap["restore_starts"] >= 2,
        "captured bytes == expected_row_bytes":
            m_snap["snapshots_taken"] == 1
            and snap_ev[0].detail["bytes"] == row_bytes,
        "partition_attention launches == decode steps x layers":
            launches["partition_attention"] == decode_steps * cfg.num_layers,
        "capture launches == STATS": launches["snapshot_capture"]
        == stats["capture_launches"] > 0,
        "restore launches == STATS": launches["snapshot_restore"]
        == stats["restore_launches"] > 0,
        "zero-h2d remap restore": remaps == 1 and remap_h2d == 0
        and cow_ev[-1].detail["pages_shared"]
        == cow_ev[-1].detail["pages_total"],
        "fresh replica pays one h2d": cow_b.restore_starts == 1
        and fresh_h2d == 1,
        "unplug frees device memory": bool(drops) and all(
            d["freed_bytes"] >= (d["rows"] - d["parts"])
            * spec.bytes_per_partition for d in drops),
    }
    walls = {k: [e.wall_s for e in snap.events if e.kind == k]
             for k in ("prefill", "snapshot", "restore")}
    unplug_ms = {
        "hotmem": [e.wall_s * 1e3 for e in burst.events
                   if e.kind == "unplug"],
        "vanilla": [e.wall_s * 1e3 for e in van.events
                    if e.kind == "unplug"],
        "vanilla_scripted": [e.wall_s * 1e3 for e in van_s.events
                             if e.kind == "unplug"]}
    van_decode = [e.wall_s * 1e3 for e in van.events if e.kind == "decode"]
    burst_walls = {k: [e.wall_s * 1e3 for e in burst.events if e.kind == k]
                   for k in ("decode", "prefill", "plug", "unplug")}
    wall_stats = {k: {"n": len(v), "median": float(np.median(v)),
                      "p90": float(np.percentile(v, 90)), "max": max(v)}
                  for k, v in burst_walls.items() if v}
    emit({"phase": "engine", "run_seconds": run_s,
          "decode_steps": decode_steps, "launches": launches,
          "stats": stats, "unplug_memory": drops,
          "vanilla_unplug_memory": van_drops,
          "unplug_walls_ms": unplug_ms, "vanilla_scripted": scripted,
          "vanilla_burst": {k: v for k, v in m_van.items() if k != "events"},
          "vanilla_migrated_blocks": [ev.migrated_blocks
                                      for ev in van_events],
          "snapshot_walls_s": walls, "burst_walls_ms": wall_stats,
          "burst": {k: v for k, v in m_burst.items() if k != "events"},
          "snapshot_schedule": {k: v for k, v in m_snap.items()
                                if k != "events"},
          "checks": checks})
    for what, ok in checks.items():
        check(ok, what)

    # the output itself: a full-width decode step gives finite logits
    caches = M.init_caches(cfg, 1, PARTITION_TOKENS, device=DEV)
    prompt = torch.full((1, 24), 7, dtype=torch.int32, device=DEV)
    lg, caches = M.prefill(cfg, params, {"tokens": prompt}, caches)
    nxt = lg.argmax(-1)[:, None].to(torch.int32)
    lg2, _ = M.decode_step(cfg, params, nxt,
                           torch.tensor([24], dtype=torch.int32, device=DEV),
                           caches)
    check(tuple(lg2.shape) == (1, cfg.vocab_size)
          and bool(torch.isfinite(lg2.float()).all()),
          "full-width decode logits finite, shape (1, vocab)")
    summary = {"decode_steps": decode_steps,
               "latency_p50_s": m_burst["latency_p50"],
               "latency_p99_s": m_burst["latency_p99"],
               "burst_median_ms": {k: v["median"]
                                   for k, v in wall_stats.items()},
               "snapshot_walls_ms": {k: [x * 1e3 for x in v]
                                     for k, v in walls.items()},
               "unplug_freed_bytes": [d["freed_bytes"] for d in drops],
               "reclaimed_bytes": m_burst["reclaimed_bytes"],
               "unplug_walls_ms": unplug_ms,
               "vanilla": {
                   "migrated_bytes": m_van["migrated_bytes"]
                   + m_van_s["migrated_bytes"],
                   "migrated_blocks": [ev.migrated_blocks
                                       for ev in van_events],
                   "reclaimed_bytes": m_van["reclaimed_bytes"]
                   + m_van_s["reclaimed_bytes"],
                   "unplug_freed_bytes": [d["freed_bytes"]
                                          for d in van_drops],
                   "decode_median_ms": float(np.median(van_decode)),
                   "latency_p50_s": m_van["latency_p50"],
                   "latency_p99_s": m_van["latency_p99"],
                   "kv_compact_launches": launches["kv_compact"]}}
    return launches, params, summary


# ---------------------------------------------------------------------------
# Phase 4: the cluster layer — two full-width replicas share one host budget
# ---------------------------------------------------------------------------


def _allocated() -> int:
    torch.cuda.synchronize(DEV)
    return torch.cuda.memory_allocated(DEV)


def _digest(blob) -> str:
    """sha256 of a row blob's bytes (a host uint8 array or a device blob)."""
    if isinstance(blob, torch.Tensor):
        blob = blob.view(torch.uint8).reshape(-1).cpu().numpy()
    return hashlib.sha256(memoryview(blob)).hexdigest()


def _row_digest(eng, row: int) -> str:
    """Digest of one arena row, gathered by the plain version (no kernel
    launch is counted for the check)."""
    leaves, _axes, _ = M.cache_flat_axes(eng.caches)
    return _digest(ref.snapshot_capture(
        leaves, torch.tensor([row], device=DEV), eng._snapshot_layout()))


def _arena_bytes(engines) -> int:
    """Device bytes of the engines' own tensors: row caches and pools."""
    return sum(x.numel() * x.element_size() for e in engines
               for x in tree_leaves(e.caches) + tree_leaves(e.pool or []))


class ClusterProbe:
    """Checks the cluster runs from outside the engines' timed walls.

    ``watch`` wraps an engine's ``_unplug_now``: at every steal it keeps
    the survivors' K/V (hotmem: every arena row; vanilla: each request's
    blocks read through its block table, after filling the pool with random
    bytes — decode computes over the rows, so the pool's content is
    otherwise zeros), reads ``memory_allocated()`` around the unplug, and
    afterwards holds the drop to the stolen rows' or blocks' bytes and the
    survivors to their old bytes.  It also wraps ``_offer_snapshot`` and
    ``_start_restore``: a captured blob must equal its row, and a restored
    row must equal the blob it came from, by sha256."""

    def __init__(self, spec, gen):
        self.spec, self.gen = spec, gen
        self.steals: list[dict] = []
        self.captured: dict[int, str] = {}
        self.restores: list[dict] = []

    def watch(self, eng) -> None:
        unplug, offer, restore = (eng._unplug_now, eng._offer_snapshot,
                                  eng._start_restore)

        def measured_unplug(units, *, stolen=False):
            if not stolen:
                return unplug(units)
            before = self._survivors(eng)
            mem0 = _allocated()
            ev = unplug(units, stolen=True)
            freed = mem0 - _allocated()
            self.steals.append({
                "victim": eng.replica_id, "mode": eng.mode,
                "units": ev.reclaimed_units,
                "reclaimed_bytes": ev.reclaimed_bytes,
                "migrated_blocks": ev.migrated_blocks,
                "freed_bytes": freed,
                "survivors": eng._rows() if eng.mode == "hotmem"
                else len(before),
                "survivors_unchanged": self._unchanged(eng, before)})
            return ev

        def checked_offer(prof_name, rid, row):
            ok = offer(prof_name, rid, row)
            if ok:
                snap = eng.broker.snapshots.peek(prof_name)
                digest = _digest(snap.payload.blob)
                check(digest == _row_digest(eng, row),
                      f"{eng.replica_id} captured {prof_name} as its row")
                self.captured[id(snap.payload)] = digest
            return ok

        def checked_restore(req, row, snap):
            restore(req, row, snap)
            want = self.captured.get(id(snap.payload))
            got = _row_digest(eng, row)
            self.restores.append({
                "replica": eng.replica_id, "key": snap.key,
                "source": eng.events[-1].detail["source"],
                "digest": got[:16], "equal": got == want})

        eng._unplug_now = measured_unplug
        eng._offer_snapshot = checked_offer
        eng._start_restore = checked_restore

    def _survivors(self, eng) -> dict:
        if eng.mode == "hotmem":
            leaves = M.cache_flat_axes(eng.caches)[0]
            return {"rows": [x.clone() for x in leaves]}
        _fill_random(eng.pool, self.gen)
        mgr = eng.arena.manager
        return {rid: gather_blocks(eng.pool, torch.tensor(
            [mgr.block_table(rid)], device=DEV)) for rid in mgr._tables}

    def _unchanged(self, eng, before: dict) -> bool:
        def same(x, y):
            return torch.equal(x.view(torch.int16), y.view(torch.int16))
        if eng.mode == "hotmem":
            leaves, axes, _ = M.cache_flat_axes(eng.caches)
            return all(same(x, y.narrow(ax, 0, x.shape[ax]))
                       for x, y, ax in zip(leaves, before["rows"], axes))
        mgr = eng.arena.manager
        return set(before) == set(mgr._tables) and all(
            same(x, y) for rid, old in before.items()
            for x, y in zip(gather_blocks(eng.pool, torch.tensor(
                [mgr.block_table(rid)], device=DEV)), old))

    def steal_checks(self, steals: list[dict]) -> dict:
        spec = self.spec
        return {
            "memory drop == stolen bytes": all(
                s["freed_bytes"] == s["reclaimed_bytes"] == s["units"] * (
                    spec.bytes_per_partition if s["mode"] == "hotmem"
                    else spec.bytes_per_block) for s in steals),
            "survivors' K/V unchanged": all(s["survivors_unchanged"]
                                            for s in steals)}


def _build(cfg, params, spec, probe, **kw):
    """``launch/cluster_demo.py``'s cluster, every replica watched; checks
    that building it added only the replicas' arenas to the device."""
    gc.collect()
    mem0 = _allocated()
    sched, hosts, sim = build_cluster(cfg, params, spec, **kw)
    engines = [e for es in hosts.values() for e in es.values()]
    grew, arenas = _allocated() - mem0, _arena_bytes(engines)
    check(grew == arenas,
          f"replicas added {grew} bytes for {arenas} bytes of arenas: the "
          f"weights are held once")
    for eng in engines:
        probe.watch(eng)
    return sched, {e.replica_id: e for e in engines}, sim, grew


def _spy_async(broker, a) -> tuple[list, list]:
    """A's decode count when each reclaim order is issued and when each
    fill lands (``tests/test_cluster.py``'s spies)."""
    issued, filled = [], []
    issue, fill = broker._issue_orders, broker._apply_fill

    def decodes():
        return sum(1 for e in a.events if e.kind == "decode")

    def spy_issue(requester, deficit, grant):
        issued.append(decodes())
        return issue(requester, deficit, grant)

    def spy_fill(o, k, **kw):
        filled.append(decodes())
        return fill(o, k, **kw)

    broker._issue_orders, broker._apply_fill = spy_issue, spy_fill
    return issued, filled


def _scripted_steal(cfg, params, spec, mode, probe) -> dict:
    """A steal that cannot fail to happen (sync broker, 10 partitions'
    budget): B fills its 8 partitions, all but one request finish into warm
    containers, then A's 8 requests ask for 6 more partitions than the
    free pool holds.  Hotmem: the survivor is on row 0, under the warm
    suffix the steal drops.  Vanilla: seven requests grow the pool first,
    then a 1,024-token survivor takes blocks all over it, so shrinking B
    to 2 partitions must migrate (the plan is checked before A asks)."""
    bpp, empty = spec.blocks_per_partition, deque()
    broker = HostMemoryBroker(budget_units=10 * bpp)
    a = ServeEngine(cfg, params, spec, mode=mode, keep_alive=3.0, seed=0,
                    broker=broker, replica_id="A")
    b = ServeEngine(cfg, params, spec, mode=mode, keep_alive=1000.0, seed=1,
                    broker=broker, replica_id="B")
    for eng in (a, b):
        probe.watch(eng)
    long = FunctionProfile("long", prompt_tokens=PARTITION_TOKENS // 2,
                           decode_tokens=min(96, PARTITION_TOKENS // 2 - 8),
                           max_tokens=PARTITION_TOKENS)
    shorts = [Request(rid=f"s{i}", profile=PROFILES["bert"], submit_s=0.0)
              for i in range(7)]
    if mode == "hotmem":
        b.submit(Request(rid="L", profile=long, submit_s=0.0))
        b._tick(empty)
        for r in shorts:
            b.submit(r)
        while len(b.active) > 1 or b.pending:
            b._tick(empty)
        check(b._row_req[0].rid == "L", "the survivor holds B's row 0")
    else:
        for r in shorts:
            b.submit(r)
        while b.active or b.pending:
            b._tick(empty)
        b.submit(Request(rid="L", profile=long, submit_s=b.now))
        b._tick(empty)
        k, moves = b.arena.manager.shrink_plan(6 * bpp)
        check(b._free_units() >= 6 and k == 6 * bpp and moves,
              f"B's shrink by 6 partitions needs no eviction and migrates: "
              f"{len(moves)} moves")
    check(b._units() == N_PARTITIONS and broker.free_units == 0
          and list(b.active) == ["L"],
          "B holds its 8 partitions, one request active, the pool empty")
    n0 = len(probe.steals)
    compact0 = ops.LAUNCHES["kv_compact"]
    for i in range(8):
        a.submit(Request(rid=f"a{i}", profile=PROFILES["cnn"],
                         submit_s=a.now))
    while a.active or a.pending:
        a._tick(empty)
    while b.active:
        b._tick(empty)
    steals = probe.steals[n0:]
    rep = broker.report()
    broker.check_invariants()
    for eng in (a, b):
        eng.arena.manager.check_invariants()
    done = [e.metrics() for e in (a, b)]
    return {"mode": mode, "steals": rep["steals"],
            "stolen_units": rep["stolen_units"], "by_mode": rep["by_mode"],
            "migrated_bytes": rep["by_mode"][mode]["migrated_bytes"],
            "steal_walls_ms": [r.wall_seconds * 1e3
                               for r in broker.steal_log],
            "steal_records": steals,
            "kv_compact_launches": ops.LAUNCHES["kv_compact"] - compact0,
            "completed": sum(m["completed"] for m in done),
            "killed": sum(m["killed"] for m in done), "submitted": 16,
            "engines": 2, "natural_fills": sum(
                r.natural for r in broker.steal_log),
            "requesters": [r.requester for r in broker.steal_log],
            "victims": [r.victim for r in broker.steal_log],
            "decode_steps": sum(m["decode_steps"] for m in done),
            "migrating_unplugs": _migrating_unplugs((a, b))}


def _migrating_unplugs(engines) -> int:
    """Unplugs (steals or the engines' own) that ran a migration pass."""
    return sum(1 for e in engines for ev in e.arena.manager.reclaim_events
               if getattr(ev, "migrated_blocks", 0))


def _trace_run(cfg, params, spec, probe, *, mode, async_mode, hosts=1):
    """The demo's pinned two-replica trace (``examples/cluster_demo.py``),
    on one host, or on two hosts with the late pooled tail."""
    n0 = len(probe.steals)
    sched, engines, sim, grew = _build(
        cfg, params, spec, probe, mode=mode, async_mode=async_mode,
        hosts=hosts, policy="pinned")
    a = engines["A"]
    spies = _spy_async(sched.brokers["h0"], a) if async_mode else None
    reqs = demo_requests(hosts > 1)
    t0 = time.perf_counter()
    m = sim.run(reqs, max_virtual_s=2000)
    torch.cuda.synchronize(DEV)
    seconds = time.perf_counter() - t0
    sched.check_invariants()
    for eng in engines.values():
        eng.arena.manager.check_invariants()
    row = summarize(mode, sched, m)
    brokers = list(sched.brokers.values())
    a_lat = [r.latency for r in a.done if r.state is State.DONE]
    a_stalls = [e.wall_s for e in a.events if e.kind == "stall"] or [0.0]
    out = {"mode": mode, "broker": "async" if async_mode else "sync",
           "hosts": hosts, "submitted": len(reqs), "seconds": seconds,
           "arena_growth_bytes": grew, **row,
           "a_latency_p99_s": float(np.percentile(a_lat, 99)),
           "a_stall_p99_ms": float(np.percentile(a_stalls, 99)) * 1e3,
           "engines": len(engines),
           "natural_fills": sum(r.natural for b in brokers
                                for r in b.steal_log),
           "steal_walls_ms": [r.wall_seconds * 1e3 for b in brokers
                              for r in b.steal_log],
           "steal_records": probe.steals[n0:],
           "request_stalls": sum((b.request_stalls for b in brokers), []),
           "pending_units": sum(b.pending_units() for b in brokers),
           "decode_steps": sum(e.metrics()["decode_steps"]
                               for e in engines.values()),
           "migrating_unplugs": _migrating_unplugs(engines.values())}
    if spies is not None:
        out["orders_issued_at_a_decode"], out["fills_at_a_decode"] = spies
    return out


def phase_cluster(cfg, params, gen) -> tuple[dict, dict]:
    """Two full-width qwen2-7b replicas on one ``HostMemoryBroker`` with 10
    partitions' budget (less than two full arenas), on the one ``params``:
    (a) a scripted steal per mode, (b) the demo's pinned trace in both modes
    under the sync and the async broker, (c) two hosts with the late pooled
    tail, B's captures restored remotely on A."""
    spec = ArenaSpec.from_model(cfg, partition_tokens=PARTITION_TOKENS,
                                n_partitions=N_PARTITIONS,
                                block_tokens=BLOCK_TOKENS)
    probe = ClusterProbe(spec, gen)
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launches()
    kv_snapshot.reset_stats()
    t0 = time.perf_counter()
    scripted = {mode: _scripted_steal(cfg, params, spec, mode, probe)
                for mode in ("hotmem", "vanilla")}
    runs = [_trace_run(cfg, params, spec, probe, mode=mode,
                       async_mode=async_mode)
            for mode in ("hotmem", "vanilla") for async_mode in (False, True)]
    fleet = _trace_run(cfg, params, spec, probe, mode="hotmem",
                       async_mode=False, hosts=2)
    torch.cuda.synchronize(DEV)
    seconds = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    stats = dict(kv_snapshot.STATS)

    every = list(scripted.values()) + runs + [fleet]
    # each engine's one warm-up decode step (made in this phase) and the
    # steps of its runs
    decode_steps = sum(r["decode_steps"] + r["engines"] for r in every)
    migrating = sum(r["migrating_unplugs"] for r in every)
    h, v = scripted["hotmem"], scripted["vanilla"]
    asyncs = [r for r in runs if r["broker"] == "async"]
    checks = {
        "completed == submitted, killed == 0": all(
            r["completed"] == r["submitted"] and r["killed"] == 0
            for r in every),
        "(a) steals >= 1 per mode, the first A's from B": all(
            r["steals"] >= 1 and r["steal_records"]
            and (r["requesters"][0], r["victims"][0]) == ("A", "B")
            for r in (h, v)),
        "hotmem migrated_bytes == 0": all(
            r["migrated_bytes"] == 0 for r in [h] + runs + [fleet]
            if r["mode"] == "hotmem"),
        "vanilla migrated_bytes > 0, == migrated blocks x 1,835,008":
            v["migrated_bytes"] > 0 and spec.bytes_per_block == 1_835_008
            and all(r["migrated_bytes"] == 1_835_008 * sum(
                s["migrated_blocks"] for s in r["steal_records"])
                for r in [v] + runs if r["mode"] == "vanilla"),
        "(a) kv_compact launches == vanilla steals that migrated":
            v["kv_compact_launches"] == sum(
                1 for s in v["steal_records"] if s["migrated_blocks"]) > 0
            and h["kv_compact_launches"] == 0,
        "kv_compact launches == migrating vanilla unplugs":
            launches["kv_compact"] == migrating > 0,
        **probe.steal_checks(probe.steals),
        "async: request stalls 0, nothing pending, A decoded mid-order":
            all(all(s == 0.0 for s in r["request_stalls"])
                and r["pending_units"] == 0
                and r["orders_issued_at_a_decode"]
                and max(r["fills_at_a_decode"])
                > min(r["orders_issued_at_a_decode"]) for r in asyncs),
        "(c) remote restores >= 1, snapshot migrations >= 1":
            fleet["remote"] >= 1 and fleet["mig"] >= 1,
        "(c) every restored row equals its captured blob": bool(
            probe.restores) and all(r["equal"] for r in probe.restores),
        "partition_attention launches == decode steps x layers":
            launches["partition_attention"] == decode_steps * cfg.num_layers,
        "capture and restore launches == STATS":
            launches["snapshot_capture"] == stats["capture_launches"] > 0
            and launches["snapshot_restore"] == stats["restore_launches"]
            > 0,
    }
    walls = {"scripted": {m: r["steal_walls_ms"]
                          for m, r in scripted.items()},
             **{f"trace_{r['broker']}": {} for r in runs}}
    for r in runs:
        walls[f"trace_{r['broker']}"][r["mode"]] = r["steal_walls_ms"]
    table = [{k: r[k] for k in ("mode", "broker", "hosts", "completed",
                                "submitted", "killed", "steals",
                                "stolen_units", "reclaimed_bytes",
                                "migrated_bytes", "stall_p99_ms",
                                "a_stall_p99_ms", "steal_ms",
                                "latency_p99_s", "a_latency_p99_s", "warm",
                                "restore", "remote", "mig", "decode_steps",
                                "natural_fills", "seconds",
                                "arena_growth_bytes")}
             for r in runs + [fleet]]
    memory = [{k: s[k] for k in ("victim", "mode", "units", "freed_bytes",
                                 "reclaimed_bytes", "migrated_blocks",
                                 "survivors")} for s in probe.steals]
    emit({"phase": "cluster", "seconds": seconds, "launches": launches,
          "stats": stats, "checks": checks,
          "scripted": {m: {k: r[k] for k in (
              "steals", "stolen_units", "by_mode", "kv_compact_launches",
              "completed", "killed", "decode_steps", "natural_fills")}
              for m, r in scripted.items()},
          "runs": table, "restores": probe.restores,
          "steal_memory": memory[:8], "steals_checked": len(memory)})
    emit({"phase": "cluster_steal_walls_ms", **walls})
    for what, ok in checks.items():
        check(ok, what)
    summary = {
        "stall_p99_ms": {f"{r['mode']}_{r['broker']}": r["a_stall_p99_ms"]
                         for r in runs},
        "steals": {f"{r['mode']}_{r['broker']}": [
            r["steals"], r["stolen_units"], r["reclaimed_bytes"],
            r["migrated_bytes"]] for r in runs},
        "a_latency_p99_s": {f"{r['mode']}_{r['broker']}":
                            r["a_latency_p99_s"] for r in runs},
        "remote_restores": fleet["remote"], "seconds": seconds}
    return launches, summary


# ---------------------------------------------------------------------------
# Phase 5: where a decode step's time goes
# ---------------------------------------------------------------------------


def phase_profile(cfg, params) -> dict:
    """One full-width decode step over a full arena (8 rows, each at
    position 1024): its wall on the host clock (median of 10, each ended
    by a synchronise), then ``torch.profiler`` over 5 more steps for the
    device time by kernel and the device's busy share of the wall."""
    caches = M.init_caches(cfg, N_PARTITIONS, PARTITION_TOKENS, device=DEV)
    toks = torch.zeros((N_PARTITIONS, 1), dtype=torch.int32, device=DEV)
    pos = torch.full((N_PARTITIONS,), PARTITION_TOKENS // 2,
                     dtype=torch.int32, device=DEV)

    def step():
        M.decode_step(cfg, params, toks, pos, caches)

    step()
    walls = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    n = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    kernels = sorted(((e.self_device_time_total, e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0), reverse=True)
    busy_us = sum(k[0] for k in kernels)
    attn_us = sum(k[0] for k in kernels if "partition_attention" in k[2])
    emit({"phase": "profile", "rows": N_PARTITIONS,
          "position": PARTITION_TOKENS // 2,
          "step_ms_median": float(np.median(walls)) * 1e3,
          "step_ms_min": min(walls) * 1e3,
          "profiled_step_ms": prof_wall / n * 1e3,
          "device_busy_ms_per_step": busy_us / n / 1e3,
          "device_busy_share": busy_us / 1e6 / prof_wall if kernels else None,
          "attention_share_of_device": attn_us / busy_us if busy_us else None,
          "kernels_seen": len(kernels),
          "top": [{"kernel": k[2][:90], "ms_per_step": k[0] / n / 1e3,
                   "launches_per_step": k[1] / n,
                   "share": k[0] / busy_us} for k in kernels[:8]]})
    return {"step_ms_median": float(np.median(walls)) * 1e3,
            "device_busy_ms_per_step": busy_us / n / 1e3,
            "attention_ms_per_step": attn_us / n / 1e3}


# ---------------------------------------------------------------------------
# Phase 6: the path on the card against the plain path on the CPU
# ---------------------------------------------------------------------------


def phase_reference() -> float:
    """Reduced qwen2-7b with the same weights: prefill + three decode steps
    with the kernels on the card against the plain versions on the CPU.
    Tolerance 2e-2 of the largest logit: bf16 activations round at other
    places in cuBLAS and in PyTorch's CPU kernels."""
    cfg = reduced(get_config(ARCH))
    params_cpu = M.init_params(cfg, 0, device="cpu")
    params = tree_map(lambda x: x.to(DEV), params_cpu)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 16)).astype(np.int32))
    out = {}
    for dev, p in (("cpu", params_cpu), ("cuda", params)):
        caches = M.init_caches(cfg, 2, 32, device=dev)
        lg, caches = M.prefill(cfg, p, {"tokens": toks[:, :12].to(dev)},
                               caches)
        logits = [lg]
        for i in range(12, 16):
            lg, caches = M.decode_step(
                cfg, p, toks[:, i:i + 1].to(dev),
                torch.full((2,), i, dtype=torch.int32, device=dev), caches)
            logits.append(lg)
        out[dev] = torch.stack(logits).float().cpu()
    err = float((out["cuda"] - out["cpu"]).abs().max())
    scale = float(out["cpu"].abs().max())
    emit({"phase": "reference", "config": cfg.name, "max_abs_err": err,
          "max_abs_logit": scale})
    check(bool(torch.isfinite(out["cuda"]).all()) and err <= 2e-2 * scale,
          f"card vs CPU logits: {err} > 2e-2 * {scale}")
    return err


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this check runs on an NVIDIA card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    smi = phase_build()
    cfg = get_config(ARCH)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    rows = [phase_attention(cfg, gen), phase_paged_attention(cfg, gen),
            phase_kv_compact(cfg, gen)] + phase_snapshot(cfg, gen)
    torch.cuda.empty_cache()
    launches, params, summary = phase_engine(cfg, gen)
    cluster_launches, summary["cluster"] = phase_cluster(cfg, params, gen)
    summary.update(phase_profile(cfg, params))
    del params
    summary["reference_max_abs_err"] = phase_reference()
    for row in rows:
        # each kernel's count from the runs of the paths that drive it: the
        # engine and cluster runs, each counted from 0, or the
        # layout-contrast entry point
        if row["path"] == "engine":
            row["launches"] = launches[row["name"]] \
                + cluster_launches[row["name"]]
            check(cluster_launches[row["name"]] > 0,
                  f"{row['name']} ran on the cluster path")
        else:
            row["launches"] = row["path_launches"][row["name"]]
        check(row["launches"] > 0,
              f"{row['name']} ran on the {row['path']} path")
    emit({"phase": "summary", **summary})
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: row[k] for k in keys} for row in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
